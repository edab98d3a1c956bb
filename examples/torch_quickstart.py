"""Quickstart of the PyTorch port: per-iteration differential
checkpointing with LowDiff.

Trains a small GPT-2-family model with checkpointing *every iteration*,
then simulates a crash and recovers — the recovered state equals the
live state (the compressed gradient IS the differential checkpoint,
Finding 1 of the paper). Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import shutil
import tempfile

from repro_torch import tree_leaves
from repro_torch.checkpoint import StoreConfig, TierSpec
from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig, make_engine
from repro_torch.core.steps import init_state
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.registry import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart"))
    a = ap.parse_args(argv)
    shutil.rmtree(a.ckpt_dir, ignore_errors=True)
    cfg = get_config("gpt2-l").reduced()
    model = build_model(cfg)
    print(f"model: {cfg.name} ({model.n_params() / 1e6:.1f}M params) "
          f"on {a.device}")

    # the store is a declarative tier stack: swap TierSpec("local") for
    # TierSpec("sharded")/TierSpec("memory")/... — or prepend
    # TierSpec("peer", replicas=2) for Checkmate-style peer replication
    store = StoreConfig(a.ckpt_dir, tiers=[TierSpec("local")],
                        retention_fulls=2).build()
    lowdiff = make_engine(
        EngineConfig(strategy="lowdiff", rho=0.01, lr=1e-3,
                     full_interval=10, batch_size=2, device=a.device),
        model, store=store)
    state = init_state(model, 0, device=a.device)
    stream = TokenStream(cfg, seq_len=64, batch=4, device=a.device)

    print(f"\ntraining {a.steps} steps, checkpointing EVERY iteration...")
    for t in range(a.steps):
        state, metrics = lowdiff.train_step(state, next(stream))
        if (t + 1) % 5 == 0:
            print(f"  step {t + 1:3d}  loss {float(metrics['loss']):.4f}")
    lowdiff.flush()

    s = lowdiff.stats()
    print(f"\ncheckpoints: {s['store']['fulls']} full, "
          f"{s['store']['batches']} batched-diff writes "
          f"({s['store']['bytes'] / 2 ** 20:.1f} MiB total)")
    print(f"checkpointing time inside the training loop: "
          f"{s['train_loop_ckpt_time'] * 1e3:.1f} ms over {a.steps} steps")

    print("\n*** simulating failure; recovering from storage ***")
    recovered, n = lowdiff.recover()
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(tree_leaves(recovered["params"]),
                              tree_leaves(state["params"])))
    print(f"recovered to step {int(recovered['step'])} "
          f"(replayed {n} differentials); max |Δparam| vs live = {err:.2e}")
    assert err < 1e-6
    lowdiff.close()
    print("OK — recovery is exact.")


if __name__ == "__main__":
    main()
