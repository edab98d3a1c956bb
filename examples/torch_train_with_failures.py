"""End-to-end example of the PyTorch port: train a ~100M-param LM for a
few hundred steps with LowDiff per-iteration checkpointing and an
injected failure, through the port's launcher (repro_torch.launch.train).
Runs on the card unless ``--device cpu``; pass --quick for a 40-step
smoke variant of a reduced model.

Run:  PYTHONPATH=src python examples/torch_train_with_failures.py \\
          [--quick] [--device cpu]
"""
import argparse
import os
import tempfile

import repro_torch.launch.train as T
from repro_torch.configs import get_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    q = ap.parse_args(argv)

    args = T.build_parser().parse_args([
        "--arch", "gpt2-l", "--steps", "40" if q.quick else "300",
        "--batch", "2", "--seq", "64" if q.quick else "128",
        "--lr", "1e-3", "--rho", "0.01", "--strategy", "lowdiff",
        "--full-interval", "20", "--batch-size", "2",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_e2e"),
        "--fail-at", "20" if q.quick else "150", "--seed", "0",
        "--log-every", "10", "--device", q.device])
    # ~100M model: trim gpt2-l (1.07B) to a 12-layer/768-d variant
    cfg = get_config("gpt2-l").replace(
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
        vocab=16384 if q.quick else 50257)
    if q.quick:
        cfg = cfg.reduced()

    orig = T.get_config
    T.get_config = lambda name: cfg
    try:
        losses, times = T.run(args)
    finally:
        T.get_config = orig
    # single steps of synthetic tokens are noisy: compare 10-step means
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    assert last < first, "loss should decrease"
    print("\nend-to-end run finished; mean loss of 10 steps decreased "
          f"{first:.3f} -> {last:.3f} across an injected failure.")
    return losses


if __name__ == "__main__":
    main()
