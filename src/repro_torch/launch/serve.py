"""Batched-request serving entry point (port of ``repro.launch.serve``).

Serves a model to a batch of concurrent requests with a KV cache: the
prompt is fed token by token through the decode step (no separate
prefill; the cache starts at zero), then the greedy continuation is
decoded, and the batch-aggregate tokens/s is reported. Params come from
the newest full of a checkpoint store (``--ckpt-dir``, with LowDiff+
patches overlaid), else from a seeded init. Runs on the card unless
``--device cpu`` is given; with no card and no ``--device cpu`` it
raises instead of running. The flags keep the reference's names and
defaults (``--reduced`` is on whatever is passed, as in the reference;
``run`` takes ``reduced=False`` from a caller).

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch qwen2-1.5b --reduced --batch 8 --prompt-len 16 --gen 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
from repro_torch.configs import get_config
from repro_torch.models.param import to_tensor
from repro_torch.models.registry import build_model
from repro_torch.obs.log import configure as configure_logging, get_logger

log = get_logger("serve")


def load_params(model, ckpt_dir, device=None):
    """Newest persisted params from a checkpoint directory on ``device``
    (CUDA unless the CPU is asked for), or None when the store holds no
    loadable full. The store is declared with the default single-tier
    StoreConfig — serving only reads. A top-k LowDiff chain gives its
    newest full (its differentials are not replayed); LowDiff+ patches
    are overlaid."""
    from repro_torch.checkpoint.config import StoreConfig
    dev = resolve_device(device)
    store = StoreConfig(root=ckpt_dir).build()
    try:
        state, step = store.load_latest_state()
    except FileNotFoundError:
        return None
    finally:
        store.close()
    params = state.get("params", state) if isinstance(state, dict) else state
    log.info(f"loaded checkpoint step {step} from {ckpt_dir}")
    return tree_map(lambda a: to_tensor(a, device=dev), params)


def generate(model, params, prompt: np.ndarray, gen: int, device, *,
             cache=None, keep_logits: bool = False):
    """Greedy decode of ``prompt`` (B, P) then ``gen`` tokens, one
    ``decode_step`` per position (the reference's loop: P + gen - 1
    steps). ``cache`` defaults to ``init_cache``'s zeros (an
    encoder-decoder's prefilled cache can be passed). Returns (tokens:
    ``gen`` arrays (B,) int32, logits: one (B, V) f32 tensor per step
    when ``keep_logits``, step_ms: per-step times, seconds: the loop's
    wall time with the card synchronised before the clock is read).
    On the card step times come from CUDA events recorded between the
    steps, so the host is not held back for them."""
    B, P = prompt.shape
    total = P + gen
    if cache is None:
        cache = model.init_cache(B, total, device=device)
    prompt_t = torch.from_numpy(prompt.astype(np.int32)).to(device)
    positions = torch.arange(total, dtype=torch.int32, device=device)
    cuda = device.type == "cuda"
    tokens = prompt_t[:, :1]
    out_tokens, logits_seen, marks = [], [], []

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    with torch.no_grad():
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        marks.append(mark())
        for pos in range(total - 1):
            batch = {"tokens": tokens, "pos": positions[pos]}
            logits, cache = model.decode_step(params, cache, batch, total)
            if keep_logits:
                logits_seen.append(logits)
            if pos + 1 < P:
                tokens = prompt_t[:, pos + 1:pos + 2]
            else:
                tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                out_tokens.append(tokens[:, 0].cpu().numpy())
            marks.append(mark())
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return out_tokens, logits_seen, step_ms, dt


def run(args, *, return_logits: bool = False):
    """Serve ``args.batch`` random prompts; returns the generated tokens
    (``args.gen`` arrays (B,)), with the per-step logits as a second
    value when ``return_logits``."""
    configure_logging(getattr(args, "log_level", "info"))
    device = resolve_device(getattr(args, "device", None))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = None
    if getattr(args, "ckpt_dir", None):
        params = load_params(model, args.ckpt_dir, device=device)
        if params is None:
            log.info(f"no loadable checkpoint in {args.ckpt_dir}; "
                     f"using random init")
    if params is None:
        params = model.init(0, device=device)

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    out_tokens, logits, step_ms, dt = generate(
        model, params, prompt, args.gen, device, keep_logits=return_logits)
    n_generated = len(out_tokens) * args.batch
    log.info(f"arch={cfg.name} batch={args.batch} "
             f"prompt={args.prompt_len} generated={len(out_tokens)}/req "
             f"device={device}")
    log.info(f"{n_generated} tokens in {dt:.2f}s -> "
             f"{n_generated / dt:.1f} tok/s (batch-aggregate)")
    log.info(f"sample continuation (req 0): "
             f"{[int(t[0]) for t in out_tokens[:10]]}")
    return (out_tokens, logits) if return_logits else out_tokens


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None,
                    help="load the newest persisted params from this "
                         "checkpoint store (random init when absent)")
    ap.add_argument("--log-level", default="info",
                    choices=("debug", "info", "warning", "error"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs on the host)")
    return ap


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
