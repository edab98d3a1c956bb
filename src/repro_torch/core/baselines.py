"""Baseline checkpointing strategies the paper compares against (§VIII-A),
port of ``repro.core.baselines``.

All share the LowDiff strategy interface (train_step / flush / recover /
stats), so the launcher and a benchmark can swap them:

* ``FullSync``      — "Torch.save": blocking full-state write every
                      ``interval`` iterations.
* ``CheckFreq``     — [FAST'21]: snapshot (sync D2H) + asynchronous
                      persist, pipelined; per-paper default interval 10.
* ``Gemini``        — [SOSP'23]: per-iteration snapshot into (peer) host
                      memory as the primary checkpoint, rare persistence;
                      recovery from host memory.
* ``NaiveDC``       — Check-N-Run style differential checkpointing for a
                      dense model: differential = M_{t+1} - M_t over the
                      *full* model state (3Ψ), top-k compressed each
                      iteration — i.e. DC *without* gradient reuse. This
                      carries the paper's Challenge-1 compression cost and
                      Challenge-2 transmission cost by construction.

Every baseline trains with the dense step (K3). Snapshots are
synchronous host copies (``core.snapshot.host_copy``). ``recover()``
returns the state on the strategy's device in the training layout
(``{"params", "opt": AdamState, "step"}``), so training resumes from it.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device, tree_leaves, tree_map
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.compression.sparse import is_compressed, topk_compress
from repro_torch.core import recovery as rec
from repro_torch.core.snapshot import host_copy
from repro_torch.core.steps import make_train_step
from repro_torch.kernels import ops
from repro_torch.obs.trace import trace_span
from repro_torch.optim.adam import AdamState


class _Base:
    def __init__(self, model, store: CheckpointStore, *, lr=1e-3,
                 interval: int = 1, device=None):
        self.model, self.store, self.lr = model, store, lr
        self.interval = interval
        self.device = resolve_device(device)
        self.step_fn = make_train_step(model, mode="dense", lr=lr)
        self.ckpt_time = 0.0
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Any] = []

    def flush(self):
        for f in self._pending:
            f.result()
        self._pending.clear()
        self.store.flush()

    def close(self):
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)
            self.store.close()

    def recover(self):
        entry = self.store.latest_full()
        if entry is None:
            raise FileNotFoundError("no checkpoint")
        return rec.to_device(self.store.load_full(entry), self.device), 0

    def stats(self):
        return {"store": self.store.stats(),
                "train_loop_ckpt_time": self.ckpt_time}


class FullSync(_Base):
    name = "full_sync"

    def train_step(self, state, batch):
        state, metrics, _ = self.step_fn(state, batch)
        step = int(state["step"])
        if step % self.interval == 0:
            t0 = time.perf_counter()
            self.store.save_full(step, host_copy(state))   # blocking
            self.ckpt_time += time.perf_counter() - t0
        return state, metrics


class CheckFreq(_Base):
    name = "checkfreq"

    def __init__(self, model, store, *, lr=1e-3, interval: int = 10,
                 device=None):
        super().__init__(model, store, lr=lr, interval=interval,
                         device=device)

    def train_step(self, state, batch):
        state, metrics, _ = self.step_fn(state, batch)
        step = int(state["step"])
        if step % self.interval == 0:
            t0 = time.perf_counter()
            # snapshot() is synchronous w.r.t. the update (WAR hazard in
            # the paper's analysis); persist() is async.
            snap = host_copy(state)
            self.ckpt_time += time.perf_counter() - t0
            self.flush()   # CheckFreq admits at most one in-flight persist
            self._pending.append(
                self._pool.submit(self.store.save_full, step, snap))
        return state, metrics


class Gemini(_Base):
    """In-memory checkpointing to (simulated peer) host DRAM."""
    name = "gemini"

    def __init__(self, model, store, *, lr=1e-3, interval: int = 1,
                 persist_interval: int = 100, device=None):
        super().__init__(model, store, lr=lr, interval=interval,
                         device=device)
        self.persist_interval = persist_interval
        self.memory_ckpt: Optional[Dict] = None
        self.memory_step = -1

    def train_step(self, state, batch):
        state, metrics, _ = self.step_fn(state, batch)
        step = int(state["step"])
        if step % self.interval == 0:
            t0 = time.perf_counter()
            # the old copy is dropped only once the new one has landed
            self.memory_ckpt = host_copy(state)      # "peer CPU memory"
            self.memory_step = step
            self.ckpt_time += time.perf_counter() - t0
        if step % self.persist_interval == 0:
            self._pending.append(self._pool.submit(
                self.store.save_full, step, self.memory_ckpt))
        return state, metrics

    def recover(self):
        if self.memory_ckpt is not None:
            return rec.to_device(self.memory_ckpt, self.device), 0
        return super().recover()


class NaiveDC(_Base):
    """Differential checkpointing without gradient reuse (Check-N-Run
    transplanted to dense models). The differential is computed and
    compressed *inside the training loop* — the compression stall the
    paper measures in Fig. 1 — then written asynchronously.

    The step replaces the state rather than updating it in place
    (``core.steps``), so the step-t state stays intact while step t+1
    runs and the delta reads both."""
    name = "naive_dc"

    def __init__(self, model, store, *, lr=1e-3, rho=0.01,
                 interval: int = 1, full_interval: int = 50, device=None):
        super().__init__(model, store, lr=lr, interval=interval,
                         device=device)
        self.rho = rho
        self.full_interval = full_interval

    def _diff_compress(self, new_state, old_state):
        """``compress_tree`` of the 3Ψ delta ``{"mu", "nu", "params"}``
        (params in f32), taken leaf by leaf: each leaf's dense delta is
        freed once K1 has selected from it, so the peak holds one leaf's
        delta beside the two states. The payload is the whole-tree
        one."""
        def one(a, b):
            return topk_compress(a.float() - b.float(), self.rho)
        return {"mu": tree_map(one, new_state["opt"].mu,
                               old_state["opt"].mu),
                "nu": tree_map(one, new_state["opt"].nu,
                               old_state["opt"].nu),
                "params": tree_map(one, new_state["params"],
                                   old_state["params"])}

    def train_step(self, state, batch):
        old_state = state
        state, metrics, _ = self.step_fn(state, batch)
        step = int(state["step"])
        t0 = time.perf_counter()
        if step % self.interval == 0:
            with trace_span("ckpt.compress", "persist", step=step):
                cd = self._diff_compress(state, old_state)
                if self.device.type == "cuda":  # Challenge 1 stall: waits
                    # on the training stream only, not on snapshot copies
                    torch.cuda.current_stream(self.device).synchronize()
            payload = host_copy(cd)
            self._pending.append(
                self._pool.submit(self.store.save_diff, step, payload))
        del old_state
        if step % self.full_interval == 0:
            self._pending.append(self._pool.submit(
                self.store.save_full, step, host_copy(state)))
        self.ckpt_time += time.perf_counter() - t0
        return state, metrics

    def recover(self):
        """Latest full + every differential after it: each delta decoded
        on the device (K2), merged pairwise, added to the full. Leaf by
        leaf, so the device holds one leaf's n dense deltas at a time;
        the sums are the whole-tree merge's."""
        state, diffs = rec.load_latest_chain(self.store)
        state = rec.to_device(state, self.device)
        if diffs:
            payloads = [rec.to_device(p, self.device) for _, p in diffs]

            def apply(comp, tree, add):
                wires = [tree_leaves(p[comp], is_leaf=is_compressed)
                         for p in payloads]
                new = [add(x, rec.merge_deltas_pairwise(
                    [ops.topk_decompress(w[j]) for w in wires])[0])
                       for j, x in enumerate(tree_leaves(tree))]
                it = iter(new)
                return tree_map(lambda _: next(it), tree)

            state["params"] = apply(
                "params", state["params"],
                lambda p, d: (p.float() + d).to(p.dtype))
            opt = state["opt"]
            state["opt"] = AdamState(
                apply("mu", opt.mu, lambda a, b: a + b),
                apply("nu", opt.nu, lambda a, b: a + b),
                opt.count + len(diffs))
            state["step"] = torch.tensor(diffs[-1][0], dtype=torch.int32,
                                         device=self.device)
        return state, len(diffs)
