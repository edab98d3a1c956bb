"""Checkpoint storage backends (port of ``repro.checkpoint.backends``:
the local-filesystem tier; the memory, sharded, remote and peer tiers
are not ported yet).

A backend is a key -> tree blob store; :class:`repro_torch.checkpoint.
store.CheckpointStore` layers the full/diff/batch chain semantics and
the manifest journal on top.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List

from repro_torch.checkpoint import io as cio
from repro_torch.obs.trace import trace_span

BACKENDS = ("local",)


class LocalFSBackend:
    """One atomic file per key: ``<key>.ckpt``, a streamed frame (reads
    are lazy ``np.memmap`` views)."""

    name = "local"
    provenance = "local"
    SUFFIX = ".ckpt"

    def __init__(self, root: str, *, fmt: str = "frame",
                 mmap_reads: bool = True):
        if fmt != "frame":
            raise NotImplementedError(
                f"format {fmt!r}: only 'frame' writing is ported")
        self.root = root
        self.persist_root = root
        self.fmt = fmt
        self.mmap_reads = mmap_reads
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}{self.SUFFIX}")

    def put(self, key: str, obj: Any) -> int:
        with trace_span("backend.put", "backend", tier=self.name,
                        key=key) as sp:
            n = cio.save_frame(self._path(key), obj)
            sp.set(bytes=n)
        return n

    def get(self, key: str) -> Any:
        path = self._path(key)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no blob {key!r} in {self.root}")
        return cio.load_frame(path, mmap=self.mmap_reads)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def keys(self) -> List[str]:
        return sorted(f[:-len(self.SUFFIX)] for f in os.listdir(self.root)
                      if f.endswith(self.SUFFIX))

    def url(self, key: str) -> str:
        return self._path(key)

    def protect(self, keys) -> None:
        """Nothing to evict on a durable tier."""

    def flush(self) -> None:
        """Every put is durable when it returns."""

    def close(self) -> None:
        self.flush()

    def stats(self) -> Dict[str, Any]:
        return {"backend": self.name}


def make_backend(name: str, root: str, *, fmt: str = "frame"):
    if name not in BACKENDS:
        raise NotImplementedError(
            f"backend {name!r} is not ported (ROADMAP slice 4)")
    return LocalFSBackend(root, fmt=fmt)
