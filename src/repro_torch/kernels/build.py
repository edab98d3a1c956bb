"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
under ``build/repro_torch/`` at the repository root, named by a hash of
the source and flags so an edited source rebuilds. Libraries load with
``ctypes``; every entry point takes device pointers, sizes and the CUDA
stream as ``c_void_p`` / ``c_longlong`` / ``c_int`` and returns the
``cudaError_t`` of its launch, which :func:`check` turns into an
exception. Nothing here runs at import time: the CPU tests import every
module of the port on a machine with no ``nvcc``.

Each kernel's wrapper keeps a plain-int launch count in
:data:`LAUNCHES`, incremented where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("topk", "fused_adam", "replay")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # every product and sum rounded on its own, as the plain
              # torch versions round them: no a*b+c contraction to fma
              "--fmad=false", "-Xptxas", "-v"]

#: kernel name -> launches on the card since the last reset
LAUNCHES: Dict[str, int] = {"topk_select": 0, "topk_scatter": 0,
                            "adam_tile_update": 0, "topk_apply": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> str:
    """``<repo>/build/repro_torch`` (override: ``REPRO_TORCH_BUILD``)."""
    env = os.environ.get("REPRO_TORCH_BUILD")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
    return os.path.join(root, "build", "repro_torch")


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the port's "
                       "CUDA kernels are built from kernels/csrc at first use")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{h.hexdigest()[:12]}.so")


def build(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns
    {name: seconds}; the ptxas report lands beside each library as
    ``<lib>.ptxas.txt``. Raises with nvcc's output on failure."""
    names = list(names or SOURCES)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    secs = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        with open(out + ".ptxas.txt", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def ptxas_report(name: str) -> str:
    try:
        with open(_lib_path(name) + ".ptxas.txt", encoding="utf-8",
                  errors="replace") as f:
            return f.read()
    except OSError:
        return ""


_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: C entry points per source: prefix -> argtypes
_SIGS = {
    "topk": {"topk_select_": [_VP, _VP, _VP, _LL, _INT, _VP],
             "topk_scatter_": [_VP, _VP, _VP, _LL, _INT, _VP]},
    "fused_adam": {"adam_update_": [_VP] * 8 + [_LL, _VP]},
    "replay": {"topk_apply_": [_VP] * 9 + [_LL, _INT, _VP]},
}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built at first use."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not os.path.exists(path):
                build([name])
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def entry(name: str, symbol: str):
    fn = getattr(lib(name), symbol)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        for prefix, argtypes in _SIGS[name].items():
            if symbol.startswith(prefix):
                fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


_SUFFIX = {"torch.float32": "f32", "torch.bfloat16": "bf16"}


def dtype_tag(dtype) -> str:
    tag = _SUFFIX.get(str(dtype))
    if tag is None:
        raise TypeError(f"kernel takes float32 or bfloat16, not {dtype}")
    return tag


def require_cuda(t, name: str, *, dtypes=None, align: int = 16) -> None:
    """Wrapper-side argument checks for a CUDA launch."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; kernel takes {dtypes}")
    if t.numel() and t.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned")
