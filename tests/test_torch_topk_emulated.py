"""The CUDA source of K1/K8's selection kernel (``kernels/csrc/topk.cu``)
compiled for the CPU with the host C++ compiler and run lane by lane,
against the port's plain versions, bit for bit.

The emulation stands in for what the CPU lacks: the lanes of a warp run
in turn as coroutines (``ucontext``) on one thread, each up to its next
warp collective; shuffles, warp reductions and ``__syncwarp`` exchange
their values between two such rounds; the warps of a CTA, and the CTAs,
run one after another (the selection has no barrier across warps);
``__shared__`` arrays are shared by them all; the cp.async helpers
become synchronous copies with the same zero fill. So the kernel's own
control flow and arithmetic run (the pipeline of stages, the lane
layout, the threshold, the three paths, the K8 epilogue), but neither
its timing nor the asynchrony of its copies: those are checked on the
card by ``chip_smoke.py``. Skipped where no C++ compiler is found."""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from test_torch_topk_select import INPUTS, _bits, _torch

EMU_HEADER = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
using std::max; using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline dim3 threadIdx, blockIdx, gridDim, blockDim;
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d}; }
struct __nv_bfloat16 { unsigned short x; };
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.x; }
inline float __bfloat162float(__nv_bfloat16 v) {
  unsigned u = (unsigned)v.x << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u; memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1);
  return {(unsigned short)(u >> 16)}; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline float __fdiv_rn(float a, float b) { return a / b; }
// the lanes of one warp run in turn as coroutines on this thread: each
// runs to its next warp collective and yields; a collective's values are
// exchanged through emu_buf between two rounds
inline ucontext_t emu_main, emu_ctx[32];
inline int emu_lane = 0;
inline bool emu_finished = false;
inline long long emu_buf[32];
inline std::function<void()> emu_body;
inline void emu_yield() { swapcontext(&emu_ctx[emu_lane], &emu_main); }
template <typename V> inline V emu_get(int src, V v) {
  long long s = 0; memcpy(&s, &v, sizeof(V)); emu_buf[emu_lane] = s;
  emu_yield();
  const long long r = emu_buf[src];
  emu_yield();
  V out; memcpy(&out, &r, sizeof(V)); return out; }
template <typename V> inline V __shfl_xor_sync(unsigned, V v, int m) {
  return emu_get(emu_lane ^ m, v); }
template <typename V> inline V __shfl_sync(unsigned, V v, int s) {
  return emu_get(s & 31, v); }
template <typename V> inline V __shfl_up_sync(unsigned, V v, int d) {
  return emu_get(emu_lane >= d ? emu_lane - d : emu_lane, v); }
inline int __reduce_max_sync(unsigned, int v) {
  int m = v; for (int s = 0; s < 32; ++s) m = std::max(m, emu_get(s, v));
  return m; }
inline void __syncwarp() { emu_yield(); }
inline void __syncthreads() { abort(); }   // no selection code uses it
inline void cp_async16(void* dst, const void* src, int bytes) {
  memcpy(dst, src, bytes); memset((char*)dst + bytes, 0, 16 - bytes); }
inline void cp_async_commit() {}
inline void cp_async_wait_prior() {}
static void emu_trampoline() { emu_body(); emu_finished = true; }
// runs warp w of the current CTA to its end, its lanes in rounds
static void emu_run_warp(int w) {
  static char stacks[32][1 << 18];
  bool done[32] = {};
  for (int l = 0; l < 32; ++l) {
    getcontext(&emu_ctx[l]);
    emu_ctx[l].uc_stack.ss_sp = stacks[l];
    emu_ctx[l].uc_stack.ss_size = sizeof(stacks[l]);
    emu_ctx[l].uc_link = &emu_main;
    makecontext(&emu_ctx[l], emu_trampoline, 0);
  }
  for (int left = 32; left;) {
    for (int l = 0; l < 32; ++l) {
      if (done[l]) continue;
      threadIdx.x = w * 32 + l;
      emu_lane = l;
      emu_finished = false;
      swapcontext(&emu_main, &emu_ctx[l]);
      if (emu_finished) { done[l] = true; --left; }
    }
    if (left && left < 32) abort();   // lanes left a collective unequal
  }
}
"""

EMU_MAIN = r"""
}  // namespace
template <typename T, bool PACK>
static void run(const void* x, void* vals, void* idx, void* scale,
                long long n, int k, int grid) {
  const long long nb = (n + kBlock - 1) / kBlock;
  gridDim.x = grid;
  blockDim.x = kSelWarps * kWarp;
  emu_body = [=] {
    topk_select_kernel<T, PACK>((const T*)x, vals, (int32_t*)idx,
                                (float*)scale, n, nb, k); };
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    for (int w = 0; w < kSelWarps; ++w) emu_run_warp(w);
  }
}
extern "C" void emu_select(const void* x, void* v, void* i, void* s,
                           long long n, int k, int grid, int bf16) {
  if (bf16) {
    if (s) run<__nv_bfloat16, true>(x, v, i, s, n, k, grid);
    else run<__nv_bfloat16, false>(x, v, i, s, n, k, grid);
  } else {
    if (s) run<float, true>(x, v, i, s, n, k, grid);
    else run<float, false>(x, v, i, s, n, k, grid);
  }
}
"""


def _emulation_source() -> str:
    """topk.cu up to its host launchers, with the CUDA headers and the
    cp.async helpers (inline PTX) replaced by the emulation's."""
    with open(os.path.join(build.CSRC, "topk.cu"), encoding="utf-8") as f:
        src = f.read()
    src = re.sub(r"#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n",
                 '#include "cuda_emu.h"\n', src)
    for name in ("cp_async16", "cp_async_commit", "cp_async_wait_prior"):
        src, n = re.subn(r"__device__ __forceinline__ void %s\(.*?\n}\n"
                         % name, "", src, flags=re.S)
        assert n == 1, name
    src = src[:src.index("template <typename T, bool PACK>\n"
                         "int launch_select")]
    assert "asm" not in src
    return src + EMU_MAIN


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to emulate the kernel with")
    d = tmp_path_factory.mktemp("topk_emu")
    (d / "cuda_emu.h").write_text(EMU_HEADER)
    (d / "topk_emu.cpp").write_text(_emulation_source())
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                          "-w", "-o", str(d / "emu.so"),
                          str(d / "topk_emu.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "emu.so"))
    lib.emu_select.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def emulate(lib, x: torch.Tensor, k: int, pack: bool, grid: int = 2):
    """The kernel's outputs for x (f32 or bf16), as the wrappers shape
    them; every output starts as garbage, so an unwritten one shows."""
    n = x.numel()
    nb = -(-n // 1024)
    idx = torch.full((nb, k), -7, dtype=torch.int32)
    if pack:
        vals = torch.full((nb, k), 99, dtype=torch.int8)
        scale = torch.full((nb, 1), -5.0)
    else:
        vals = torch.full((nb, k), 7.0).to(x.dtype)
        scale = None
    lib.emu_select(x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                   None if scale is None else scale.data_ptr(), n, k, grid,
                   int(x.dtype == torch.bfloat16))
    return (vals, idx) if scale is None else (vals, idx, scale)


@pytest.mark.parametrize("k", (1, 2, 11, 32, 33))
@pytest.mark.parametrize("name", list(INPUTS))
def test_kernel_source_matches_plain_versions(emu_lib, name, k):
    x = _torch(name).contiguous()
    xb = ref.to_blocks(x, 1024)[0]
    for pack, want in ((False, ref.topk_select_ref(xb, k)),
                       (True, ref.pack_select_ref(xb, k))):
        got = emulate(emu_lib, x, k, pack)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_kernel_source_walks_blocks_with_few_warps(emu_lib):
    """One CTA of four warps over 30 blocks: each warp cycles its two
    stages many times; k = 1024 runs the fallback to the last pick."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(30 * 1024 - 5)
                         .astype(np.float32))
    xb = ref.to_blocks(x, 1024)[0]
    for k in (11, 1024):
        got = emulate(emu_lib, x, k, False, grid=1)
        for a, b in zip(got, ref.topk_select_ref(xb, k)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
