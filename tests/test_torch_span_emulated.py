"""The CUDA source of K5 ``span_pack`` (``kernels/csrc/span.cu``, both
its one-pass and its two-pass path) compiled for the CPU with the host
C++ compiler and run thread by thread, against the port's plain version
and the numpy codec, bit for bit.

The emulation stands in for what the CPU lacks: every thread of every
CTA of a launch runs as a coroutine (``ucontext``) on one thread, up to
its next barrier, warp collective, mbarrier wait or spin, where it
yields; ``__syncthreads`` and ``__syncwarp`` wait for the CTA's or the
warp's threads, shuffles exchange their values between two such points,
and all CTAs of the one-pass grid run interleaved, so the cross-CTA row
sync runs as written (a part that spins yields to the others). The bulk
copies become synchronous copies that check their 16-B alignment and
complete their mbarrier's phase at once; each CTA has its own dynamic
shared memory. So the kernel's own control flow and arithmetic run (the
plan's segments, the ragged ends, the chunked reduction, the tagged row
slots, the lane chunks and their vector stores), but neither its timing nor the
asynchrony of its copies: those are checked on the card by
``chip_smoke.py``. Skipped where no C++ compiler is found."""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.compression.quant_span import encode_rows
from repro_torch.kernels import build, ref, span

THREADS = 128           # the emulated CTA: 4 warps (the card's has 16)

EMU_HEADER = r"""
#pragma once
#include <ucontext.h>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline dim3 threadIdx, blockIdx, gridDim, blockDim;
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct alignas(16) float4 { float x, y, z, w; };
struct __nv_bfloat16 { unsigned short x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u; memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1);
  return {(unsigned short)(u >> 16)}; }
inline unsigned __float_as_uint(float f) { unsigned i; memcpy(&i, &f, 4);
  return i; }
inline float __uint_as_float(unsigned i) { float f; memcpy(&f, &i, 4);
  return f; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
// every thread of the launch is a coroutine; the scheduler runs each in
// turn up to its next yield
struct EmuThread { ucontext_t ctx; unsigned cta, tid; bool done; };
inline std::vector<EmuThread> emu_threads;
inline std::vector<unsigned char*> emu_smem;
inline std::vector<int> emu_cta_count, emu_cta_gen;
inline std::vector<int> emu_warp_count, emu_warp_gen;
inline std::vector<long long> emu_warp_buf;
inline ucontext_t emu_main;
inline size_t emu_cur = 0;
inline std::function<void()> emu_body;
inline void emu_yield() {
  swapcontext(&emu_threads[emu_cur].ctx, &emu_main); }
inline void emu_barrier(int& count, int& gen, int n) {
  const int g = gen;
  if (++count == n) { count = 0; ++gen; return; }
  while (gen == g) emu_yield(); }
inline int emu_warp() {
  return blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; }
inline void __syncthreads() {
  emu_barrier(emu_cta_count[blockIdx.x], emu_cta_gen[blockIdx.x],
              blockDim.x); }
inline void __syncwarp() {
  emu_barrier(emu_warp_count[emu_warp()], emu_warp_gen[emu_warp()], 32); }
template <typename V> inline V __shfl_xor_sync(unsigned, V v, int m) {
  long long* buf = &emu_warp_buf[32 * emu_warp()];
  long long s = 0; memcpy(&s, &v, sizeof(V));
  buf[threadIdx.x % 32] = s;
  __syncwarp();
  const long long r = buf[(threadIdx.x % 32) ^ m];
  __syncwarp();
  V out; memcpy(&out, &r, sizeof(V)); return out; }
inline unsigned atomicMax(unsigned* p, unsigned v) {
  const unsigned o = *p; if (v > o) *p = v; return o; }
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  const unsigned long long o = *p; if (v > o) *p = v; return o; }
inline int __all_sync(unsigned, int pred) {
  long long* buf = &emu_warp_buf[32 * emu_warp()];
  buf[threadIdx.x % 32] = pred != 0;
  __syncwarp();
  int all = 1;
  for (int l = 0; l < 32; ++l) all &= buf[l] != 0;
  __syncwarp();
  return all; }
inline void __threadfence() {}
inline void __nanosleep(unsigned) { emu_yield(); }
inline void __trap() { abort(); }
// shared memory, mbarriers, bulk copies (synchronous), acquire loads
inline unsigned char* dynamic_smem() { return emu_smem[blockIdx.x]; }
// an mbarrier: completed phases (bits 0..31), arrivals in the current
// phase (32..47), arrivals a phase takes (48..63)
inline void mbar_init(uint64_t* bar, unsigned count) {
  *bar = (uint64_t)count << 48; }
inline void mbar_arrive(uint64_t* bar) {
  const uint64_t count = *bar >> 48;
  const uint64_t arrived = ((*bar >> 32) & 0xffff) + 1;
  const uint64_t phases = *bar & 0xffffffffu;
  *bar = arrived == count ? (count << 48) | (phases + 1)
                          : (count << 48) | (arrived << 32) | phases;
  emu_yield(); }   // a waiter may act on it before this thread goes on
inline void bulk_load(void* dst, const void* src, unsigned bytes,
                      uint64_t* bar) {
  if (bytes && (((uintptr_t)dst | (uintptr_t)src | bytes) & 15)) abort();
  memcpy(dst, src, bytes);
  mbar_arrive(bar); }
inline void fence_proxy_async() {}
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  while ((*bar & 1) == parity) emu_yield(); }
inline unsigned long long ld_acquire(const unsigned long long* p) {
  return *p; }
inline void st_release(unsigned long long* p, unsigned long long v) {
  *p = v; }
inline unsigned long long emu_clock = 0;
inline unsigned long long globaltimer() { return ++emu_clock; }
static void emu_trampoline() {
  emu_body(); emu_threads[emu_cur].done = true; }
// a launch of `grid` CTAs: all at once (the cooperative grid) or one
// CTA after another
static void emu_launch(unsigned grid, unsigned threads, size_t smem,
                       bool together) {
  static std::vector<char*> stacks;
  const size_t kStack = 1 << 16;
  gridDim.x = grid; blockDim.x = threads;
  emu_cta_count.assign(grid, 0); emu_cta_gen.assign(grid, 0);
  emu_warp_count.assign(grid * threads / 32, 0);
  emu_warp_gen.assign(grid * threads / 32, 0);
  emu_warp_buf.assign(grid * threads, 0);
  emu_smem.assign(grid, nullptr);
  for (unsigned b = 0; b < grid; ++b) {
    emu_smem[b] = (unsigned char*)aligned_alloc(128, (smem + 127) & ~127);
    memset(emu_smem[b], 0xAB, smem);   // garbage, as on the card
  }
  const unsigned per = together ? grid : 1;
  for (unsigned b0 = 0; b0 < grid; b0 += per) {
    const unsigned nt = per * threads;
    emu_threads.assign(nt, EmuThread{});
    while (stacks.size() < nt) stacks.push_back(new char[kStack]);
    for (unsigned i = 0; i < nt; ++i) {
      EmuThread& t = emu_threads[i];
      t.cta = b0 + i / threads; t.tid = i % threads; t.done = false;
      getcontext(&t.ctx);
      t.ctx.uc_stack.ss_sp = stacks[i];
      t.ctx.uc_stack.ss_size = kStack;
      t.ctx.uc_link = &emu_main;
      makecontext(&t.ctx, emu_trampoline, 0);
    }
    for (unsigned left = nt, rounds = 0; left; ++rounds) {
      if (rounds > 200000u) abort();     // no thread makes progress
      for (emu_cur = 0; emu_cur < nt; ++emu_cur) {
        EmuThread& t = emu_threads[emu_cur];
        if (t.done) continue;
        blockIdx.x = t.cta; threadIdx.x = t.tid;
        swapcontext(&emu_main, &t.ctx);
        if (t.done) --left;
      }
    }
  }
  for (unsigned char* p : emu_smem) free(p);
}
"""

EMU_MAIN = r"""
}  // namespace
extern "C" void emu_one_pass(const void* x, void* q, void* scale,
                             void* slots, long long n, long long cols,
                             int bits, long long parts, long long width,
                             long long rows, long long segments,
                             int warp_rows, long long gen, long long grid,
                             long long cap, void* stamps) {
  PackPlan p{n, cols, bits == 8 ? cols : (cols + 1) / 2, parts, width,
             rows, segments, (unsigned long long)gen,
             (unsigned long long*)stamps, bits, warp_rows};
  emu_body = [=] {
    pack_one_pass_kernel((const float*)x, (uint8_t*)q, (float*)scale,
                         (unsigned long long*)slots, p); };
  // the segment capacity the plan was made for, + the alignment slack
  emu_launch((unsigned)grid, kPackThreads, kHeader + 4 * (cap + 4), true);
}
extern "C" void emu_two_pass(const void* x, void* q, void* scale,
                             void* amax, long long n, long long cols,
                             int bits) {
  const long long wc = bits == 8 ? cols : (cols + 1) / 2;
  const long long ca = chunks_of(cols), cp = chunks_of(wc);
  emu_body = [=] {
    absmax_kernel((const float*)x, (unsigned*)amax, cols, ca); };
  emu_launch((unsigned)(n * ca), kThreads, 0, false);
  emu_body = [=] {
    pack_kernel((const float*)x, (const unsigned*)amax, (uint8_t*)q,
                (float*)scale, cols, wc, cp, bits); };
  emu_launch((unsigned)(n * cp), kThreads, 0, false);
}
"""

_PTX_HELPERS = ("dynamic_smem", "smem_u32", "mbar_init", "mbar_arrive",
                "bulk_load",
                "fence_proxy_async", "mbar_wait", "ld_acquire", "globaltimer",
                "st_release")


def _emulation_source() -> str:
    """span.cu up to its host launchers (chunks_of kept), with the CUDA
    headers and the PTX helpers replaced by the emulation's."""
    with open(os.path.join(build.CSRC, "span.cu"), encoding="utf-8") as f:
        src = f.read()
    src, n = re.subn(r"#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n",
                     '#include "cuda_emu.h"\n', src)
    assert n == 1
    for name in _PTX_HELPERS:
        src, n = re.subn(r"__device__ __forceinline__ [\w *]+ %s\(.*?\n}\n"
                         % name, "", src, flags=re.S)
        assert n == 1, name
    src = src[:src.index("// the dynamic shared memory of pack_one_pass")]
    assert "asm" not in src
    return src + EMU_MAIN


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to emulate the kernel with")
    d = tmp_path_factory.mktemp("span_emu")
    (d / "cuda_emu.h").write_text(EMU_HEADER)
    (d / "span_emu.cpp").write_text(_emulation_source())
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w",
                          f"-DSPAN_PACK_THREADS={THREADS}", "-o",
                          str(d / "emu.so"), str(d / "span_emu.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "emu.so"))
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.emu_one_pass.argtypes = [vp] * 4 + [ll, ll, i] + [ll] * 4 + [
        i, ll, ll, ll, vp]
    lib.emu_two_pass.argtypes = [vp] * 4 + [ll, ll, i]
    return lib


class Emulator:
    """span.span_pack's dispatch on the emulated kernels, for a grid of
    ``grid`` CTAs holding ``cap`` f32 each; the row slots live as long as
    the emulator and are zeroed once, as the wrapper's."""

    def __init__(self, lib, grid: int, cap: int):
        self.lib, self.grid, self.cap = lib, grid, cap
        self.slots = torch.zeros(256, dtype=torch.int64)
        self.gen = 0
        self.paths = []

    def pack(self, x: torch.Tensor, bits: int, stamps=None):
        n, cols = x.shape
        wc = span.wire_cols(cols, bits)
        # outputs start as garbage, so an unwritten byte or scale shows
        q = torch.full((n, wc), 0x5A, dtype=torch.uint8)
        scale = torch.full((n, 1), -3.0)
        plan = span.pack_plan(n, cols, self.grid, self.cap)
        self.paths.append(plan)
        assert plan.segments <= self.slots.numel()
        if plan.path == "one_pass":
            self.gen += 1
            self.lib.emu_one_pass(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                self.slots.data_ptr(), n, cols, bits, plan.parts,
                plan.width, plan.rows, plan.segments, int(plan.warp_rows),
                self.gen, plan.grid, self.cap,
                None if stamps is None else stamps.data_ptr())
        else:
            amax = torch.zeros(n, dtype=torch.int32)
            self.lib.emu_two_pass(x.data_ptr(), q.data_ptr(),
                                  scale.data_ptr(), amax.data_ptr(), n, cols,
                                  bits)
        return (q.view(torch.int8) if bits == 8 else q), scale


def _check(emu: Emulator, x: np.ndarray, bits: int) -> None:
    """The emulated kernel == the plain version == encode_rows, bitwise."""
    t = torch.from_numpy(x)
    q, s = emu.pack(t, bits)
    rq, rs = ref.span_pack_ref(t, bits)
    nq, ns = encode_rows(x, bits)
    np.testing.assert_array_equal(q.numpy(), rq.numpy())
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  rs.numpy().view(np.int32))
    np.testing.assert_array_equal(q.numpy(), nq)
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  ns.view(np.int32))


def _misaligned(x: np.ndarray, offset: int) -> np.ndarray:
    """x copied to an address ``offset`` f32 past a 16-B boundary."""
    buf = np.empty(x.size + 8, np.float32)
    base = (-(buf.ctypes.data // 4)) % 4
    out = buf[base + offset: base + offset + x.size].reshape(x.shape)
    out[...] = x
    assert out.ctypes.data % 16 == 4 * offset
    return out


def _rows(n, cols, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, cols)) * rng.uniform(0.01, 10.0, (n, 1))
         ).astype(np.float32)
    if n > 1:
        x[1] = 0.0                   # an all-zero row: scale 1e-12
    return x


# (n, cols, grid, cap): grid 4 with tiny segments puts wide rows across
# CTAs, narrow rows several to a CTA, and rows wider than 4 * cap on the
# two-pass path; cap 8192 gives whole rows of one CTA each (parts == 1)
CASES = [
    (1, 1, 4, 64), (9, 1, 4, 64), (1, 7, 4, 64), (9, 7, 4, 64),
    (50, 20, 4, 64),          # whole rows, 3 to a segment, 5 waves
    (1, 64, 4, 64), (2, 65, 4, 64), (9, 100, 4, 64), (3, 201, 4, 64),
    (3, 256, 4, 64), (5, 250, 3, 64),
    (2, 257, 4, 64), (1, 1001, 4, 64),                  # two passes
    (9, 5001, 4, 8192), (4, 4099, 4, 8192),             # one CTA a row
    (7, 1281, 4, 8192),                                 # warp rows
    (9, 41, 4, 8192), (12, 45, 4, 64),  # int4 pad byte at a chunk's end
]


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("n,cols,grid,cap", CASES)
def test_kernel_source_matches_plain_and_numpy(emu_lib, n, cols, grid, cap,
                                               bits):
    emu = Emulator(emu_lib, grid, cap)
    x = _rows(n, cols, seed=n * 1000 + cols)
    for offset in (0, 1, 3):
        _check(emu, _misaligned(x, offset), bits)
    plan = emu.paths[-1]
    assert plan.path == ("two_pass" if cols > grid * cap else "one_pass")


def test_plans_take_every_segment_kind():
    kinds = set()
    for n, cols, grid, cap in CASES:
        p = span.pack_plan(n, cols, grid, cap)
        kinds.add("two_pass" if p.path == "two_pass" else
                  "warp_rows" if p.warp_rows else
                  "split" if p.parts > 1 else "cta_row")
        if p.path == "one_pass" and not p.warp_rows and cols % 2:
            kinds.add("odd_split" if p.parts > 1 else "odd_row")
    assert kinds == {"two_pass", "warp_rows", "split", "cta_row",
                     "odd_split", "odd_row"}


def test_plan_at_full_width():
    """gpt2-l's leaves as row blocks on a grid of 132 CTAs of 58,044 f32:
    a wave of segments fills the grid, every part of a row fits a CTA
    and is even, no part is empty, and a 9,000,000-column row takes the
    two-pass path."""
    grid, cap = 132, 58044
    want = {(36, 6553600): (132, 36), (36, 1638400): (33, 9),
            (1280, 50257): (1, 10), (50257, 1280): (1, 9),
            (36, 1280): (1, 1), (1280, 1): (1, 1)}
    for (n, cols), (parts, waves) in want.items():
        p = span.pack_plan(n, cols, grid, cap)
        assert p.path == "one_pass" and p.parts == parts
        assert p.waves == waves, (n, cols, p)
        if p.warp_rows:
            assert p.rows * cols <= cap and p.segments * p.rows >= n
        else:
            assert p.width % 4 == 0 and p.width <= cap
            assert (p.parts - 1) * p.width < cols <= p.parts * p.width
            assert p.parts <= p.grid <= grid
    assert span.pack_plan(1, 9_000_000, grid, cap).path == "two_pass"


def test_pack_phases_needs_the_card():
    with pytest.raises(ValueError):
        span.pack_phases(torch.zeros(2, 3), 8)


@pytest.mark.parametrize("bits", (8, 4))
def test_absmax_in_last_segment_and_specials(emu_lib, bits):
    """The absmax in a row's last part (and in its last, ragged column);
    +-inf; a NaN; a negative absmax; on every path."""
    rng = np.random.default_rng(5)
    for n, cols, grid, cap in ((3, 201, 4, 64), (4, 4099, 4, 8192),
                               (9, 33, 4, 64), (2, 300, 4, 64)):
        emu = Emulator(emu_lib, grid, cap)
        x = rng.standard_normal((n, cols)).astype(np.float32)
        x[0, -1] = 40.0
        x[min(1, n - 1), -2] = -41.0
        if n > 2:
            x[2, cols // 2] = np.inf
            x[2, 0] = -np.inf
        _check(emu, x, bits)
        y = x.copy()
        y[0, cols // 3] = np.nan
        _check(emu, y, bits)


@pytest.mark.parametrize("bits,qmax", ((8, 127.0), (4, 7.0)))
def test_half_steps(emu_lib, bits, qmax):
    """Values on and a few ulps around (k + 1/2) * scale: the rounding
    mode and a true division (not a reciprocal multiply) decide them."""
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(6):
        amax = np.float32(rng.uniform(0.1, 10.0))
        sc = amax * np.float32(1.0 / qmax)
        vals = [amax]
        for k in range(-int(qmax), int(qmax)):
            up = dn = np.float32((k + 0.5) * sc)
            vals.append(up)
            for _ in range(3):
                up = np.nextafter(up, np.float32(np.inf))
                dn = np.nextafter(dn, np.float32(-np.inf))
                vals += [up, dn]
        rows.append(vals)
    x = np.asarray(rows, np.float32)
    for grid, cap in ((4, 64), (4, 8192), (1, 64)):
        _check(Emulator(emu_lib, grid, cap), x, bits)


def test_row_slots_carry_across_launches(emu_lib):
    """Launch after launch on the same slots (zeroed once, larger
    generations), each with rows split across CTAs, stays exact, also
    when a later launch's absmax is below an earlier one's."""
    emu = Emulator(emu_lib, 4, 64)
    rng = np.random.default_rng(9)
    for scale in (100.0, 1.0, 0.01, 5.0):
        x = (rng.standard_normal((5, 230)) * scale).astype(np.float32)
        _check(emu, x, 8)
        _check(emu, x, 4)
    assert emu.gen == 8 and all(p.parts > 1 for p in emu.paths)


@pytest.mark.parametrize("n,cols", ((9, 100), (50, 20), (9, 5001)))
def test_phase_stamps(emu_lib, n, cols):
    """With a stamps buffer every segment records four times, in order;
    the codes are the same as without."""
    emu = Emulator(emu_lib, 4, 64 if cols < 1000 else 8192)
    x = _rows(n, cols, seed=3)
    plan = span.pack_plan(n, cols, emu.grid, emu.cap)
    stamps = torch.zeros((plan.segments, 4), dtype=torch.int64)
    q, s = emu.pack(torch.from_numpy(x), 8, stamps)
    rq, rs = ref.span_pack_ref(torch.from_numpy(x), 8)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    t = stamps.numpy()
    assert (t[:, 0] > 0).all() and (np.diff(t, axis=1) >= 0).all()
