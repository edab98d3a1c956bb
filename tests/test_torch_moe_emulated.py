"""The CUDA source of the MoE dispatch kernels (``kernels/csrc/moe.cu``:
``moe_plan``, ``moe_slot_gather``, ``moe_assign_gather``) compiled for
the CPU with the host C++ compiler and run thread by thread, with the
emulation of ``test_torch_span_emulated.py`` (every thread a coroutine,
barriers and shuffles between yields, one CTA after another), against
the plain versions in ``kernels/ref.py``: the plan and both gathers bit
for bit, the gathers' dot products within the f32 rounding of a sum in
another order. So the plan's scans, its chunks and the drop slots of the
experts not held, the 16-byte and the scalar paths of the gathers and
their empty slots and dropped assignments run as written; timing and the
card's memory system are checked by ``chip_smoke.py``. Skipped where no
C++ compiler is found."""
import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from repro_torch.kernels import build, ref
from test_torch_span_emulated import EMU_HEADER

EMU_EXTRA = r"""
template <typename V> inline V __shfl_up_sync(unsigned, V v, int delta) {
  long long* buf = &emu_warp_buf[32 * emu_warp()];
  long long s = 0; memcpy(&s, &v, sizeof(V));
  const int lane = threadIdx.x % 32;
  buf[lane] = s;
  __syncwarp();
  const long long r = buf[lane >= delta ? lane - delta : lane];
  __syncwarp();
  V out; memcpy(&out, &r, sizeof(V)); return out; }
inline float __bfloat162float(__nv_bfloat16 b) {
  const unsigned u = (unsigned)b.x << 16; float f; memcpy(&f, &u, 4);
  return f; }
"""

EMU_MAIN = r"""
template <typename T>
void emu_slot(const void* x, const void* src, long long S, long long K,
              long long d, const void* w, const void* dot_rows, void* dots,
              void* out, int vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    emu_body = [=] {
      moe_slot_gather_kernel<T, V>((const T*)x, (const long long*)src, K, d,
                                   (const T*)w, (const T*)dot_rows,
                                   (float*)dots, (T*)out); };
  else
    emu_body = [=] {
      moe_slot_gather_kernel<T, 1>((const T*)x, (const long long*)src, K, d,
                                   (const T*)w, (const T*)dot_rows,
                                   (float*)dots, (T*)out); };
  emu_launch((unsigned)S, GATHER_THREADS, 0, false);
}
template <typename T>
void emu_assign(const void* rows, long long R, const void* dest,
                long long T_, long long K, long long d, const void* w,
                void* out, int vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    emu_body = [=] {
      moe_assign_gather_kernel<T, V>((const T*)rows, R,
                                     (const long long*)dest, K, d,
                                     (const T*)w, (T*)out); };
  else
    emu_body = [=] {
      moe_assign_gather_kernel<T, 1>((const T*)rows, R,
                                     (const long long*)dest, K, d,
                                     (const T*)w, (T*)out); };
  emu_launch((unsigned)T_, GATHER_THREADS, 0, false);
}
}  // namespace
extern "C" void emu_plan(const void* eid, long long TK, long long first,
                         long long n, long long C, void* dest, void* valid,
                         void* src) {
  emu_body = [=] {
    moe_plan_kernel((const long long*)eid, TK, first, n, C,
                    (long long*)dest, (unsigned char*)valid,
                    (long long*)src); };
  emu_launch((unsigned)n, PLAN_THREADS, 0, false);
}
extern "C" void emu_slot_gather(int bf16, const void* x, const void* src,
                                long long S, long long K, long long d,
                                const void* w, const void* dot_rows,
                                void* dots, void* out, int vec) {
  if (bf16) emu_slot<__nv_bfloat16>(x, src, S, K, d, w, dot_rows, dots, out,
                                    vec);
  else emu_slot<float>(x, src, S, K, d, w, dot_rows, dots, out, vec);
}
extern "C" void emu_assign_gather(int bf16, const void* rows, long long R,
                                  const void* dest, long long T,
                                  long long K, long long d, const void* w,
                                  void* out, int vec) {
  if (bf16) emu_assign<__nv_bfloat16>(rows, R, dest, T, K, d, w, out, vec);
  else emu_assign<float>(rows, R, dest, T, K, d, w, out, vec);
}
"""


def _emulation_source() -> str:
    """moe.cu up to its host launchers, with the CUDA headers replaced
    by the emulation's."""
    with open(os.path.join(build.CSRC, "moe.cu"), encoding="utf-8") as f:
        src = f.read()
    head = "#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n"
    assert src.count(head) == 1
    src = src.replace(head, '#include "cuda_emu.h"\n')
    src = src[:src.index("template <typename T>\nint slot_gather(")]
    assert "asm" not in src and "<<<" not in src
    return src + EMU_MAIN


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to emulate the kernels with")
    d = tmp_path_factory.mktemp("moe_emu")
    (d / "cuda_emu.h").write_text(EMU_HEADER + EMU_EXTRA)
    (d / "moe_emu.cpp").write_text(_emulation_source())
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w",
                          "-o", str(d / "emu.so"), str(d / "moe_emu.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(d / "emu.so"))
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.emu_plan.argtypes = [vp, ll, ll, ll, ll, vp, vp, vp]
    lib.emu_slot_gather.argtypes = [i, vp, vp, ll, ll, ll, vp, vp, vp, vp, i]
    lib.emu_assign_gather.argtypes = [i, vp, vp, ll, ll, ll, ll, vp, vp, i]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _eid(T: int, K: int, E: int, seed: int) -> torch.Tensor:
    """K distinct experts a token, picked unevenly (a few experts take
    most assignments, so capacity drops them)."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(T, E, generator=g) + torch.linspace(0, 3, E)
    return torch.topk(logits, K, dim=-1).indices


@pytest.mark.parametrize("first,n,cf", [(0, 16, 1.0), (0, 16, 2.5),
                                        (0, 8, 1.0), (8, 8, 1.0),
                                        (5, 3, 0.5)])
def test_plan_kernel_is_its_plain_version(emu_lib, first, n, cf):
    """Three chunks of 4096 assignments (T 1500, K 6, 16 experts): dest,
    valid and src bit for bit, outputs started as garbage."""
    T, K, E = 1500, 6, 16
    eid = _eid(T, K, E, seed=first + n)
    C = max(8, int(T * K * cf / E))
    dest = torch.full((T * K,), -7, dtype=torch.int64)
    valid = torch.full((T * K,), True)
    src = torch.full((n * C,), -7, dtype=torch.int64)
    emu_lib.emu_plan(eid.contiguous().data_ptr(), T * K, first, n, C,
                     dest.data_ptr(), valid.data_ptr(), src.data_ptr())
    want = ref.moe_plan_ref(eid, first, n, C)
    assert torch.equal(dest, want[0])
    assert torch.equal(valid, want[1])
    assert torch.equal(src, want[2])
    assert int(valid.sum()) > 0
    assert bool(valid.all()) == (cf > 1.0)      # drops at factor 1 or less


def _gather_case(dtype, d: int, seed: int = 3):
    """T 40 tokens, K 3, 6 experts of which 4 held with 12 slots: rows,
    the plan (some slots empty, some assignments dropped or foreign),
    gates and a second set of rows for the dot products."""
    T, K, E, n, C = 40, 3, 6, 4, 12
    eid = _eid(T, K, E, seed)
    dest, valid, src = ref.moe_plan_ref(eid, 1, n, C)
    assert bool((src < 0).any()) and not bool(valid.all())
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, d, generator=g).to(dtype)
    rows = torch.randn(n * C, d, generator=g).to(dtype)
    w = (torch.rand(T * K, generator=g) * valid).to(dtype)
    return T, K, x, rows, dest, src, w


@pytest.mark.parametrize("d", [64, 36], ids=["vec", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["copy", "weight", "weight+dots"])
def test_slot_gather_kernel_is_its_plain_version(emu_lib, mode, dtype, d):
    T, K, x, rows, dest, src, w = _gather_case(dtype, d)
    wt = None if mode == "copy" else w
    dr = rows if mode == "weight+dots" else None
    S = src.numel()
    out = torch.full((S, d), 7.0, dtype=dtype)
    dots = None if dr is None else torch.zeros(T * K)
    vec = int((d * x.element_size()) % 16 == 0)
    emu_lib.emu_slot_gather(int(dtype == torch.bfloat16), x.data_ptr(),
                            src.data_ptr(), S, K, d, _ptr(wt), _ptr(dr),
                            _ptr(dots), out.data_ptr(), vec)
    want = ref.slot_gather_ref(x, src, K, wt, dr)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    if dr is None:
        assert torch.equal(out.view(bits), want.view(bits))
        return
    assert torch.equal(out.view(bits), want[0].view(bits))
    # an f32 sum of d rounded products in another order
    mag = ref.slot_gather_ref(x.abs(), src, K, None, rows.abs())[1]
    assert bool(((dots - want[1]).abs() <= d * 2.0 ** -24 * mag).all())
    assert bool((dots[want[1] == 0] == 0).all())


@pytest.mark.parametrize("d", [64, 36], ids=["vec", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True], ids=["sum", "gated"])
def test_assign_gather_kernel_is_its_plain_version(emu_lib, weighted, dtype,
                                                   d):
    T, K, x, rows, dest, src, w = _gather_case(dtype, d)
    wt = w if weighted else None
    out = torch.full((T, d), 7.0, dtype=dtype)
    vec = int((d * x.element_size()) % 16 == 0)
    emu_lib.emu_assign_gather(int(dtype == torch.bfloat16), rows.data_ptr(),
                              rows.shape[0], dest.data_ptr(), T, K, d,
                              _ptr(wt), out.data_ptr(), vec)
    want = ref.assign_gather_ref(rows, dest, K, wt)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), want.view(bits))
