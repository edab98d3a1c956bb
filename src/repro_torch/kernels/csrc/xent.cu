// The loss head's two row kernels, CUDA C++ for sm_90a: xent_rows (the
// forward's softmax statistics) and xent_grad_split (the backward's f32
// logit gradient as three bf16 planes).
//
// Replaces no TPU kernel: the JAX package leaves the chunked
// cross-entropy (repro/models/ops.py::chunked_softmax_xent) to XLA. They
// were added with the head's tensor-core path (models/ops.py::
// _TensorCoreXent): the head's products now run as bf16 tensor-core GEMMs
// with an f32 output (aten::mm.dtype), and these kernels do everything
// between those GEMMs in one read of each chunk's f32 logits.
//
// Layout. logits (R, ld) f32, row-major, ld % 4 == 0 (the caller pads the
// vocabulary V up to a multiple of 8 with zero head columns, so every row
// starts 16-byte aligned and the GEMMs see aligned leading dimensions);
// columns >= V are padding and are ignored (read) or written as 0 (split).
// targets (R,) int32, mask (R,) f32, lse (R,) f32, dtot (1,) f32 in device
// memory (the gradient of the summed loss, so no host sync hands it over).
//
// xent_rows. Per row: lse = log(sum exp(x - m)) + m with m the row's max,
// tgt = x[target], loss = (lse - tgt) * mask. One CTA per row; each thread
// keeps an online (max, sum) pair over 16-byte loads, the pairs merge by
// warp shuffles and then through shared memory. The sum's order differs
// from torch.logsumexp's (kernels/ref.py::xent_rows_ref), so lse agrees
// with it to a few f32 ulps, not bit for bit. A target outside [0, V)
// gives tgt = NaN (the plain version's gather would refuse it).
//
// xent_grad_split. Per element, as autograd forms the gradient of the
// plain version: gm = dtot * mask[r]; g = gm * exp(x - lse[r]), minus gm
// at the target column. g is written as its exact three-term bf16 split:
//   hi = bf16(g), mid = bf16(g - hi), lo = bf16(g - hi - mid).
// bf16 keeps 8 significant bits and f32 24, and each subtraction is exact
// (the residual of a round-to-nearest fits in f32), so hi + mid + lo == g
// bit for bit wherever lo stays a normal bf16 (|g| >= 2^-100 is ample).
// The three planes are stacked as (3R, ld) bf16: [hi; mid; lo]. So the
// backward's two tensor-core GEMMs (dh from the three (R, D) blocks of
// [hi; mid; lo] @ W^T, dW from [h; h; h]^T @ [hi; mid; lo] with K = 3R)
// take the f32 gradient at full f32 precision: every product of a bf16
// term with a bf16 operand is exact in f32, and the sums run in f32. One
// bf16 rounding of g would lose 16 of its 24 bits; this split loses none.
// Built with --fmad=false: each product and sum is rounded on its own,
// as the plain version rounds them.
//
// Bound on this card: bytes. xent_rows reads 4 B an element (~1 flop
// and one exp each); xent_grad_split reads 4 B and writes 6 B an element.
// At DeepSeekMoE's chunk (512 x 102400) that is 210 MB (0.063 ms at
// 3.35 TB/s) and 524 MB (0.157 ms).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROW_THREADS = 512;     // xent_rows: one CTA per row
constexpr int ROW_UNROLL = 4;        // 16-byte loads in flight per thread
constexpr int SPLIT_THREADS = 256;   // xent_grad_split: 4 columns a thread

// (max, sum of exp(x - max)) of a set of values; m == -inf is the empty
// set. A NaN value reaches s (exp(NaN - m)), never m, so it survives.
struct MaxSum {
  float m, s;
};

__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return {m, a.s + b.s};
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

__device__ __forceinline__ void absorb(MaxSum& acc, float4 v, long long c,
                                       long long V) {
  float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e >= V) x[e] = -INFINITY;    // padding columns
  const float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
  const float m = fmaxf(acc.m, mx);
  if (m == -INFINITY) {                  // padding (or NaN) alone so far
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (x[e] != x[e]) acc.s = x[e];
    return;
  }
  float s = acc.s * expf(acc.m - m);
#pragma unroll
  for (int e = 0; e < 4; ++e) s = s + expf(x[e] - m);
  acc.m = m;
  acc.s = s;
}

__device__ __forceinline__ MaxSum warp_merge(MaxSum a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    MaxSum b;
    b.m = __shfl_xor_sync(0xffffffffu, a.m, off);
    b.s = __shfl_xor_sync(0xffffffffu, a.s, off);
    a = merge(a, b);
  }
  return a;
}

__global__ void __launch_bounds__(ROW_THREADS)
xent_rows_kernel(const float* __restrict__ logits,
                 const int* __restrict__ targets,
                 const float* __restrict__ mask,
                 float* __restrict__ lse_out, float* __restrict__ tgt_out,
                 float* __restrict__ loss_out, long long V, long long ld) {
  const long long r = blockIdx.x;
  const float* row = logits + r * ld;
  MaxSum acc = {-INFINITY, 0.f};
  const long long step = (long long)ROW_THREADS * 4;
  for (long long c0 = (long long)threadIdx.x * 4; c0 < ld;
       c0 += step * ROW_UNROLL) {
    float4 v[ROW_UNROLL];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const long long c = c0 + u * step;
      v[u] = c < ld ? __ldcs(reinterpret_cast<const float4*>(row + c))
                    : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) absorb(acc, v[u], c0 + u * step, V);
  }
  acc = warp_merge(acc);
  __shared__ float sm[ROW_THREADS / 32], ss[ROW_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = acc.m;
    ss[warp] = acc.s;
  }
  __syncthreads();
  if (warp != 0) return;
  acc = lane < ROW_THREADS / 32 ? MaxSum{sm[lane], ss[lane]}
                                : MaxSum{-INFINITY, 0.f};
  acc = warp_merge(acc);
  if (lane != 0) return;
  const float lse = logf(acc.s) + acc.m;
  const int t = targets[r];
  const float tgt = (t >= 0 && t < V) ? row[t] : __int_as_float(0x7fc00000);
  lse_out[r] = lse;
  tgt_out[r] = tgt;
  loss_out[r] = (lse - tgt) * mask[r];
}

// four bf16 (as bits) in one 8-byte word, the first in the low half
__device__ __forceinline__ uint2 pack4(const unsigned short b[4]) {
  return make_uint2((unsigned)b[0] | ((unsigned)b[1] << 16),
                    (unsigned)b[2] | ((unsigned)b[3] << 16));
}

__global__ void __launch_bounds__(SPLIT_THREADS)
xent_grad_split_kernel(const float* __restrict__ logits,
                       const float* __restrict__ lse,
                       const int* __restrict__ targets,
                       const float* __restrict__ mask,
                       const float* __restrict__ dtot,
                       __nv_bfloat16* __restrict__ out, long long R,
                       long long V, long long ld) {
  const long long r = blockIdx.x;
  const long long c = ((long long)blockIdx.y * SPLIT_THREADS + threadIdx.x) * 4;
  if (c >= ld) return;
  const float l = lse[r];
  const float gm = dtot[0] * mask[r];
  const long long t = targets[r];
  const float4 v = __ldcs(reinterpret_cast<const float4*>(logits + r * ld + c));
  const float x[4] = {v.x, v.y, v.z, v.w};
  unsigned short hi[4], mid[4], lo[4];   // bf16 bits
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float g = 0.f;
    if (c + e < V) {
      g = gm * expf(x[e] - l);
      if (c + e == t) g = g - gm;
    }
    const __nv_bfloat16 h = __float2bfloat16_rn(g);
    const float r1 = g - __bfloat162float(h);
    const __nv_bfloat16 m = __float2bfloat16_rn(r1);
    hi[e] = __bfloat16_as_ushort(h);
    mid[e] = __bfloat16_as_ushort(m);
    lo[e] = __bfloat16_as_ushort(__float2bfloat16_rn(r1 - __bfloat162float(m)));
  }
  *reinterpret_cast<uint2*>(out + r * ld + c) = pack4(hi);
  *reinterpret_cast<uint2*>(out + (R + r) * ld + c) = pack4(mid);
  *reinterpret_cast<uint2*>(out + (2 * R + r) * ld + c) = pack4(lo);
}

}  // namespace

// logits 16-byte aligned, ld % 4 == 0, 0 < V <= ld, R >= 1
extern "C" int xent_rows_f32(const void* logits, const void* targets,
                             const void* mask, void* lse, void* tgt,
                             void* loss, long long R, long long V,
                             long long ld, void* stream) {
  xent_rows_kernel<<<(unsigned)R, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (const int*)targets, (const float*)mask,
      (float*)lse, (float*)tgt, (float*)loss, V, ld);
  return (int)cudaGetLastError();
}

// out (3R, ld) bf16, 8-byte aligned; the rest as xent_rows_f32
extern "C" int xent_grad_split_f32(const void* logits, const void* lse,
                                   const void* targets, const void* mask,
                                   const void* dtot, void* out, long long R,
                                   long long V, long long ld, void* stream) {
  const long long tiles = (ld + 4LL * SPLIT_THREADS - 1) / (4LL * SPLIT_THREADS);
  dim3 grid((unsigned)R, (unsigned)tiles);
  xent_grad_split_kernel<<<grid, SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)lse, (const int*)targets,
      (const float*)mask, (const float*)dtot, (__nv_bfloat16*)out, R, V, ld);
  return (int)cudaGetLastError();
}
