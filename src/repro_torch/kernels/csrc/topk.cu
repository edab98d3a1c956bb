// K1 topk_select and K2 topk_scatter: blockwise top-k compression of a
// gradient, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels repro/kernels/topk.py::topk_select
// (_topk_kernel) and repro/kernels/topk.py::topk_scatter
// (_decompress_kernel).
//
// Function. The flat tensor x (n elements) is cut into nb = ceil(n/1024)
// blocks of 1024; the tail of the last block reads as zero, exactly as
// the reference pads it. K1 keeps, per block, the k entries of largest
// |x| (compared in f32), in descending order, ties to the lowest index:
// values in x's dtype, int32 block-local indices. K2 is its inverse: it
// writes the dense flat tensor (n elements) with each block's k values
// added in f32 into zeros at their indices and cast back to the values'
// dtype (indices within a block are distinct, so add == write, and a
// -0.0 pick comes out +0.0 as in the reference's f32 sum).
//
// Bound on this card. Both are memory-bound: K1 reads the gradient once
// (4 B/element in f32, 4.3 GB a step at gpt2-l full width) and writes
// 8k B per block; K2 writes the dense tensor once and reads 8k B per
// block. At k = 11 the selection work (k rounds of a 32-lane argmax) is
// far below the card's instruction rate, so the bound is bytes / HBM
// bandwidth.
//
// Design. K1: one warp per 1024-element block. Each lane loads its 32
// elements with 16-byte loads (a full row is 4 KB of coalesced reads)
// and keeps their magnitudes in registers; a round is a lane-local argmax
// (kept between rounds, recomputed only by the lane that lost its pick)
// plus a 5-step xor-shuffle reduction on (magnitude, column) with the
// lowest column winning ties; the winning lane marks its magnitude -1 (so
// zero magnitudes are still taken in column order) and writes the pick.
// The picked value is re-read from x (an L1/L2 hit), which keeps register
// pressure to the 32 magnitudes. K2: one CTA per block builds the row in
// shared memory (zero, scatter-add, then one vectorized store), so global
// memory sees one coalesced write of the dense row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;   // elements per compression block
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------------------------ K1
template <typename T>
__global__ void topk_select_kernel(const T* __restrict__ x,
                                   T* __restrict__ vals,
                                   int32_t* __restrict__ idx, long long n,
                                   long long nb, int k) {
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int PER_LANE = kBlock / kWarp;   // 32 elements per lane
  constexpr int CHUNKS = PER_LANE / VEC;     // 16-byte loads per lane
  constexpr int STRIDE = kWarp * VEC;        // columns per load round
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      (long long)blockIdx.x * (blockDim.x / kWarp) + (threadIdx.x / kWarp);
  if (row >= nb) return;                     // whole warp exits together
  const long long base = row * kBlock;

  // element i of this lane sits at column (i / VEC) * STRIDE +
  // lane * VEC + i % VEC: increasing in i, so the lane-local argmax with
  // a strict '>' already prefers the lowest column
  float m[PER_LANE];
  if (base + kBlock <= n) {
    const uint4* src = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      uint4 u = src[j * kWarp + lane];
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < VEC; ++e) m[j * VEC + e] = fabsf(to_f(t[e]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const long long c = base + j * STRIDE + lane * VEC + e;
        m[j * VEC + e] = c < n ? fabsf(to_f(x[c])) : 0.0f;
      }
    }
  }

  float bm = m[0];
  int bi = 0;
#pragma unroll
  for (int i = 1; i < PER_LANE; ++i) {
    if (m[i] > bm) { bm = m[i]; bi = i; }
  }

  for (int r = 0; r < k; ++r) {
    float wm = bm;
    int wc = (bi / VEC) * STRIDE + lane * VEC + bi % VEC;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(kFull, wm, off);
      const int oc = __shfl_xor_sync(kFull, wc, off);
      if (om > wm || (om == wm && oc < wc)) { wm = om; wc = oc; }
    }
    const int owner = (wc % STRIDE) / VEC;
    if (lane == owner) {
      const long long c = base + wc;
      vals[row * k + r] = c < n ? x[c] : from_f<T>(0.0f);
      idx[row * k + r] = wc;
      const int pos = (wc / STRIDE) * VEC + wc % VEC;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        if (i == pos) m[i] = -1.0f;
      }
      bm = m[0];
      bi = 0;
#pragma unroll
      for (int i = 1; i < PER_LANE; ++i) {
        if (m[i] > bm) { bm = m[i]; bi = i; }
      }
    }
  }
}

// ------------------------------------------------------------------ K2
template <typename T> struct Vec4;   // four T in one aligned word
template <> struct Vec4<float> { typedef float4 type; };
template <> struct Vec4<__nv_bfloat16> { typedef uint2 type; };

template <typename T>
__global__ void topk_scatter_kernel(const T* __restrict__ vals,
                                    const int32_t* __restrict__ idx,
                                    T* __restrict__ out, long long n,
                                    int k) {
  __shared__ __align__(16) float row[kBlock];
  const long long r = blockIdx.x;
  const int t = threadIdx.x;                 // blockDim.x == kBlock / 4
  reinterpret_cast<float4*>(row)[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int j = t; j < k; j += blockDim.x) {
    row[idx[r * k + j]] += to_f(vals[r * k + j]);
  }
  __syncthreads();
  const long long c0 = r * kBlock + 4 * t;
  if (c0 + 4 <= n) {
    typename Vec4<T>::type w;
    T* wt = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) wt[e] = from_f<T>(row[4 * t + e]);
    *reinterpret_cast<typename Vec4<T>::type*>(out + c0) = w;
  } else {
    for (int e = 0; e < 4; ++e) {
      if (c0 + e < n) out[c0 + e] = from_f<T>(row[4 * t + e]);
    }
  }
}

template <typename T>
int launch_select(const void* x, void* vals, void* idx, long long n, int k,
                  void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  const int rows_per_cta = 8;                // 8 warps
  const long long grid = (nb + rows_per_cta - 1) / rows_per_cta;
  topk_select_kernel<T><<<(unsigned)grid, rows_per_cta * kWarp, 0,
                          (cudaStream_t)stream>>>(
      (const T*)x, (T*)vals, (int32_t*)idx, n, nb, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scatter(const void* vals, const void* idx, void* out, long long n,
                   int k, void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  topk_scatter_kernel<T><<<(unsigned)nb, kBlock / 4, 0,
                           (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)idx, (T*)out, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: n elements (16-byte aligned); vals/idx: (ceil(n/1024), k).
int topk_select_f32(const void* x, void* vals, void* idx, long long n,
                    int k, void* stream) {
  return launch_select<float>(x, vals, idx, n, k, stream);
}
int topk_select_bf16(const void* x, void* vals, void* idx, long long n,
                     int k, void* stream) {
  return launch_select<__nv_bfloat16>(x, vals, idx, n, k, stream);
}

// vals/idx: (ceil(n/1024), k); out: n elements (16-byte aligned).
int topk_scatter_f32(const void* vals, const void* idx, void* out,
                     long long n, int k, void* stream) {
  return launch_scatter<float>(vals, idx, out, n, k, stream);
}
int topk_scatter_bf16(const void* vals, const void* idx, void* out,
                      long long n, int k, void* stream) {
  return launch_scatter<__nv_bfloat16>(vals, idx, out, n, k, stream);
}

}  // extern "C"
