// K3 adam_tile_update: one-pass fused Adam over a flat tensor, CUDA C++
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fused_adam.py::adam_tile_update
// (_adam_kernel).
//
// Function. hyper (8 f32, in device memory) = [lr, b1, b2, eps, c1, c2,
// -, -]. Per element, in f32:
//   mu' = b1*mu + (1-b1)*g;  nu' = b2*nu + (1-b2)*g*g
//   p'  = p - lr*(mu'/c1) / (sqrt(nu'/c2) + eps)      (cast to p's dtype)
// with 1-b1 and 1-b2 computed in f32 inside the kernel, as the TPU kernel
// computes them. Every product and sum is rounded on its own (this file
// is built with --fmad=false), so the result equals the plain torch
// version (kernels/ref.py::adam_tile_update_ref) bit for bit.
//
// Bound on this card. Memory-bound: per f32 element it reads p, g, mu, nu
// (16 B) and writes p', mu', nu' (12 B); ~13 flops against 28 bytes is far
// below the card's flop:byte balance. At gpt2-l full width a step moves
// 17.2 GB read + 12.9 GB written.
//
// Design. Elementwise, one thread per 4 consecutive elements with 16-byte
// (f32) or 8-byte (bf16) vector loads and stores, so every warp touches
// contiguous 512-byte spans of each stream. hyper is read from device
// memory by every thread (a broadcast L1 hit), so the caller never has to
// synchronize to hand the step's bias corrections to the kernel. The
// ragged tail (n % 4) runs the same arithmetic element by element.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

template <typename T> struct Vec4;   // four T in one aligned word
template <> struct Vec4<float> { typedef float4 type; };
template <> struct Vec4<__nv_bfloat16> { typedef uint2 type; };

template <typename T>
__device__ __forceinline__ void load4(const T* src, float out[4]) {
  typename Vec4<T>::type w = *reinterpret_cast<const typename Vec4<T>::type*>(src);
  const T* t = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = to_f(t[e]);
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, const float in[4]) {
  typename Vec4<T>::type w;
  T* t = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) t[e] = from_f<T>(in[e]);
  *reinterpret_cast<typename Vec4<T>::type*>(dst) = w;
}

template <typename P, typename G>
__global__ void adam_kernel(const float* __restrict__ hyper,
                            const P* __restrict__ p,
                            const G* __restrict__ g,
                            const float* __restrict__ mu,
                            const float* __restrict__ nu,
                            P* __restrict__ p_out,
                            float* __restrict__ mu_out,
                            float* __restrict__ nu_out, long long n) {
  const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i0 >= n) return;
  const float lr = hyper[0], b1 = hyper[1], b2 = hyper[2], eps = hyper[3];
  const float c1 = hyper[4], c2 = hyper[5];
  const float om1 = 1.0f - b1, om2 = 1.0f - b2;
  float pv[4], gv[4], mv[4], vv[4];
  const int cnt = (i0 + 4 <= n) ? 4 : (int)(n - i0);
  if (cnt == 4) {
    load4(p + i0, pv);
    load4(g + i0, gv);
    load4(mu + i0, mv);
    load4(nu + i0, vv);
  } else {
    for (int e = 0; e < 4; ++e) {
      const bool in = e < cnt;
      pv[e] = in ? to_f(p[i0 + e]) : 0.f;
      gv[e] = in ? to_f(g[i0 + e]) : 0.f;
      mv[e] = in ? mu[i0 + e] : 0.f;
      vv[e] = in ? nu[i0 + e] : 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float m2 = b1 * mv[e] + om1 * gv[e];
    const float v2 = b2 * vv[e] + om2 * gv[e] * gv[e];
    const float step = lr * (m2 / c1) / (sqrtf(v2 / c2) + eps);
    pv[e] = pv[e] - step;
    mv[e] = m2;
    vv[e] = v2;
  }
  if (cnt == 4) {
    store4(p_out + i0, pv);
    store4(mu_out + i0, mv);
    store4(nu_out + i0, vv);
  } else {
    for (int e = 0; e < cnt; ++e) {
      p_out[i0 + e] = from_f<P>(pv[e]);
      mu_out[i0 + e] = mv[e];
      nu_out[i0 + e] = vv[e];
    }
  }
}

template <typename P, typename G>
int launch(const void* hyper, const void* p, const void* g, const void* mu,
           const void* nu, void* p_out, void* mu_out, void* nu_out,
           long long n, void* stream) {
  const int threads = 256;
  const long long grid = (n + 4LL * threads - 1) / (4LL * threads);
  adam_kernel<P, G><<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)hyper, (const P*)p, (const G*)g, (const float*)mu,
      (const float*)nu, (P*)p_out, (float*)mu_out, (float*)nu_out, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define ADAM_ENTRY(NAME, P, G)                                              \
  extern "C" int NAME(const void* hyper, const void* p, const void* g,      \
                      const void* mu, const void* nu, void* p_out,          \
                      void* mu_out, void* nu_out, long long n,              \
                      void* stream) {                                       \
    return launch<P, G>(hyper, p, g, mu, nu, p_out, mu_out, nu_out, n,      \
                        stream);                                            \
  }

// all pointers 16-byte aligned, n elements each; mu/nu f32
ADAM_ENTRY(adam_update_pf32_gf32, float, float)
ADAM_ENTRY(adam_update_pf32_gbf16, float, __nv_bfloat16)
ADAM_ENTRY(adam_update_pbf16_gf32, __nv_bfloat16, float)
ADAM_ENTRY(adam_update_pbf16_gbf16, __nv_bfloat16, __nv_bfloat16)
