// K4 topk_apply: fused scatter-decode of a top-k differential + one Adam
// step, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/replay.py::topk_apply
// (_topk_apply_kernel + _adam_epilogue; the TPU kernel's k == 0 detour
// through _zero_apply is handled here directly, with g == 0 exactly).
//
// Function. The differential's wire form — values (nb, k) and int32
// block-local indices (nb, k) over 1024-element blocks of the flat state
// leaf (n elements, nb = ceil(n/1024)) — is decoded into an f32 gradient
// (added into zeros, as the reference scatters it) and applied:
//   mu' = b1*mu + om1*g;  nu' = b2*nu + om2*g*g
//   p'  = p - lr*(mu'/c1) / (sqrt(nu'/c2) + eps)      (cast to p's dtype)
// with hyper (8 f32, in device memory) = [lr, b1, b2, eps, c1, c2, om1,
// om2]: om1/om2 are 1-b1/1-b2 pre-rounded from python doubles, which is
// how repro.optim.adam.adam_update rounds them, so the port's training
// step and its recovery replay — both run this kernel on the same wire
// payload — produce the same bits, and the result matches adam_update.
// Built with --fmad=false: every product and sum is rounded on its own,
// equal bit for bit to kernels/ref.py::topk_apply_ref.
//
// Bound on this card. Memory-bound: per f32 element it reads p, mu, nu
// (12 B) and writes p', mu', nu' (12 B), plus 8k B of payload per block;
// at gpt2-l full width a step or a replayed differential moves 12.9 GB
// read + 12.9 GB written.
//
// Design. One CTA of 256 threads per 1024-element block: the block's k
// (value, index) pairs are added into a 4 KB shared-memory accumulator,
// then each thread runs the Adam epilogue on 4 consecutive elements with
// vector loads and stores — the dense gradient never reaches device
// memory. hyper is read from device memory, so a replay loop over a chain
// of differentials never synchronizes with the host between steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;

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

template <typename P, typename V>
__global__ void topk_apply_kernel(const float* __restrict__ hyper,
                                  const V* __restrict__ vals,
                                  const int32_t* __restrict__ idx,
                                  const P* __restrict__ p,
                                  const float* __restrict__ mu,
                                  const float* __restrict__ nu,
                                  P* __restrict__ p_out,
                                  float* __restrict__ mu_out,
                                  float* __restrict__ nu_out, long long n,
                                  int k) {
  __shared__ __align__(16) float gs[kBlock];
  const long long r = blockIdx.x;
  const int t = threadIdx.x;                 // blockDim.x == kBlock / 4
  reinterpret_cast<float4*>(gs)[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int j = t; j < k; j += blockDim.x) {
    gs[idx[r * k + j]] += to_f(vals[r * k + j]);
  }
  __syncthreads();

  const long long i0 = r * kBlock + 4 * t;
  if (i0 >= n) return;
  const float lr = hyper[0], b1 = hyper[1], b2 = hyper[2], eps = hyper[3];
  const float c1 = hyper[4], c2 = hyper[5], om1 = hyper[6], om2 = hyper[7];
  float pv[4], mv[4], vv[4];
  const int cnt = (i0 + 4 <= n) ? 4 : (int)(n - i0);
  if (cnt == 4) {
    load4(p + i0, pv);
    load4(mu + i0, mv);
    load4(nu + i0, vv);
  } else {
    for (int e = 0; e < 4; ++e) {
      const bool in = e < cnt;
      pv[e] = in ? to_f(p[i0 + e]) : 0.f;
      mv[e] = in ? mu[i0 + e] : 0.f;
      vv[e] = in ? nu[i0 + e] : 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float g = gs[4 * t + e];
    const float m2 = b1 * mv[e] + om1 * g;
    const float v2 = b2 * vv[e] + om2 * g * g;
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

template <typename P, typename V>
int launch(const void* hyper, const void* vals, const void* idx,
           const void* p, const void* mu, const void* nu, void* p_out,
           void* mu_out, void* nu_out, long long n, int k, void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  topk_apply_kernel<P, V><<<(unsigned)nb, kBlock / 4, 0,
                            (cudaStream_t)stream>>>(
      (const float*)hyper, (const V*)vals, (const int32_t*)idx,
      (const P*)p, (const float*)mu, (const float*)nu, (P*)p_out,
      (float*)mu_out, (float*)nu_out, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

#define APPLY_ENTRY(NAME, P, V)                                             \
  extern "C" int NAME(const void* hyper, const void* vals, const void* idx, \
                      const void* p, const void* mu, const void* nu,        \
                      void* p_out, void* mu_out, void* nu_out, long long n, \
                      int k, void* stream) {                                \
    return launch<P, V>(hyper, vals, idx, p, mu, nu, p_out, mu_out,         \
                        nu_out, n, k, stream);                              \
  }

// p/mu/nu/outputs: n elements, 16-byte aligned; vals/idx (ceil(n/1024), k)
APPLY_ENTRY(topk_apply_pf32_vf32, float, float)
APPLY_ENTRY(topk_apply_pf32_vbf16, float, __nv_bfloat16)
APPLY_ENTRY(topk_apply_pbf16_vf32, __nv_bfloat16, float)
APPLY_ENTRY(topk_apply_pbf16_vbf16, __nv_bfloat16, __nv_bfloat16)
