// K4 topk_apply, K10 packed_apply and K13 quant_apply: fused decode of a
// compressed differential + one Adam step, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels repro/kernels/replay.py::topk_apply
// (_topk_apply_kernel + _adam_epilogue; the TPU kernel's k == 0 detour
// through _zero_apply is handled here directly, with g == 0 exactly),
// repro/kernels/replay.py::packed_apply (_packed_apply_kernel) and
// repro/kernels/replay.py::quant_apply (_quant_apply_kernel).
//
// Function. The differential's wire form over 1024-element blocks of the
// flat state leaf (n elements, nb = ceil(n/1024)) is decoded into an f32
// gradient g:
//   K4  values (nb, k) + int32 block-local indices (nb, k), added into
//       zeros, as the reference scatters them;
//   K10 int8 q (nb, k) + indices (nb, k) + scale (nb): K4 with each value
//       f32(q) * scale[block] (one rounding);
//   K13 int8 q (nb, 1024) + scale (nb): g = f32(q) * scale[block], dense;
// and applied:
//   mu' = b1*mu + om1*g;  nu' = b2*nu + om2*g*g
//   p'  = p - lr*(mu'/c1) / (sqrt(nu'/c2) + eps)      (cast to p's dtype)
// with hyper (8 f32, in device memory) = [lr, b1, b2, eps, c1, c2, om1,
// om2]: om1/om2 are 1-b1/1-b2 pre-rounded from python doubles, which is
// how repro.optim.adam.adam_update rounds them, so the port's training
// step and its recovery replay — both run the compressor's kernel on the
// same wire payload — produce the same bits, and the result matches
// adam_update. Built with --fmad=false: every product and sum is rounded
// on its own, equal bit for bit to kernels/ref.py's topk_apply_ref,
// packed_apply_ref and quant_apply_ref.
//
// Bound on this card. Memory-bound: per f32 element they read p, mu, nu
// (12 B) and write p', mu', nu' (12 B), plus the payload: 8k B per block
// (K4), 5k + 4 B (K10), 1 B per element + 4 B per block (K13). At gpt2-l
// full width a step or a replayed differential moves 12.9 GB read +
// 12.9 GB written.
//
// Design. One CTA of 256 threads per 1024-element block. K4/K10: the
// block's k pairs are added into a 4 KB shared-memory accumulator; K13
// reads its four int8 codes per thread straight from the payload. Then
// each thread runs the shared Adam epilogue on 4 consecutive elements
// with vector loads and stores — the dense gradient never reaches device
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
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
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

// The Adam epilogue on elements [i0, i0 + 4) of the leaf (fewer at the
// ragged end), with their gradient in g.
template <typename P>
__device__ __forceinline__ void adam4(const float* __restrict__ hyper,
                                      const float g[4], long long i0,
                                      long long n, const P* __restrict__ p,
                                      const float* __restrict__ mu,
                                      const float* __restrict__ nu,
                                      P* __restrict__ p_out,
                                      float* __restrict__ mu_out,
                                      float* __restrict__ nu_out) {
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
    const float m2 = b1 * mv[e] + om1 * g[e];
    const float v2 = b2 * vv[e] + om2 * g[e] * g[e];
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

// K4 (PACK == false, scale unused) and K10 (PACK == true, V == int8_t)
template <typename P, typename V, bool PACK>
__global__ void topk_apply_kernel(const float* __restrict__ hyper,
                                  const V* __restrict__ vals,
                                  const int32_t* __restrict__ idx,
                                  const float* __restrict__ scale,
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
    float v = to_f(vals[r * k + j]);
    if (PACK) v = v * scale[r];
    gs[idx[r * k + j]] += v;
  }
  __syncthreads();
  const long long i0 = r * kBlock + 4 * t;
  if (i0 >= n) return;
  const float g[4] = {gs[4 * t], gs[4 * t + 1], gs[4 * t + 2],
                      gs[4 * t + 3]};
  adam4(hyper, g, i0, n, p, mu, nu, p_out, mu_out, nu_out);
}

// K13: q (nb, 1024) int8, dense
template <typename P>
__global__ void quant_apply_kernel(const float* __restrict__ hyper,
                                   const int8_t* __restrict__ q,
                                   const float* __restrict__ scale,
                                   const P* __restrict__ p,
                                   const float* __restrict__ mu,
                                   const float* __restrict__ nu,
                                   P* __restrict__ p_out,
                                   float* __restrict__ mu_out,
                                   float* __restrict__ nu_out, long long n) {
  const long long r = blockIdx.x;
  const int t = threadIdx.x;                 // blockDim.x == kBlock / 4
  const long long i0 = r * kBlock + 4 * t;
  if (i0 >= n) return;
  const char4 c = reinterpret_cast<const char4*>(q)[r * (kBlock / 4) + t];
  const float s = scale[r];
  const float g[4] = {(float)c.x * s, (float)c.y * s, (float)c.z * s,
                      (float)c.w * s};
  adam4(hyper, g, i0, n, p, mu, nu, p_out, mu_out, nu_out);
}

template <typename P, typename V, bool PACK>
int launch(const void* hyper, const void* vals, const void* idx,
           const void* scale, const void* p, const void* mu, const void* nu,
           void* p_out, void* mu_out, void* nu_out, long long n, int k,
           void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  topk_apply_kernel<P, V, PACK><<<(unsigned)nb, kBlock / 4, 0,
                                  (cudaStream_t)stream>>>(
      (const float*)hyper, (const V*)vals, (const int32_t*)idx,
      (const float*)scale, (const P*)p, (const float*)mu, (const float*)nu,
      (P*)p_out, (float*)mu_out, (float*)nu_out, n, k);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_quant(const void* hyper, const void* q, const void* scale,
                 const void* p, const void* mu, const void* nu, void* p_out,
                 void* mu_out, void* nu_out, long long n, void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  quant_apply_kernel<P><<<(unsigned)nb, kBlock / 4, 0,
                          (cudaStream_t)stream>>>(
      (const float*)hyper, (const int8_t*)q, (const float*)scale,
      (const P*)p, (const float*)mu, (const float*)nu, (P*)p_out,
      (float*)mu_out, (float*)nu_out, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define APPLY_ENTRY(NAME, P, V)                                             \
  extern "C" int NAME(const void* hyper, const void* vals, const void* idx, \
                      const void* p, const void* mu, const void* nu,        \
                      void* p_out, void* mu_out, void* nu_out, long long n, \
                      int k, void* stream) {                                \
    return launch<P, V, false>(hyper, vals, idx, nullptr, p, mu, nu, p_out, \
                               mu_out, nu_out, n, k, stream);               \
  }

// p/mu/nu/outputs: n elements, 16-byte aligned; vals/idx (ceil(n/1024), k)
APPLY_ENTRY(topk_apply_pf32_vf32, float, float)
APPLY_ENTRY(topk_apply_pf32_vbf16, float, __nv_bfloat16)
APPLY_ENTRY(topk_apply_pbf16_vf32, __nv_bfloat16, float)
APPLY_ENTRY(topk_apply_pbf16_vbf16, __nv_bfloat16, __nv_bfloat16)

#define PACKED_ENTRY(NAME, P)                                               \
  extern "C" int NAME(const void* hyper, const void* q, const void* idx,    \
                      const void* scale, const void* p, const void* mu,     \
                      const void* nu, void* p_out, void* mu_out,            \
                      void* nu_out, long long n, int k, void* stream) {     \
    return launch<P, int8_t, true>(hyper, q, idx, scale, p, mu, nu, p_out,  \
                                   mu_out, nu_out, n, k, stream);           \
  }

// q int8 / idx int32 (ceil(n/1024), k), scale f32 (ceil(n/1024))
PACKED_ENTRY(packed_apply_pf32, float)
PACKED_ENTRY(packed_apply_pbf16, __nv_bfloat16)

#define QUANT_ENTRY(NAME, P)                                                \
  extern "C" int NAME(const void* hyper, const void* q, const void* scale,  \
                      const void* p, const void* mu, const void* nu,        \
                      void* p_out, void* mu_out, void* nu_out, long long n, \
                      void* stream) {                                       \
    return launch_quant<P>(hyper, q, scale, p, mu, nu, p_out, mu_out,       \
                           nu_out, n, stream);                              \
  }

// q int8 (ceil(n/1024), 1024) (4-byte aligned), scale f32 (ceil(n/1024))
QUANT_ENTRY(quant_apply_pf32, float)
QUANT_ENTRY(quant_apply_pbf16, __nv_bfloat16)
