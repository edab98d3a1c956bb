// K11 quantize and K12 dequantize: blockwise absmax int8 quantization of
// a gradient (the quant8 compressor), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels repro/kernels/quant8.py::quantize
// (_quant_kernel) and repro/kernels/quant8.py::dequantize
// (_dequant_kernel).
//
// Function. The flat tensor x (n elements, f32 or bf16) is cut into
// nb = ceil(n/1024) blocks of 1024; the tail of the last block reads as
// zero, as the reference pads it. K11, per block, in f32:
//   scale = max(absmax * f32(1/127), 1e-12)
//   q     = clip(rint(x / scale), -127, 127)          stored as int8
// q is (nb, 1024), the padded tail included (its codes are 0); scale is
// (nb). The reciprocal multiply is what the reference computes under
// jax.jit (XLA rewrites its `/ 127.0`); x / scale is a true division
// (__fdiv_rn), rint rounds half to even as jnp.round, and the floor is a
// compare that keeps a NaN. K12 writes the first n elements of
// f32(q) * scale[block], one rounding each. Built with --fmad=false, both
// equal kernels/ref.py's quantize_ref / dequantize_ref bit for bit.
//
// Bound on this card. Both are memory-bound: K11 reads 4 B (f32) and
// writes 1 B per element, K12 reads 1 B and writes 4 B; at gpt2-l full
// width one step's gradient moves 4.29 GB + 1.07 GB either way.
//
// Design. One CTA of 256 threads per 1024-element block, four consecutive
// elements per thread with one 16-byte (f32) or 8-byte (bf16) load and
// one 4-byte int8 store (char4), so a block is one coalesced read and one
// coalesced write. K11 reduces the block's absmax in registers, then by
// xor shuffle within each warp and through 8 words of shared memory
// across the warps (a NaN propagates, as in jnp.max); every thread then
// quantizes its own four values, still in registers: x is read from
// device memory once. K12 is the elementwise inverse, char4 -> float4.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kThreads = kBlock / 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> struct Vec4;   // four T in one aligned word
template <> struct Vec4<float> { typedef float4 type; };
template <> struct Vec4<__nv_bfloat16> { typedef uint2 type; };

// max that propagates a NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ signed char quantize8(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  r = r < -127.0f ? -127.0f : r;
  r = r > 127.0f ? 127.0f : r;
  return (signed char)(int)r;
}

// ----------------------------------------------------------------- K11
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ scale, long long n) {
  const long long r = blockIdx.x;
  const int t = threadIdx.x;
  const long long i0 = r * kBlock + 4 * t;
  float v[4];
  if (i0 + 4 <= n) {
    typename Vec4<T>::type w =
        *reinterpret_cast<const typename Vec4<T>::type*>(x + i0);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i0 + j < n ? to_f(x[i0 + j]) : 0.0f;
  }
  float m = max_nan(max_nan(fabsf(v[0]), fabsf(v[1])),
                    max_nan(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ float warp_max[kThreads / 32];
  if ((t & 31) == 0) warp_max[t >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = max_nan(m, warp_max[w]);
  const float a = m * (float)(1.0 / 127.0);
  const float s = a < 1e-12f ? 1e-12f : a;
  if (t == 0) scale[r] = s;
  char4 c;
  c.x = quantize8(v[0], s);
  c.y = quantize8(v[1], s);
  c.z = quantize8(v[2], s);
  c.w = quantize8(v[3], s);
  reinterpret_cast<char4*>(q)[r * kThreads + t] = c;
}

// ----------------------------------------------------------------- K12
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, long long n) {
  const long long r = blockIdx.x;
  const int t = threadIdx.x;
  const long long i0 = r * kBlock + 4 * t;
  if (i0 >= n) return;
  const char4 c = reinterpret_cast<const char4*>(q)[r * kThreads + t];
  const float s = scale[r];
  const float4 d = make_float4((float)c.x * s, (float)c.y * s,
                               (float)c.z * s, (float)c.w * s);
  if (i0 + 4 <= n) {
    *reinterpret_cast<float4*>(out + i0) = d;
  } else {
    const float e[4] = {d.x, d.y, d.z, d.w};
    for (int j = 0; i0 + j < n; ++j) out[i0 + j] = e[j];
  }
}

template <typename T>
int launch_quantize(const void* x, void* q, void* scale, long long n,
                    void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  quantize_kernel<T><<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (int8_t*)q, (float*)scale, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: n elements (16-byte aligned); q int8 (ceil(n/1024), 1024); scale f32
// (ceil(n/1024)).
int quantize_f32(const void* x, void* q, void* scale, long long n,
                 void* stream) {
  return launch_quantize<float>(x, q, scale, n, stream);
}
int quantize_bf16(const void* x, void* q, void* scale, long long n,
                  void* stream) {
  return launch_quantize<__nv_bfloat16>(x, q, scale, n, stream);
}

// q int8 (ceil(n/1024), 1024) (4-byte aligned); scale f32 (ceil(n/1024));
// out: n f32 (16-byte aligned).
int dequantize_f32(const void* q, const void* scale, void* out, long long n,
                   void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  dequantize_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scale, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
