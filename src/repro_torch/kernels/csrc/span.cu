// K5 span_pack, K6 quant_span_decode, K7 quant_span_apply: the
// quantized row-span codec of LowDiff+ patches, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels
//   K5 repro/kernels/pack.py::span_pack   (_span_pack_kernel)
//   K6 repro/kernels/replay.py::quant_span_decode (_quant_span_kernel)
//   K7 repro/kernels/replay.py::quant_span_apply  (K6 + dynamic_update_slice)
//
// Function. A row block x (n, cols) f32 is quantized per row:
//   scale = max(absmax(row) * RECIP, 1e-12)     RECIP = f32(1.0 / qmax)
//   q     = clip(rint(x / scale), -qmax, qmax)  qmax = 127 (int8) or 7 (int4)
// int8 keeps q as int8; int4 packs two per byte, (q[2j] & 0xF) |
// ((q[2j+1] & 0xF) << 4), with a zero pad column when cols is odd. The
// decode is f32(q) * scale[row], the int4 nibble (low = even column)
// sign-extended. Every step is one IEEE f32 operation, the ones the numpy
// codec (compression/quant_span.py::encode_rows) performs: RECIP is the
// f32 rounding of the double 1/qmax (0.007874016, 0.14285715), x / scale
// is a true division (__fdiv_rn), rounding is half to even (rintf), and
// the build keeps --fmad=false. So q bytes, scales and decoded values
// equal the codec's and kernels/ref.py's bit for bit.
//
// Bound on this card. All three are memory-bound: K5 reads 4 B and writes
// 1 B (int8) or 0.5 B (int4) per element; K6 reads 1 or 0.5 B and writes
// 4 B; K7 reads 1 or 0.5 B and writes the leaf's 4 (f32) or 2 (bf16) B.
// At gpt2-l full width a whole-model int8 pack moves 4.29 GB + 1.07 GB.
//
// Design. gpt2-l's stacked leaves have rows of up to 6,553,600 columns,
// far more than a block holds, so the row absmax is reduced across
// blocks: pass 1 gives each block one chunk of one row, reduces |x| in
// registers and shared memory, and atomicMax-es the f32 bit pattern into
// a zeroed per-row scratch (for values >= 0 the integer order of the bit
// patterns is the float order; a NaN's pattern is above +inf's, so a NaN
// propagates as numpy's max does); pass 2 reads the row's absmax and
// quantizes its chunk. K6 and K7 share one decode function over a grid
// of (row, column chunk); K7 stores straight into rows [start, start+n)
// of the state leaf, cast to its dtype (bf16 round to nearest even), with
// no dense intermediate in device memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;   // elements of a row per block

__device__ __forceinline__ float recip_qmax(int bits) {
  return bits == 8 ? (float)(1.0 / 127.0) : (float)(1.0 / 7.0);
}

__global__ void absmax_kernel(const float* __restrict__ x,
                              unsigned int* __restrict__ amax,
                              long long cols, long long chunks) {
  const long long row = blockIdx.x / chunks;
  const long long c0 = (blockIdx.x % chunks) * kChunk;
  const long long c1 = c0 + kChunk < cols ? c0 + kChunk : cols;
  const float* xr = x + row * cols;
  unsigned int m = 0u;                 // bit pattern of +0.0f
  for (long long c = c0 + threadIdx.x; c < c1; c += kThreads) {
    const unsigned int b = __float_as_uint(fabsf(xr[c]));
    m = b > m ? b : m;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned int o = __shfl_xor_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  __shared__ unsigned int warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      m = warp_max[w] > m ? warp_max[w] : m;
    atomicMax(amax + row, m);
  }
}

__device__ __forceinline__ int quantize(float x, float scale, float qmax) {
  float r = rintf(__fdiv_rn(x, scale));
  r = r < -qmax ? -qmax : r;
  r = r > qmax ? qmax : r;
  return (int)r;
}

// pass 2: wire chunk of one row; int4 byte j covers columns 2j, 2j+1
__global__ void pack_kernel(const float* __restrict__ x,
                            const unsigned int* __restrict__ amax,
                            uint8_t* __restrict__ q,
                            float* __restrict__ scale_out, long long cols,
                            long long wc, long long chunks, int bits) {
  const long long row = blockIdx.x / chunks;
  const long long j0 = (blockIdx.x % chunks) * kChunk;
  const long long j1 = j0 + kChunk < wc ? j0 + kChunk : wc;
  float s = __uint_as_float(amax[row]) * recip_qmax(bits);
  s = s < 1e-12f ? 1e-12f : s;       // np.maximum: a NaN stays NaN
  if (j0 == 0 && threadIdx.x == 0) scale_out[row] = s;
  const float* xr = x + row * cols;
  uint8_t* qr = q + row * wc;
  if (bits == 8) {
    for (long long j = j0 + threadIdx.x; j < j1; j += kThreads)
      qr[j] = (uint8_t)(int8_t)quantize(xr[j], s, 127.f);
  } else {
    for (long long j = j0 + threadIdx.x; j < j1; j += kThreads) {
      const int lo = quantize(xr[2 * j], s, 7.f);
      const int hi = 2 * j + 1 < cols ? quantize(xr[2 * j + 1], s, 7.f) : 0;
      qr[j] = (uint8_t)((lo & 0xF) | ((hi & 0xF) << 4));
    }
  }
}

__device__ __forceinline__ float decode_one(const uint8_t* __restrict__ qr,
                                            long long c, int bits) {
  if (bits == 8) return (float)(int8_t)qr[c];
  const int b = qr[c >> 1];
  int v = (c & 1) ? (b >> 4) & 0xF : b & 0xF;
  v = v > 7 ? v - 16 : v;
  return (float)v;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// K6 (dst = dense (n, cols), row0 = 0) and K7 (dst = the state leaf,
// row0 = start)
template <typename T>
__global__ void decode_kernel(const uint8_t* __restrict__ q,
                              const float* __restrict__ scale,
                              T* __restrict__ dst, long long cols,
                              long long wc, long long row0, long long chunks,
                              int bits) {
  const long long row = blockIdx.x / chunks;
  const long long c0 = (blockIdx.x % chunks) * kChunk;
  const long long c1 = c0 + kChunk < cols ? c0 + kChunk : cols;
  const float s = scale[row];
  const uint8_t* qr = q + row * wc;
  T* dr = dst + (row0 + row) * cols;
  for (long long c = c0 + threadIdx.x; c < c1; c += kThreads)
    store(dr + c, decode_one(qr, c, bits) * s);
}

inline long long chunks_of(long long width) {
  return width > 0 ? (width + kChunk - 1) / kChunk : 0;
}

}  // namespace

// x (n, cols) f32; q (n, wc) int8 or uint8 with wc = cols (int8) or
// ceil(cols / 2) (int4); scale (n,) f32; amax (n,) u32, zeroed by the
// caller. Two launches on one stream: absmax, then pack.
extern "C" int span_pack(const void* x, void* q, void* scale, void* amax,
                         long long n, long long cols, int bits,
                         void* stream) {
  if (n <= 0 || cols <= 0) return 0;
  const long long wc = bits == 8 ? cols : (cols + 1) / 2;
  const long long ca = chunks_of(cols), cp = chunks_of(wc);
  if (n * ca > 0x7fffffffLL || n * cp > 0x7fffffffLL) return 9;  // grid
  cudaStream_t st = (cudaStream_t)stream;
  absmax_kernel<<<(unsigned)(n * ca), kThreads, 0, st>>>(
      (const float*)x, (unsigned int*)amax, cols, ca);
  int err = (int)cudaGetLastError();
  if (err) return err;
  pack_kernel<<<(unsigned)(n * cp), kThreads, 0, st>>>(
      (const float*)x, (const unsigned int*)amax, (uint8_t*)q,
      (float*)scale, cols, wc, cp, bits);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_decode(const void* q, const void* scale, void* dst,
                         long long n, long long cols, long long wc,
                         long long row0, int bits, void* stream) {
  if (n <= 0 || cols <= 0) return 0;
  const long long ch = chunks_of(cols);
  if (n * ch > 0x7fffffffLL) return 9;   // cudaErrorInvalidConfiguration
  decode_kernel<T><<<(unsigned)(n * ch), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const float*)scale, (T*)dst, cols, wc, row0, ch,
      bits);
  return (int)cudaGetLastError();
}

// q (n, wc), scale (n,) -> out (n, cols) f32
extern "C" int span_decode(const void* q, const void* scale, void* out,
                           long long n, long long cols, long long wc,
                           int bits, void* stream) {
  return launch_decode<float>(q, scale, out, n, cols, wc, 0, bits, stream);
}

// q (n, wc), scale (n,) -> rows [start, start + n) of dst (N, cols), in place
extern "C" int span_apply_f32(const void* q, const void* scale, void* dst,
                              long long n, long long cols, long long wc,
                              long long start, int bits, void* stream) {
  return launch_decode<float>(q, scale, dst, n, cols, wc, start, bits,
                              stream);
}

extern "C" int span_apply_bf16(const void* q, const void* scale, void* dst,
                               long long n, long long cols, long long wc,
                               long long start, int bits, void* stream) {
  return launch_decode<__nv_bfloat16>(q, scale, dst, n, cols, wc, start,
                                      bits, stream);
}
