// K1 topk_select and K2 topk_scatter: blockwise top-k compression of a
// gradient; K8 pack_select and K9 pack_scatter: the same with the picks
// quantized to int8 (the packed compressor). CUDA C++ for sm_90a.
//
// Replaces the TPU kernels repro/kernels/topk.py::topk_select
// (_topk_kernel), repro/kernels/topk.py::topk_scatter
// (_decompress_kernel), repro/kernels/pack.py::pack_select
// (_pack_kernel) and repro/kernels/pack.py::pack_scatter
// (_unpack_kernel).
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
// K8 selects exactly as K1 (the same kernel, a template flag: the same
// indices on the same input) and quantizes the f32 picks against the
// block's absmax, which is the first pick's magnitude:
//   scale = max(|v0| * f32(1/127), 1e-12);  q = clip(rint(v / scale), +-127)
// The reciprocal multiply is what the reference computes under jax.jit
// (XLA rewrites its `/ 127.0`); v / scale is a true division (__fdiv_rn),
// rint rounds half to even as jnp.round, and the floor is a compare that
// keeps a NaN. K9 is K2 with each value f32(q) * scale (one rounding)
// added into the zeroed f32 row.
//
// Bound on this card. All four are memory-bound: K1/K8 read the gradient
// once (4 B/element in f32, 4.3 GB a step at gpt2-l full width) and write
// 8k (K1) or 5k + 4 (K8) B per block; K2/K9 write the dense tensor once
// and read the payload. At 3.35 TB/s a step's 1,047,336 blocks leave each
// SM ~165 ns per block, so a selection that costs more than a few hundred
// warp instructions per block, or that stops the loads while it runs,
// cannot reach the bound.
//
// Design. K1/K8 (one kernel, a template flag; K8's indices are K1's by
// construction): a persistent grid, each warp walking blocks
// row, row + warps, ...; each warp has two shared-memory stages of one
// block and fills the next one with cp.async (16 B per lane, zero-filled
// past n, so the ragged tail reads as zero) while it selects in the
// current one, so loads stay in flight through the selection. A block's
// keys are the f32 bits of |x| (monotone as integers for |x| >= 0); lane
// l holds the 32 elements at columns j * 32 * VEC + l * VEC + e (VEC =
// 16 B / element). The selection, for k <= 32:
//  1. t0 = the k-th largest of the 32 lane maxima (a warp bitonic sort).
//     At least k elements have |x| >= t0, so the k-th largest |x| is >= t0.
//  2. fast path: if at most 32 elements have |x| >= t0, they hold the
//     top k; their columns are compacted into shared memory, one per
//     lane, and each lane counts the candidates ranked before its own
//     by (|x| descending, column ascending): ranks 0..k-1 are the picks.
//  3. tie path: else, if at most 32 elements have |x| > t0, rank those;
//     when fewer than k, the k-th largest equals t0 and the rest of the
//     picks are the lowest columns with |x| == t0, in column order (an
//     all-zero block: t0 = 0, the first k columns).
//  4. fallback (more than 32 elements above t0, or k > 32): k rounds of
//     warp argmax on the staged block, lowest column winning ties, the
//     pick marked -1 so zero magnitudes are still taken in column order:
//     exact and slow, and rare at the main path's k = 11.
// The rare paths load the keys again from the stage, so the fast path
// holds no key past its candidate mask; the register count is left to
// the compiler (70-96, no spills): a cap for six CTAs per SM (80)
// spilled, and so did a lane maximum kept in an array the compiler could
// not unroll, each costing ~1 ms a step (PERF.md).
// Values are read from the stage, so a -0.0 pick stays -0.0. K8's scale
// comes from the block's absmax (the warp max of the keys), which is
// |first pick|. NaN inputs are out of scope: the reference, its plain
// version and this kernel order them differently. K2/K9: one CTA per
// block builds the row in shared memory (zero, scatter-add, then one
// vectorized store), so global memory sees one coalesced write of the
// dense row.
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
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// K8's quantization of one pick against the block's scale
__device__ __forceinline__ int8_t quantize8(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = r < -127.0f ? -127.0f : r;
  r = r > 127.0f ? 127.0f : r;
  return (int8_t)(int)r;
}

// ------------------------------------------------------------- K1 / K8
constexpr int kSelWarps = 4;   // warps (each its own block stream) per CTA
constexpr int kStages = 2;     // shared-memory blocks per warp
constexpr int kPerLane = kBlock / kWarp;   // elements per lane: 32
constexpr int kCand = kWarp;   // candidates the fast and tie paths rank

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {   // all but newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// f32 bits of |to_f(v)|: ordered as |v| when compared as integers
__device__ __forceinline__ int key_of(float v) {
  return __float_as_int(v) & 0x7fffffff;
}
__device__ __forceinline__ int key_of(__nv_bfloat16 v) {
  return ((int)__bfloat16_as_ushort(v) & 0x7fff) << 16;
}

// copy block `row` of x into the stage, 16 B per lane per chunk; bytes
// past n are zero-filled
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, const T* __restrict__ x,
                                            long long n, long long row,
                                            int lane) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = kBlock / (kWarp * VEC);
  const T* src = x + row * kBlock;
  if ((row + 1) * kBlock <= n) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int c = (j * kWarp + lane) * VEC;
      cp_async16(dst + c, src + c, 16);
    }
    return;
  }
  const long long left0 = n - row * kBlock;  // the ragged last block
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = (j * kWarp + lane) * VEC;
    const long long left = left0 - c;
    const int bytes =
        left >= VEC ? 16 : left > 0 ? (int)left * (int)sizeof(T) : 0;
    cp_async16(dst + c, bytes ? src + c : x, bytes);
  }
}

// this lane's 32 keys of the staged block: element i at column
// (i / VEC) * STRIDE + lane * VEC + i % VEC, increasing in i
template <typename T>
__device__ __forceinline__ void load_keys(const T* __restrict__ st,
                                          int lane, int (&key)[kPerLane]) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4* s4 = reinterpret_cast<const uint4*>(st);
#pragma unroll
  for (int j = 0; j < kPerLane / VEC; ++j) {
    const uint4 u = s4[j * kWarp + lane];
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) key[j * VEC + e] = key_of(t[e]);
  }
}

// one int per lane, sorted descending across the warp (bitonic network)
__device__ __forceinline__ int warp_sort_desc(int v, int lane) {
#pragma unroll
  for (int size = 2; size <= kWarp; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int p = __shfl_xor_sync(kFull, v, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_max ? max(v, p) : min(v, p);
    }
  }
  return v;
}

// exclusive prefix sum over the lanes; `total` is the warp's sum
__device__ __forceinline__ int warp_excl_scan(int v, int lane, int& total) {
  int incl = v;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  total = __shfl_sync(kFull, incl, kWarp - 1);
  return incl - v;
}

// the candidates (bit i of `cand`: this lane's element i; `off` its
// lanes' exclusive prefix, `total` <= 32 in all) compacted one per lane
// and ranked by (key descending, column ascending): lane t < total gets
// candidate t's column and its rank among them
template <typename T>
__device__ __forceinline__ void rank_candidates(
    const T* __restrict__ st, int* __restrict__ list, unsigned cand,
    int off, int total, int lane, int& rank, int& col) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int STRIDE = kWarp * VEC;
  for (; cand; cand &= cand - 1) {
    const int i = __ffs(cand) - 1;
    list[off++] = (i / VEC) * STRIDE + lane * VEC + i % VEC;
  }
  __syncwarp();
  int ck = -1;
  col = kBlock + lane;
  if (lane < total) {
    col = list[lane];
    ck = key_of(st[col]);
  }
  rank = 0;
#pragma unroll 4
  for (int j = 0; j < total; ++j) {
    const int kj = __shfl_sync(kFull, ck, j);
    const int cj = __shfl_sync(kFull, col, j);
    rank += kj > ck || (kj == ck && cj < col);
  }
}

// pick r of block `row` is column c of the staged block
template <typename T, bool PACK>
__device__ __forceinline__ void emit_pick(const T* __restrict__ st,
                                          void* __restrict__ vals,
                                          int32_t* __restrict__ idx,
                                          long long at, int c, float sc) {
  const T v = st[c];
  if (PACK) {
    static_cast<int8_t*>(vals)[at] = quantize8(to_f(v), sc);
  } else {
    static_cast<T*>(vals)[at] = v;
  }
  idx[at] = c;
}

// the top k of one staged block (see the note at the top)
template <typename T, bool PACK>
__device__ __forceinline__ void select_block(
    const T* __restrict__ st, int* __restrict__ list, long long row,
    int lane, int k, void* __restrict__ vals, int32_t* __restrict__ idx,
    float* __restrict__ scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int STRIDE = kWarp * VEC;
  const long long out = row * k;
  int key[kPerLane];
  load_keys(st, lane, key);
  int m[kPerLane / 2];                       // lane max, as a tree
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = max(key[i], key[i + 16]);
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = max(m[i], m[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = max(m[i], m[i + 4]);
  const int lm = max(max(m[0], m[2]), max(m[1], m[3]));
  float sc = 0.0f;                           // K8: the block's scale
  if (PACK) {                                // absmax == |first pick|
    const float a = __int_as_float(__reduce_max_sync(kFull, lm)) *
                    (float)(1.0 / 127.0);
    sc = a < 1e-12f ? 1e-12f : a;
    if (lane == 0) scale[row] = sc;
  }

  int t0 = 0;
  if (k <= kWarp) {
    t0 = __shfl_sync(kFull, warp_sort_desc(lm, lane), k - 1);
    unsigned cand = 0;                       // fast path: |x| >= t0
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      cand |= (unsigned)(key[i] >= t0) << i;
    }
    int total;
    const int off = warp_excl_scan(__popc(cand), lane, total);
    if (total <= kCand) {
      int rank, col;
      rank_candidates(st, list, cand, off, total, lane, rank, col);
      if (lane < total && rank < k) {
        emit_pick<T, PACK>(st, vals, idx, out + rank, col, sc);
      }
      return;
    }
  }
  // the rare paths read the keys again, so that the fast path holds
  // none of them past its candidate mask
  load_keys(st, lane, key);
  if (k <= kWarp) {
    unsigned cand = 0;                       // tie path: |x| > t0
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      cand |= (unsigned)(key[i] > t0) << i;
    }
    int total;
    const int off = warp_excl_scan(__popc(cand), lane, total);
    if (total <= kCand) {
      int rank, col;
      rank_candidates(st, list, cand, off, total, lane, rank, col);
      if (lane < total && rank < k) {
        emit_pick<T, PACK>(st, vals, idx, out + rank, col, sc);
      }
      // fewer than k above t0: the lowest columns equal to t0 follow,
      // in column order (chunk, then lane, then element)
      int filled = total;
#pragma unroll
      for (int j = 0; j < kPerLane / VEC; ++j) {
        if (filled >= k) break;              // warp-uniform
        unsigned eq = 0;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          eq |= (unsigned)(key[j * VEC + e] == t0) << e;
        }
        int cnt;
        int pos = filled + warp_excl_scan(__popc(eq), lane, cnt);
        for (; eq && pos < k; eq &= eq - 1, ++pos) {
          emit_pick<T, PACK>(st, vals, idx, out + pos,
                             j * STRIDE + lane * VEC + __ffs(eq) - 1, sc);
        }
        filled += cnt;
      }
      return;
    }
  }

  // fallback: k rounds of warp argmax, lowest column winning ties; the
  // pick is marked -1, so zero magnitudes are still taken in column order
  int bm = key[0];
  int bi = 0;
#pragma unroll
  for (int i = 1; i < kPerLane; ++i) {
    if (key[i] > bm) { bm = key[i]; bi = i; }
  }
  for (int r = 0; r < k; ++r) {
    int wm = bm;
    int wc = (bi / VEC) * STRIDE + lane * VEC + bi % VEC;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const int om = __shfl_xor_sync(kFull, wm, off);
      const int oc = __shfl_xor_sync(kFull, wc, off);
      if (om > wm || (om == wm && oc < wc)) { wm = om; wc = oc; }
    }
    if (lane == (wc % STRIDE) / VEC) {       // the pick's lane
      emit_pick<T, PACK>(st, vals, idx, out + r, wc, sc);
      const int pos = (wc / STRIDE) * VEC + wc % VEC;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        if (i == pos) key[i] = -1;
      }
      bm = key[0];
      bi = 0;
#pragma unroll
      for (int i = 1; i < kPerLane; ++i) {
        if (key[i] > bm) { bm = key[i]; bi = i; }
      }
    }
  }
}

// PACK == false: K1, vals are T. PACK == true: K8, vals are int8 q and
// scale (nb) receives each block's scale.
template <typename T, bool PACK>
__global__ void __launch_bounds__(kSelWarps * kWarp)
topk_select_kernel(const T* __restrict__ x, void* __restrict__ vals,
                   int32_t* __restrict__ idx, float* __restrict__ scale,
                   long long n, long long nb, int k) {
  __shared__ __align__(16) unsigned char smem[kSelWarps * kStages * kBlock *
                                              sizeof(T)];
  __shared__ int list[kSelWarps][kCand];
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  T* stage = reinterpret_cast<T*>(smem) + w * kStages * kBlock;
  const long long step = (long long)gridDim.x * kSelWarps;
  long long row = (long long)blockIdx.x * kSelWarps + w;
  if (row < nb) stage_block(stage, x, n, row, lane);
  cp_async_commit();
  for (int s = 0; row < nb; row += step, s ^= 1) {
    if (row + step < nb) {
      stage_block(stage + (s ^ 1) * kBlock, x, n, row + step, lane);
    }
    cp_async_commit();
    cp_async_wait_prior();                   // this lane's copies of `row`
    __syncwarp();                            // ... and every lane's
    select_block<T, PACK>(stage + s * kBlock, list[w], row, lane, k, vals,
                          idx, scale);
    __syncwarp();                            // stage s free for refill
  }
}

// ------------------------------------------------------------- K2 / K9
template <typename T> struct Vec4;   // four T in one aligned word
template <> struct Vec4<float> { typedef float4 type; };
template <> struct Vec4<__nv_bfloat16> { typedef uint2 type; };

// K2: V == T, scale == nullptr. K9: V == int8_t (q), T == float, each
// value f32(q) * scale[block].
template <typename T, typename V, bool PACK>
__global__ void topk_scatter_kernel(const V* __restrict__ vals,
                                    const int32_t* __restrict__ idx,
                                    const float* __restrict__ scale,
                                    T* __restrict__ out, long long n,
                                    int k) {
  __shared__ __align__(16) float row[kBlock];
  const long long r = blockIdx.x;
  const int t = threadIdx.x;                 // blockDim.x == kBlock / 4
  reinterpret_cast<float4*>(row)[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int j = t; j < k; j += blockDim.x) {
    float v = to_f(vals[r * k + j]);
    if (PACK) v = v * scale[r];
    row[idx[r * k + j]] += v;
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

template <typename T, bool PACK>
int launch_select(const void* x, void* vals, void* idx, void* scale,
                  long long n, int k, void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  static int resident = 0;                   // CTAs the card holds at once
  if (!resident) {
    int dev, sms, per_sm;
    cudaError_t e = cudaGetDevice(&dev);
    if (!e) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
    if (!e) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, topk_select_kernel<T, PACK>, kSelWarps * kWarp, 0);
    if (e) return (int)e;
    resident = sms * per_sm;
  }
  const long long need = (nb + kSelWarps - 1) / kSelWarps;
  const unsigned grid = (unsigned)(need < resident ? need : resident);
  topk_select_kernel<T, PACK><<<grid, kSelWarps * kWarp, 0,
                                (cudaStream_t)stream>>>(
      (const T*)x, vals, (int32_t*)idx, (float*)scale, n, nb, k);
  return (int)cudaGetLastError();
}

template <typename T, typename V, bool PACK>
int launch_scatter(const void* vals, const void* idx, const void* scale,
                   void* out, long long n, int k, void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  topk_scatter_kernel<T, V, PACK><<<(unsigned)nb, kBlock / 4, 0,
                                    (cudaStream_t)stream>>>(
      (const V*)vals, (const int32_t*)idx, (const float*)scale, (T*)out, n,
      k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: n elements (16-byte aligned); vals/idx: (ceil(n/1024), k).
int topk_select_f32(const void* x, void* vals, void* idx, long long n,
                    int k, void* stream) {
  return launch_select<float, false>(x, vals, idx, nullptr, n, k, stream);
}
int topk_select_bf16(const void* x, void* vals, void* idx, long long n,
                     int k, void* stream) {
  return launch_select<__nv_bfloat16, false>(x, vals, idx, nullptr, n, k,
                                             stream);
}

// vals/idx: (ceil(n/1024), k); out: n elements (16-byte aligned).
int topk_scatter_f32(const void* vals, const void* idx, void* out,
                     long long n, int k, void* stream) {
  return launch_scatter<float, float, false>(vals, idx, nullptr, out, n, k,
                                             stream);
}
int topk_scatter_bf16(const void* vals, const void* idx, void* out,
                      long long n, int k, void* stream) {
  return launch_scatter<__nv_bfloat16, __nv_bfloat16, false>(
      vals, idx, nullptr, out, n, k, stream);
}

// x: n elements (16-byte aligned); q int8 / idx int32 (ceil(n/1024), k);
// scale f32 (ceil(n/1024)).
int pack_select_f32(const void* x, void* q, void* idx, void* scale,
                    long long n, int k, void* stream) {
  return launch_select<float, true>(x, q, idx, scale, n, k, stream);
}
int pack_select_bf16(const void* x, void* q, void* idx, void* scale,
                     long long n, int k, void* stream) {
  return launch_select<__nv_bfloat16, true>(x, q, idx, scale, n, k, stream);
}

// q/idx (ceil(n/1024), k), scale (ceil(n/1024)); out: n f32 (16-byte
// aligned).
int pack_scatter_f32(const void* q, const void* idx, const void* scale,
                     void* out, long long n, int k, void* stream) {
  return launch_scatter<float, int8_t, true>(q, idx, scale, out, n, k,
                                             stream);
}

}  // extern "C"
