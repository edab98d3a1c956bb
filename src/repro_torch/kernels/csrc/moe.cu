// The MoE layer's dispatch through a slot map, CUDA C++ for sm_90a:
// moe_plan (each assignment's slot, and each slot's assignment),
// moe_slot_gather and moe_assign_gather (every data movement of the
// layer, forward and backward, as a gather with no collisions).
//
// Replaces no TPU kernel: the JAX package leaves the dispatch
// (repro/models/moe.py: the exclusive cumsum of a (T·K, E) one-hot, K
// scatter-adds into the expert buffers, K gathers to combine) to XLA.
// On the card those PyTorch ops cost a sorting index_put_ (the combine's
// backward, serial over the rows that share the drop row) and a scan over
// the outer dim of the one-hot; models/moe.py::_Dispatch and _Combine run
// these kernels in their place, with the same products and sums.
//
// Terms. T tokens route to K experts each: assignment a = t·K + k, in
// flat (t, k) order, goes to expert eid[a]. The layer holds n experts
// [first, first + n), each with C slots: slot s = e·C + p holds the p-th
// assignment to held expert e, in assignment order, if p < C. The plan:
//   dest[a]  = e·C + p for a kept assignment, else the drop slot n·C;
//   valid[a] = whether a is kept;
//   src[s]   = the assignment a that fills slot s, or -1 (empty).
// src is dest's inverse: src[dest[a]] == a for every kept a.
//
// moe_plan. One CTA per held expert walks all T·K assignments in flat
// order, PLAN_THREADS · PLAN_ITEMS at a time: each thread counts its
// items' matches, a warp scan (shuffles) and a scan of the 32 warp totals
// give each thread's offset, and a running total carries the prefix
// across chunks. So a position is the count of earlier assignments to the
// same expert: the exclusive cumsum of the one-hot, exactly (dest and
// valid are the cumsum plan's bit for bit). Assignments to experts the
// layer does not hold get the drop slot from the CTA whose index is the
// chunk's modulo n. Each CTA then marks its unfilled slots -1. Bound:
// latency; the CTAs read eid (T·K int64) n times, from L2.
//
// moe_slot_gather. One CTA per slot s: out[s] = x[src[s] / K] · w[src[s]]
// (the product rounded to the dtype; without w a copy), a row of zeros
// where src[s] < 0. With dot_rows it also writes, for a filled slot,
// dots[src[s]] = sum_d f32(round(x[t, d] · dot_rows[s, d])): the combine's
// backward reads dy[t] once for the slot's gradient and its gate's.
//
// moe_assign_gather. One CTA per token t: out[t] = sum over k = 0..K-1
// whose slot s = dest[t·K + k] lies in [0, R) of round(rows[s] · w[t·K +
// k]) (without w, rows[s]), starting from zero, every add rounded to the
// dtype: the combine's forward chain (y = y + y_k) term for term, and the
// dispatch's backward (dx[t] = sum_k dxe[dest]).
//
// Both gathers are bound by bytes: each reads every row it moves once
// and writes every output row once, 16 bytes a thread per access where
// the width allows. Built with --fmad=false: every product and sum is
// rounded on its own, as the plain versions (kernels/ref.py) round them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int PLAN_THREADS = 1024;   // 32 warps: one scan of warp totals
constexpr int PLAN_ITEMS = 4;        // consecutive assignments a thread
constexpr int GATHER_THREADS = 256;
constexpr int MAX_K = 32;            // experts per token
constexpr int LOADS = 8;             // rows in flight per thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// V elements of T in one aligned load or store (16 bytes where V > 1)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& x) {
  *reinterpret_cast<Pack<T, V>*>(p) = x;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(PLAN_THREADS)
moe_plan_kernel(const long long* __restrict__ eid, long long TK,
                long long first, long long n, long long C,
                long long* __restrict__ dest,
                unsigned char* __restrict__ valid,
                long long* __restrict__ src) {
  const long long e = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ int warp_off[PLAN_THREADS / 32];
  __shared__ int chunk_total;
  const long long drop = n * C;
  const long long chunk = (long long)PLAN_THREADS * PLAN_ITEMS;
  long long running = 0;     // assignments to e before this chunk
  long long ci = 0;
  for (long long base = 0; base < TK; base += chunk, ++ci) {
    const long long a0 = base + (long long)tid * PLAN_ITEMS;
    long long rel[PLAN_ITEMS];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < PLAN_ITEMS; ++i) {
      rel[i] = a0 + i < TK ? eid[a0 + i] - first : -1;
      cnt += rel[i] == e;
    }
    const int incl = warp_inclusive_scan(cnt, lane);
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int tot = warp_off[lane];
      const int wincl = warp_inclusive_scan(tot, lane);
      warp_off[lane] = wincl - tot;
      if (lane == 31) chunk_total = wincl;
    }
    __syncthreads();
    long long pos = running + warp_off[warp] + (incl - cnt);
    const bool foreign_here = ci % n == e;
#pragma unroll
    for (int i = 0; i < PLAN_ITEMS; ++i) {
      const long long a = a0 + i;
      if (a >= TK) break;
      if (rel[i] == e) {
        const bool kept = pos < C;
        dest[a] = kept ? e * C + pos : drop;
        valid[a] = kept;
        if (kept) src[e * C + pos] = a;
        ++pos;
      } else if (foreign_here && (rel[i] < 0 || rel[i] >= n)) {
        dest[a] = drop;
        valid[a] = 0;
      }
    }
    running += chunk_total;
    __syncthreads();         // warp_off and chunk_total are reused
  }
  for (long long p = (running < C ? running : C) + tid; p < C;
       p += PLAN_THREADS)
    src[e * C + p] = -1;
}

template <typename T, int V>
__global__ void __launch_bounds__(GATHER_THREADS)
moe_slot_gather_kernel(const T* __restrict__ x,
                       const long long* __restrict__ src, long long K,
                       long long d, const T* __restrict__ w,
                       const T* __restrict__ dot_rows,
                       float* __restrict__ dots, T* __restrict__ out) {
  const long long s = blockIdx.x;
  const long long a = src[s];
  const long long nv = d / V;
  T* o = out + s * d;
  if (a < 0) {
    Pack<T, V> z;
#pragma unroll
    for (int i = 0; i < V; ++i) z.v[i] = from_f<T>(0.f);
    for (long long j = threadIdx.x; j < nv; j += GATHER_THREADS)
      store<T, V>(o + j * V, z);
    return;                  // uniform over the CTA
  }
  const T* xr = x + (a / K) * d;
  const float wa = w != nullptr ? to_f(w[a]) : 1.f;
  const T* yr = dot_rows != nullptr ? dot_rows + s * d : nullptr;
  float acc = 0.f;
  for (long long j = threadIdx.x; j < nv; j += GATHER_THREADS) {
    const Pack<T, V> xv = load<T, V>(xr + j * V);
    if (w != nullptr) {
      Pack<T, V> ov;
#pragma unroll
      for (int i = 0; i < V; ++i) ov.v[i] = from_f<T>(to_f(xv.v[i]) * wa);
      store<T, V>(o + j * V, ov);
    } else {
      store<T, V>(o + j * V, xv);
    }
    if (yr != nullptr) {
      const Pack<T, V> yv = load<T, V>(yr + j * V);
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc = acc + rnd<T>(to_f(xv.v[i]) * to_f(yv.v[i]));
    }
  }
  if (dots == nullptr) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = acc + __shfl_xor_sync(FULL, acc, off);
  __shared__ float part[GATHER_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < GATHER_THREADS / 32; ++i) tot = tot + part[i];
    dots[a] = tot;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(GATHER_THREADS)
moe_assign_gather_kernel(const T* __restrict__ rows, long long R,
                         const long long* __restrict__ dest, long long K,
                         long long d, const T* __restrict__ w,
                         T* __restrict__ out) {
  const long long t = blockIdx.x;
  __shared__ long long slot[MAX_K];
  __shared__ float wk[MAX_K];
  __shared__ int kept;
  if (threadIdx.x == 0) {    // the kept assignments, in k order
    int m = 0;
    for (long long k = 0; k < K; ++k) {
      const long long s = dest[t * K + k];
      if (s >= 0 && s < R) {
        slot[m] = s;
        wk[m] = w != nullptr ? to_f(w[t * K + k]) : 1.f;
        ++m;
      }
    }
    kept = m;
  }
  __syncthreads();
  const int m = kept;
  const long long nv = d / V;
  for (long long j = threadIdx.x; j < nv; j += GATHER_THREADS) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < m; k0 += LOADS) {
      Pack<T, V> rv[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        if (k0 + u < m) rv[u] = load<T, V>(rows + slot[k0 + u] * d + j * V);
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        if (k0 + u >= m) break;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float v = to_f(rv[u].v[i]);
          if (w != nullptr) v = rnd<T>(v * wk[k0 + u]);
          acc[i] = rnd<T>(acc[i] + v);
        }
      }
    }
    Pack<T, V> ov;
#pragma unroll
    for (int i = 0; i < V; ++i) ov.v[i] = from_f<T>(acc[i]);
    store<T, V>(out + t * d + j * V, ov);
  }
}

template <typename T>
int slot_gather(const void* x, const void* src, long long S, long long K,
                long long d, const void* w, const void* dot_rows,
                void* dots, void* out, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    moe_slot_gather_kernel<T, V><<<(unsigned)S, GATHER_THREADS, 0, stream>>>(
        (const T*)x, (const long long*)src, K, d, (const T*)w,
        (const T*)dot_rows, (float*)dots, (T*)out);
  else
    moe_slot_gather_kernel<T, 1><<<(unsigned)S, GATHER_THREADS, 0, stream>>>(
        (const T*)x, (const long long*)src, K, d, (const T*)w,
        (const T*)dot_rows, (float*)dots, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int assign_gather(const void* rows, long long R, const void* dest,
                  long long T_, long long K, long long d, const void* w,
                  void* out, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    moe_assign_gather_kernel<T, V>
        <<<(unsigned)T_, GATHER_THREADS, 0, stream>>>(
            (const T*)rows, R, (const long long*)dest, K, d, (const T*)w,
            (T*)out);
  else
    moe_assign_gather_kernel<T, 1>
        <<<(unsigned)T_, GATHER_THREADS, 0, stream>>>(
            (const T*)rows, R, (const long long*)dest, K, d, (const T*)w,
            (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// eid (TK,) int64; dest (TK,) int64, valid (TK,) bool, src (n·C,) int64;
// n >= 1, C >= 1
extern "C" int moe_plan_i64(const void* eid, long long TK, long long first,
                            long long n, long long C, void* dest,
                            void* valid, void* src, void* stream) {
  moe_plan_kernel<<<(unsigned)n, PLAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)eid, TK, first, n, C, (long long*)dest,
      (unsigned char*)valid, (long long*)src);
  return (int)cudaGetLastError();
}

// x (T, d), src (S,) int64, w (T·K,) or null, dot_rows (S, d) or null,
// dots (T·K,) f32 (zeroed by the caller) or null, out (S, d); S >= 1;
// vec: d a multiple of 16 bytes' worth and every pointer 16-byte aligned
extern "C" int moe_slot_gather_f32(const void* x, const void* src,
                                   long long S, long long K, long long d,
                                   const void* w, const void* dot_rows,
                                   void* dots, void* out, int vec,
                                   void* stream) {
  return slot_gather<float>(x, src, S, K, d, w, dot_rows, dots, out, vec,
                            (cudaStream_t)stream);
}

extern "C" int moe_slot_gather_bf16(const void* x, const void* src,
                                    long long S, long long K, long long d,
                                    const void* w, const void* dot_rows,
                                    void* dots, void* out, int vec,
                                    void* stream) {
  return slot_gather<__nv_bfloat16>(x, src, S, K, d, w, dot_rows, dots, out,
                                    vec, (cudaStream_t)stream);
}

// rows (R, d), dest (T·K,) int64 (a slot outside [0, R) is skipped),
// w (T·K,) or null, out (T, d); T >= 1, K <= 32; vec as above
extern "C" int moe_assign_gather_f32(const void* rows, long long R,
                                     const void* dest, long long T,
                                     long long K, long long d, const void* w,
                                     void* out, int vec, void* stream) {
  return assign_gather<float>(rows, R, dest, T, K, d, w, out, vec,
                              (cudaStream_t)stream);
}

extern "C" int moe_assign_gather_bf16(const void* rows, long long R,
                                      const void* dest, long long T,
                                      long long K, long long d, const void* w,
                                      void* out, int vec, void* stream) {
  return assign_gather<__nv_bfloat16>(rows, R, dest, T, K, d, w, out, vec,
                                      (cudaStream_t)stream);
}
