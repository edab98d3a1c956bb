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
// equal the codec's and kernels/ref.py's bit for bit. The absmax is a
// maximum of f32 bit patterns of |x| (for values >= 0 the integer order
// is the float order; a NaN's pattern is above +inf's, so a NaN
// propagates as numpy's max does).
//
// Bound on this card. All three are memory-bound: K5 reads 4 B and writes
// 1 B (int8) or 0.5 B (int4) per element; K6 reads 1 or 0.5 B and writes
// 4 B; K7 reads 1 or 0.5 B and writes the leaf's 4 (f32) or 2 (bf16) B.
// At gpt2-l full width a whole-model int8 pack moves 4.29 GB + 1.07 GB.
//
// K5 design: one pass. A row's scale depends on all of the row, so a
// kernel that reads x once must hold the row on chip until its absmax is
// known. gpt2-l's widest row (6,553,600 f32, 26.2 MB) over the 132 SMs is
// 198,594 B per SM, under the ~227 KB of shared memory one CTA may hold.
// So the kernel runs a persistent grid of one 512-thread CTA per SM,
// launched cooperatively (every CTA resident at once), and walks
// segments: whole narrow rows, one row to a warp, or one part of a row,
// a CTA's share (parts <= grid, so all parts of a row are resident
// together). The host's plan (kernels/span.py::pack_plan) sizes the
// segments of a leaf so that a wave of them fills the grid. Per segment:
//  1. load: thread 0 starts kLoads bulk asynchronous copies (TMA
//     cp.async.bulk, one mbarrier each) of the segment's 16-B-aligned
//     interior into shared memory; the up to 3 + 3 ragged elements at its
//     ends are plain loads. A CTA that owns a row part reduces |x| copy
//     by copy as they land;
//  2. row sync (parts > 1): warp 0 stores the CTA's maximum into its
//     part's slot, tagged with the launch's generation in the high 32
//     bits (a slot of an earlier launch never matches, so no slot is
//     reset: no memset launch per call), and polls the row's slots, a
//     lane per part, until all carry the tag: no atomics;
//  3. quantize from shared memory: each lane turns 16 f32 into 16 wire
//     bytes (8 at int4) written with one vector store, the ragged bytes
//     one per lane; one scale per row. The division runs only for
//     values within 6e-5 of a half step (code_of). For a row part,
//     warps 1..15 quantize and arrive on a "group written" mbarrier per
//     copy once their bytes of it are out; thread 0 waits on those and
//     starts the copies of the CTA's next segment as the chunks they
//     fill are freed, so the next load overlaps this quantize.
// Where the time goes (chip_smoke.py's phase stamps, `pack_phases`): on
// the 6,553,600-column leaves all 132 CTAs hold one row, so every wave
// waits for the slowest CTA's load before any can quantize.
// x is read from HBM once. A row wider than grid x capacity (none at
// gpt2-l full width) takes the second, explicit path: pass 1 reduces each
// row's absmax into a zeroed scratch with atomicMax, pass 2 reads the row
// again to quantize it.
//
// K6 and K7 share one decode function over a grid of (row, column chunk);
// K7 stores straight into rows [start, start+n) of the state leaf, cast
// to its dtype (bf16 round to nearest even), with no dense intermediate
// in device memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef SPAN_PACK_THREADS
#define SPAN_PACK_THREADS 512
#endif

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;   // elements of a row per block

// K5 one pass. Dynamic shared memory: [header | x segment]; the header
// holds the kLoads "copy landed" and kLoads "group written" mbarriers,
// the warp maxima and the row's absmax.
constexpr int kPackThreads = SPAN_PACK_THREADS;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kLoads = 8;            // bulk copies per segment
constexpr int kWmaxAt = 16 * kLoads;   // after 2 kLoads mbarriers
constexpr int kRmaxAt = kWmaxAt + 4 * kPackWarps;
constexpr int kHeader = (kRmaxAt + 4 + 127) / 128 * 128;
static_assert(kPackWarps <= 32, "one warp reduces the warp maxima");

__device__ __forceinline__ float recip_qmax(int bits) {
  return bits == 8 ? (float)(1.0 / 127.0) : (float)(1.0 / 7.0);
}

__device__ __forceinline__ unsigned absbits(float v) {
  return __float_as_uint(fabsf(v));
}

__device__ __forceinline__ unsigned umax(unsigned a, unsigned b) {
  return a > b ? a : b;
}

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned warp_max(unsigned m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = umax(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float scale_of(unsigned amax, float recip) {
  const float s = __uint_as_float(amax) * recip;
  return s < 1e-12f ? 1e-12f : s;    // np.maximum: a NaN stays NaN
}

// A row's quantizer: scale s, r = RN(1 / s), qmax.
struct Quant {
  float s, r, qmax;
};

__device__ __forceinline__ Quant quant_of(float s, int bits) {
  return {s, __frcp_rn(s), bits == 8 ? 127.f : 7.f};
}

// clip(rint(x / s), +-qmax) in the low bits of the result (two's
// complement): clipped first (rint is monotone and qmax an integer, so
// the order does not matter), then 1.5 * 2^23 is added, which rounds half
// to even to an integer held in the low mantissa bits; no conversion
// instruction. A NaN codes as 0, as a conversion of NaN to int gives.
__device__ __noinline__ unsigned code_exact(float x, const Quant& u) {
  float y = __fdiv_rn(x, u.s);
  y = y < -u.qmax ? -u.qmax : y;
  y = y > u.qmax ? u.qmax : y;
  const unsigned b = __float_as_uint(y + 12582912.f);
  return y == y ? b : 0u;
}

// code_exact without the division where it cannot matter, for x of the
// row whose absmax gave s. y = RN(x * r) is within 3 ulp-units (2^-24)
// of x / s relative, so |y - RN(x / s)| <= 3 * 2^-24 * 127.01 < 2.3e-5
// (|x| <= absmax and s >= absmax / 127.00002); when y lies within
// kNearInt = 0.5 - 2^-14 of the integer k it rounds to, RN(x / s) lies
// within 0.5 - 3.8e-5 of k and rint gives k too, so k is the code.
// |k| <= qmax, so the clip changes nothing: a finite x of the row has
// |x / s| <= 127.00002 (7.000001 at int4). Otherwise (y within 6.1e-5 of
// a half step, or NaN: an inf or NaN in the row) the exact division
// decides.
constexpr float kNearInt = 0.5f - 1.0f / 16384.0f;

// the fast code of x; clears ok where the exact division must decide
__device__ __forceinline__ unsigned code_fast(float x, const Quant& u,
                                              bool& ok) {
  const float y = x * u.r;
  const float t = y + 12582912.f;
  ok &= fabsf(y - (t - 12582912.f)) <= kNearInt;   // false for a NaN
  return __float_as_uint(t);
}

__device__ __forceinline__ unsigned code_of(float x, const Quant& u) {
  bool ok = true;
  const unsigned c = code_fast(x, u, ok);
  return ok ? c : code_exact(x, u);
}

// four f32 -> four int8 codes (a word) or four int4 nibbles (the low 16
// bits), little-endian in wire order
__device__ __forceinline__ unsigned pack_int8x4(float4 v, const Quant& u) {
  return (code_of(v.x, u) & 0xFFu) | (code_of(v.y, u) & 0xFFu) << 8 |
         (code_of(v.z, u) & 0xFFu) << 16 | (code_of(v.w, u) & 0xFFu) << 24;
}

__device__ __forceinline__ unsigned pack_int4x4(float4 v, const Quant& u) {
  return (code_of(v.x, u) & 0xFu) | (code_of(v.y, u) & 0xFu) << 4 |
         (code_of(v.z, u) & 0xFu) << 8 | (code_of(v.w, u) & 0xFu) << 12;
}

// the same from the fast codes; ok is cleared where one needs the exact
__device__ __forceinline__ unsigned fast_int8x4(float4 v, const Quant& u,
                                                bool& ok) {
  return (code_fast(v.x, u, ok) & 0xFFu) |
         (code_fast(v.y, u, ok) & 0xFFu) << 8 |
         (code_fast(v.z, u, ok) & 0xFFu) << 16 |
         (code_fast(v.w, u, ok) & 0xFFu) << 24;
}

__device__ __forceinline__ unsigned fast_int4x4(float4 v, const Quant& u,
                                                bool& ok) {
  return (code_fast(v.x, u, ok) & 0xFu) |
         (code_fast(v.y, u, ok) & 0xFu) << 4 |
         (code_fast(v.z, u, ok) & 0xFu) << 8 |
         (code_fast(v.w, u, ok) & 0xFu) << 12;
}

// ---- shared memory, mbarriers, bulk copies, the row slots (PTX)
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(128) unsigned char span_smem[];
  return span_smem;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one thread: arm `bar` for `bytes` and start the bulk copy that delivers
// them (bytes == 0: arrive only, so the phase completes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  if (bytes == 0) {
    mbar_arrive(bar);
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                  "r"(smem_u32(bar)) : "memory");
}

// generic-proxy reads of shared memory before async-proxy writes to it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries > (1 << 22)) __trap();    // a copy that never lands: fail
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t) :: "memory");
  return t;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n"
               :: "l"(p), "l"(v) : "memory");
}

// ---- K5, one pass
struct PackPlan {
  long long n, cols, wc;
  long long parts;      // CTAs that share one row (row-part segments)
  long long width;      // columns of a part, a multiple of 4
  long long rows;       // rows of a whole-row segment
  long long segments;
  unsigned long long gen;  // this launch's tag for the part slots
  unsigned long long* stamps;  // null, or 4 ns times per segment (below)
  int bits;
  int warp_rows;        // 1: whole-row segments, one row to a warp
};

// Warp 0 of each part of a row: publish the CTA's maximum m into the
// part's slot as tag | m (the tag is the launch's generation, so a slot
// of an earlier launch never matches and no slot is ever reset), then
// poll the row's `parts` slots, a lane per slot, with acquire loads until
// every one carries the tag; returns the row's absmax bits. No atomics:
// one store per part and loads that all parts may make at once.
__device__ unsigned row_sync(unsigned long long* row_slots, long long part,
                             long long parts, unsigned m,
                             unsigned long long gen, int lane) {
  const unsigned long long tag = gen << 32;
  if (lane == 0) st_release(row_slots + part, tag | m);
  for (long long spins = 0;; ++spins) {
    unsigned r = 0u;
    int ready = 1;
    for (long long i = lane; i < parts; i += 32) {
      const unsigned long long v = ld_acquire(row_slots + i);
      ready &= (v & ~0xffffffffULL) == tag;
      r = umax(r, (unsigned)(v & 0xffffffffULL));
    }
    if (__all_sync(0xffffffffu, ready)) return warp_max(r);
    if (spins > (1LL << 22)) __trap();  // a part that never came: fail
    __nanosleep(100);
  }
}

// wire byte j of a row whose column c sits at sr[c - cb]
__device__ __forceinline__ uint8_t wire_byte(const float* sr, long long cb,
                                             long long j, long long cols,
                                             const Quant& u, int bits) {
  if (bits == 8) return (uint8_t)code_of(sr[j - cb], u);
  const unsigned lo = code_of(sr[2 * j - cb], u);
  const unsigned hi = 2 * j + 1 < cols ? code_of(sr[2 * j + 1 - cb], u) : 0u;
  return (uint8_t)((lo & 0xFu) | ((hi & 0xFu) << 4));
}

// One segment: the flat range [f0, f1) of x (whole rows from `row`, or
// columns [c0, c1) of `row`), staged at sx[h + (f - f0)]; [fa, fb) is
// 16-B aligned in x and in shared memory and lands by kLoads bulk copies
// of `per` f32 (chunk k = [lo(k), lo(k + 1))), the ragged ends by plain
// loads.
struct Segment {
  long long row, c0, c1, f0, f1, h, fa, fb, per;
  bool bulk;
  __device__ long long lo(int k) const {
    return bulk ? lmin(fa + k * per, fb) : f0;
  }
};

__device__ __forceinline__ Segment segment_of(const PackPlan& p,
                                              long long seg, long long mis) {
  Segment g;
  if (p.warp_rows) {
    g.row = seg * p.rows;
    g.c0 = 0;
    g.c1 = p.cols;
    g.f0 = g.row * p.cols;
    g.f1 = lmin(g.row + p.rows, p.n) * p.cols;
  } else {
    g.row = seg / p.parts;
    g.c0 = (seg % p.parts) * p.width;
    g.c1 = lmin(g.c0 + p.width, p.cols);
    g.f0 = g.row * p.cols + g.c0;
    g.f1 = g.row * p.cols + g.c1;
  }
  g.h = (g.f0 + mis) & 3;
  g.fa = g.f0 + ((4 - g.h) & 3);
  g.fb = g.f1 - ((g.f1 + mis) & 3);
  g.bulk = g.fa < g.fb;
  g.per = g.bulk ? ((g.fb - g.fa + kLoads - 1) / kLoads + 3) & ~3LL : 0;
  return g;
}

// thread 0: chunk k of segment g into shared memory (0 bytes: arrive)
__device__ __forceinline__ void load_chunk(const float* x, float* sx,
                                           const Segment& g, int k,
                                           uint64_t* bars) {
  const long long a = g.lo(k), b = g.lo(k + 1);
  bulk_load(sx + g.h + (a - g.f0), x + a, (unsigned)(4 * (b - a)),
            bars + k);
}

// The first wire byte of quantize group b (0 <= b <= kLoads) of the
// row part g in wire bytes [j0, j1): group b holds the bytes whose first
// column lies in its copies, so a group's columns are free once it and
// all groups before it are written (an int4 byte may read the first
// column of the next group, which is freed only after that group).
__device__ __forceinline__ long long group_start(const Segment& g, int b,
                                                 long long rb, long long j0,
                                                 long long j1, int bits) {
  if (b == 0) return j0;
  if (b >= kLoads) return j1;
  const long long c = g.lo(b) - rb;
  return lmin(bits == 8 ? c : (c + 1) / 2, j1);
}

// One lane's chunk of wire bytes from 16 consecutive f32 at src (16-B
// aligned in shared memory): 16 int8 codes (16 B) or 16 int4 nibbles
// (8 B), stored to dst with one vector store. Lanes take consecutive
// chunks, 64 B of f32 apart, so a lane reads its four float4 rotated by
// (lane >> 1) & 3 and the 8 lanes of a shared-memory wavefront hit
// distinct banks; the four results are rotated back. The fast codes
// take no branch; one branch per chunk goes to the exact codes for the
// rare chunk where some value needs them.
template <int BITS>
__device__ __forceinline__ void quantize_chunk(const float4* src,
                                               uint8_t* dst, int lane,
                                               const Quant& u) {
  const int rot = (lane >> 1) & 3;
  float4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = src[(i + rot) & 3];
  bool ok = true;
  unsigned c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = BITS == 8 ? fast_int8x4(v[i], u, ok) : fast_int4x4(v[i], u, ok);
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[i] = BITS == 8 ? pack_int8x4(v[i], u) : pack_int4x4(v[i], u);
  }
  // c[i] is float4 number (i + rot) & 3 of the chunk
  if (rot & 1) {
    const unsigned t = c[3];
    c[3] = c[2];
    c[2] = c[1];
    c[1] = c[0];
    c[0] = t;
  }
  if (rot & 2) {
    unsigned t = c[0];
    c[0] = c[2];
    c[2] = t;
    t = c[1];
    c[1] = c[3];
    c[3] = t;
  }
  if (BITS == 8)
    *reinterpret_cast<uint4*>(dst) = make_uint4(c[0], c[1], c[2], c[3]);
  else
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(c[0] | c[1] << 16, c[2] | c[3] << 16);
}

// Wire bytes [j0, j1) of one row (qr = the row's first byte), from
// shared memory, by the 32 lanes of warp `unit` of `units` warps: the
// body in lane chunks (quantize_chunk), aligned for their vector stores;
// the ragged ends, and a body whose f32 are not 16-B aligned in shared
// memory (int4 rows of odd width), a byte per lane. With `empty` (a row
// part, row's column 0 at flat index rb), the warp arrives on empty[b]
// as soon as it has written all its bytes of quantize group b.
__device__ void quantize_bytes(const float* sr, long long cb, uint8_t* qr,
                               long long j0, long long j1, long long cols,
                               const Quant& u, int bits, int unit,
                               int units, int lane, uint64_t* empty,
                               const Segment& g, long long rb) {
  const int a = bits == 8 ? 16 : 8;      // wire bytes of a lane chunk
  long long ja = j0 + (long long)((a - ((uintptr_t)(qr + j0) & (a - 1))) &
                                  (a - 1));
  ja = lmin(ja, j1);
  const long long je = bits == 8 ? j1 : lmin(j1, cols / 2);  // no pad col
  long long jb = je - (long long)((uintptr_t)(qr + je) & (a - 1));
  jb = jb < ja ? ja : jb;
  const long long step = (long long)units * 32;
  const long long me = (long long)unit * 32 + lane;
  int done = 0;                 // groups this warp has arrived on
  // every byte of this warp below `next` is written: arrive on the
  // groups that end there
  auto release = [&](long long next) {
    if (!empty) return;
    while (done < kLoads &&
           group_start(g, done + 1, rb, j0, j1, bits) <= next) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + done);
      ++done;
    }
  };
  if (unit == 0)
    for (long long j = j0 + lane; j < ja; j += 32)
      qr[j] = wire_byte(sr, cb, j, cols, u, bits);
  const float* body = sr + ((bits == 8 ? ja : 2 * ja) - cb);
  if ((uintptr_t)body & 15) {
    for (long long j0w = ja + (me - lane); j0w < jb; j0w += step) {
      if (j0w + lane < jb)
        qr[j0w + lane] = wire_byte(sr, cb, j0w + lane, cols, u, bits);
      release(lmin(j0w + step, jb));     // the tail [jb, j1) comes last
    }
  } else {
    const float4* b4 = reinterpret_cast<const float4*>(body);
    for (long long k0 = me - lane; ja + k0 * a < jb; k0 += step) {
      const long long k = k0 + lane;
      if (ja + k * a < jb) {
        if (bits == 8)
          quantize_chunk<8>(b4 + 4 * k, qr + ja + k * a, lane, u);
        else
          quantize_chunk<4>(b4 + 4 * k, qr + ja + k * a, lane, u);
      }
      release(lmin(ja + (k0 + step) * a, jb));
    }
  }
  if (unit == 0)
    for (long long j = jb + lane; j < j1; j += 32)
      qr[j] = wire_byte(sr, cb, j, cols, u, bits);
  release(0x7fffffffffffffffLL);
}

__global__ void __launch_bounds__(kPackThreads, 1)
pack_one_pass_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                     float* __restrict__ scale_out,
                     unsigned long long* __restrict__ slots, PackPlan p) {
  unsigned char* smem = dynamic_smem();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = bars + kLoads;
  unsigned* wmax = reinterpret_cast<unsigned*>(smem + kWmaxAt);
  unsigned* rmax = reinterpret_cast<unsigned*>(smem + kRmaxAt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sx = reinterpret_cast<float*>(smem + kHeader);
  if (threadIdx.x == 0) {
    for (int k = 0; k < kLoads; ++k) mbar_init(bars + k, 1);
    for (int k = 0; k < kLoads; ++k) mbar_init(empty + k, kPackWarps - 1);
  }
  __syncthreads();
  const float recip = recip_qmax(p.bits);
  // x's offset past a 16-B boundary, in floats
  const long long mis = (long long)(((uintptr_t)x >> 2) & 3);
  unsigned parity = 0;
  int issued = 0;          // thread 0: chunks of `g` already in flight
  Segment g = segment_of(p, blockIdx.x, mis);
  // with p.stamps, thread 0 records per segment the global times at
  // which it began, its copies had landed, the row's absmax was known and
  // its wire bytes were written
  unsigned long long* stamp = nullptr;
  for (long long seg = blockIdx.x; seg < p.segments;
       seg += gridDim.x, parity ^= 1u) {
    if (p.stamps && threadIdx.x == 0) {
      stamp = p.stamps + 4 * seg;
      stamp[0] = globaltimer();
    }
    if (threadIdx.x == 0 && issued < kLoads) {
      fence_proxy_async();
      for (; issued < kLoads; ++issued) load_chunk(x, sx, g, issued, bars);
    }
    const bool more = seg + gridDim.x < p.segments;
    issued = 0;
    // the ragged ends (the whole segment when it spans no aligned 16 B)
    unsigned m = 0u;
    const long long head_end = g.bulk ? g.fa : g.f1;
    const long long tail = g.bulk ? g.fb : g.f1;
    for (long long f = g.f0 + threadIdx.x; f < head_end; f += kPackThreads) {
      const float v = x[f];
      sx[g.h + (f - g.f0)] = v;
      m = umax(m, absbits(v));
    }
    for (long long f = tail + threadIdx.x; f < g.f1; f += kPackThreads) {
      const float v = x[f];
      sx[g.h + (f - g.f0)] = v;
      m = umax(m, absbits(v));
    }
    if (!p.warp_rows) {
      // a row part: reduce each copy as it lands, then the CTA's maximum
      for (int k = 0; k < kLoads; ++k) {
        mbar_wait(bars + k, parity);
        const long long a = g.h + g.lo(k) - g.f0, b = g.h + g.lo(k + 1) - g.f0;
        const float4* v4 = reinterpret_cast<const float4*>(sx + a);
        for (long long i = threadIdx.x; i < (b - a) / 4; i += kPackThreads) {
          const float4 v = v4[i];
          m = umax(umax(m, absbits(v.x)), absbits(v.y));
          m = umax(umax(m, absbits(v.z)), absbits(v.w));
        }
      }
      if (stamp) stamp[1] = globaltimer();
      m = warp_max(m);
      if (lane == 0) wmax[warp] = m;
      __syncthreads();
      if (warp == 0) {
        m = warp_max(lane < kPackWarps ? wmax[lane] : 0u);
        if (p.parts > 1)
          m = row_sync(slots + g.row * p.parts, seg % p.parts, p.parts, m,
                       p.gen, lane);
        if (lane == 0) {
          *rmax = m;
          if (g.c0 == 0) scale_out[g.row] = scale_of(m, recip);
          if (stamp) stamp[2] = globaltimer();
        }
      }
      __syncthreads();
      const Quant u = quant_of(scale_of(*rmax, recip), p.bits);
      uint8_t* qr = q + g.row * p.wc;
      const long long rb = g.row * p.cols;   // flat index of column 0
      const long long j1 =
          p.bits == 8 ? g.c1 : (g.c1 == p.cols ? p.wc : g.c1 / 2);
      // warps 1.. quantize, each arriving on empty[b] once its bytes of
      // group b are written; thread 0 waits for each group in turn and
      // starts the copies of the CTA's next segment that fit below the
      // freed chunks, so they land while this segment is quantized
      if (warp > 0) {
        quantize_bytes(sx + g.h, g.c0, qr, p.bits == 8 ? g.c0 : g.c0 / 2,
                       j1, p.cols, u, p.bits, warp - 1, kPackWarps - 1,
                       lane, empty, g, rb);
      } else if (threadIdx.x == 0 && more) {
        const Segment next = segment_of(p, seg + gridDim.x, mis);
        for (int k = 0; k < kLoads && issued < kLoads; ++k) {
          mbar_wait(empty + k, parity);
          const long long freed = k + 1 < kLoads
              ? g.h + g.lo(k + 1) - g.f0
              : 0x7fffffffffffffffLL;
          if (next.h + next.lo(issued + 1) - next.f0 <= freed) {
            fence_proxy_async();
            for (; issued < kLoads &&
                   next.h + next.lo(issued + 1) - next.f0 <= freed;
                 ++issued)
              load_chunk(x, sx, next, issued, bars);
          }
        }
      }
      __syncthreads();   // the segment is read before the next one lands
    } else {
      // whole rows: one row to a warp, reduced and quantized by it alone
      for (int k = 0; k < kLoads; ++k) mbar_wait(bars + k, parity);
      if (stamp) stamp[1] = stamp[2] = globaltimer();
      __syncthreads();                  // the ragged ends' plain stores
      const long long r1 = lmin(g.row + p.rows, p.n);
      for (long long r = g.row + warp; r < r1; r += kPackWarps) {
        const float* sr = sx + g.h + (r - g.row) * p.cols;
        unsigned mr = 0u;
        for (long long c = lane; c < p.cols; c += 32)
          mr = umax(mr, absbits(sr[c]));
        const Quant u = quant_of(scale_of(warp_max(mr), recip), p.bits);
        if (lane == 0) scale_out[r] = u.s;
        quantize_bytes(sr, 0, q + r * p.wc, 0, p.wc, p.cols, u, p.bits, 0,
                       1, lane, nullptr, g, 0);
      }
      __syncthreads();   // the segment is read before the next one lands
    }
    if (stamp) stamp[3] = globaltimer();
    if (more) g = segment_of(p, seg + gridDim.x, mis);
  }
}

// ---- K5, two passes (rows wider than the grid's shared memory)
__global__ void absmax_kernel(const float* __restrict__ x,
                              unsigned int* __restrict__ amax,
                              long long cols, long long chunks) {
  const long long row = blockIdx.x / chunks;
  const long long c0 = (blockIdx.x % chunks) * kChunk;
  const long long c1 = c0 + kChunk < cols ? c0 + kChunk : cols;
  const float* xr = x + row * cols;
  unsigned int m = 0u;                 // bit pattern of +0.0f
  for (long long c = c0 + threadIdx.x; c < c1; c += kThreads)
    m = umax(m, absbits(xr[c]));
  m = warp_max(m);
  __shared__ unsigned int warp_maxima[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_maxima[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = umax(m, warp_maxima[w]);
    atomicMax(amax + row, m);
  }
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
  const Quant u = quant_of(scale_of(amax[row], recip_qmax(bits)), bits);
  if (j0 == 0 && threadIdx.x == 0) scale_out[row] = u.s;
  const float* xr = x + row * cols;
  uint8_t* qr = q + row * wc;
  for (long long j = j0 + threadIdx.x; j < j1; j += kThreads)
    qr[j] = wire_byte(xr, 0, j, cols, u, bits);
}

// ---- K6, K7
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

// ---- host launchers
inline long long chunks_of(long long width) {
  return width > 0 ? (width + kChunk - 1) / kChunk : 0;
}

// the dynamic shared memory of pack_one_pass_kernel on the current
// device, set as the kernel's limit at the first call per device
int pack_smem_bytes(int* bytes) {
  static int done[64];
  int dev, optin;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return (int)e;
  if (dev < 64 && done[dev]) {
    *bytes = done[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (!e) e = cudaFuncGetAttributes(&fa, pack_one_pass_kernel);
  if (e) return (int)e;
  *bytes = (optin - (int)fa.sharedSizeBytes) & ~15;
  e = cudaFuncSetAttribute(pack_one_pass_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *bytes);
  if (!e && dev < 64) done[dev] = *bytes;
  return (int)e;
}

}  // namespace

// The one-pass kernel's limits on the current device: out[0] = the CTAs
// resident at once (the cooperative grid), out[1] = the f32 elements a
// segment may span, out[2] = dynamic shared memory per CTA in bytes,
// out[3] = CTAs per SM. Fails (cudaErrorNotSupported or
// cudaErrorCooperativeLaunchTooLarge) where the card cannot launch the
// kernel cooperatively with at least one CTA per SM.
extern "C" int span_pack_limits(long long* out) {
  int dev, coop, sms, per_sm, smem;
  int e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                          dev);
  if (!e && !coop) e = (int)cudaErrorNotSupported;
  if (!e) e = (int)cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = pack_smem_bytes(&smem);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pack_one_pass_kernel, kPackThreads, smem);
  if (!e && per_sm < 1) e = (int)cudaErrorCooperativeLaunchTooLarge;
  if (e) return e;
  out[0] = (long long)sms * per_sm;
  out[1] = ((smem - kHeader) / 4 - 4) & ~3LL;
  out[2] = smem;
  out[3] = per_sm;
  return 0;
}

// x (n, cols) f32 -> q (n, wc), scale (n,) in one cooperative launch of
// `grid` CTAs over the plan's segments (kernels/span.py::pack_plan);
// stamps: null, or 4 u64 per segment for the kernel's phase times;
// slots (one u64 per segment, zeroed once by their owner, never reset)
// are used only when parts > 1, each launch with a larger gen.
extern "C" int span_pack_one_pass(const void* x, void* q, void* scale,
                                  void* slots, long long n, long long cols,
                                  int bits, long long parts, long long width,
                                  long long rows, long long segments,
                                  int warp_rows, long long gen,
                                  long long grid, void* stamps,
                                  void* stream) {
  if (n <= 0 || cols <= 0) return 0;
  if (grid <= 0 || (!warp_rows && parts > grid) || parts < 1 ||
      gen <= 0 || gen > 0xffffffffLL)
    return (int)cudaErrorInvalidValue;  // parts not co-resident: deadlock
  int smem;
  int e = pack_smem_bytes(&smem);
  if (e) return e;
  if (grid > segments) grid = segments;
  const float* xp = (const float*)x;
  uint8_t* qp = (uint8_t*)q;
  float* sp = (float*)scale;
  unsigned long long* slp = (unsigned long long*)slots;
  PackPlan p{n,
             cols,
             bits == 8 ? cols : (cols + 1) / 2,
             parts,
             width,
             rows,
             segments,
             (unsigned long long)gen,
             (unsigned long long*)stamps,
             bits,
             warp_rows};
  void* args[] = {&xp, &qp, &sp, &slp, &p};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)pack_one_pass_kernel, dim3((unsigned)grid),
      dim3(kPackThreads), args, (size_t)smem, (cudaStream_t)stream);
}

// The two-pass path: amax (n,) u32, zeroed by the caller. Two launches
// on one stream: absmax, then pack.
extern "C" int span_pack_two_pass(const void* x, void* q, void* scale,
                                  void* amax, long long n, long long cols,
                                  int bits, void* stream) {
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
