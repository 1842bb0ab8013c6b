// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_paged_kernel` of
// tpu_dra_driver/workloads/ops/paged_attention.py (launched by its
// `paged_decode_attention`): single-query decode attention through a
// block table into pooled K/V caches.
//
//   q      [b, h, 1, hd]                  bf16 or f32
//   pool_k [n_blocks, h_kv, block_t, hd]  same dtype as q
//   pool_v [n_blocks, h_kv, block_t, hd]
//   table  [b, max_blocks] int32 physical block ids
//   lens   [b] int32 visible tokens per sequence
//   out    [b, h, 1, hd]                  q's dtype
//   part   [b, h, n_split, hd + 2]        f32 scratch: each chunk's
//                                         partial acc, m and l
//
// Semantics follow the TPU kernel: slots >= lens[seq] are masked, at
// most `n_live_blocks` table columns are walked, a row with lens == 0
// gives 0 (l is clamped at 1e-30), scores accumulate in f32 with K in
// q's dtype, P is cast to V's dtype before the P.V product, and the
// softmax scale is 1/sqrt(hd).
//
// Bound on this card: bytes. Each sequence's live K and V are read once
// (2 * lens * h_kv * hd * sizeof(T) per sequence) against 4 * h * hd
// multiply-adds per token, about one operation per byte, far below the
// H100's ~295 operations per byte of bf16 tensor-core work, so the
// least time is live K+V bytes over 3.35 TB/s. At the serving shapes
// that is a few microseconds: the time goes to latency (launch, the
// dependent reads of lens, table and K/V, the merge), so the design is
// about putting every byte in flight at once on many SMs.
//
// Two kernels, by the dtype: f32 takes the FMA kernel, whose design
// follows, in chunks of 64 tokens; bf16 (the serving cell, and
// Gemma-class heads: a GQA group of 8 over one KV head of 256) takes the
// tensor-core kernel further down in chunks of 32 (see its note), with
// its own merge.
//
// Design (flash-decoding over the block table). The TPU walked a
// sequence's blocks as a sequential grid axis; here each (sequence, KV
// head)'s live range is cut into chunks of kChunk = 64 tokens, one CTA
// each: grid (h_kv, b, n_split) with n_split = ceil(n_live_blocks *
// block_t / 64) from host integers only, so the caller never waits for
// the card. A CTA reads lens[seq] and exits at once when its chunk
// starts past the row's end; otherwise it follows the table only for the
// tokens its chunk covers (a chunk spans several table entries when
// block_t < 64, and several chunks share one entry when block_t > 64),
// so entries past a row's live range are never read. It issues every
// 16-byte cp.async of its chunk's K (one group) and V (a second group)
// up front, so the V loads are in flight while the scores are computed.
// The GQA group's `rep` query rows stay together in the CTA, so each K/V
// byte is read from device memory once. Inner loops give each thread
// several slots and 16-byte loads: a score is one token's K row split
// over 4 lanes (16-byte pieces against the q rows, kept in shared memory
// as f32, 8 rows at a time in registers) and a quad shuffle; P.V gives
// each group of lanes one 16-byte piece of the V rows, every lane of the
// group a stride of tokens, and sums the group by shuffles. The chunk's
// softmax is taken whole (its own max and sum), so each CTA writes its
// partial (acc, m, l); a second kernel merges a row's live partials with
// the usual rescaling and divides by max(l, 1e-30) (the fast division,
// within 2 ulp, keeps the IEEE division's slow-path call and its stack
// frame out of the split kernel). A row that one chunk covers (or of
// length 0) is written by its first CTA and skipped by the merge, which
// is not launched at all when n_split is 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                     // tokens per CTA
// tokens per CTA of the tensor-core kernel (bf16): a 16-slot round for
// each of its warps
constexpr int kMmaChunk = 32;
constexpr int kMmaWarps = kMmaChunk / mma_decode::kRound;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMergeWarps = 4;                 // rows per CTA of its merge
constexpr int kTokLanes = kThreads / kChunk;   // lanes per score
constexpr int kRowBlock = 8;                   // q rows per register block
constexpr int kPad = 16;                       // bytes of padding per row
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;                // per-device flags of launch()

// the FMA kernel's element types (f32: bf16 takes the tensor-core kernel)
template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// x rounded to T's precision, back in f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// one 16-byte piece of a cache row, widened to f32
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the live tokens of a row: its length, at most n_live_blocks blocks
__device__ __forceinline__ int live_len(const int* lens, int seq,
                                        int n_live_blocks, int block_t) {
  return min(lens[seq], n_live_blocks * block_t);
}

template <typename T>
size_t smem_bytes(int rep, int hd) {
  const size_t row_stride = (size_t)hd * sizeof(T) + kPad;
  return 2 * kChunk * row_stride                    // K and V rows
         + ((size_t)rep * hd                        // q rows
            + (size_t)rep * kChunk                  // scores, then P
            + 2 * (size_t)rep) * sizeof(float);     // m, l
}

// grid (h_kv, b, n_split): CTA (head, seq, split) reads tokens [64 split,
// 64 split + 64) of the row's live range
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const int* __restrict__ table,
    const int* __restrict__ lens, T* __restrict__ out,
    float* __restrict__ part, int h_kv, int rep, int hd, int block_t,
    int max_blocks, int n_live_blocks, float sm_scale) {
  constexpr int N = Piece<T>::N;
  const int head = blockIdx.x;
  const int seq = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // query row of (seq, head * rep + r) is (seq * h_kv + head) * rep + r
  const int64_t row0 = ((int64_t)seq * h_kv + head) * rep;

  const int len = live_len(lens, seq, n_live_blocks, block_t);
  const int c0 = split * kChunk;
  if (c0 >= len) {
    if (split == 0)                 // a length-0 row gives 0
      for (int i = tid; i < rep * hd; i += kThreads)
        out[row0 * hd + i] = from_f<T>(0.f);
    return;
  }
  const int nt = min(kChunk, len - c0);
  const bool whole = len <= kChunk;  // this CTA covers the whole row

  const int row_bytes = hd * (int)sizeof(T);
  const int row_stride = row_bytes + kPad;
  const int pieces = row_bytes / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;                          // [kChunk][row]
  unsigned char* v_s = smem + kChunk * row_stride;
  float* q_s = reinterpret_cast<float*>(smem + 2 * kChunk * row_stride);
  float* p_s = q_s + rep * hd;                        // [rep, kChunk]
  float* m_s = p_s + rep * kChunk;
  float* l_s = m_s + rep;

  // every copy of the chunk goes out now: K as one group, V as another
  auto issue = [&](const T* pool, unsigned char* dst) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(pool);
    for (int i = tid; i < nt * pieces; i += kThreads) {
      const int t = i / pieces;
      const int c = i - t * pieces;
      const int tok = c0 + t;
      const int64_t blk = table[(int64_t)seq * max_blocks + tok / block_t];
      const int64_t row = (blk * h_kv + head) * block_t + tok % block_t;
      cp_async16(dst + t * row_stride + c * 16, src + row * row_bytes + c * 16);
    }
    cp_async_commit();
  };
  issue(pool_k, k_s);
  issue(pool_v, v_s);
  for (int i = tid; i < rep * hd; i += kThreads) q_s[i] = to_f(q[row0 * hd + i]);
  cp_async_wait<1>();               // K has landed
  __syncthreads();

  // scores s[r, t] = (q_r . k_t) * sm_scale: token t = tid / 4, each of
  // its 4 lanes a stride of 16-byte pieces, 8 q rows at a time
  {
    const int t = tid / kTokLanes;
    const int g = tid % kTokLanes;
    const bool live = t < nt;
    const unsigned char* krow = k_s + t * row_stride;
    for (int r0 = 0; r0 < rep; r0 += kRowBlock) {
      float s[kRowBlock];
#pragma unroll
      for (int rr = 0; rr < kRowBlock; ++rr) s[rr] = 0.f;
      if (live) {
        for (int c = g; c < pieces; c += kTokLanes) {
          float kv[N];
          Piece<T>::load(krow + c * 16, kv);
#pragma unroll
          for (int rr = 0; rr < kRowBlock; ++rr) {
            if (r0 + rr < rep) {
              const float* qr = q_s + (r0 + rr) * hd + c * N;
#pragma unroll
              for (int e = 0; e < N; e += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qr + e);
                s[rr] += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] +
                         qv.w * kv[e + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowBlock; ++rr) {
        if (r0 + rr < rep) {        // the same for every thread
          float v = s[rr];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (live && g == 0) p_s[(r0 + rr) * kChunk + t] = v * sm_scale;
        }
      }
    }
  }
  __syncthreads();

  // the chunk's softmax, one warp per query row: its max m and sum l of
  // exp(s - m); P is rounded to V's dtype for the P.V product after l
  // has summed it
  for (int r = warp; r < rep; r += kWarps) {
    float* pr = p_s + r * kChunk;
    float mx = kNegInf;
    for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < nt; t += 32) {
      const float p = expf(pr[t] - mx);
      sum += p;
      pr[t] = round_to<T>(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  cp_async_wait<0>();               // V has landed
  __syncthreads();

  // acc[r, piece] = sum_t P[r, t] V[t, piece]: a group of G lanes (a
  // power of two, within one warp) per 16-byte piece of the V rows, each
  // lane every G-th token, 8 q rows at a time; the group sums by shuffles
  int G = 1;
  while (2 * G <= 32 && 2 * G * pieces <= kThreads) G *= 2;
  const int groups = kThreads / G;
  const int j = tid % G;
  const unsigned mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1))
                        << (lane & ~(G - 1));
  for (int c = tid / G; c < pieces; c += groups) {
    for (int r0 = 0; r0 < rep; r0 += kRowBlock) {
      float acc[kRowBlock][N];
#pragma unroll
      for (int rr = 0; rr < kRowBlock; ++rr)
#pragma unroll
        for (int e = 0; e < N; ++e) acc[rr][e] = 0.f;
      for (int t = j; t < nt; t += G) {
        float vv[N];
        Piece<T>::load(v_s + t * row_stride + c * 16, vv);
#pragma unroll
        for (int rr = 0; rr < kRowBlock; ++rr) {
          if (r0 + rr < rep) {
            const float p = p_s[(r0 + rr) * kChunk + t];
#pragma unroll
            for (int e = 0; e < N; ++e) acc[rr][e] += p * vv[e];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowBlock; ++rr) {
        if (r0 + rr >= rep) break;
        const int r = r0 + rr;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          float x = acc[rr][e];
          for (int o = G >> 1; o > 0; o >>= 1)
            x += __shfl_xor_sync(mask, x, o);
          acc[rr][e] = x;
        }
        if (j != 0) continue;
        if (whole) {
          T* o = out + (row0 + r) * hd + c * N;
          const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
          for (int e = 0; e < N; ++e)
            o[e] = from_f<T>(__fdividef(acc[rr][e], l));
        } else {
          float* o = part + ((row0 + r) * n_split + split) * (hd + 2) + c * N;
#pragma unroll
          for (int e = 0; e < N; ++e) o[e] = acc[rr][e];
        }
      }
    }
  }
  if (!whole) {
    for (int r = tid; r < rep; r += kThreads) {
      float* o = part + ((row0 + r) * n_split + split) * (hd + 2);
      o[hd] = m_s[r];
      o[hd + 1] = l_s[r];
    }
  }
}

// grid (h_kv, b): merges each query row's live partials, rescaled to
// their common maximum; rows that one chunk covers were written by the
// split kernel
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_merge_kernel(
    const float* __restrict__ part, const int* __restrict__ lens,
    T* __restrict__ out, int h_kv, int rep, int hd, int block_t,
    int n_live_blocks, int n_split) {
  const int head = blockIdx.x;
  const int seq = blockIdx.y;
  const int len = live_len(lens, seq, n_live_blocks, block_t);
  const int live = (len + kChunk - 1) / kChunk;
  if (live <= 1) return;
  const int64_t row0 = ((int64_t)seq * h_kv + head) * rep;
  const int stride = hd + 2;
  for (int idx = threadIdx.x; idx < rep * hd; idx += kThreads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const float* base = part + (row0 + r) * n_split * stride;
    float m = kNegInf;
    for (int s = 0; s < live; ++s) m = fmaxf(m, base[s * stride + hd]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < live; ++s) {
      const float* ps = base + s * stride;
      const float w = expf(ps[hd] - m);
      l += ps[hd + 1] * w;
      a += ps[d] * w;
    }
    out[(row0 + r) * hd + d] = from_f<T>(__fdividef(a, fmaxf(l, 1e-30f)));
  }
}

// ---------------------------------------------------------------------
// The tensor-core split kernel, for bf16: HD 128 up to head dim 128 (the
// serving cell: a GQA group of 2), HD 256 past it (Gemma-class heads: a
// group of 8 over one KV head). At 256 the FMA kernel above does 8x the
// work per CTA of the serving cell's, and its grid (h_kv, b, n_split)
// holds few CTAs at h_kv 1. Here each CTA takes kMmaChunk = 32 tokens of
// a row's live range (twice the CTAs of 64-token chunks) and two warps,
// each a 16-slot round of mma_decode's `Walk`: S^T = K Q^T and O^T +=
// V^T P^T on mma.sync m16n8k16 with the GQA group on the n8 side, query
// rows in groups of 8.
// A pool block of one KV head is contiguous ([n_blocks, h_kv, block_t,
// hd]), so one thread copies the chunk's K and V rows into shared memory
// with one 1-D bulk copy per block it touches and per K/V, completing on
// one mbarrier, while the warps load their q fragments; rows past the
// row's end are never copied and are excluded by select. The warps merge
// their (m, l, acc) through shared memory into the chunk's partial state,
// or the output where one chunk covers the row.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) paged_decode_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ pool_k,
    const __nv_bfloat16* __restrict__ pool_v, const int* __restrict__ table,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int h_kv, int rep, int hd, int block_t,
    int max_blocks, int n_live_blocks, float sm_scale) {
  using namespace mma_decode;
  const int head = blockIdx.x;
  const int seq = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row0 = ((int64_t)seq * h_kv + head) * rep;
  const int c0 = split * kMmaChunk;
  const int* trow = table + (int64_t)seq * max_blocks;
  // the chunk's first table entry is read beside lens: the column is
  // below n_live_blocks <= max_blocks, though only followed when live
  const int blk0 = tid == 0 ? trow[c0 / block_t] : 0;
  const int len = live_len(lens, seq, n_live_blocks, block_t);
  if (c0 >= len) {
    if (split == 0)                 // a length-0 row gives 0
      for (int i = tid; i < rep * hd; i += kMmaThreads)
        out[row0 * hd + i] = __float2bfloat16(0.f);
    return;
  }
  const int nt = min(kMmaChunk, len - c0);
  const bool whole = len <= kMmaChunk;
  const int row_bytes = hd * (int)sizeof(__nv_bfloat16);
  const int stride = hd + 2;
  extern __shared__ __align__(128) unsigned char smem[];
  // [kMmaChunk] K rows, [kMmaChunk] V rows, the warps' states
  // [kMmaWarps][8][hd + 2] f32, the barrier
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + kMmaChunk * row_bytes;
  float* mrg = reinterpret_cast<float*>(smem + 2 * kMmaChunk * row_bytes);
  const uint32_t bar = smem_addr(mrg + kMmaWarps * kMmaRows * stride);

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar, (uint32_t)(2 * nt * row_bytes));
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(pool_k);
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(pool_v);
    int blk = blk0;
    for (int tok = c0; tok < c0 + nt;) {
      const int off = tok % block_t;
      const int run = min(block_t - off, c0 + nt - tok);
      const int64_t src = (((int64_t)blk * h_kv + head) * block_t + off) *
                          row_bytes;
      const int dst = (tok - c0) * row_bytes;
      bulk_load(smem_addr(k_s + dst), kb + src, (uint32_t)(run * row_bytes),
                bar);
      bulk_load(smem_addr(v_s + dst), vb + src, (uint32_t)(run * row_bytes),
                bar);
      tok += run;
      if (tok < c0 + nt) blk = trow[tok / block_t];
    }
  }
  // every thread waits on the barrier only once it is initialized
  __syncthreads();

  const int slot0 = warp * kRound;
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(q);
  for (int r0 = 0; r0 < rep; r0 += kMmaRows) {
    const int rows = min(kMmaRows, rep - r0);
    uint32_t qf[HD / 32][4];
    load_q<HD>(qf, qb + (row0 + r0 + g) * hd, g < rows, hd, t);
    Walk<HD> walk;
    walk.init();
    if (r0 == 0) mbar_wait(bar, 0);
    if (slot0 < nt)
      walk.template round16<__nv_bfloat16>(qf, k_s, v_s, row_bytes, slot0,
                                           nt, nullptr, nullptr, sm_scale,
                                           hd, g, t);
    walk.finish();
    walk.store(mrg + warp * kMmaRows * stride, rows, hd, stride, g, t);
    __syncthreads();
    // the warps' states rescaled to their common max: the output, or the
    // chunk's partial (acc, m, l)
    for (int i = tid; i < rows * hd; i += kMmaThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      float mm = kNegInf;
#pragma unroll
      for (int x = 0; x < kMmaWarps; ++x)
        mm = fmaxf(mm, mrg[(x * kMmaRows + r) * stride + hd]);
      float acc = 0.f, l = 0.f;
#pragma unroll
      for (int x = 0; x < kMmaWarps; ++x) {
        const float* ps = mrg + (x * kMmaRows + r) * stride;
        const float wt = expf(ps[hd] - mm);
        acc += ps[d] * wt;
        l += ps[hd + 1] * wt;
      }
      const int64_t row = row0 + r0 + r;
      if (whole) {
        out[row * hd + d] = __float2bfloat16(__fdividef(acc, fmaxf(l, 1e-30f)));
      } else {
        float* o = part + (row * n_split + split) * stride;
        o[d] = acc;
        if (d == 0) {
          o[hd] = mm;
          o[hd + 1] = l;
        }
      }
    }
    __syncthreads();                // before the next group's states
  }
}

// grid ceil(b * h / 4), 4 warps: warp w merges query row (block * 4 + w)
// over its row's live chunks of kMmaChunk tokens (rows that one chunk
// covers, or of length 0, were written by the split kernel), lane d of
// the warp head dims d + 32 i (i < DIMS). The chunks' states come in
// groups of 8 whose loads are all issued before any is used, folded in
// by the online rescaling, each weight exp(m_s - m) taken once per chunk.
template <int DIMS>
__global__ void __launch_bounds__(32 * kMergeWarps)
    paged_decode_merge_rows_kernel(const float* __restrict__ part,
                                   const int* __restrict__ lens,
                                   __nv_bfloat16* __restrict__ out,
                                   int n_rows, int h, int hd, int block_t,
                                   int n_live_blocks, int n_split) {
  constexpr int kGroup = 8;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int len = live_len(lens, (int)(row / h), n_live_blocks, block_t);
  const int live = (len + kMmaChunk - 1) / kMmaChunk;
  if (live <= 1) return;
  const int stride = hd + 2;
  const float* base = part + row * n_split * stride;
  float acc[DIMS];
#pragma unroll
  for (int i = 0; i < DIMS; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  for (int s0 = 0; s0 < live; s0 += kGroup) {
    float ms[kGroup], ls[kGroup], av[kGroup][DIMS];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const bool have = s0 + j < live;
      const float* ps = base + (s0 + j) * stride;
      ms[j] = have ? ps[hd] : kNegInf;
      ls[j] = have ? ps[hd + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < DIMS; ++i) {
        const int d = lane + 32 * i;
        av[j][i] = have && d < hd ? ps[d] : 0.f;
      }
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) m_new = fmaxf(m_new, ms[j]);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DIMS; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float wt = expf(ms[j] - m_new);
      l = fmaf(ls[j], wt, l);
#pragma unroll
      for (int i = 0; i < DIMS; ++i) acc[i] = fmaf(av[j][i], wt, acc[i]);
    }
    m = m_new;
  }
  l = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DIMS; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) out[row * hd + d] = __float2bfloat16(__fdividef(acc[i], l));
  }
}

// The shared-memory limit of `kernel` is raised once per device, to the
// most any launch can ask for, at the first launch that needs it: a
// launch captured into a CUDA graph then makes no call but the launch
// itself. `raised` holds the kernel's own flags, one per device.
template <typename K>
cudaError_t allow_smem(K* kernel, bool* raised, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && raised[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem);
  if (e == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return e;
}

template <typename T>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* table, const void* lens, void* out, void* part, int b,
           int h, int h_kv, int hd, int block_t, int max_blocks,
           int n_live_blocks, int n_split, cudaStream_t stream) {
  const int rep = h / h_kv;
  if (n_split != (n_live_blocks * block_t + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(rep, hd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool raised[kMaxDevices] = {};
  cudaError_t e = allow_smem(paged_decode_split_kernel<T>, raised, smem);
  if (e != cudaSuccess) return (int)e;
  paged_decode_split_kernel<T><<<dim3(h_kv, b, n_split), kThreads, smem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(part), h_kv, rep, hd, block_t, max_blocks,
      n_live_blocks, 1.0f / sqrtf((float)hd));
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  paged_decode_merge_kernel<T><<<dim3(h_kv, b), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(lens),
      static_cast<T*>(out), h_kv, rep, hd, block_t, n_live_blocks, n_split);
  return (int)cudaGetLastError();
}

// the tensor-core kernel's route: bf16, chunks of kMmaChunk tokens
template <int HD>
int launch_mma(const void* q, const void* pool_k, const void* pool_v,
               const void* table, const void* lens, void* out, void* part,
               int b, int h, int h_kv, int hd, int block_t, int max_blocks,
               int n_live_blocks, int n_split, cudaStream_t stream) {
  using T = __nv_bfloat16;
  if (n_split != (n_live_blocks * block_t + kMmaChunk - 1) / kMmaChunk)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)kMmaChunk * hd * sizeof(T) +
                      (size_t)kMmaWarps * mma_decode::kMmaRows * (hd + 2) *
                          sizeof(float) +
                      8;                               // the barrier
  static bool raised[kMaxDevices] = {};
  cudaError_t e = allow_smem(paged_decode_split_mma_kernel<HD>, raised, smem);
  if (e != cudaSuccess) return (int)e;
  paged_decode_split_mma_kernel<HD><<<dim3(h_kv, b, n_split), kMmaThreads,
                                      smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(part), h_kv, h / h_kv, hd, block_t, max_blocks,
      n_live_blocks, 1.0f / sqrtf((float)hd));
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const int n_rows = b * h;
  paged_decode_merge_rows_kernel<HD / 32>
      <<<(n_rows + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0,
         stream>>>(static_cast<const float*>(part),
                   static_cast<const int*>(lens), static_cast<T*>(out),
                   n_rows, h, hd, block_t, n_live_blocks, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel, chunks of 64 tokens), 1 = bfloat16
// (the tensor-core kernel, chunks of 32, head dims up to 256). `part` is
// f32 scratch [b, h, n_split, hd + 2], needed when n_split > 1; n_split
// must be ceil(n_live_blocks * block_t / chunk). Returns a cudaError_t
// (0 = success).
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* pool_k, const void* pool_v,
    const void* table, const void* lens, void* out, void* part, int b, int h,
    int h_kv, int hd, int block_t, int max_blocks, int n_live_blocks,
    int n_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t el = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(pool_k) |
                         reinterpret_cast<uintptr_t>(pool_v)) % 16) == 0;
  if (!aligned || (hd * el) % 16 != 0 || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, pool_k, pool_v, table, lens, out, part, b, h,
                         h_kv, hd, block_t, max_blocks, n_live_blocks,
                         n_split, s);
  if (dtype == 1 && hd <= 128)
    return launch_mma<128>(q, pool_k, pool_v, table, lens, out, part, b, h,
                           h_kv, hd, block_t, max_blocks, n_live_blocks,
                           n_split, s);
  if (dtype == 1 && hd <= 256)
    return launch_mma<256>(q, pool_k, pool_v, table, lens, out, part, b, h,
                           h_kv, hd, block_t, max_blocks, n_live_blocks,
                           n_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
