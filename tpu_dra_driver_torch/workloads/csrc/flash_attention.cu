// Flash attention for Hopper (sm_90a): the forward and both backward
// kernels of the training path.
//
// Replaces the three Pallas kernels of
// tpu_dra_driver/workloads/ops/attention.py:
//
//   flash_fwd_kernel     <- `_flash_kernel`          (B1, launched by
//                           `_flash_forward`)
//   flash_bwd_dq_kernel  <- `_flash_bwd_dq_kernel`   (B2, launched by
//                           `_flash_backward`)
//   flash_bwd_dkv_kernel <- `_flash_bwd_dkv_kernel`  (B3, launched by
//                           `_flash_backward`)
//
// Layouts (all contiguous):
//   q, out, dout, dq  [b, h, t, d]       bf16 or f32
//   k, v, dk, dv      [b, h_kv, tkv, d]  q's dtype; query head j reads
//                                        KV head j / (h / h_kv) (GQA)
//   dq, dk, dv are f32 also for bf16 inputs when the caller asks
//   (`grad_f32`: a ring sums them over its hops before one rounding)
//   lse, dd           [b, h, t]          f32, natural-log logsumexp and
//                                        D = rowsum(dO * O) - g_lse
//
// Masks (global row r = row_offset + local row, column c): without
// `causal` every column c < tkv is visible; with it, c is visible when
// c < prefix, or when r >= c and (window == 0 or r - c < window).
// prefix == 0 and window == 0 mean "none". A row that sees no column
// gives out 0, lse (NEG_INF + log2(1e-30)) / LOG2E (the reference's
// -6.93e29, finite so that partial merges stay finite) and gradient 0.
//
// Numerics: products take the inputs' dtype and accumulate in f32;
// scores are kept in base 2 (the scale 1/sqrt(d) * log2(e) multiplies
// the f32 score); P and dS are rounded to the inputs' dtype before they
// enter a product, as the TPU kernels round them. The backward kernels
// set P to 0 wherever the mask hides a column, rather than relying on
// exp2(NEG_INF - lse): on a row with an empty band lse * LOG2E rounds to
// NEG_INF itself and that difference is 0, not -inf.
//
// Bound on this card: operations. Causal attention at the training
// shapes (t = 2048, d = 128) does 4 d multiply-adds per visible
// (row, column) pair in the forward, 6 d in dq and 8 d in dk/dv, against
// O(t d) bytes per head: thousands of operations per byte, far above the
// H100's ~295 bf16 tensor-core operations per byte. So the kernels must
// keep the tensor cores fed: every product of the bf16 kernels is a
// Hopper warpgroup product (wgmma) and nothing else waits.
//
// Design. The TPU kernels carry their state across a sequential
// superblock grid axis in VMEM scratch; Hopper has no ordered grid, so
// each CTA walks its own KV tiles (forward, dq) or q tiles (dk/dv) in a
// loop and nothing carries between CTAs. The work items are (q tile,
// b * h) for the forward and dq, and (KV tile, b * h_kv) for dk/dv,
// which loops over the GQA group's heads itself: no atomics, and the
// result does not change from run to run. Loops start and stop at the
// causal, window and prefix bounds, so tiles wholly outside the band are
// never loaded, and the items with the most tiles come first. The bf16
// forward and dq are persistent (below); dk/dv and the f32 kernels
// launch one CTA per item.
//
// bf16 forward (B1), dq (B2) and dk/dv (B3), sm_90a only, along the
// lines of FlashAttention-3: a CTA is two consumer warpgroups and one
// producer warp(group). The producer's one thread streams tiles with TMA
// (128-byte swizzled panels of 64 columns; rows and columns past the
// tensor's edge arrive as zeros) through a ring of shared memory guarded
// by mbarriers, so the next tile is in flight while the consumers
// multiply the current one. Each consumer warpgroup owns 64 rows (B1,
// B2: q rows of a 128-row tile; B3: KV rows of a 128-row tile), whose
// tiles (Q; Q, dO, lse and D; K and V) arrive once:
// S = Q K^T (B2 also dP = dO V^T; B3: S^T = K Q^T and dP^T = V dO^T)
// runs as wgmma from shared memory into registers; the online softmax
// (B1) or P and dS (B2, B3) are formed on the accumulator fragment in
// registers; P (B2: dS; B3: P^T, dS^T) is rounded to bf16 in registers
// and is the register A operand of the next wgmma (O += P V; dQ += dS K;
// dV += P^T dO, dK += dS^T Q) with B read MN-major from the same
// swizzled tiles, so nothing is transposed in memory. O, m and l (B2:
// dQ; B3: dK and dV) stay in registers for the whole walk and are
// written once, through a per-warp staging panel in shared memory as
// 16-byte row segments (store_rows); setmaxnreg moves registers from the
// producer to the consumers. Head dims up to 64, up to 128 and up to 256
// are three instantiations; the columns past d are zero-filled by TMA
// and never stored.
//
// Three rules keep the tensor cores fed in all three:
// - no serialised products: every register operand of a wgmma
//   (accumulators, A operands) is fenced above its wgmma.fence, so ptxas
//   injects no warpgroup.arrive of its own (C7519); the wait for a
//   tile's data comes before that fence; each product is waited for in
//   the iteration that issued it (a wait across the loop's back edge, or
//   under a branch, makes ptxas serialise them all, C7514/C7515/C7517);
//   releases are predicated arrives, not branches;
// - the mask is predicates without branches (seen()), under one uniform
//   test of the tile (unmasked()): a per-element branch made B1's
//   softmax, and B2's and B3's P, 64 guarded blocks with convergence
//   barriers on every score, unmasked tiles too;
// - the walks are software pipelines: per tile the warpgroup issues the
//   scores of tile j (B1: S; B2: S and dP; B3: S^T and dP^T) and the
//   products of tile j - 1 (P V; dS K; P^T dO and dS^T Q), waits only
//   for the scores, forms P (and dS) beside the other products, and
//   rounds them to A operands once those are done.
//
// B1. The two warpgroups take turns on the tensor cores through two
// named barriers (ping-pong), so one's softmax runs under the other's
// products. Persistent CTAs: one per SM walks the items with a static
// stride of the grid over the longest-first order (fwd_tile:
// deterministic, no counter, safe under graph capture). K and V stages
// are released apart (K once S is done, V once P V is), and the next
// item's Q loads as soon as the last S has read Q, under the last P V and
// the epilogue. Stages: at HD 64 and 128, Q (16 or 32 KiB) and two
// stages of 128-row K and V tiles (32 or 64 KiB a stage) beside the 16
// KiB epilogue staging; a third stage would not fit at 128, and the
// copies alone take under half of B1's time (the copy probe below). At
// HD 256, 64-row K/V tiles (O is 128 f32 a thread, S 32) and two stages:
// Q alone is 64 KiB. The wait for P V sits above the softmax's
// exponentials (SASS `W1 W0 E`): ptxas waits for every product in flight
// at the join after the mask's test of the tile, so a warpgroup's own
// softmax does not overlap its own P V, only the other warpgroup's
// products. Measured on the card (PERF.md), each way of moving the
// wait below the exponentials read slower: the walk split into
// masked and unmasked loops with the mask a constant (`W1 E W0`, 10-15%
// slower; the products alone slower too), the mask as predicates on
// every tile (33%), P through shared memory with P V as wgmma_ss (5-15%,
// and still `W1 W0 E`); so were the epilogue by TMA (0-6%), O's rescale
// after the P V wait (0-3%), and a softmax with the scale in the
// exponent's FMA and tree reductions (no faster). Pace probes built only
// by tools/flash_fwd_steps.py (B1_PACE, below) split B1's time: at the
// training shape the products alone take 0.21-0.23 ms of 0.28, the
// softmax alone 0.16-0.18, the copies 0.13-0.14 and an item's fixed cost
// (Q, the epilogue, the lse) ~3.2 us.
//
// B2. Persistent over the same order as B1, K and V in 64-row tiles
// (32 at HD 256) through three stages, so that dQ (HD / 2 f32 a thread),
// S, dP and the dS operand fit the registers. Q, dO, lse and D of the
// next item load once the last S and dP have read them, under the last
// dQ product and the epilogue; at HD 256 Q and dO take 128 KiB and the
// epilogue stages in the warpgroup's own dO tile, so there they load
// after it. No ping-pong: the two warpgroups' walks interleave on the
// tensor cores by themselves.
//
// B3. One CTA per item (at the training shape 512 CTAs, 3.9 waves), the
// q walk pipelined through three stages of Q, dO, lse and D up to HD 128
// (163 KiB with K and V) and two at 256. Up to HD 128 each warpgroup
// owns 64 KV rows and the whole head dim: dK and dV (128 f32 a thread)
// and S^T and dP^T (64) are live beside the P^T operand (16) at the
// pipeline's peak, so dS^T goes to a 64 x 64 swizzled panel in shared
// memory and dK += dS^T Q reads it there (with dS^T in registers too,
// ptxas ran out of registers and serialised every product, C7512). At HD
// 256 dK and dV of 64 rows x 256 would take 256 f32 a thread, so the CTA
// takes 64 KV rows and the warpgroups split the head dim of dK and dV,
// each holding half (as FlashAttention-3 does), and the scores: warpgroup
// w computes S^T and dP^T of q rows [32 w, 32 w + 32) of each tile (P^T
// kept in f32 until dS^T is formed, as the reference does), the two
// trade their bf16 P^T and dS^T operands through shared memory under one
// named barrier a tile, and each multiplies its half of dV and dK over
// all 64 q rows, so no product is computed twice. That read no faster
// than computing the scores twice (PERF.md): with 64 KV rows a CTA, B3
// at 256 streams twice the Q and dO bytes per product that HD 128's
// 128-row tiles do.
//
// Together B2 and B3 run 7 products a tile pair (B2: S, dP, dQ; B3: S^T,
// dP^T, dV, dK), where a fused backward (dq accumulated across KV-tile
// CTAs with atomics, as FlashAttention-3's) runs 5: the two kernels
// match the reference's two `pallas_call`s and keep the result the same
// from run to run.
//
// The f32 instantiations multiply with plain FMAs on 32-row tiles in
// shared memory, so their comparison with the plain version is tight.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxHeadDim = 256;
// the dynamic shared memory a block may opt into on sm_90
constexpr size_t kMaxSmem = 232448;

// rows per tile and row padding (elements) of the f32 kernels' tiles
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int kB = 32;
  static constexpr int kPad = 4;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* dd;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int b, h, h_kv, t, tkv, d;
  int causal, window, row_offset, prefix;
  int grad_f32;  // bf16 kernels: dq, dk, dv written in f32
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int r, int c) {
  if (c >= a.tkv) return false;
  if (!a.causal) return true;
  if (c < a.prefix) return true;  // prefix and window are exclusive
  return r >= c && (a.window == 0 || r - c < a.window);
}

// KV tiles [lo, hi) that global rows [r0, r1] can see
__device__ void kv_tiles(const Args& a, int r0, int r1, int tile, int* lo,
                         int* hi) {
  const int n = (a.tkv + tile - 1) / tile;
  *lo = 0;
  *hi = n;
  if (!a.causal) return;
  int cmax = r1;
  if (a.prefix > 0) cmax = max(cmax, a.prefix - 1);
  cmax = min(cmax, a.tkv - 1);
  const int cmin = a.window > 0 ? max(0, r0 - a.window + 1) : 0;
  if (cmax < cmin) {
    *hi = 0;
    return;
  }
  *lo = cmin / tile;
  *hi = cmax / tile + 1;
}

// q tiles [lo, hi) (local rows) that can see columns [c0, c1]
__device__ void q_tiles(const Args& a, int c0, int c1, int tile, int* lo,
                        int* hi) {
  const int n = (a.t + tile - 1) / tile;
  *lo = 0;
  *hi = n;
  if (!a.causal) return;
  int rmin = c0 < a.prefix ? 0 : c0 - a.row_offset;
  rmin = max(rmin, 0);
  int rmax = a.t - 1;
  if (a.window > 0 && !(c0 < a.prefix))
    rmax = min(rmax, c1 + a.window - 1 - a.row_offset);
  if (rmax < rmin) {
    *hi = 0;
    return;
  }
  *lo = rmin / tile;
  *hi = rmax / tile + 1;
}

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// shared-memory carving shared by the kernels and the host size query
struct Bump {
  size_t top = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = top;
    top = align128(top + bytes);
    return o;
  }
};

template <typename T> struct Lds {
  int t;    // row stride of a [B, d] tile of T
  int s;    // row stride of a [B, B] f32 score tile
  int p;    // row stride of a [B, B] tile of T (P or dS)
  int acc;  // row stride of a [B, d] f32 accumulator
  __host__ __device__ explicit Lds(int d)
      : t(d + Cfg<T>::kPad), s(Cfg<T>::kB + 4), p(Cfg<T>::kB + Cfg<T>::kPad),
        acc(d + 4) {}
};

// Rows [0, rows) of a [*, d] matrix at src into a [B, ld] tile, rows
// [rows, B) zeroed. 16-byte loads when src is aligned (d % 16 == 0, so
// every row is).
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, int rows, int d) {
  constexpr int B = Cfg<T>::kB;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = d / kVec;
    for (int i = threadIdx.x; i < B * per_row; i += kThreads) {
      const int r = i / per_row;
      const int c = i - r * per_row;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows)
        val = reinterpret_cast<const uint4*>(src + (size_t)r * d)[c];
      reinterpret_cast<uint4*>(dst + (size_t)r * ld)[c] = val;
    }
  } else {
    for (int i = threadIdx.x; i < B * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      dst[r * ld + c] = r < rows ? src[(size_t)r * d + c] : from_f<T>(0.f);
    }
  }
}

// C[B, B] (f32) = A[B, d] . B[B, d]^T, both tiles of T in shared memory
template <typename T>
__device__ void mm_abt(const T* A, const T* Bm, int ld, int d, float* C,
                       int ldc) {
  constexpr int B = Cfg<T>::kB;
  for (int i = threadIdx.x; i < B * B; i += kThreads) {
    const int r = i / B;
    const int c = i - r * B;
    const T* ar = A + r * ld;
    const T* br = Bm + c * ld;
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = fmaf(to_f(ar[k]), to_f(br[k]), s);
    C[r * ldc + c] = s;
  }
}

// C[B, d] (f32) += A[B, B] . Bm[B, d], A and Bm tiles of T in shared memory
template <typename T>
__device__ void mm_ab_acc(const T* A, int lda, const T* Bm, int ldb, int d,
                          float* C, int ldc) {
  constexpr int B = Cfg<T>::kB;
  for (int i = threadIdx.x; i < B * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const T* ar = A + r * lda;
    float s = C[r * ldc + c];
    for (int k = 0; k < B; ++k) s = fmaf(to_f(ar[k]), to_f(Bm[k * ldb + c]), s);
    C[r * ldc + c] = s;
  }
}

// ------------------------------------------------------------- forward

template <typename T> struct FwdLayout {
  size_t q, k, v, s, p, acc, m, l, alpha, total;
  __host__ __device__ explicit FwdLayout(int d) {
    constexpr int B = Cfg<T>::kB;
    const Lds<T> ld(d);
    Bump b;
    q = b.take((size_t)B * ld.t * sizeof(T));
    k = b.take((size_t)B * ld.t * sizeof(T));
    v = b.take((size_t)B * ld.t * sizeof(T));
    s = b.take((size_t)B * ld.s * sizeof(float));
    p = b.take((size_t)B * ld.p * sizeof(T));
    acc = b.take((size_t)B * ld.acc * sizeof(float));
    m = b.take(B * sizeof(float));
    l = b.take(B * sizeof(float));
    alpha = b.take(B * sizeof(float));
    total = b.top;
  }
};

// B1 in f32, replaces `_flash_kernel` (ops/attention.py:105); bf16
// takes `flash_fwd_kernel_sm90`. One CTA per (q tile, b * h) keeps its q
// tile and f32 accumulator in shared memory for the whole KV walk, so q
// is read once and K/V once per q tile; the walk stops at the causal,
// window and prefix bounds.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  static_assert(std::is_same<T, float>::value, "bf16 runs the sm90 kernel");
  constexpr int B = Cfg<T>::kB;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = a.d;
  const Lds<T> ld(d);
  const FwdLayout<T> lay(d);
  T* q_s = reinterpret_cast<T*>(smem + lay.q);
  T* k_s = reinterpret_cast<T*>(smem + lay.k);
  T* v_s = reinterpret_cast<T*>(smem + lay.v);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  T* p_s = reinterpret_cast<T*>(smem + lay.p);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* alpha_s = reinterpret_cast<float*>(smem + lay.alpha);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int i0 = qt * B;
  const int rows = min(B, a.t - i0);
  const int kvh = (bh / a.h) * a.h_kv + (bh % a.h) / (a.h / a.h_kv);
  const T* q = static_cast<const T*>(a.q) + ((size_t)bh * a.t + i0) * d;
  const T* k = static_cast<const T*>(a.k) + (size_t)kvh * a.tkv * d;
  const T* v = static_cast<const T*>(a.v) + (size_t)kvh * a.tkv * d;

  load_tile(q_s, ld.t, q, rows, d);
  for (int i = tid; i < B * d; i += kThreads) {
    const int r = i / d;
    acc[r * ld.acc + (i - r * d)] = 0.f;
  }
  for (int r = tid; r < B; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int r0 = a.row_offset + i0;
  int lo, hi;
  kv_tiles(a, r0, r0 + rows - 1, B, &lo, &hi);
  const float qk_scale = a.scale * kLog2e;

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * B;
    __syncthreads();  // the previous tile's products are done
    load_tile(k_s, ld.t, k + (size_t)c0 * d, min(B, a.tkv - c0), d);
    load_tile(v_s, ld.t, v + (size_t)c0 * d, min(B, a.tkv - c0), d);
    __syncthreads();
    mm_abt(q_s, k_s, ld.t, d, s_s, ld.s);
    __syncthreads();
    // online softmax in base 2, one warp per row; masked scores take a
    // fill below the m sentinel so they give exp2(...) == 0
    for (int r = warp; r < B; r += kWarps) {
      float mx = 2.f * kNegInf;
      for (int c = lane; c < B; c += 32) {
        float s = s_s[r * ld.s + c] * qk_scale;
        if (!visible(a, r0 + r, c0 + c)) s = 2.f * kNegInf;
        s_s[r * ld.s + c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < B; c += 32) {
        const float p = exp2f(s_s[r * ld.s + c] - m_new);
        p_s[r * ld.p + c] = from_f<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < B * d; i += kThreads) {
      const int r = i / d;
      acc[r * ld.acc + (i - r * d)] *= alpha_s[r];
    }
    __syncthreads();
    mm_ab_acc(p_s, ld.p, v_s, ld.t, d, acc, ld.acc);
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out) + ((size_t)bh * a.t + i0) * d;
  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d;
    out[i] = from_f<T>(acc[r * ld.acc + (i - r * d)] / fmaxf(l_s[r], 1e-30f));
  }
  if (a.lse_out != nullptr) {
    for (int r = tid; r < rows; r += kThreads)
      a.lse_out[(size_t)bh * a.t + i0 + r] =
          (m_s[r] + log2f(fmaxf(l_s[r], 1e-30f))) / kLog2e;
  }
}

// ------------------------------------------------------------------ dq

template <typename T> struct DqLayout {
  size_t q, dout, k, v, s, dp, ds, acc, lse2, dd, total;
  __host__ __device__ explicit DqLayout(int d) {
    constexpr int B = Cfg<T>::kB;
    const Lds<T> ld(d);
    Bump b;
    q = b.take((size_t)B * ld.t * sizeof(T));
    dout = b.take((size_t)B * ld.t * sizeof(T));
    k = b.take((size_t)B * ld.t * sizeof(T));
    v = b.take((size_t)B * ld.t * sizeof(T));
    s = b.take((size_t)B * ld.s * sizeof(float));
    dp = b.take((size_t)B * ld.s * sizeof(float));
    ds = b.take((size_t)B * ld.p * sizeof(T));
    acc = b.take((size_t)B * ld.acc * sizeof(float));
    lse2 = b.take(B * sizeof(float));
    dd = b.take(B * sizeof(float));
    total = b.top;
  }
};

// B2 in f32, replaces `_flash_bwd_dq_kernel` (ops/attention.py:528);
// bf16 takes `flash_bwd_dq_kernel_sm90`. One CTA per (q tile, b * h)
// holds q, dO, lse and D for its rows and the dq accumulator, rebuilds P
// from (q, k, lse) tile by tile and never writes P or dS out.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  static_assert(std::is_same<T, float>::value, "bf16 runs the sm90 kernel");
  constexpr int B = Cfg<T>::kB;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = a.d;
  const Lds<T> ld(d);
  const DqLayout<T> lay(d);
  T* q_s = reinterpret_cast<T*>(smem + lay.q);
  T* do_s = reinterpret_cast<T*>(smem + lay.dout);
  T* k_s = reinterpret_cast<T*>(smem + lay.k);
  T* v_s = reinterpret_cast<T*>(smem + lay.v);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* dp_s = reinterpret_cast<float*>(smem + lay.dp);
  T* ds_s = reinterpret_cast<T*>(smem + lay.ds);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* lse2 = reinterpret_cast<float*>(smem + lay.lse2);
  float* dd = reinterpret_cast<float*>(smem + lay.dd);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int i0 = qt * B;
  const int rows = min(B, a.t - i0);
  const int kvh = (bh / a.h) * a.h_kv + (bh % a.h) / (a.h / a.h_kv);
  const size_t row_base = (size_t)bh * a.t + i0;
  const T* k = static_cast<const T*>(a.k) + (size_t)kvh * a.tkv * d;
  const T* v = static_cast<const T*>(a.v) + (size_t)kvh * a.tkv * d;

  load_tile(q_s, ld.t, static_cast<const T*>(a.q) + row_base * d, rows, d);
  load_tile(do_s, ld.t, static_cast<const T*>(a.dout) + row_base * d, rows,
            d);
  for (int i = tid; i < B * d; i += kThreads) {
    const int r = i / d;
    acc[r * ld.acc + (i - r * d)] = 0.f;
  }
  for (int r = tid; r < B; r += kThreads) {
    lse2[r] = r < rows ? a.lse_in[row_base + r] * kLog2e : 0.f;
    dd[r] = r < rows ? a.dd[row_base + r] : 0.f;
  }
  const int r0 = a.row_offset + i0;
  int lo, hi;
  kv_tiles(a, r0, r0 + rows - 1, B, &lo, &hi);
  const float qk_scale = a.scale * kLog2e;

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * B;
    __syncthreads();
    load_tile(k_s, ld.t, k + (size_t)c0 * d, min(B, a.tkv - c0), d);
    load_tile(v_s, ld.t, v + (size_t)c0 * d, min(B, a.tkv - c0), d);
    __syncthreads();
    mm_abt(q_s, k_s, ld.t, d, s_s, ld.s);     // S = Q K^T
    mm_abt(do_s, v_s, ld.t, d, dp_s, ld.s);   // dP = dO V^T
    __syncthreads();
    for (int i = tid; i < B * B; i += kThreads) {
      const int r = i / B;
      const int c = i - r * B;
      float p = 0.f;
      if (visible(a, r0 + r, c0 + c))
        p = exp2f(s_s[r * ld.s + c] * qk_scale - lse2[r]);
      ds_s[r * ld.p + c] = from_f<T>(p * (dp_s[r * ld.s + c] - dd[r]));
    }
    __syncthreads();
    mm_ab_acc(ds_s, ld.p, k_s, ld.t, d, acc, ld.acc);  // dQ += dS K
  }
  __syncthreads();

  T* dq = static_cast<T*>(a.dq) + row_base * d;
  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d;
    dq[i] = from_f<T>(acc[r * ld.acc + (i - r * d)] * a.scale);
  }
}

// --------------------------------------------------------------- dk/dv

template <typename T> struct DkvLayout {
  size_t k, v, q, dout, s, dp, p, ds, dk, dv, lse2, dd, total;
  __host__ __device__ explicit DkvLayout(int d) {
    constexpr int B = Cfg<T>::kB;
    const Lds<T> ld(d);
    Bump b;
    k = b.take((size_t)B * ld.t * sizeof(T));
    v = b.take((size_t)B * ld.t * sizeof(T));
    q = b.take((size_t)B * ld.t * sizeof(T));
    dout = b.take((size_t)B * ld.t * sizeof(T));
    s = b.take((size_t)B * ld.s * sizeof(float));
    dp = b.take((size_t)B * ld.s * sizeof(float));
    p = b.take((size_t)B * ld.p * sizeof(T));
    ds = b.take((size_t)B * ld.p * sizeof(T));
    dk = b.take((size_t)B * ld.acc * sizeof(float));
    dv = b.take((size_t)B * ld.acc * sizeof(float));
    lse2 = b.take(B * sizeof(float));
    dd = b.take(B * sizeof(float));
    total = b.top;
  }
};

// B3 in f32, replaces `_flash_bwd_dkv_kernel` (ops/attention.py:635);
// bf16 takes `flash_bwd_dkv_kernel_sm90`. One CTA per (KV tile,
// b * h_kv) walks every head of its GQA group and the q tiles that can
// see its columns (from the diagonal on), so dk and dv are summed over
// the group in shared memory: no atomics, the same result from run to
// run.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  static_assert(std::is_same<T, float>::value, "bf16 runs the sm90 kernel");
  constexpr int B = Cfg<T>::kB;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = a.d;
  const Lds<T> ld(d);
  const DkvLayout<T> lay(d);
  T* k_s = reinterpret_cast<T*>(smem + lay.k);
  T* v_s = reinterpret_cast<T*>(smem + lay.v);
  T* q_s = reinterpret_cast<T*>(smem + lay.q);
  T* do_s = reinterpret_cast<T*>(smem + lay.dout);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);    // S^T [kv, q]
  float* dp_s = reinterpret_cast<float*>(smem + lay.dp);  // dP^T [kv, q]
  T* p_s = reinterpret_cast<T*>(smem + lay.p);            // P^T
  T* ds_s = reinterpret_cast<T*>(smem + lay.ds);          // dS^T
  float* dk_acc = reinterpret_cast<float*>(smem + lay.dk);
  float* dv_acc = reinterpret_cast<float*>(smem + lay.dv);
  float* lse2 = reinterpret_cast<float*>(smem + lay.lse2);
  float* dd = reinterpret_cast<float*>(smem + lay.dd);

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x;  // b * h_kv + kv head
  const int c0 = blockIdx.y * B;
  const int cols = min(B, a.tkv - c0);
  const int group = a.h / a.h_kv;
  const int bb = kvh / a.h_kv;
  const int hk = kvh - bb * a.h_kv;
  const size_t kv_base = (size_t)kvh * a.tkv + c0;

  load_tile(k_s, ld.t, static_cast<const T*>(a.k) + kv_base * d, cols, d);
  load_tile(v_s, ld.t, static_cast<const T*>(a.v) + kv_base * d, cols, d);
  for (int i = tid; i < B * d; i += kThreads) {
    const int r = i / d;
    dk_acc[r * ld.acc + (i - r * d)] = 0.f;
    dv_acc[r * ld.acc + (i - r * d)] = 0.f;
  }
  int lo, hi;
  q_tiles(a, c0, c0 + cols - 1, B, &lo, &hi);
  const float qk_scale = a.scale * kLog2e;

  for (int g = 0; g < group; ++g) {
    const int bh = bb * a.h + hk * group + g;
    for (int it = lo; it < hi; ++it) {
      const int i0 = it * B;
      const int rows = min(B, a.t - i0);
      const size_t row_base = (size_t)bh * a.t + i0;
      __syncthreads();
      load_tile(q_s, ld.t, static_cast<const T*>(a.q) + row_base * d, rows,
                d);
      load_tile(do_s, ld.t, static_cast<const T*>(a.dout) + row_base * d,
                rows, d);
      for (int r = tid; r < B; r += kThreads) {
        lse2[r] = r < rows ? a.lse_in[row_base + r] * kLog2e : 0.f;
        dd[r] = r < rows ? a.dd[row_base + r] : 0.f;
      }
      __syncthreads();
      mm_abt(k_s, q_s, ld.t, d, s_s, ld.s);    // S^T = K Q^T
      mm_abt(v_s, do_s, ld.t, d, dp_s, ld.s);  // dP^T = V dO^T
      __syncthreads();
      const int g0 = a.row_offset + i0;
      for (int i = tid; i < B * B; i += kThreads) {
        const int c = i / B;  // kv row of the transposed tiles
        const int r = i - c * B;
        float p = 0.f;
        if (r < rows && visible(a, g0 + r, c0 + c))
          p = exp2f(s_s[c * ld.s + r] * qk_scale - lse2[r]);
        p_s[c * ld.p + r] = from_f<T>(p);
        ds_s[c * ld.p + r] = from_f<T>(p * (dp_s[c * ld.s + r] - dd[r]));
      }
      __syncthreads();
      mm_ab_acc(p_s, ld.p, do_s, ld.t, d, dv_acc, ld.acc);  // dV += P^T dO
      mm_ab_acc(ds_s, ld.p, q_s, ld.t, d, dk_acc, ld.acc);  // dK += dS^T Q
    }
  }
  __syncthreads();

  T* dk = static_cast<T*>(a.dk) + kv_base * d;
  T* dv = static_cast<T*>(a.dv) + kv_base * d;
  for (int i = tid; i < cols * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dk[i] = from_f<T>(dk_acc[r * ld.acc + c] * a.scale);
    dv[i] = from_f<T>(dv_acc[r * ld.acc + c]);
  }
}

// ------------------------------------------- Hopper building blocks

namespace sm90 {

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kRows = 64;                       // rows per warpgroup
constexpr uint32_t kPanelRow = 128;             // bytes: 64 bf16 columns
constexpr uint32_t kAtom = 8 * kPanelRow;       // an 8-row swizzle atom
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// an mbarrier arrival by the threads for which `pred` holds, without a
// branch
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// orders this thread's shared-memory writes before later TMA writes to
// the same bytes (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait of over a second traps, so a broken pipeline fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t since = 0;
  for (uint32_t tries = 1; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && tries % 4096 == 0) {
      if (since == 0) since = global_ns();
      else if (global_ns() - since > 1000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B. K-major tiles (rows of 64 bf16 along K) step 8-row atoms
// by `sbo` = 1024; MN-major tiles (K along the rows) step the next 8 K
// rows by `sbo` = 1024 and the next 64 MN columns (the next panel) by
// `lbo`.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most `pending` committed wgmma groups are in flight
template <int pending> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending)
               : "memory");
}

// Keeps the compiler from moving reads of a wgmma's accumulators above
// the wait for it, and from reusing a register A operand's registers
// while the product that reads them may still run.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// An m64nN f32 accumulator fragment: thread (warp w, lane l) of the
// warpgroup holds, for each 8-column group j, d[4j + 2i + e] = element
// (row 16w + l/4 + 8i, column 8j + 2(l%4) + e). Rounded to bf16 and
// packed in pairs, 16 columns of it (groups 2k, 2k + 1) are exactly the
// register A operand of the k-th m64k16 step of a following product.
template <int N>
__device__ __forceinline__ void to_a_operand(const float (&d)[N / 2],
                                             uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    a[k][0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
    a[k][1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
    a[k][2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
    a[k][3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
  }
}

// d (+)= A . B, m64n32k16: A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A . B, m64n64k16: A and B in shared memory, A K-major, B
// K-major or, with TB = 1, MN-major
template <int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A . B, m64n128k16: A and B in shared memory, A K-major, B
// K-major or, with TB = 1, MN-major
template <int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d += A . B, m64n64k16: A in registers, B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d += A . B, m64n128k16: A in registers, B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d += A . B with A in registers and B in shared memory MN-major at `b`:
// 16 K rows of 128-byte-swizzled panels, `panel` bytes from one 64-column
// panel to the next. N is twice d's size: 64, 128, or 256 as two
// m64n128k16 products over panels 0-1 and 2-3.
template <int M>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[M],
                                            const uint32_t (&a)[4],
                                            uint32_t b, uint32_t panel) {
  if constexpr (M <= 64) {
    wgmma_rs(d, a, desc(b, panel, kAtom));
  } else {
    static_assert(M == 128, "N is at most 256");
    wgmma_rs(reinterpret_cast<float(&)[64]>(d[0]), a, desc(b, panel, kAtom));
    wgmma_rs(reinterpret_cast<float(&)[64]>(d[64]), a,
             desc(b + 2 * panel, panel, kAtom));
  }
}

// A warp's 16 rows of an m64nN f32 accumulator fragment (N = 2 * NH; the
// warp's rows 16 w + l/4 + 8 r of the layout above), times mul[r], to
// `out` + `first` (element offsets; row stride d; columns col0 + 0..N)
// in bf16 or, with `f32`, in f32: through the warp's 2 KiB staging
// panel, 128 bytes of each row at a time (64 bf16 or 32 f32 columns).
// The fragment goes in as 4- or 8-byte pieces, 16-byte chunks XOR
// swizzled by row so that neither side conflicts on a bank, and leaves
// as one 16-byte store per chunk, a row's 128 bytes by 8 neighbouring
// lanes. Rows from `rows` on and columns from d on are not stored.
template <int NH>
__device__ __forceinline__ void store_rows(const float (&acc)[NH],
                                           const float (&mul)[2],
                                           uint32_t* staged, void* out,
                                           size_t first, int rows, int d,
                                           int col0, int f32, int lane) {
  const int qr = lane / 4;
  auto drain = [&](int pass, int per_pass, int elem) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = 4 * k + lane / 8, c = lane % 8;
      const int col = col0 + pass * 8 * per_pass + c * per_pass;
      const uint4 v = *reinterpret_cast<const uint4*>(
          staged + row * 32 + ((c ^ (row & 7)) * 4));
      if (row < rows && col < d)
        *reinterpret_cast<uint4*>(static_cast<char*>(out) +
                                  (first + (size_t)row * d + col) * elem) = v;
    }
    __syncwarp();
  };
  if (f32) {
#pragma unroll
    for (int p = 0; p < NH / 16; ++p) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 4 * p + c, row = qr + 8 * r;
          const int chunk = 2 * c + (lane % 4) / 2;
          *reinterpret_cast<float2*>(staged + row * 32 +
                                     ((chunk ^ (row & 7)) * 4) +
                                     (lane & 1) * 2) =
              make_float2(acc[4 * j + 2 * r] * mul[r],
                          acc[4 * j + 2 * r + 1] * mul[r]);
        }
      drain(p, 4, 4);
    }
  } else {
#pragma unroll
    for (int p = 0; p < NH / 32; ++p) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 8 * p + c, row = qr + 8 * r;
          staged[row * 32 + ((c ^ qr) * 4) + lane % 4] =
              pack_bf16(acc[4 * j + 2 * r] * mul[r],
                        acc[4 * j + 2 * r + 1] * mul[r]);
        }
      drain(p, 8, 2);
    }
  }
}

// d += A . B with A in shared memory K-major (descriptor `da`) and B in
// shared memory MN-major at `b`, as wgmma_rs_mn's: N = 64 or 128
template <int M>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[M], uint64_t da,
                                            uint32_t b, uint32_t panel) {
  static_assert(M <= 64, "N is at most 128");
  wgmma_ss<1>(d, da, desc(b, panel, kAtom), 1);
}

// global rows [r0, r1] x columns [c0, c1] all visible: no mask needed
__device__ __forceinline__ bool unmasked(const Args& a, int r0, int r1,
                                         int c0, int c1) {
  if (c1 >= a.tkv) return false;
  if (!a.causal || c1 < a.prefix) return true;
  return c1 <= r0 && (a.window == 0 || r1 - c0 < a.window);
}

// ---------------------------------------------------- B1 forward, bf16

// visible() as predicates and no branches, so that B1's softmax and B2's
// and B3's P on a masked tile stay one basic block (the f32 kernels keep
// visible())
__device__ __forceinline__ bool seen(const Args& a, int r, int c) {
  const bool band = (r >= c) & ((a.window == 0) | (r - c < a.window));
  return (c < a.tkv) & ((a.causal == 0) | (c < a.prefix) | band);
}

// the named barriers (`bar.sync` ids; 0 is __syncthreads') on which the
// two consumer warpgroups hand each other the tensor cores: warpgroup w
// waits on kPingPong + w and, once its products are issued, arrives on
// the other's
constexpr int kPingPong = 1;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers * 128)
               : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers * 128)
               : "memory");
}
// a named barrier of one warpgroup's 128 threads
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Pace probes of B1, built only by tools/flash_fwd_steps.py
// (-DB1_PACE=n), never by the port: 1 (copy) keeps the producer, every
// wait and release, the turns and the epilogue, and issues no product
// and no softmax; 2 (products) issues S and P V with the softmax cut to
// P's cast; 3 (softmax) runs the softmax on the fragment, issues no
// product and loads no K or V; 4 (no ping-pong) drops the named
// barriers; 5 (fixed) cuts every item's walk to zero tiles, leaving Q,
// the epilogue and the lse. Their outputs are not the function's.
#ifndef B1_PACE
#define B1_PACE 0
#endif
constexpr int kB1Pace = B1_PACE;

template <int HD> struct Fwd {
  // KV rows per ring stage: at HD 256 the 64-row tiles keep S (32 f32 a
  // thread) and P beside O (128) in the registers
  static constexpr int kBN = HD > 128 ? 64 : 128;
  // two stages, K and V released apart: K(it + 1) lands while S(it) and
  // P V(it - 1) run. At HD 128, Q and two stages of K and V take 160 KiB
  // and a third would not leave room for the epilogue's staging; at 256,
  // Q alone is 64 KiB
  static constexpr int kStages = 2;
  static constexpr int kPanels = HD / 64;
  static constexpr uint32_t kQWg = kPanels * kRows * kPanelRow;
  static constexpr uint32_t kKv = kPanels * kBN * kPanelRow;  // K or V
  // a warp's 16 output rows of one 64-column panel, staged for 16-byte
  // stores
  static constexpr uint32_t kStageOut = 16 * kPanelRow;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kConsumers * kQWg;
  static constexpr uint32_t kV = kK + kStages * kKv;
  static constexpr uint32_t kOut = kV + kStages * kKv;
  static constexpr uint32_t kBars = kOut + kConsumers * 4 * kStageOut;
  // q_full, q_empty, k_full[S], k_empty[S], v_full[S], v_empty[S]; +
  // slack to align the base to 1024
  static constexpr uint32_t kSmem = kBars + 8 * (2 + 4 * kStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "B1's tiles fit the shared memory");
};

// one work item of B1: q rows [i0, i0 + rows) of head bh (kTile rows at
// most), against KV tiles [lo, lo + n) of its KV head kvh
struct FwdTile {
  int bh, i0, rows, kvh, lo, n;
};

// Work item `i` of the longest-first order: the last q tiles of every
// head first (under a causal mask they see the most KV tiles), then the
// ones before them.
template <int kTile, int kBN>
__device__ __forceinline__ FwdTile fwd_tile(const Args& a, int i, int n_qt) {
  FwdTile w;
  const int bhs = a.b * a.h;
  w.bh = i % bhs;
  w.i0 = (n_qt - 1 - i / bhs) * kTile;
  w.rows = min(kTile, a.t - w.i0);
  w.kvh = (w.bh / a.h) * a.h_kv + (w.bh % a.h) / (a.h / a.h_kv);
  int hi;
  kv_tiles(a, a.row_offset + w.i0, a.row_offset + w.i0 + w.rows - 1, kBN,
           &w.lo, &hi);
  w.n = hi - w.lo;
  return w;
}

// B1 in bf16, replaces `_flash_kernel` (ops/attention.py:105). Persistent:
// gridDim.x CTAs (one per SM) walk the (128-row q tile, b * h) work
// items of the longest-first order with a stride of gridDim.x, so the
// walk is the same from run to run, needs no counter, and a graph can
// capture it. Consumer warpgroup w owns q rows [64 w, 64 w + 64) of each
// item. Per KV tile of kBN rows: S = Q K^T by wgmma from shared memory,
// the online softmax on the fragment, O *= alpha and O += P V with P from
// registers; the two warpgroups take turns on the tensor cores, so one's
// softmax runs under the other's products. Returns out (bf16) and the
// natural-log lse.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const Args a) {
  using L = Fwd<HD>;
  constexpr int kBN = L::kBN;
  constexpr int kS = L::kStages;
  constexpr int kTile = kConsumers * kRows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q_full = base + L::kBars;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const uint32_t bar_k_full = bar_q_empty + 8;      // + 8 s
  const uint32_t bar_k_empty = bar_k_full + 8 * kS;
  const uint32_t bar_v_full = bar_k_empty + 8 * kS;
  const uint32_t bar_v_empty = bar_v_full + 8 * kS;
  const int n_qt = (a.t + kTile - 1) / kTile;
  const int n_items = n_qt * a.b * a.h;
  // what the pace probes keep (all of it in the port's build)
  constexpr bool kProducts = kB1Pace != 1 && kB1Pace != 3;
  constexpr bool kSoftmax = kB1Pace != 1 && kB1Pace != 2;
  constexpr bool kRing = kB1Pace != 3 && kB1Pace != 5;
  constexpr bool kTurns = kB1Pace != 4;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, kConsumers * 4);         // one per warp
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar_k_full + 8 * s, 1);
      mbar_init(bar_k_empty + 8 * s, kConsumers * 4);
      mbar_init(bar_v_full + 8 * s, 1);
      mbar_init(bar_v_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int kv = 0;                     // KV tiles loaded, over all items
      int item = 0;                   // items loaded
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++item) {
        const FwdTile w = fwd_tile<kTile, kBN>(a, i, n_qt);
        // the next item's Q once both warpgroups are done with the last
        // one's (its last S), so it lands under the last P V and the
        // epilogue. q rows wholly past t are not loaded; their rows are
        // never stored
        if (item > 0) mbar_wait(bar_q_empty, (item - 1) & 1);
        const int live = (w.rows + kRows - 1) / kRows;
        mbar_expect(bar_q_full, live * L::kQWg);
        for (int h = 0; h < live; ++h)
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_3d(base + L::kQ + h * L::kQWg + p * kRows * kPanelRow,
                        &tm_q, bar_q_full, 64 * p, w.i0 + kRows * h, w.bh);
        for (int it = 0; it < (kRing ? w.n : 0); ++it, ++kv) {
          const int s = kv % kS;
          // the phase in which the consumers freed stage s
          const uint32_t freed = ((kv / kS) - 1) & 1;
          const int c0 = (w.lo + it) * kBN;
          if (kv >= kS) mbar_wait(bar_k_empty + 8 * s, freed);
          mbar_expect(bar_k_full + 8 * s, L::kKv);
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_3d(base + L::kK + s * L::kKv + p * kBN * kPanelRow,
                        &tm_k, bar_k_full + 8 * s, 64 * p, c0, w.kvh);
          if (kv >= kS) mbar_wait(bar_v_empty + 8 * s, freed);
          mbar_expect(bar_v_full + 8 * s, L::kKv);
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_3d(base + L::kV + s * L::kKv + p * kBN * kPanelRow,
                        &tm_v, bar_v_full + 8 * s, 64 * p, c0, w.kvh);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int qr = lane / 4, qc = 2 * (lane % 4);
    const uint32_t q_s = base + L::kQ + wg * L::kQWg;
    const float qk_scale = a.scale * kLog2e;
    // this warp's staging panel for the epilogue
    uint32_t* staged = reinterpret_cast<uint32_t*>(
        smem_raw + (base - smem_addr(smem_raw)) + L::kOut +
        (wg * 4 + warp) * L::kStageOut);

    // S = Q K^T of KV tile `kv` (over all items) into sc: issued and
    // committed, not waited. The register fences before wgmma.fence pin
    // every write to sc (the softmax's) above it, so ptxas has no reason
    // to add a warpgroup.arrive of its own between the products.
    auto issue_s = [&](float (&sc)[kBN / 2], int kv) {
      if constexpr (!kProducts) return;
      const uint32_t k_s = base + L::kK + (kv % kS) * L::kKv;
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off = (k / 4) * kRows * kPanelRow + (k % 4) * 32;
        const uint32_t koff = (k / 4) * kBN * kPanelRow + (k % 4) * 32;
        wgmma_ss(sc, desc(q_s + off, 16, kAtom), desc(k_s + koff, 16, kAtom),
                 k > 0);
      }
      wg_commit();
      fence_regs(sc);
    };
    // O += P V of KV tile `kv`: issued and committed, not waited; O's
    // rescale and P's rounding are pinned above the wgmma.fence likewise
    auto issue_pv = [&](float (&o)[HD / 2], uint32_t (&pa)[kBN / 16][4],
                        int kv) {
      if constexpr (!kProducts) return;
      const uint32_t v_s = base + L::kV + (kv % kS) * L::kKv;
      fence_regs(o);
      fence_regs(pa);
      wg_fence();
#pragma unroll
      for (int k = 0; k < kBN / 16; ++k)
        wgmma_rs_mn(o, pa[k], v_s + k * 16 * kPanelRow, kBN * kPanelRow);
      wg_commit();
      fence_regs(o);
      fence_regs(pa);
    };
    auto k_ready = [&](int kv) {
      if (kRing) mbar_wait(bar_k_full + 8 * (kv % kS), (kv / kS) & 1);
    };
    auto v_ready = [&](int kv) {
      if (kRing) mbar_wait(bar_v_full + 8 * (kv % kS), (kv / kS) & 1);
    };
    auto take_turn = [&] { if (kTurns) named_sync(kPingPong + wg); };
    auto hand_over = [&] { if (kTurns) named_arrive(kPingPong + 1 - wg); };

    // warpgroup 0 takes the tensor cores first
    if (wg == 1 && kTurns) named_arrive(kPingPong);
    int kv = 0;                       // KV tiles consumed, over all items
    int item = 0;                     // items consumed
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++item) {
      const FwdTile w = fwd_tile<kTile, kBN>(a, i, n_qt);
      const int n = kB1Pace == 5 ? 0 : w.n;
      const int r0 = a.row_offset + w.i0 + kRows * wg;  // first global row
      const int rw = r0 + 16 * warp + qr;               // this thread's row

      float o[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

      // online softmax in base 2 on the fragment of the item's KV tile
      // `it`: sc becomes P, m and l move on, and alpha is what rescales
      // O. Masked scores take a fill below the m sentinel so they give
      // exp2(...) == 0.
      auto softmax = [&](float (&sc)[kBN / 2], int it, float (&alpha)[2]) {
        alpha[0] = alpha[1] = 1.f;
        if constexpr (!kSoftmax) return;
        const int c0 = (w.lo + it) * kBN;
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) sc[j] *= qk_scale;
        if (!unmasked(a, r0, r0 + kRows - 1, c0, c0 + kBN - 1)) {
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!seen(a, rw + 8 * (e / 2), c0 + 8 * j + qc + e % 2))
                sc[4 * j + e] = 2.f * kNegInf;
        }
        float mx[2] = {2.f * kNegInf, 2.f * kNegInf};
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          alpha[r] = ex2(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(sc[4 * j + e] - m[e / 2]);
            sc[4 * j + e] = p;
            sum[e / 2] += p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
      };
      auto rescale = [&](const float (&alpha)[2]) {
        if constexpr (!kSoftmax) return;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
      };

      // Per KV tile `it` the warpgroup waits for its tiles, takes its
      // turn (named_sync), issues S(it) and, after O's rescale, O +=
      // P(it - 1) V(it - 1), and hands the turn over; then it waits only
      // for S(it), releases K(it) (and Q after the item's last S), runs
      // softmax(it) beside the P V product and the other warpgroup's
      // products, and releases V(it - 1) once its product is done. Each
      // product is waited for in the iteration that issued it (a wait
      // across the loop's back edge makes ptxas serialise every wgmma).
      // The first tile is peeled and releases are predicated, not
      // branched, so no branch separates a product from its wait.
      float sc[kBN / 2];
      uint32_t pa[kBN / 16][4];
      float alpha[2];
      if constexpr (!kProducts) {     // the probes' scores: no product
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) sc[j] = 0.f;
      }
      mbar_wait(bar_q_full, item & 1);
      mbar_arrive_if(bar_q_empty, lane == 0 && n == 0);
      if (n > 0) {
        k_ready(kv);
        take_turn();
        issue_s(sc, kv);
        hand_over();
        wg_wait<0>();
        fence_regs(sc);
        mbar_arrive_if(bar_k_empty + 8 * (kv % kS), kRing && lane == 0);
        mbar_arrive_if(bar_q_empty, lane == 0 && n == 1);
        softmax(sc, 0, alpha);
        if (kB1Pace != 1) to_a_operand<kBN>(sc, pa);
      }
      for (int it = 1; it < n; ++it) {
        k_ready(kv + it);
        v_ready(kv + it - 1);
        take_turn();
        issue_s(sc, kv + it);
        rescale(alpha);
        issue_pv(o, pa, kv + it - 1);
        hand_over();
        wg_wait<1>();                 // S(it) is done, P V may still run
        fence_regs(sc);
        mbar_arrive_if(bar_k_empty + 8 * ((kv + it) % kS),
                       kRing && lane == 0);
        mbar_arrive_if(bar_q_empty, lane == 0 && it == n - 1);
        softmax(sc, it, alpha);
        fence_regs(sc);
        wg_wait<0>();
        fence_regs(o);
        fence_regs(pa);               // P(it - 1) stays put until here
        fence_regs(sc);
        mbar_arrive_if(bar_v_empty + 8 * ((kv + it - 1) % kS),
                       kRing && lane == 0);
        if (kB1Pace != 1) to_a_operand<kBN>(sc, pa);
      }
      if (n > 0) {
        v_ready(kv + n - 1);
        rescale(alpha);
        issue_pv(o, pa, kv + n - 1);
        wg_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive_if(bar_v_empty + 8 * ((kv + n - 1) % kS),
                       kRing && lane == 0);
      }
      kv += n;

      // out = O / l through the warp's staging panel (store_rows); lse
      // straight from the fragment
      const int q0 = w.i0 + kRows * wg + 16 * warp;   // the warp's first row
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float li = fmaxf(quad_sum(l[r]), 1e-30f);
        inv[r] = 1.f / li;
        const int qi = q0 + qr + 8 * r;
        if (a.lse_out != nullptr && lane % 4 == 0 && qi < a.t)
          a.lse_out[(size_t)w.bh * a.t + qi] = (m[r] + log2f(li)) / kLog2e;
      }
      store_rows(o, inv, staged, a.out, ((size_t)w.bh * a.t + q0) * a.d,
                 a.t - q0, a.d, 0, 0, lane);
    }
  }
}

// ------------------------------------------------------ B3 dk/dv, bf16

template <int HD> struct Dkv {
  static constexpr int kBQ = 64;            // q rows per ring stage
  // up to HD 128 each consumer warpgroup owns 64 KV rows of a 128-row
  // tile, all of the head dim; at HD 256 the CTA owns 64 KV rows and each
  // warpgroup half of the head dim of them (dK and dV of 64 x 256 would
  // take 256 f32 registers a thread)
  static constexpr bool kSplit = HD > 128;
  // q rows of a tile whose scores a warpgroup computes: at HD 256 each
  // takes half, so that no product is computed twice
  static constexpr int kQw = kSplit ? kBQ / kConsumers : kBQ;
  // three stages up to HD 128: the pipelined walk holds tiles it - 1 (for
  // dV and dK) and it (for S^T and dP^T) while the producer fills the
  // next; at HD 256 two fit
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kPanels = HD / 64;
  static constexpr int kHdWg = kSplit ? HD / kConsumers : HD;
  static constexpr int kKvBlocks = kSplit ? 1 : kConsumers;  // 64-row ones
  static constexpr int kCols = kKvBlocks * kRows;            // KV rows a CTA
  static constexpr uint32_t kKvWg = kPanels * kRows * kPanelRow;  // K or V
  static constexpr uint32_t kQt = kPanels * kBQ * kPanelRow;      // Q or dO
  static constexpr uint32_t kRowVec = kBQ * 4;                    // lse or D
  // lse and D padded so that every stage starts on a 1024-byte swizzle
  // atom, as the swizzled tiles need; the mbarriers (kv, full[S],
  // empty[S]) live in the first stage's pad
  static constexpr uint32_t kStage = 2 * kQt + 1024;
  static constexpr uint32_t kLoaded = 2 * kQt + 2 * kRowVec;  // per stage
  static_assert(2 * kRowVec + 8 * (1 + 2 * kStages) <= 1024,
                "lse, D and the barriers fit the pad");
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kKvBlocks * kKvWg;
  static constexpr uint32_t kRing = kV + kKvBlocks * kKvWg;
  static constexpr uint32_t kBars = kRing + 2 * kQt + 2 * kRowVec;
  // 32 KiB past the ring. Up to HD 128: the epilogue's staging (a warp's
  // 16 rows of one 128-byte column block, 8 warps: 16 KiB), then each
  // warpgroup's dS^T as a 64 x 64 panel, 128-byte swizzled as a TMA tile:
  // the A operand of dK += dS^T Q read from shared memory, so that the
  // pipelined walk needs no dS^T registers. At HD 256: the bf16 P^T and
  // dS^T operands of each warpgroup's half of the tile, for the other
  // warpgroup, as fragments (each thread's values where the same thread
  // of the other reads them), in two buffers by the tile's parity; the
  // staging after the walk.
  static constexpr uint32_t kX = kRing + kStages * kStage;
  static constexpr uint32_t kStageOut = 16 * kPanelRow;
  static constexpr uint32_t kDs = kX + kConsumers * 4 * kStageOut;
  static constexpr uint32_t kDsPanel = kRows * kPanelRow;
  static constexpr uint32_t kTrade = 2 * (kQw / 16) * 4 * 4 * 128;  // bytes
  static_assert(kSplit ? 2 * kConsumers * kTrade == 32768
                       : kDs + kConsumers * kDsPanel == kX + 32768,
                "32 KiB past the ring");
  static constexpr uint32_t kSmem = kX + 32768 + 1024;  // + base alignment
  static_assert(kSmem <= kMaxSmem, "B3's tiles fit the shared memory");
};

// B3 in bf16, replaces `_flash_bwd_dkv_kernel` (ops/attention.py:635).
// One CTA per (kCols-row KV tile, b * h_kv); the CTA walks every head of
// its GQA group and the q tiles that can see its columns, and keeps dK
// and dV in registers: no atomics, the same result from run to run. Per
// q tile: S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory, P^T
// and dS^T = P^T (dP^T - D) on the fragments, then dV += P^T dO and dK
// += dS^T Q. Up to HD 128 consumer warpgroup w owns KV rows [64 w, 64 w
// + 64) of the tile, P^T is the register A operand and dS^T is read from
// the warpgroup's panel in shared memory. At HD 256 the two warpgroups
// share the tile's 64 KV rows: warpgroup w computes the scores of q rows
// [32 w, 32 w + 32) of each q tile, the two trade their bf16 P^T and
// dS^T halves through shared memory (one named barrier a tile), and each
// multiplies its half of the head dim of dV and dK over all 64 q rows.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_lse,
                              const __grid_constant__ CUtensorMap tm_dd,
                              const Args a) {
  using L = Dkv<HD>;
  constexpr int kBQ = L::kBQ;
  constexpr int kQw = L::kQw;
  constexpr int kS = L::kStages;
  // named barriers: the two warpgroups' trade (HD 256), and each
  // warpgroup's threads having written its dS^T panel (up to 128)
  constexpr int kTraded = 1, kPanelDone = 2;        // + wg
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_kv = base + L::kBars;
  const uint32_t bar_full = bar_kv + 8;             // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kS;

  const int kvh = blockIdx.x;                       // b * h_kv + kv head
  const int c0 = blockIdx.y * L::kCols;             // longest causal first
  const int cols = min(L::kCols, a.tkv - c0);
  const int group = a.h / a.h_kv;
  const int bb = kvh / a.h_kv;
  const int hk = kvh - bb * a.h_kv;
  int lo, hi;
  q_tiles(a, c0, c0 + cols - 1, kBQ, &lo, &hi);
  const int tiles = hi - lo;
  const int n = group * tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      // KV rows wholly past tkv are not loaded; they are never stored
      const int live = (cols + kRows - 1) / kRows;
      mbar_expect(bar_kv, 2 * live * L::kKvWg);
      for (int w = 0; w < live; ++w)
        for (int p = 0; p < L::kPanels; ++p) {
          const uint32_t off = w * L::kKvWg + p * kRows * kPanelRow;
          tma_load_3d(base + L::kK + off, &tm_k, bar_kv, 64 * p,
                      c0 + kRows * w, kvh);
          tma_load_3d(base + L::kV + off, &tm_v, bar_kv, 64 * p,
                      c0 + kRows * w, kvh);
        }
      for (int it = 0; it < n; ++it) {
        const int s = it % kS;
        if (it >= kS) mbar_wait(bar_empty + 8 * s, ((it / kS) - 1) & 1);
        const int bh = bb * a.h + hk * group + it / tiles;
        const int i0 = (lo + it % tiles) * kBQ;
        const uint32_t st = base + L::kRing + s * L::kStage;
        const uint32_t bar = bar_full + 8 * s;
        mbar_expect(bar, L::kLoaded);
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_3d(st + p * kBQ * kPanelRow, &tm_q, bar, 64 * p, i0, bh);
          tma_load_3d(st + L::kQt + p * kBQ * kPanelRow, &tm_do, bar, 64 * p,
                      i0, bh);
        }
        // rows past t read the next head's (or zeros): always masked
        tma_load_2d(st + 2 * L::kQt, &tm_lse, bar, bh * a.t + i0, 0);
        tma_load_2d(st + 2 * L::kQt + L::kRowVec, &tm_dd, bar, bh * a.t + i0,
                    0);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int qr = lane / 4, qc = 2 * (lane % 4);
    const int blk = L::kSplit ? 0 : wg;               // the 64 KV rows
    const uint32_t k_s = base + L::kK + blk * L::kKvWg;
    const uint32_t v_s = base + L::kV + blk * L::kKvWg;
    const int cw = c0 + kRows * blk;                  // first KV column
    const int kc = cw + 16 * warp + qr;               // this thread's
    // the warpgroup's head-dim columns [col0, col0 + kHdWg) of dK and dV,
    // and their panels' offset in a Q or dO tile
    const int col0 = L::kSplit ? wg * L::kHdWg : 0;
    const uint32_t qpanel = (col0 / 64) * kBQ * kPanelRow;
    // the q rows of a tile whose scores this warpgroup computes, and (at
    // HD 256) the other warpgroup's
    const int qw = L::kSplit ? wg * kQw : 0;
    const int qo = L::kSplit ? (1 - wg) * kQw : 0;
    const float qk_scale = a.scale * kLog2e;
    unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
    uint32_t* staged = reinterpret_cast<uint32_t*>(
        smem + L::kX + (wg * 4 + warp) * L::kStageOut);
    // up to HD 128: this warpgroup's dS^T panel
    const uint32_t ds_s = base + L::kDs + wg * L::kDsPanel;
    uint32_t* ds_panel =
        reinterpret_cast<uint32_t*>(smem + L::kDs + wg * L::kDsPanel);
    // at HD 256: the trade's buffer of warpgroup w for tiles of parity p
    auto trade_buf = [&](int p, int w) {
      return reinterpret_cast<uint4*>(smem + L::kX +
                                      (2 * p + w) * L::kTrade) + t;
    };

    auto ready = [&](int it) {
      mbar_wait(bar_full + 8 * (it % kS), (it / kS) & 1);
    };
    auto release = [&](int it) {
      mbar_arrive_if(bar_empty + 8 * (it % kS), lane == 0);
    };
    auto stage = [&](int it) { return base + L::kRing + (it % kS) * L::kStage; };
    // lse and D of tile `it`'s q rows
    auto row_vecs = [&](int it) {
      return reinterpret_cast<const float*>(smem + L::kRing +
                                            (it % kS) * L::kStage +
                                            2 * L::kQt);
    };
    // A . B^T over the whole head dim into x: A the 64 KV rows at `ka`,
    // B the warpgroup's q rows of the tile at `qb` (both K-major), not
    // committed
    auto scores = [&](float (&x)[kQw / 2], uint32_t ka, uint32_t qb) {
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off = (k / 4) * kRows * kPanelRow + (k % 4) * 32;
        const uint32_t qoff =
            (k / 4) * kBQ * kPanelRow + qw * kPanelRow + (k % 4) * 32;
        wgmma_ss(x, desc(ka + off, 16, kAtom), desc(qb + qoff, 16, kAtom),
                 k > 0);
      }
    };
    // P^T = exp2(S^T scale log2e - lse log2e) in st and dS^T = P^T (dP^T
    // - D) in dpt, in place, f32, on the fragments (KV row kc + 8 (e / 2),
    // q row qw + 8 j + qc + e % 2); lse and D read once per row. Then the
    // mask as predicates under one uniform test of the tile: the pairs it
    // hides, and q rows past t, selected to 0 (p may be inf there)
    auto form = [&](float (&st)[kQw / 2], float (&dpt)[kQw / 2], int it) {
      const float* lse = row_vecs(it) + qw;
      const float* dd = lse + kBQ;
#pragma unroll
      for (int j = 0; j < kQw / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 8 * j + qc + c;
          const float l2 = lse[r] * kLog2e, dr = dd[r];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + c;
            st[e] = ex2(st[e] * qk_scale - l2);
            dpt[e] = st[e] * (dpt[e] - dr);
          }
        }
      const int i0 = (lo + it % tiles) * kBQ;
      const int g0 = a.row_offset + i0;
      if (!(i0 + kBQ <= a.t &&
            unmasked(a, g0, g0 + kBQ - 1, cw, cw + kRows - 1))) {
#pragma unroll
        for (int j = 0; j < kQw / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = qw + 8 * j + qc + e % 2;
            if (!((i0 + r < a.t) & seen(a, g0 + r, kc + 8 * (e / 2)))) {
              st[4 * j + e] = 0.f;
              dpt[4 * j + e] = 0.f;
            }
          }
      }
    };

    float dk[L::kHdWg / 2], dv[L::kHdWg / 2];
#pragma unroll
    for (int i = 0; i < L::kHdWg / 2; ++i) dk[i] = dv[i] = 0.f;
    // S^T and dP^T of the warpgroup's q rows; the A operands of its own
    // rows (P^T; dS^T at HD 256) and, at HD 256, of the other's
    constexpr int kOther = L::kSplit ? kQw / 16 : 1;
    float st[kQw / 2], dpt[kQw / 2];
    uint32_t pa[kQw / 16][4], dsa[kOther][4];
    uint32_t pa_o[kOther][4], dsa_o[kOther][4];

    auto fence_scores = [&]() {
      fence_regs(st);
      fence_regs(dpt);
    };
    // dV's and dK's accumulators and register operands
    auto fence_products = [&]() {
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      if constexpr (L::kSplit) {
        fence_regs(dsa);
        fence_regs(pa_o);
        fence_regs(dsa_o);
      }
    };
    // the scores of tile `it`, issued and committed
    auto issue_scores = [&](int it) {
      const uint32_t q_st = stage(it);
      scores(st, k_s, q_st);
      scores(dpt, v_s, q_st + L::kQt);
      wg_commit();
    };
    // dV += P^T dO and dK += dS^T Q of tile `it` (the warpgroup's
    // columns of dO and Q, MN-major; K = the q rows), issued and
    // committed
    auto issue_dkv = [&](int it) {
      const uint32_t q_st = stage(it) + qpanel;
      const uint32_t do_st = q_st + L::kQt;
#pragma unroll
      for (int k = 0; k < kQw / 16; ++k) {
        const uint32_t row = (qw + 16 * k) * kPanelRow;
        wgmma_rs_mn(dv, pa[k], do_st + row, kBQ * kPanelRow);
        if constexpr (L::kSplit)
          wgmma_rs_mn(dk, dsa[k], q_st + row, kBQ * kPanelRow);
        else
          wgmma_ss_mn(dk, desc(ds_s + k * 32, 16, kAtom), q_st + row,
                      kBQ * kPanelRow);
      }
      if constexpr (L::kSplit) {
#pragma unroll
        for (int k = 0; k < kQw / 16; ++k) {
          const uint32_t row = (qo + 16 * k) * kPanelRow;
          wgmma_rs_mn(dv, pa_o[k], do_st + row, kBQ * kPanelRow);
          wgmma_rs_mn(dk, dsa_o[k], q_st + row, kBQ * kPanelRow);
        }
      }
      wg_commit();
    };
    // once tile `it - 1`'s dV and dK are done: P^T and dS^T of tile `it`
    // rounded to the A operands; up to HD 128 dS^T goes to the panel, at
    // HD 256 the warpgroups trade theirs
    auto to_operands = [&](int it) {
      to_a_operand<kQw>(st, pa);
      if constexpr (!L::kSplit) {
        // row 16 warp + qr + 8 i, 16-byte chunk j XOR swizzled by the
        // row (its row mod 8 is qr)
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ds_panel[(16 * warp + qr + 8 * i) * 32 + ((j ^ qr) * 4) +
                     lane % 4] = pack_bf16(dpt[4 * j + 2 * i],
                                           dpt[4 * j + 2 * i + 1]);
        fence_proxy_async();        // before the wgmma that reads it
        wg_sync(kPanelDone + wg);
      } else {
        to_a_operand<kQw>(dpt, dsa);
        uint4* mine = trade_buf(it & 1, wg);
        const uint4* theirs = trade_buf(it & 1, 1 - wg);
#pragma unroll
        for (int k = 0; k < kQw / 16; ++k) {
          mine[(2 * k) * 128] = make_uint4(pa[k][0], pa[k][1], pa[k][2],
                                           pa[k][3]);
          mine[(2 * k + 1) * 128] = make_uint4(dsa[k][0], dsa[k][1],
                                               dsa[k][2], dsa[k][3]);
        }
        named_sync(kTraded);
#pragma unroll
        for (int k = 0; k < kQw / 16; ++k) {
          const uint4 p = theirs[(2 * k) * 128], d = theirs[(2 * k + 1) * 128];
          pa_o[k][0] = p.x;
          pa_o[k][1] = p.y;
          pa_o[k][2] = p.z;
          pa_o[k][3] = p.w;
          dsa_o[k][0] = d.x;
          dsa_o[k][1] = d.y;
          dsa_o[k][2] = d.z;
          dsa_o[k][3] = d.w;
        }
      }
    };

    // Software pipeline over the q walk, as B2's: the tensor cores get
    // the scores of tile it, then dV and dK of tile it - 1; the warpgroup
    // waits only for the scores, forms P^T and dS^T beside the dV and dK
    // products, and rounds them to the A operands once those are done.
    // Register operands are fenced above each wgmma.fence, each product
    // is waited for in the iteration that issued it, and releases are
    // predicated. At HD 256 the trade's buffers alternate by the tile's
    // parity: a warpgroup writes one only after the next trade's barrier,
    // which the other passes only once it has read it.
    mbar_wait(bar_kv, 0);
    if (n > 0) {
      ready(0);
      fence_scores();
      wg_fence();
      issue_scores(0);
      wg_wait<0>();
      fence_scores();
      form(st, dpt, 0);
      to_operands(0);
    }
    for (int it = 1; it < n; ++it) {
      ready(it);
      fence_scores();
      fence_products();
      wg_fence();
      issue_scores(it);
      issue_dkv(it - 1);
      wg_wait<1>();                 // the scores of tile it are in
      fence_scores();
      form(st, dpt, it);
      fence_scores();
      wg_wait<0>();
      fence_products();             // tile it - 1's operands stay put
      release(it - 1);
      to_operands(it);
    }
    if (n > 0) {
      fence_products();
      wg_fence();
      issue_dkv(n - 1);
      wg_wait<0>();
      fence_products();
      release(n - 1);
    }

    // dk = dS^T Q / sqrt(d) and dv through the warp's staging panel (at
    // HD 256 in the trade's buffers, once both warpgroups have read the
    // last trade)
    if constexpr (L::kSplit) named_sync(kTraded);
    const int r0 = cw + 16 * warp;                    // the warp's first row
    const size_t first = ((size_t)kvh * a.tkv + r0) * a.d;
    const float scale[2] = {a.scale, a.scale}, one[2] = {1.f, 1.f};
    store_rows(dk, scale, staged, a.dk, first, a.tkv - r0, a.d, col0,
               a.grad_f32, lane);
    store_rows(dv, one, staged, a.dv, first, a.tkv - r0, a.d, col0,
               a.grad_f32, lane);
  }
}

// ------------------------------------------------------------ B2 dq, bf16

template <int HD> struct Dq {
  // KV rows per ring stage: at HD 256, Q and dO of the two warpgroups
  // take 128 KiB, and 32-row K/V tiles let three stages fit beside them
  static constexpr int kBN = HD > 128 ? 32 : 64;
  // three stages: the pipelined walk holds tiles it - 1 (K, for dQ) and
  // it (K and V, for S and dP) while the producer fills the next
  static constexpr int kStages = 3;
  static constexpr int kPanels = HD / 64;
  static constexpr uint32_t kQWg = kPanels * kRows * kPanelRow;  // Q or dO
  static constexpr uint32_t kKv = kPanels * kBN * kPanelRow;     // K or V
  static constexpr uint32_t kRowVec = kConsumers * kRows * 4;    // lse or D
  // a warp's 16 rows of one 128-byte column block, staged for 16-byte
  // stores: in a panel of their own up to HD 128; at HD 256 in the
  // warpgroup's dO tile, whose last reader (dP) is done by then, so the
  // next item's Q and dO load only after the epilogue there
  static constexpr bool kOwnStaging = HD <= 128;
  static constexpr uint32_t kStageOut = 16 * kPanelRow;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kQ + kConsumers * kQWg;
  static constexpr uint32_t kLse = kDo + kConsumers * kQWg;
  static constexpr uint32_t kDd = kLse + kRowVec;
  // lse and D padded to a 1024-byte swizzle atom, as the K tiles need
  static constexpr uint32_t kK = kLse + 1024;
  static_assert(2 * kRowVec <= 1024, "lse and D fit the pad");
  static constexpr uint32_t kV = kK + kStages * kKv;
  static constexpr uint32_t kOut = kV + kStages * kKv;
  static constexpr uint32_t kBars =
      kOut + (kOwnStaging ? kConsumers * 4 * kStageOut : 0);
  // q_full, q_empty, full[S], empty[S]; + slack to align the base to 1024
  static constexpr uint32_t kSmem = kBars + 8 * (2 + 2 * kStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "B2's tiles fit the shared memory");
};

// B2 in bf16, replaces `_flash_bwd_dq_kernel` (ops/attention.py:528).
// Persistent, as B1: gridDim.x CTAs (one per SM) walk the (128-row q
// tile, b * h) work items of the longest-first order (fwd_tile) with a
// stride of gridDim.x. Consumer warpgroup w owns q rows [64 w, 64 w + 64)
// of each item and keeps their dQ in registers while the producer
// streams the KV tiles the rows can see, kBN rows at a time. Per KV
// tile: S = Q K^T and dP = dO V^T by wgmma from shared memory, P =
// exp2(S scale log2e - lse log2e) and dS = P (dP - D) on the fragments,
// then dQ += dS K with dS from registers and K read MN-major from the
// same swizzled tile.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_lse,
                             const __grid_constant__ CUtensorMap tm_dd,
                             const Args a) {
  using L = Dq<HD>;
  constexpr int kBN = L::kBN;
  constexpr int kS = L::kStages;
  constexpr int kTile = kConsumers * kRows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q_full = base + L::kBars;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full = bar_q_empty + 8;        // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kS;
  const int n_qt = (a.t + kTile - 1) / kTile;
  const int n_items = n_qt * a.b * a.h;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, kConsumers * 4);         // one per warp
    for (int s = 0; s < kS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int kv = 0;                     // KV tiles loaded, over all items
      int item = 0;                   // items loaded
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++item) {
        const FwdTile w = fwd_tile<kTile, kBN>(a, i, n_qt);
        // the next item's Q, dO, lse and D once both warpgroups are done
        // with the last one's. q rows wholly past t are not loaded; their
        // rows are never stored. lse and D of rows past t are the next
        // head's (or zeros): masked
        if (item > 0) mbar_wait(bar_q_empty, (item - 1) & 1);
        const int live = (w.rows + kRows - 1) / kRows;
        mbar_expect(bar_q_full, 2 * live * L::kQWg + 2 * L::kRowVec);
        for (int h = 0; h < live; ++h)
          for (int p = 0; p < L::kPanels; ++p) {
            const uint32_t off = h * L::kQWg + p * kRows * kPanelRow;
            tma_load_3d(base + L::kQ + off, &tm_q, bar_q_full, 64 * p,
                        w.i0 + kRows * h, w.bh);
            tma_load_3d(base + L::kDo + off, &tm_do, bar_q_full, 64 * p,
                        w.i0 + kRows * h, w.bh);
          }
        tma_load_2d(base + L::kLse, &tm_lse, bar_q_full, w.bh * a.t + w.i0,
                    0);
        tma_load_2d(base + L::kDd, &tm_dd, bar_q_full, w.bh * a.t + w.i0, 0);
        for (int it = 0; it < w.n; ++it, ++kv) {
          const int s = kv % kS;
          if (kv >= kS) mbar_wait(bar_empty + 8 * s, ((kv / kS) - 1) & 1);
          const int c0 = (w.lo + it) * kBN;
          const uint32_t bar = bar_full + 8 * s;
          mbar_expect(bar, 2 * L::kKv);
          for (int p = 0; p < L::kPanels; ++p) {
            const uint32_t off = s * L::kKv + p * kBN * kPanelRow;
            tma_load_3d(base + L::kK + off, &tm_k, bar, 64 * p, c0, w.kvh);
            tma_load_3d(base + L::kV + off, &tm_v, bar, 64 * p, c0, w.kvh);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int qr = lane / 4, qc = 2 * (lane % 4);
    const uint32_t q_s = base + L::kQ + wg * L::kQWg;
    const uint32_t do_s = base + L::kDo + wg * L::kQWg;
    const int lr = kRows * wg + 16 * warp + qr;       // this thread's rows
    const float qk_scale = a.scale * kLog2e;
    const float* vecs = reinterpret_cast<const float*>(
        smem_raw + (base - smem_addr(smem_raw)) + L::kLse);
    // this warp's staging panel for the epilogue
    uint32_t* staged = reinterpret_cast<uint32_t*>(
        smem_raw + (base - smem_addr(smem_raw)) +
        (L::kOwnStaging ? L::kOut + (wg * 4 + warp) * L::kStageOut
                        : L::kDo + wg * L::kQWg + warp * L::kStageOut));

    auto ready = [&](int kv) {
      mbar_wait(bar_full + 8 * (kv % kS), (kv / kS) & 1);
    };
    // S = Q K^T and dP = dO V^T of KV tile `kv` (over all items), issued
    // and committed
    auto issue_sdp = [&](float (&sc)[kBN / 2], float (&dp)[kBN / 2], int kv) {
      const int s = kv % kS;
      const uint32_t k_s = base + L::kK + s * L::kKv;
      const uint32_t v_s = base + L::kV + s * L::kKv;
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off = (k / 4) * kRows * kPanelRow + (k % 4) * 32;
        const uint32_t koff = (k / 4) * kBN * kPanelRow + (k % 4) * 32;
        wgmma_ss(sc, desc(q_s + off, 16, kAtom), desc(k_s + koff, 16, kAtom),
                 k > 0);
      }
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off = (k / 4) * kRows * kPanelRow + (k % 4) * 32;
        const uint32_t koff = (k / 4) * kBN * kPanelRow + (k % 4) * 32;
        wgmma_ss(dp, desc(do_s + off, 16, kAtom), desc(v_s + koff, 16, kAtom),
                 k > 0);
      }
      wg_commit();
    };
    auto release = [&](int kv) {
      mbar_arrive_if(bar_empty + 8 * (kv % kS), lane == 0);
    };

    int kv = 0;                       // KV tiles consumed, over all items
    int item = 0;                     // items consumed
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++item) {
      const FwdTile w = fwd_tile<kTile, kBN>(a, i, n_qt);
      const int n = w.n;
      const int r0 = a.row_offset + w.i0 + kRows * wg;  // first global row
      const bool rows_in = w.i0 + kRows * (wg + 1) <= a.t;

      float dq[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) dq[j] = 0.f;

      // lse (in base 2) and D of rows lr and lr + 8, their global rows,
      // and whether they lie before t
      mbar_wait(bar_q_full, item & 1);
      float lse2[2], dd[2];
      int rg[2];
      bool row_in[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = vecs[lr + 8 * r] * kLog2e;
        dd[r] = vecs[kTile + lr + 8 * r];
        rg[r] = a.row_offset + w.i0 + lr + 8 * r;
        row_in[r] = w.i0 + lr + 8 * r < a.t;
      }
      mbar_arrive_if(bar_q_empty, lane == 0 && n == 0 && L::kOwnStaging);

      // dQ += dS K of KV tile `kv`, issued and committed
      auto issue_dq = [&](const uint32_t (&dsa)[kBN / 16][4], int kv) {
        const uint32_t k_s = base + L::kK + (kv % kS) * L::kKv;
#pragma unroll
        for (int k = 0; k < kBN / 16; ++k)
          wgmma_rs_mn(dq, dsa[k], k_s + k * 16 * kPanelRow, kBN * kPanelRow);
        wg_commit();
      };
      // P and dS = P (dP - D) into dp, on the fragments of the item's KV
      // tile `it`: row lr + 8 r, column c0 + 8 j + qc + e % 2. The mask
      // is predicates under one uniform test of the tile: dS is selected
      // to 0 where it hides the pair and on rows past t (p may be inf
      // there, and a row past t may hold the last item's data)
      auto form_ds = [&](const float (&sc)[kBN / 2], float (&dp)[kBN / 2],
                         int it) {
        const int c0 = (w.lo + it) * kBN;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(sc[4 * j + e] * qk_scale - lse2[e / 2]);
            dp[4 * j + e] = p * (dp[4 * j + e] - dd[e / 2]);
          }
        if (!(rows_in && unmasked(a, r0, r0 + kRows - 1, c0, c0 + kBN - 1))) {
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!(row_in[e / 2] & seen(a, rg[e / 2], c0 + 8 * j + qc + e % 2)))
                dp[4 * j + e] = 0.f;
        }
      };

      // Software pipeline over the KV walk: the tensor cores get S(it)
      // and dP(it), then dQ += dS(it - 1) K(it - 1); the warpgroup waits
      // only for the first two, forms dS(it) beside the dQ product, and
      // rounds it to the A operand once that product is done. Every
      // register operand is fenced above its wgmma.fence (so ptxas
      // injects no warpgroup.arrive), the wait for a tile's data comes
      // before it, each product is waited for in the iteration that
      // issued it, and releases are predicated, not branched. Q and dO
      // are released after the item's last S and dP.
      float sc[kBN / 2], dp[kBN / 2];
      uint32_t dsa[kBN / 16][4];
      if (n > 0) {
        ready(kv);
        fence_regs(sc);
        fence_regs(dp);
        wg_fence();
        issue_sdp(sc, dp, kv);
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        mbar_arrive_if(bar_q_empty, lane == 0 && n == 1 && L::kOwnStaging);
        form_ds(sc, dp, 0);
        to_a_operand<kBN>(dp, dsa);
      }
      for (int it = 1; it < n; ++it) {
        ready(kv + it);
        fence_regs(sc);
        fence_regs(dp);
        fence_regs(dq);
        fence_regs(dsa);
        wg_fence();
        issue_sdp(sc, dp, kv + it);
        issue_dq(dsa, kv + it - 1);
        wg_wait<1>();                 // S(it), dP(it) done; dQ may still run
        fence_regs(sc);
        fence_regs(dp);
        mbar_arrive_if(bar_q_empty,
                       lane == 0 && it == n - 1 && L::kOwnStaging);
        form_ds(sc, dp, it);
        fence_regs(dp);
        wg_wait<0>();
        fence_regs(dq);
        fence_regs(dsa);              // dS(it - 1) stays put until here
        release(kv + it - 1);
        to_a_operand<kBN>(dp, dsa);
      }
      if (n > 0) {
        fence_regs(dq);
        fence_regs(dsa);
        wg_fence();
        issue_dq(dsa, kv + n - 1);
        wg_wait<0>();
        fence_regs(dq);
        fence_regs(dsa);
        release(kv + n - 1);
      }
      kv += n;

      // dq = dS K / sqrt(d) through the warp's staging panel
      const int q0 = w.i0 + kRows * wg + 16 * warp;   // the warp's first row
      const float scale[2] = {a.scale, a.scale};
      store_rows(dq, scale, staged, a.dq, ((size_t)w.bh * a.t + q0) * a.d,
                 a.t - q0, a.d, 0, a.grad_f32, lane);
      if constexpr (!L::kOwnStaging) {
        fence_proxy_async();          // the staging before the next dO
        __syncwarp();
        mbar_arrive_if(bar_q_empty, lane == 0);
      }
    }
  }
}

}  // namespace sm90

// --------------------------------------------------------------- launch

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int launch_fwd(const Args& a, cudaStream_t s) {
  const size_t smem = FwdLayout<T>(a.d).total;
  if (int e = prepare(flash_fwd_kernel<T>, smem)) return e;
  const dim3 grid(a.b * a.h, (a.t + Cfg<T>::kB - 1) / Cfg<T>::kB);
  flash_fwd_kernel<T><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const Args& a, cudaStream_t s) {
  const size_t smem = DqLayout<T>(a.d).total;
  if (int e = prepare(flash_bwd_dq_kernel<T>, smem)) return e;
  const dim3 grid(a.b * a.h, (a.t + Cfg<T>::kB - 1) / Cfg<T>::kB);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const Args& a, cudaStream_t s) {
  const size_t smem = DkvLayout<T>(a.d).total;
  if (int e = prepare(flash_bwd_dkv_kernel<T>, smem)) return e;
  const dim3 grid(a.b * a.h_kv, (a.tkv + Cfg<T>::kB - 1) / Cfg<T>::kB);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- TMA descriptors

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [heads, rows, d] bf16 tensor read as boxes of 64 columns x `box`
// rows of one head, 128-byte swizzled; out-of-range rows and columns
// arrive as zeros
int rows_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
             int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t boxes[3] = {64, (cuuint32_t)box, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, boxes, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a flat f32 vector of n read as boxes of `box` values (a 2-D map of
// one row: its stride is never stepped)
int vec_map(CUtensorMap* map, const float* ptr, size_t n, int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {(cuuint64_t)n, 1};
  const cuuint64_t strides[1] = {((cuuint64_t)n * 4 + 15) / 16 * 16};
  const cuuint32_t boxes[2] = {(cuuint32_t)box, 1};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(ptr), dims, strides, boxes, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the current device's SM count, B1's grid: one persistent CTA per SM.
// Read once per device, so that a launch under graph capture makes no
// query of its own.
int sm_count(int* n) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && known[dev] > 0) {
    *n = known[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64) known[dev] = *n;
  return (int)e;
}

template <int HD>
int launch_fwd_sm90(const Args& a, cudaStream_t s) {
  using L = sm90::Fwd<HD>;
  CUtensorMap tq, tk, tv;
  if (int e = rows_map(&tq, a.q, a.d, a.t, a.b * a.h, sm90::kRows)) return e;
  if (int e = rows_map(&tk, a.k, a.d, a.tkv, a.b * a.h_kv, L::kBN)) return e;
  if (int e = rows_map(&tv, a.v, a.d, a.tkv, a.b * a.h_kv, L::kBN)) return e;
  if (int e = prepare(sm90::flash_fwd_kernel_sm90<HD>, L::kSmem)) return e;
  constexpr int kTile = sm90::kConsumers * sm90::kRows;
  const int items = a.b * a.h * ((a.t + kTile - 1) / kTile);
  int sms = 0;
  if (int e = sm_count(&sms)) return e;
  sm90::flash_fwd_kernel_sm90<HD>
      <<<std::min(items, sms), sm90::kThreads, L::kSmem, s>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq_sm90(const Args& a, cudaStream_t s) {
  using L = sm90::Dq<HD>;
  constexpr int kTile = sm90::kConsumers * sm90::kRows;
  CUtensorMap tq, tdo, tk, tv, tlse, tdd;
  const size_t rows = (size_t)a.b * a.h * a.t;
  if (int e = rows_map(&tq, a.q, a.d, a.t, a.b * a.h, sm90::kRows)) return e;
  if (int e = rows_map(&tdo, a.dout, a.d, a.t, a.b * a.h, sm90::kRows))
    return e;
  if (int e = rows_map(&tk, a.k, a.d, a.tkv, a.b * a.h_kv, L::kBN)) return e;
  if (int e = rows_map(&tv, a.v, a.d, a.tkv, a.b * a.h_kv, L::kBN)) return e;
  if (int e = vec_map(&tlse, a.lse_in, rows, kTile)) return e;
  if (int e = vec_map(&tdd, a.dd, rows, kTile)) return e;
  if (int e = prepare(sm90::flash_bwd_dq_kernel_sm90<HD>, L::kSmem)) return e;
  const int items = a.b * a.h * ((a.t + kTile - 1) / kTile);
  int sms = 0;
  if (int e = sm_count(&sms)) return e;
  sm90::flash_bwd_dq_kernel_sm90<HD>
      <<<std::min(items, sms), sm90::kThreads, L::kSmem, s>>>(
          tq, tdo, tk, tv, tlse, tdd, a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv_sm90(const Args& a, cudaStream_t s) {
  using L = sm90::Dkv<HD>;
  CUtensorMap tq, tdo, tk, tv, tlse, tdd;
  const size_t rows = (size_t)a.b * a.h * a.t;
  if (int e = rows_map(&tq, a.q, a.d, a.t, a.b * a.h, L::kBQ)) return e;
  if (int e = rows_map(&tdo, a.dout, a.d, a.t, a.b * a.h, L::kBQ)) return e;
  if (int e = rows_map(&tk, a.k, a.d, a.tkv, a.b * a.h_kv, sm90::kRows))
    return e;
  if (int e = rows_map(&tv, a.v, a.d, a.tkv, a.b * a.h_kv, sm90::kRows))
    return e;
  if (int e = vec_map(&tlse, a.lse_in, rows, L::kBQ)) return e;
  if (int e = vec_map(&tdd, a.dd, rows, L::kBQ)) return e;
  if (int e = prepare(sm90::flash_bwd_dkv_kernel_sm90<HD>, L::kSmem)) return e;
  const dim3 grid(a.b * a.h_kv, (a.tkv + L::kCols - 1) / L::kCols);
  sm90::flash_bwd_dkv_kernel_sm90<HD>
      <<<grid, sm90::kThreads, L::kSmem, s>>>(tq, tdo, tk, tv, tlse, tdd, a);
  return (int)cudaGetLastError();
}

Args make_args(int b, int h, int h_kv, int t, int tkv, int d, int causal,
               int window, int row_offset, int prefix) {
  Args a = {};
  a.b = b;
  a.h = h;
  a.h_kv = h_kv;
  a.t = t;
  a.tkv = tkv;
  a.d = d;
  a.causal = causal;
  a.window = window;
  a.row_offset = row_offset;
  a.prefix = prefix;
  a.scale = 1.0f / sqrtf((float)d);
  return a;
}

// the bf16 instantiation for the head dim: the narrowest that holds d
int launch_sm90(int (*hd64)(const Args&, cudaStream_t),
                int (*hd128)(const Args&, cudaStream_t),
                int (*hd256)(const Args&, cudaStream_t), const Args& a,
                cudaStream_t s) {
  if (a.d <= 64) return hd64(a, s);
  if (a.d <= 128) return hd128(a, s);
  return hd256(a, s);
}

int check_shape(int b, int h, int h_kv, int t, int tkv, int d) {
  if (b <= 0 || h <= 0 || h_kv <= 0 || h % h_kv || t <= 0 || tkv <= 0 ||
      d <= 0 || d % 16 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window/prefix 0 = none. lse may be
// null (not written). Each returns a cudaError_t (0 = success).
extern "C" int flash_attention_forward_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int b, int h, int h_kv, int t, int tkv, int d, int causal,
    int window, int row_offset, int prefix, void* stream) {
  if (int e = check_shape(b, h, h_kv, t, tkv, d)) return e;
  Args a = make_args(b, h, h_kv, t, tkv, d, causal, window, row_offset,
                     prefix);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(a, s);
  if (dtype == 1)
    return launch_sm90(launch_fwd_sm90<64>, launch_fwd_sm90<128>,
                       launch_fwd_sm90<256>, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_backward_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dq, int b, int h, int h_kv, int t,
    int tkv, int d, int causal, int window, int row_offset, int prefix,
    int grad_f32, void* stream) {
  if (int e = check_shape(b, h, h_kv, t, tkv, d)) return e;
  Args a = make_args(b, h, h_kv, t, tkv, d, causal, window, row_offset,
                     prefix);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.dq = dq;
  a.grad_f32 = grad_f32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dq<float>(a, s);
  if (dtype == 1)
    return launch_sm90(launch_dq_sm90<64>, launch_dq_sm90<128>,
                       launch_dq_sm90<256>, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_backward_dkv_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dk, void* dv, int b, int h,
    int h_kv, int t, int tkv, int d, int causal, int window, int row_offset,
    int prefix, int grad_f32, void* stream) {
  if (int e = check_shape(b, h, h_kv, t, tkv, d)) return e;
  Args a = make_args(b, h, h_kv, t, tkv, d, causal, window, row_offset,
                     prefix);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.dk = dk;
  a.dv = dv;
  a.grad_f32 = grad_f32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dkv<float>(a, s);
  if (dtype == 1)
    return launch_sm90(launch_dkv_sm90<64>, launch_dkv_sm90<128>,
                       launch_dkv_sm90<256>, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
