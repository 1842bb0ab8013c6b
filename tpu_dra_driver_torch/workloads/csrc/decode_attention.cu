// Flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_kernel` of
// tpu_dra_driver/workloads/ops/decode_attention.py (launched by its
// `flash_decode_attention`): single-query decode attention over a
// contiguous KV cache, with visibility `slot <= pos` for one scalar pos.
//
//   q       [b, h, 1, hd]        bf16 or f32
//   k, v    [b, h_kv, L, hd]     q's dtype, or int8 codes
//   ks, vs  [b, h_kv, L]         f32 per-slot scales (int8 caches only)
//   pos     a host int, or an int32 on the device that the kernel reads
//   out     [b, h, 1, hd]        q's dtype
//   part    [b * h_kv, n_split, rep, hd + 2]  f32 scratch: each split's
//                                partial acc, m and l (n_split > 1)
//
// Semantics follow the TPU kernel: scores accumulate in f32 with K in
// q's dtype (int8 codes widen exactly), the per-slot K scale multiplies
// the score before the softmax scale 1/sqrt(hd), l sums the unscaled
// probabilities, which are then multiplied by the per-slot V scale and
// rounded to q's dtype for the P.V product, and acc / l comes last. Only
// the slots [0, n_live) with n_live = min(pos + 1, L) are visible (all L
// of them once a ring has wrapped), and only those are read.
//
// Bound on this card: bytes. Each live K and V row (and its scales) is
// read once, n_live * h_kv * hd * (2 * sizeof(cache) + 8 / hd) bytes per
// sequence, against 4 * rep * hd operations per slot and KV head: about
// one operation per byte, far below the H100's ~295 operations per byte
// of bf16 tensor work. So the design is about bytes in flight and few
// instructions per byte: on the H100 the FMA kernel below, given the
// full-width bf16 read, is paced by its inner loop (an int8 cache no
// faster than bf16), so bf16 queries take the tensor cores, though a
// fragment wastes half of them on absent query rows.
//
// Design.
// - Grid (n_split, h_kv, b * n_pass) from L, b * h_kv and the SM count
//   only, never from pos (about two CTAs per SM, one for bf16 queries
//   past hd 128), so a launch can be captured in a CUDA graph and
//   replayed at any position. Each CTA reads pos itself (from the device
//   when `pos_dev` is given), takes n_live = min(pos + 1, L), and covers
//   a balanced run of whole 64-slot tiles of the live range
//   (`split_tiles`, the partition that `decode_partition` in
//   ops/decode_attention.py mirrors). A CTA whose run is empty writes the
//   neutral state (m = -1e30, l = 0, acc = 0).
// - One producer thread streams its run's K and V tiles (and their
//   scales) with 1-D bulk asynchronous copies into a ring of 1-4 stages
//   in shared memory, guarded by mbarriers; a run of slots of one (seq,
//   KV head) is contiguous, so a tile is one copy and no thread does
//   address arithmetic. A wait of over a second traps.
// - Four consumer warps share each tile, 16 slots a warp (a round),
//   with q, the online softmax state (m, l) and acc in registers for the
//   whole walk; the only block-wide barriers per tile are the ring
//   slot's mbarriers. Rows of larger GQA groups are split over the
//   warps and, past 4 warps' worth, over passes of the grid's z axis.
// - bf16 queries (over bf16 or int8 caches, every head dim) take the
//   tensor-core kernel: mma.sync m16n8k16 with the GQA group on the
//   narrow side, S^T = K Q^T and O^T += V^T P^T (mma_decode.cuh). Up to
//   hd 128 three CTAs share an SM, each with a ring of about 70 KiB.
//   At 256 (Gemma-class heads: a GQA group of 8, the n8 side exactly) a
//   64-slot K+V tile is 64 KiB and a thread holds 64 f32 of O^T, so one
//   CTA holds an SM with a ring of three stages (192 KiB; int8 four),
//   and `decode_n_split` plans one CTA per SM: each split's 2-3 tiles
//   are in flight at once, where at two CTAs per SM a split held one tile
//   and no copy overlapped any compute.
// - f32 queries take the FMA kernel: each lane owns one
//   16-byte piece of a cache row, LPS lanes a slot, so a warp reads
//   whole rows without bank conflicts; scores reduce by shuffles inside
//   a slot's lanes, which then all hold P for P.V. Exact in f32, as the
//   f32 tolerance needs (a tf32 or bf16 product would not be).
// - Slots past the run's end are excluded by select, never multiplied
//   by 0: a NaN in a stale ring slot or past pos cannot reach a sum.
// - At the end the warps of a CTA merge their (m, l, acc) once through
//   shared memory. A second kernel merges a row's splits: one warp per
//   query row, the splits' states loaded in groups of 8 and folded in
//   by the online rescaling, each weight exp(m_s - m) taken once per
//   split (an empty split weighs exp(-1e30 - m) = 0). It reads no
//   counters, so a graph can replay it. With one split the split kernel
//   writes the output itself and no merge is launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_decode.cuh"

namespace {

using namespace mma_decode;  // kRound, kNegInf, kMmaRows, the helpers

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;      // + the producer warp
constexpr int kTile = 64;                      // slots per ring stage
constexpr int kMaxStages = 4;
// ring bytes aimed for: two CTAs of the FMA kernel share an SM, three
// of the tensor-core kernel up to hd 128; past 128 one CTA of it holds
// an SM (3 stages of bf16 tiles, 4 of int8), as `decode_n_split` plans
constexpr size_t kFmaRingBytes = 100 * 1024;
constexpr size_t kMmaRingBytes = 70 * 1024;
constexpr size_t kMmaWideRingBytes = 192 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMergeWarps = 4;
constexpr int kMaxDevices = 64;   // per-device flags of the launch code

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T's precision, back in f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// one 16-byte piece of a cache row in shared memory, widened to f32
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <> struct Piece<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[4 * i + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xffu);
  }
};

// the consumer warps only (the producer warp may have left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The live tiles [*t0, *t1) of split `split` of `n_split`: the
// ceil(n_live / 64) tiles of the live range dealt out in balanced runs.
__host__ __device__ __forceinline__ void split_tiles(int n_live, int split,
                                                     int n_split, int* t0,
                                                     int* t1) {
  const int n_tiles = n_live > 0 ? (n_live + kTile - 1) / kTile : 0;
  *t0 = (int)((int64_t)split * n_tiles / n_split);
  *t1 = (int)((int64_t)(split + 1) * n_tiles / n_split);
}

// the arguments of a split kernel's launch
struct Args {
  const void* q;          // [b, h, 1, hd] TQ
  const void* k;          // [b, h_kv, L, hd] TC
  const void* v;
  const float* ks;        // [b, h_kv, L], or null (cache in q's dtype)
  const float* vs;
  const int* pos_dev;     // the position on the device, or null
  void* out;              // [b, h, 1, hd] TQ
  float* part;            // [b * h_kv, n_split, rep, hd + 2]
  int h_kv, rep, hd, L, pos_host, n_pass, stages;
  float sm_scale;
};

// What one CTA of a split kernel covers: (seq, KV head) `bh`, split
// `split` of `n_split`, its live tiles [tile0, tile1) ending at slot
// `slot_end`, and query rows [row0, row0 + rows) of the GQA group held
// by RG row groups of RB rows, each walked by SG warps (RG * SG = 4).
struct Work {
  int64_t bh;
  int split, n_split, tile0, tile1, slot_end, row0, rows, rg_n, sg_n;
};

__device__ __forceinline__ Work plan(const Args& a, int rb) {
  Work w;
  w.split = blockIdx.x;
  w.n_split = gridDim.x;
  const int seq = blockIdx.z / a.n_pass;
  const int pass = blockIdx.z - seq * a.n_pass;
  w.bh = (int64_t)seq * a.h_kv + blockIdx.y;
  const int pos = a.pos_dev != nullptr ? *a.pos_dev : a.pos_host;
  const int n_live = pos < a.L ? pos + 1 : a.L;  // no overflow at INT_MAX
  split_tiles(n_live, w.split, w.n_split, &w.tile0, &w.tile1);
  w.slot_end = min(w.tile1 * kTile, n_live);
  w.row0 = pass * kConsumerWarps * rb;
  w.rows = min(kConsumerWarps * rb, a.rep - w.row0);
  const int need = (w.rows + rb - 1) / rb;
  w.rg_n = need <= 1 ? 1 : (need <= 2 ? 2 : 4);
  w.sg_n = kConsumerWarps / w.rg_n;
  return w;
}

// An empty run: the neutral partial state (m = -1e30, l = 0, acc = 0);
// with one split (a device pos below 0: no slot visible) the output 0.
template <typename TQ>
__device__ void write_empty(const Args& a, const Work& w) {
  const int stride = a.hd + 2;
  if (w.n_split == 1) {
    TQ* out = static_cast<TQ*>(a.out) + (w.bh * a.rep + w.row0) * a.hd;
    for (int i = threadIdx.x; i < w.rows * a.hd; i += kThreads)
      out[i] = from_f<TQ>(0.f);
    return;
  }
  float* dst =
      a.part + ((w.bh * w.n_split + w.split) * a.rep + w.row0) * stride;
  for (int i = threadIdx.x; i < w.rows * stride; i += kThreads)
    dst[i] = i % stride == a.hd ? kNegInf : 0.f;
}

// The producer thread: each tile of the run as one bulk copy of its K
// rows and one of its V rows (and one each of their scales) into ring
// stage it % stages, once the consumers have released that stage.
template <typename TC>
__device__ void produce(const Args& a, const Work& w, unsigned char* ring,
                        float* scales, uint32_t bar_full,
                        uint32_t bar_empty) {
  const bool quantized = a.ks != nullptr;
  const int row_bytes = a.hd * (int)sizeof(TC);
  const int tile_bytes = kTile * row_bytes;
  const unsigned char* kb =
      static_cast<const unsigned char*>(a.k) + w.bh * a.L * row_bytes;
  const unsigned char* vb =
      static_cast<const unsigned char*>(a.v) + w.bh * a.L * row_bytes;
  for (int it = 0; it < w.tile1 - w.tile0; ++it) {
    const int s = it % a.stages;
    if (it >= a.stages)
      mbar_wait(bar_empty + 8 * s, ((it / a.stages) - 1) & 1);
    const int t0 = (w.tile0 + it) * kTile;
    const int nrows = min(kTile, w.slot_end - t0);
    const uint32_t kv_bytes = (uint32_t)(nrows * row_bytes);
    // the scales' run rounded up to 4 slots (16 bytes): it stays inside
    // L, a multiple of 128; slots past the run are selected out by the
    // consumers
    const uint32_t sc_bytes =
        quantized ? (uint32_t)(((nrows + 3) & ~3) * sizeof(float)) : 0;
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect(bar, 2 * kv_bytes + 2 * sc_bytes);
    unsigned char* dst = ring + (size_t)s * 2 * tile_bytes;
    bulk_load(smem_addr(dst), kb + (int64_t)t0 * row_bytes, kv_bytes, bar);
    bulk_load(smem_addr(dst + tile_bytes), vb + (int64_t)t0 * row_bytes,
              kv_bytes, bar);
    if (quantized) {
      float* sd = scales + s * 2 * kTile;
      bulk_load(smem_addr(sd), a.ks + w.bh * a.L + t0, sc_bytes, bar);
      bulk_load(smem_addr(sd + kTile), a.vs + w.bh * a.L + t0, sc_bytes,
                bar);
    }
  }
}

// The warps of each row group merge their (m, l, acc), written to `mrg`
// as [warp][rb][hd + 2], rescaled to their common max: into `out` with
// one split, else into the split's partial state.
template <typename TQ>
__device__ void merge_warps(const Args& a, const Work& w, const float* mrg,
                            int rb) {
  const int hd = a.hd;
  const int stride = hd + 2;
  for (int i = threadIdx.x; i < w.rows * hd; i += kConsumers) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int g = r / rb;
    const float* base = mrg + (g * w.sg_n * rb + r - g * rb) * stride;
    float mm = kNegInf;
    for (int x = 0; x < w.sg_n; ++x)
      mm = fmaxf(mm, base[x * rb * stride + hd]);
    float acc = 0.f, l = 0.f;
    for (int x = 0; x < w.sg_n; ++x) {
      const float* ps = base + x * rb * stride;
      const float wt = expf(ps[hd] - mm);
      acc += ps[d] * wt;
      l += ps[hd + 1] * wt;
    }
    const int64_t row = w.bh * a.rep + w.row0 + r;
    if (w.n_split == 1) {
      static_cast<TQ*>(a.out)[row * hd + d] =
          from_f<TQ>(__fdividef(acc, fmaxf(l, 1e-30f)));
    } else {
      float* dst =
          a.part + ((w.bh * w.n_split + w.split) * a.rep + w.row0 + r) *
                       stride;
      dst[d] = acc;
      if (d == 0) {
        dst[hd] = mm;
        dst[hd + 1] = l;
      }
    }
  }
}

// the ring's stage bytes: K and V tiles, and their scales
template <typename TC>
size_t stage_bytes(int hd, bool quantized) {
  return 2 * (size_t)kTile * hd * sizeof(TC) +
         (quantized ? 2 * (size_t)kTile * sizeof(float) : 0);
}

// the warps' (m, l, acc) for the merge inside the CTA
__host__ __device__ size_t merge_bytes(int rb, int hd) {
  return (size_t)kConsumerWarps * rb * (hd + 2) * sizeof(float);
}

constexpr int pow2_floor(int x) { return x >= 2 ? 2 * pow2_floor(x / 2) : 1; }

// Compile-time layout of a lane's work in the FMA kernel. LPS lanes
// cover a slot (PPL 16-byte pieces each), SPS slots a warp step, STEPS
// steps a round of 16 slots; RB query rows are held in registers by each
// warp: q and acc (2 N PPL a row) and the round's scores (STEPS a row)
// in about 96 registers.
template <typename TC, int LPS, int PPL> struct Layout {
  static constexpr int N = Piece<TC>::N;
  static constexpr int SPS = 32 / LPS;
  static constexpr int STEPS = kRound / SPS;
  static constexpr int FIT = 96 / (2 * N * PPL + STEPS);
  static constexpr int RB = pow2_floor(FIT < 8 ? (FIT < 1 ? 1 : FIT) : 8);
  static_assert(SPS * STEPS == kRound, "a round is 16 slots");
};

// The FMA split kernel, for f32 queries: grid
// (n_split, h_kv, b * n_pass), CTA (split, head, seq * n_pass + pass).
template <typename TQ, typename TC, int LPS, int PPL>
__global__ void __launch_bounds__(kThreads, 2)
    flash_decode_split_kernel(const __grid_constant__ Args a) {
  using Lay = Layout<TC, LPS, PPL>;
  constexpr int N = Lay::N;
  constexpr int RB = Lay::RB;
  constexpr int SPS = Lay::SPS;
  constexpr int STEPS = Lay::STEPS;
  const Work w = plan(a, RB);
  if (w.tile0 >= w.tile1) {
    write_empty<TQ>(a, w);
    return;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool quantized = a.ks != nullptr;
  const int hd = a.hd;
  const int stride = hd + 2;
  const int row_bytes = hd * (int)sizeof(TC);
  const int tile_bytes = kTile * row_bytes;
  extern __shared__ __align__(128) unsigned char smem[];
  // [stages] x (K tile, V tile), then [stages] x (K, V scales), then the
  // warps' merge state, then the barriers
  unsigned char* ring = smem;
  float* scales = reinterpret_cast<float*>(smem + 2 * a.stages * tile_bytes);
  float* mrg = scales + (quantized ? 2 * a.stages * kTile : 0);
  const uint32_t bar_full = smem_addr(mrg + kConsumerWarps * RB * stride);
  const uint32_t bar_empty = bar_full + 8 * kMaxStages;
  const int n_t = w.tile1 - w.tile0;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) produce<TC>(a, w, ring, scales, bar_full, bar_empty);
    return;
  }

  // ------------------------------------------------------ consumers
  const int rg = warp / w.sg_n;
  const int sg = warp - rg * w.sg_n;
  const int wrows = max(0, min(RB, w.rows - rg * RB));
  const int piece0 = lane % LPS;               // + LPS * j, j < PPL
  const int sub = lane / LPS;                  // slot within a step
  const int pieces = row_bytes / 16;

  float qr[RB][PPL][N];
  float acc[RB][PPL][N];
  float m[RB], l[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const int c = piece0 + LPS * j;
      const bool have = r < wrows && c < pieces;
      const TQ* src = static_cast<const TQ*>(a.q) +
                      (w.bh * a.rep + w.row0 + rg * RB + r) * hd + c * N;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        qr[r][j][e] = have ? to_f(src[e]) : 0.f;
        acc[r][j][e] = 0.f;
      }
    }
  }
  bool live_piece[PPL];
#pragma unroll
  for (int j = 0; j < PPL; ++j) live_piece[j] = piece0 + LPS * j < pieces;

  for (int it = 0; it < n_t; ++it) {
    const int s = it % a.stages;
    mbar_wait(bar_full + 8 * s, (it / a.stages) & 1);
    if (wrows > 0) {
      const unsigned char* kt = ring + (size_t)s * 2 * tile_bytes;
      const unsigned char* vt = kt + tile_bytes;
      const float* kscale = scales + s * 2 * kTile;
      const float* vscale = kscale + kTile;
      const int live = w.slot_end - (w.tile0 + it) * kTile;  // in the tile
      // this warp's slots of the tile: RG rounds of 16 from sg * 16 RG
      for (int rd = 0; rd < w.rg_n; ++rd) {
        const int slot0 = (sg * w.rg_n + rd) * kRound;  // within the tile
        if (slot0 >= live) break;
        float sc[STEPS][RB];
        float mx[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) mx[r] = kNegInf;
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
          const int t = slot0 + i * SPS + sub;
          const bool valid = t < live;
          float dot[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) dot[r] = 0.f;
          if (valid) {
#pragma unroll
            for (int j = 0; j < PPL; ++j) {
              if (!live_piece[j]) continue;
              float kv[N];
              Piece<TC>::load(kt + t * row_bytes + (piece0 + LPS * j) * 16,
                              kv);
#pragma unroll
              for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int e = 0; e < N; ++e)
                  dot[r] = fmaf(qr[r][j][e], kv[e], dot[r]);
            }
          }
          // the slot's lanes sum their pieces; all of them hold the score
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            float x = dot[r];
#pragma unroll
            for (int o = LPS / 2; o > 0; o >>= 1)
              x += __shfl_xor_sync(0xffffffffu, x, o);
            if (quantized) x *= kscale[t];
            x *= a.sm_scale;
            sc[i][r] = valid ? x : kNegInf;
            mx[r] = fmaxf(mx[r], sc[i][r]);
          }
        }
        // the round's max over the warp's slots, then the online update
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int o = LPS; o < 32; o <<= 1)
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
          const float m_new = fmaxf(m[r], mx[r]);
          const float alpha = expf(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha;
#pragma unroll
          for (int j = 0; j < PPL; ++j)
#pragma unroll
            for (int e = 0; e < N; ++e) acc[r][j][e] *= alpha;
        }
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
          const int t = slot0 + i * SPS + sub;
          const bool valid = t < live;
          float pv[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            // by select: a slot past the run adds nothing, NaN or not
            const float p = valid ? expf(sc[i][r] - m[r]) : 0.f;
            l[r] += p;
            const float pw = (quantized && valid) ? p * vscale[t] : p;
            pv[r] = round_to<TQ>(pw);
          }
          if (valid) {
#pragma unroll
            for (int j = 0; j < PPL; ++j) {
              if (!live_piece[j]) continue;
              float vv[N];
              Piece<TC>::load(vt + t * row_bytes + (piece0 + LPS * j) * 16,
                              vv);
#pragma unroll
              for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int e = 0; e < N; ++e)
                  acc[r][j][e] = fmaf(pv[r], vv[e], acc[r][j][e]);
            }
          }
        }
      }
    }
    // the ring slot goes back to the producer
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // the warp's slot groups sum their l and acc (m is the warp's already)
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int j = 0; j < PPL; ++j)
#pragma unroll
        for (int e = 0; e < N; ++e)
          acc[r][j][e] += __shfl_xor_sync(0xffffffffu, acc[r][j][e], o);
    }
  }
  float* mine = mrg + warp * RB * stride;
  if (lane < LPS) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= wrows) break;
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        const int c = piece0 + LPS * j;
        if (c >= pieces) continue;
#pragma unroll
        for (int e = 0; e < N; ++e)
          mine[r * stride + c * N + e] = acc[r][j][e];
      }
      if (lane == 0) {
        mine[r * stride + hd] = m[r];
        mine[r * stride + hd + 1] = l[r];
      }
    }
  }
  consumers_sync();
  merge_warps<TQ>(a, w, mrg, RB);
}

// ---------------------------------------------------------------------
// The tensor-core split kernel, for bf16 queries (over bf16 or int8
// caches): each consumer warp walks 16-slot rounds of the ring's tiles
// with mma_decode's `Walk` (S^T = K Q^T, O^T += V^T P^T on mma.sync
// m16n8k16, the GQA group on the n8 side; see mma_decode.cuh). HD is 64,
// 128 or 256, the head dims it takes (below HD read as 0). At 256 the
// O^T accumulators are 64 f32 and q's fragments 32 registers a thread, so
// its instantiations take one CTA per SM (launch bounds) and, with it,
// a ring of up to 192 KiB: three 64 KiB stages of bf16 K/V tiles, so that
// a split's 2-3 tiles are all in flight at once.
template <typename TC, int HD>
__global__ void __launch_bounds__(kThreads, HD > 128 ? 1 : 3)
    flash_decode_split_mma_kernel(const __grid_constant__ Args a) {
  const Work w = plan(a, kMmaRows);
  if (w.tile0 >= w.tile1) {
    write_empty<__nv_bfloat16>(a, w);
    return;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;           // fragment row group
  const int t = lane & 3;
  const bool quantized = a.ks != nullptr;
  const int hd = a.hd;
  const int stride = hd + 2;
  const int row_bytes = hd * (int)sizeof(TC);
  const int tile_bytes = kTile * row_bytes;
  extern __shared__ __align__(128) unsigned char smem[];
  // [stages] x (K tile, V tile), [stages] x (K, V scales), the barriers;
  // the warps' merge state reuses the ring once the walk is done
  unsigned char* ring = smem;
  float* scales = reinterpret_cast<float*>(smem + 2 * a.stages * tile_bytes);
  const size_t ring_bytes =
      2 * (size_t)a.stages * tile_bytes +
      (quantized ? 2 * (size_t)a.stages * kTile * sizeof(float) : 0);
  const size_t mrg_bytes = merge_bytes(kMmaRows, hd);
  const uint32_t bar_full =
      smem_addr(smem) + (uint32_t)(ring_bytes > mrg_bytes ? ring_bytes
                                                          : mrg_bytes);
  const uint32_t bar_empty = bar_full + 8 * kMaxStages;
  const int n_t = w.tile1 - w.tile0;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) produce<TC>(a, w, ring, scales, bar_full, bar_empty);
    return;
  }

  // ------------------------------------------------------ consumers
  const int rg = warp / w.sg_n;
  const int sg = warp - rg * w.sg_n;
  const int wrows = max(0, min(kMmaRows, w.rows - rg * kMmaRows));

  uint32_t qf[HD / 32][4];
  load_q<HD>(qf,
             static_cast<const uint16_t*>(a.q) +
                 (w.bh * a.rep + w.row0 + rg * kMmaRows + g) * hd,
             g < wrows, hd, t);
  Walk<HD> walk;
  walk.init();

  for (int it = 0; it < n_t; ++it) {
    const int s = it % a.stages;
    mbar_wait(bar_full + 8 * s, (it / a.stages) & 1);
    if (wrows > 0) {
      const unsigned char* kt = ring + (size_t)s * 2 * tile_bytes;
      const unsigned char* vt = kt + tile_bytes;
      const float* kscale = quantized ? scales + s * 2 * kTile : nullptr;
      const float* vscale = quantized ? kscale + kTile : nullptr;
      const int live = w.slot_end - (w.tile0 + it) * kTile;  // in the tile
      for (int rd = 0; rd < w.rg_n; ++rd) {
        const int slot0 = (sg * w.rg_n + rd) * kRound;  // within the tile
        if (slot0 >= live) break;
        walk.template round16<TC>(qf, kt, vt, row_bytes, slot0, live, kscale,
                                vscale, a.sm_scale, hd, g, t);
      }
    }
    // the ring slot goes back to the producer
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // once every warp is done with the ring, the warps' states go where
  // the ring was
  walk.finish();
  consumers_sync();
  float* mrg = reinterpret_cast<float*>(smem);
  walk.store(mrg + warp * kMmaRows * stride, wrows, hd, stride, g, t);
  consumers_sync();
  merge_warps<__nv_bfloat16>(a, w, mrg, kMmaRows);
}

// grid ceil(b * h / 4), 4 warps: warp w merges query row (block * 4 + w)
// over its n_split partial states, lane d of the warp head dims d + 32 i
// (i < DIMS). The states come in groups of 8 splits whose loads are all
// issued before any is used, folded in by the online rescaling; each
// split's weight exp(m_s - m) is taken once per group, not per dim. An
// empty split weighs exp(-1e30 - m) = 0.
template <typename TQ, int DIMS>
__global__ void __launch_bounds__(32 * kMergeWarps) flash_decode_merge_kernel(
    const float* __restrict__ part, TQ* __restrict__ out, int n_rows, int rep,
    int hd, int n_split) {
  constexpr int kGroup = 8;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int stride = hd + 2;
  const int64_t bh = row / rep;
  const int r = (int)(row - bh * rep);
  const float* base = part + (bh * n_split * rep + r) * stride;
  const int64_t split_stride = (int64_t)rep * stride;
  float acc[DIMS];
#pragma unroll
  for (int i = 0; i < DIMS; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += kGroup) {
    float ms[kGroup], ls[kGroup], av[kGroup][DIMS];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const bool have = s0 + j < n_split;
      const float* ps = base + (s0 + j) * split_stride;
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
    if (d < hd) out[row * hd + d] = from_f<TQ>(__fdividef(acc[i], l));
  }
}

// Launches a split kernel with its ring of 1-4 stages in about `budget`
// bytes and the warps' merge state, which aliases the ring where `alias`
// is set. `raised` holds the kernel's own flags, one per device: its
// shared-memory limit is raised once on each, so that a launch under
// graph capture makes no attribute call.
template <typename TC>
int launch_split(void (*kernel)(Args), bool* raised, Args a, int b,
                 int n_split, int rb, bool alias, size_t budget,
                 cudaStream_t stream) {
  const bool quantized = a.ks != nullptr;
  const size_t per_stage = stage_bytes<TC>(a.hd, quantized);
  const size_t mrg = merge_bytes(rb, a.hd);
  const size_t bars = 2 * kMaxStages * 8;
  auto total = [&](int stages) {
    const size_t ring = stages * per_stage;
    return (alias ? (ring > mrg ? ring : mrg) : ring + mrg) + bars;
  };
  int stages = (int)(budget / per_stage);
  stages = stages < 1 ? 1 : (stages > kMaxStages ? kMaxStages : stages);
  if (stages < 2 && total(2) <= kMaxSmem) stages = 2;
  const size_t smem = total(stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && !(dev < kMaxDevices && raised[dev])) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const int rows_per_pass = kConsumerWarps * rb;
  a.n_pass = (a.rep + rows_per_pass - 1) / rows_per_pass;
  a.stages = stages;
  kernel<<<dim3(n_split, a.h_kv, b * a.n_pass), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, int LPS, int PPL>
int launch_fma(const Args& a, int b, int n_split, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  return launch_split<TC>(flash_decode_split_kernel<TQ, TC, LPS, PPL>,
                          raised, a, b, n_split, Layout<TC, LPS, PPL>::RB,
                          false, kFmaRingBytes, stream);
}

template <typename TC, int HD>
int launch_mma(const Args& a, int b, int n_split, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  return launch_split<TC>(flash_decode_split_mma_kernel<TC, HD>, raised, a,
                          b, n_split, kMmaRows, true,
                          HD > 128 ? kMmaWideRingBytes : kMmaRingBytes,
                          stream);
}

// The kernel for q's dtype and hd: bf16 queries take the tensor-core
// kernel at every head dim (up to 256, checked by `launch`); f32 queries
// the FMA kernel, whose LPS is the 16-byte pieces of a row rounded up to
// a power of two (2 to 32), two pieces a lane past 32.
template <typename TQ, typename TC>
int launch_layout(const Args& a, int b, int n_split, cudaStream_t stream) {
  const int hd = a.hd;
  const int pieces = hd * (int)sizeof(TC) / 16;
  if constexpr (sizeof(TQ) == 2) {
    if (hd <= 64) return launch_mma<TC, 64>(a, b, n_split, stream);
    if (hd <= 128) return launch_mma<TC, 128>(a, b, n_split, stream);
    return launch_mma<TC, 256>(a, b, n_split, stream);
  } else {
    if constexpr (sizeof(TC) == 4) {
      if (pieces > 32) return launch_fma<TQ, TC, 32, 2>(a, b, n_split, stream);
      if (pieces > 16) return launch_fma<TQ, TC, 32, 1>(a, b, n_split, stream);
    }
    if (pieces > 8) return launch_fma<TQ, TC, 16, 1>(a, b, n_split, stream);
    if (pieces > 4) return launch_fma<TQ, TC, 8, 1>(a, b, n_split, stream);
    if (pieces > 2) return launch_fma<TQ, TC, 4, 1>(a, b, n_split, stream);
    if constexpr (sizeof(TC) == 1)
      return launch_fma<TQ, TC, 2, 1>(a, b, n_split, stream);
    return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TC>
int launch(const Args& a, int b, int n_split, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v) |
        reinterpret_cast<uintptr_t>(a.ks) |
        reinterpret_cast<uintptr_t>(a.vs)) % 16) == 0;
  if (!aligned || a.hd % 16 != 0 || a.hd > 256 || a.L % 128 != 0 ||
      n_split < 1 || n_split > a.L / kTile ||
      (n_split > 1 && a.part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rc = launch_layout<TQ, TC>(a, b, n_split, stream);
  if (rc != 0 || n_split == 1) return rc;
  const int n_rows = b * a.h_kv * a.rep;
  const int blocks = (n_rows + kMergeWarps - 1) / kMergeWarps;
  if (a.hd <= 128)
    flash_decode_merge_kernel<TQ, 4><<<blocks, 32 * kMergeWarps, 0, stream>>>(
        a.part, static_cast<TQ*>(a.out), n_rows, a.rep, a.hd, n_split);
  else
    flash_decode_merge_kernel<TQ, 8><<<blocks, 32 * kMergeWarps, 0, stream>>>(
        a.part, static_cast<TQ*>(a.out), n_rows, a.rep, a.hd, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; quantized: the cache holds int8
// codes and ks/vs are its f32 scales (else the cache is in q's dtype and
// ks/vs are ignored). The position is `*pos_dev` (an int32 on the
// device, read by the kernel) when pos_dev is not null, else pos_host.
// n_split (1 to L / 64) comes from L, b * h_kv and the SM count only;
// `part` is f32 scratch [b * h_kv, n_split, rep, hd + 2], needed when
// n_split > 1. Returns a cudaError_t (0 = success).
extern "C" int flash_decode_attention_launch(
    int q_dtype, int quantized, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, const void* pos_dev, int pos_host,
    void* out, void* part, int b, int h_kv, int rep, int hd, int L,
    int n_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = quantized ? static_cast<const float*>(ks) : nullptr;
  a.vs = quantized ? static_cast<const float*>(vs) : nullptr;
  a.pos_dev = static_cast<const int*>(pos_dev);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.h_kv = h_kv;
  a.rep = rep;
  a.hd = hd;
  a.L = L;
  a.pos_host = pos_host;
  a.n_pass = 1;
  a.stages = 1;
  a.sm_scale = (float)(1.0 / sqrt((double)hd));
  if (q_dtype == 0)
    return quantized ? launch<float, int8_t>(a, b, n_split, s)
                     : launch<float, float>(a, b, n_split, s);
  if (q_dtype == 1)
    return quantized ? launch<__nv_bfloat16, int8_t>(a, b, n_split, s)
                     : launch<__nv_bfloat16, __nv_bfloat16>(a, b, n_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
