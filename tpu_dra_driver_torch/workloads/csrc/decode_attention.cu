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
//   narrow side, S^T = K Q^T and O^T += V^T P^T (mma_decode.cuh); q's
//   fragments load as 16-byte pieces. Up to hd 128 a CTA has a ring of
//   about 70 KiB (two CTAs fit an SM by registers, three by shared
//   memory). At 256 (Gemma-class heads: a GQA group of 8, the n8 side
//   exactly) a 64-slot K+V tile is 64 KiB and a thread holds 64 f32 of
//   O^T, so one CTA holds an SM with a ring of three stages (192 KiB;
//   int8 four), and `decode_n_split` plans one CTA per SM.
// - f32 queries take the FMA kernel: each lane owns one
//   16-byte piece of a cache row, LPS lanes a slot, so a warp reads
//   whole rows without bank conflicts; scores reduce by shuffles inside
//   a slot's lanes, which then all hold P for P.V. Exact in f32, as the
//   f32 tolerance needs (a tf32 or bf16 product would not be).
// - Slots past the run's end are excluded by select, never multiplied
//   by 0: a NaN in a stale ring slot or past pos cannot reach a sum.
// - At the end the warps of a CTA merge their (m, l, acc) once through
//   shared memory (each weight exp(m_x - m) once per row). The n_split
//   CTAs of one (seq, KV head, pass) are one thread-block cluster (x =
//   n_split, at most 8, the portable size), so one launch is the whole
//   read: each CTA publishes its merged (acc, m, l) rows in its own
//   shared memory, the cluster syncs (release / acquire), and each CTA
//   merges an hd / n_split slice of the head dims over all splits
//   through distributed shared memory, each thread's loads from every
//   split issued before any is used, folded in split order (an empty
//   split publishes m = -1e30, l = 0, acc = 0 and weighs exp(-1e30 - m)
//   = 0); it writes that slice of `out`, and a second cluster sync keeps
//   every CTA's shared memory alive until all have read it. No scratch,
//   no counter, no second kernel, and the same bits on every run. With
//   one split the CTA writes the output itself.
// - A GPC places a cluster's CTAs on as few of its SMs as their
//   resources allow, where a plain grid spreads them, and holds only as
//   many clusters at once as its SMs fit whole. So `decode_n_split`
//   keeps clusters of more than two CTAs to about 1.5 CTAs per SM.

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
// splits of a row: the CTAs of one cluster, at most the portable size
constexpr int kMaxSplits = 8;
constexpr int kMaxDevices = 64;   // per-device flags of the launch code

// Pace probes of the tensor-core kernel, built only by
// tools/decode_steps.py (-DB5_PACE=n), never by the port: 1 streams the
// ring with no math (the copies' pace), 2 walks every tile over whatever
// the ring holds, with no copy at all (the consumers' pace), 3 reads the
// run's bytes with plain 16-byte loads by every thread of the same grid
// (the card's floor for the read), 4 skips the cluster's merge, 5
// copies nothing and walks no tile (the fixed cost of a CTA). Their
// outputs are not the function's.
#ifndef B5_PACE
#define B5_PACE 0
#endif
constexpr int kPace = B5_PACE;

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

// the arguments of a launch
struct Args {
  const void* q;          // [b, h, 1, hd] TQ
  const void* k;          // [b, h_kv, L, hd] TC
  const void* v;
  const float* ks;        // [b, h_kv, L], or null (cache in q's dtype)
  const float* vs;
  const int* pos_dev;     // the position on the device, or null
  void* out;              // [b, h, 1, hd] TQ
  int h_kv, rep, hd, L, pos_host, n_pass, stages;
  float sm_scale;
};

// What one CTA covers: (seq, KV head) `bh`, split `split` of `n_split`,
// its live tiles [tile0, tile1) ending at slot `slot_end`, and query
// rows [row0, row0 + rows) of the GQA group held by RG row groups of RB
// rows, each walked by SG warps (RG * SG = 4).
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

// An empty run: the neutral state (m = -1e30, l = 0, acc = 0) published
// in `pub`; with one split (a device pos below 0: no slot visible) the
// output 0.
template <typename TQ>
__device__ void write_empty(const Args& a, const Work& w, float* pub) {
  const int stride = a.hd + 2;
  if (w.n_split == 1) {
    TQ* out = static_cast<TQ*>(a.out) + (w.bh * a.rep + w.row0) * a.hd;
    for (int i = threadIdx.x; i < w.rows * a.hd; i += kThreads)
      out[i] = from_f<TQ>(0.f);
    return;
  }
  for (int i = threadIdx.x; i < w.rows * stride; i += kThreads)
    pub[i] = i % stride == a.hd ? kNegInf : 0.f;
}

// ------------------------------------------------- the cluster's merge
// barrier.cluster with release / acquire: every thread of every CTA of
// the cluster arrives, and each waits for all of them; what a CTA wrote
// to its shared memory before arriving is visible to the cluster after
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// `addr` (this CTA's shared memory) in the shared memory of the CTA of
// rank `rank` in the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// the published rows [rb * 4][hd + 2] (acc, m, l), then the warps'
// merge weights [rb * 4][kConsumerWarps + 2] (w_x, then m and l)
__host__ __device__ size_t pub_bytes(int rb, int hd) {
  return (size_t)kConsumerWarps * rb * (hd + 2 + kConsumerWarps + 2) *
         sizeof(float);
}

// The row block's merge over its cluster of n_split CTAs (split s is
// the CTA of rank s: the cluster spans the grid's x axis), once every
// CTA has published its rows in `pub` ([rows][hd + 2]: acc, m, l). All
// threads of the CTA call it. This CTA takes the head dims [split hd /
// n, (split + 1) hd / n); each thread, for a (row, dim) of them, loads
// every split's m, l and acc through distributed shared memory, all
// issued before any is used (one round trip through the cluster), and
// folds them in split order: m = max_s m_s, w_s = exp(m_s - m), l =
// sum_s w_s l_s, acc = sum_s w_s acc_s, out = acc / max(l, 1e-30). A
// second cluster barrier keeps every CTA's shared memory alive until
// all have read it.
template <typename TQ>
__device__ void merge_splits(const Args& a, const Work& w, float* pub) {
  const int hd = a.hd;
  const int stride = hd + 2;
  const int n = w.n_split;
  cluster_sync();
  uint32_t src[kMaxSplits];           // `pub` in each split's CTA
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    src[s] = cluster_addr(smem_addr(pub), s < n ? s : 0);
  const int d0 = w.split * hd / n;
  const int nd = (w.split + 1) * hd / n - d0;
  TQ* out = static_cast<TQ*>(a.out) + (w.bh * a.rep + w.row0) * hd;
  for (int i = threadIdx.x; i < w.rows * nd; i += kThreads) {
    const int r = i / nd;
    const int d = d0 + i - r * nd;
    const uint32_t at_m = (uint32_t)((r * stride + hd) * 4);
    const uint32_t at_d = (uint32_t)((r * stride + d) * 4);
    float ms[kMaxSplits], ls[kMaxSplits], xs[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      ms[s] = s < n ? ld_cluster(src[s] + at_m) : kNegInf;
      ls[s] = s < n ? ld_cluster(src[s] + at_m + 4) : 0.f;
      xs[s] = s < n ? ld_cluster(src[s] + at_d) : 0.f;
    }
    float m = kNegInf;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) m = fmaxf(m, ms[s]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      const float wt = s < n ? expf(ms[s] - m) : 0.f;
      l = fmaf(ls[s], wt, l);
      acc = fmaf(xs[s], wt, acc);
    }
    out[r * hd + d] = from_f<TQ>(__fdividef(acc, fmaxf(l, 1e-30f)));
  }
  cluster_sync();
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
  const int n_copies = kPace == 2 || kPace == 5 ? 0 : w.tile1 - w.tile0;
  for (int it = 0; it < n_copies; ++it) {
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

// Pace probe 3: every thread reads 16-byte pieces of the run's K and V
// rows (and scales) from device memory, 8 in flight, and folds them into
// one word that is written only if it matches a value no read gives, so
// that the loads are kept
template <typename TC>
__device__ void stream_read(const Args& a, const Work& w) {
  const int row_bytes = a.hd * (int)sizeof(TC);
  const int64_t first = (int64_t)w.tile0 * kTile;
  const int64_t n_pieces = (w.slot_end - first) * row_bytes / 16;
  const uint4* kp = reinterpret_cast<const uint4*>(
      static_cast<const unsigned char*>(a.k) +
      (w.bh * a.L + first) * row_bytes);
  const uint4* vp = reinterpret_cast<const uint4*>(
      static_cast<const unsigned char*>(a.v) +
      (w.bh * a.L + first) * row_bytes);
  constexpr int kInFlight = 8;
  uint32_t x = 0;
  for (int64_t i0 = threadIdx.x; i0 < n_pieces;
       i0 += (int64_t)kThreads * kInFlight) {
    uint4 u[2 * kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int64_t i = i0 + (int64_t)j * kThreads;
      u[2 * j] = i < n_pieces ? __ldcs(kp + i) : make_uint4(0, 0, 0, 0);
      u[2 * j + 1] = i < n_pieces ? __ldcs(vp + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < 2 * kInFlight; ++j)
      x ^= u[j].x ^ u[j].y ^ u[j].z ^ u[j].w;
  }
  if (a.ks != nullptr) {
    const int n = w.slot_end - (int)first;
    for (int i = threadIdx.x; i < n; i += kThreads)
      x ^= __float_as_uint(__ldcs(a.ks + w.bh * a.L + first + i)) ^
           __float_as_uint(__ldcs(a.vs + w.bh * a.L + first + i));
  }
  if (x == 0x7fc00001u) static_cast<uint32_t*>(a.out)[0] = x;
}

// The warps of each row group merge their (m, l, acc), written to `mrg`
// as [warp][rb][hd + 2]: per row its m, the weights exp(m_x - m) and l
// once (after the CTA's rows in `pub`), then each (row, dim) of acc:
// into `out` with one split, else into the rows the CTA publishes to
// its cluster (`pub`, [rows][hd + 2]). The consumer warps only.
template <typename TQ>
__device__ void merge_warps(const Args& a, const Work& w, const float* mrg,
                            float* pub, int rb) {
  const int hd = a.hd;
  const int stride = hd + 2;
  const int ws = kConsumerWarps + 2;
  float* wts = pub + (size_t)kConsumerWarps * rb * stride;
  for (int r = threadIdx.x; r < w.rows; r += kConsumers) {
    const int g = r / rb;
    const float* base = mrg + (g * w.sg_n * rb + r - g * rb) * stride;
    float m = kNegInf;
    for (int x = 0; x < w.sg_n; ++x)
      m = fmaxf(m, base[x * rb * stride + hd]);
    float l = 0.f;
    for (int x = 0; x < w.sg_n; ++x) {
      const float* ps = base + x * rb * stride;
      const float wt = expf(ps[hd] - m);
      wts[r * ws + x] = wt;
      l += ps[hd + 1] * wt;
    }
    wts[r * ws + kConsumerWarps] = m;
    wts[r * ws + kConsumerWarps + 1] = l;
  }
  consumers_sync();
  for (int i = threadIdx.x; i < w.rows * hd; i += kConsumers) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int g = r / rb;
    const float* base = mrg + (g * w.sg_n * rb + r - g * rb) * stride;
    const float* wr = wts + r * ws;
    float acc = 0.f;
    for (int x = 0; x < w.sg_n; ++x) acc += base[x * rb * stride + d] * wr[x];
    if (w.n_split == 1) {
      TQ* out = static_cast<TQ*>(a.out) + (w.bh * a.rep + w.row0) * hd;
      out[r * hd + d] =
          from_f<TQ>(__fdividef(acc, fmaxf(wr[kConsumerWarps + 1], 1e-30f)));
    } else {
      pub[r * stride + d] = acc;
      if (d == 0) {
        pub[r * stride + hd] = wr[kConsumerWarps];
        pub[r * stride + hd + 1] = wr[kConsumerWarps + 1];
      }
    }
  }
}

// the ring's stage bytes: K and V tiles, and their scales
template <typename TC>
__host__ __device__ size_t stage_bytes(int hd, bool quantized) {
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

// The FMA walk, for f32 queries, of a CTA whose run is not empty: its
// rows' merged state into `out` (one split) or `pub`. The producer warp
// returns once it has issued its copies, the consumers after the merge
// of their states.
template <typename TQ, typename TC, int LPS, int PPL>
__device__ __forceinline__ void fma_walk(const Args& a, const Work& w,
                                         float* pub) {
  using Lay = Layout<TC, LPS, PPL>;
  constexpr int N = Lay::N;
  constexpr int RB = Lay::RB;
  constexpr int SPS = Lay::SPS;
  constexpr int STEPS = Lay::STEPS;
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
  // warps' merge state, then `pub`, then the barriers
  unsigned char* ring = smem;
  float* scales = reinterpret_cast<float*>(smem + 2 * a.stages * tile_bytes);
  float* mrg = scales + (quantized ? 2 * a.stages * kTile : 0);
  const uint32_t bar_full = smem_addr(pub) + (uint32_t)pub_bytes(RB, hd);
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
  merge_warps<TQ>(a, w, mrg, pub, RB);
}

// The FMA kernel, for f32 queries: grid (n_split, h_kv, b * n_pass) in
// clusters of (n_split, 1, 1), CTA (split, head, seq * n_pass + pass).
template <typename TQ, typename TC, int LPS, int PPL>
__global__ void __launch_bounds__(kThreads, 2)
    flash_decode_fma_kernel(const __grid_constant__ Args a) {
  constexpr int RB = Layout<TC, LPS, PPL>::RB;
  const Work w = plan(a, RB);
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t ring_bytes =
      stage_bytes<TC>(a.hd, a.ks != nullptr) * a.stages;
  float* pub = reinterpret_cast<float*>(smem + ring_bytes +
                                        merge_bytes(RB, a.hd));
  if (w.tile0 >= w.tile1)
    write_empty<TQ>(a, w, pub);
  else
    fma_walk<TQ, TC, LPS, PPL>(a, w, pub);
  if (w.n_split > 1) merge_splits<TQ>(a, w, pub);
}

// q fragments as mma_decode's `load_q` gives them (query row `row` as
// dims 32 c + 8 t + [0, 8) in 4 bf16 pairs, 0 where the row is absent
// or past hd), each chunk one 16-byte load where the row is aligned
template <int HD>
__device__ __forceinline__ void load_q16(uint32_t (&qf)[HD / 32][4],
                                         const uint16_t* row, bool have,
                                         int hd, int t) {
  if ((reinterpret_cast<uintptr_t>(row) & 15) != 0) {
    load_q<HD>(qf, row, have, hd, t);
    return;
  }
#pragma unroll
  for (int c = 0; c < HD / 32; ++c) {
    const int d0 = 32 * c + 8 * t;
    const uint4 u = have && d0 < hd
                        ? *reinterpret_cast<const uint4*>(row + d0)
                        : make_uint4(0u, 0u, 0u, 0u);
    qf[c][0] = u.x;
    qf[c][1] = u.y;
    qf[c][2] = u.z;
    qf[c][3] = u.w;
  }
}

// ---------------------------------------------------------------------
// The tensor-core walk, for bf16 queries (over bf16 or int8 caches), of
// a CTA whose run is not empty: each consumer warp walks 16-slot rounds
// of the ring's tiles with mma_decode's `Walk` (S^T = K Q^T, O^T += V^T
// P^T on mma.sync m16n8k16, the GQA group on the n8 side; see
// mma_decode.cuh). HD is 64, 128 or 256, the head dims it takes (below
// HD read as 0). At 256 the O^T accumulators are 64 f32 and q's
// fragments 32 registers a thread, so its instantiations take one CTA
// per SM (launch bounds) and, with it, a ring of up to 192 KiB: three
// 64 KiB stages of bf16 K/V tiles in flight at once.
template <typename TC, int HD>
__device__ __forceinline__ void mma_walk(const Args& a, const Work& w,
                                         float* pub) {
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
  // the warps' merge state and `pub` reuse the ring once the walk is done
  unsigned char* ring = smem;
  float* scales = reinterpret_cast<float*>(smem + 2 * a.stages * tile_bytes);
  const size_t ring_bytes = stage_bytes<TC>(hd, quantized) * a.stages;
  const size_t tail_bytes =
      merge_bytes(kMmaRows, hd) + pub_bytes(kMmaRows, hd);
  const uint32_t bar_full =
      smem_addr(smem) + (uint32_t)(ring_bytes > tail_bytes ? ring_bytes
                                                           : tail_bytes);
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
  load_q16<HD>(qf,
               static_cast<const uint16_t*>(a.q) +
                   (w.bh * a.rep + w.row0 + rg * kMmaRows + g) * hd,
               g < wrows, hd, t);
  Walk<HD> walk;
  walk.init();

  for (int it = 0; it < n_t; ++it) {
    const int s = it % a.stages;
    if (kPace != 2 && kPace != 5)
      mbar_wait(bar_full + 8 * s, (it / a.stages) & 1);
    if (kPace != 1 && kPace != 5 && wrows > 0) {
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
  merge_warps<__nv_bfloat16>(a, w, mrg, pub, kMmaRows);
}

// The tensor-core kernel: grid (n_split, h_kv, b * n_pass) in clusters
// of (n_split, 1, 1), CTA (split, head, seq * n_pass + pass).
template <typename TC, int HD>
__global__ void __launch_bounds__(kThreads, HD > 128 ? 1 : 2)
    flash_decode_mma_kernel(const __grid_constant__ Args a) {
  const Work w = plan(a, kMmaRows);
  extern __shared__ __align__(128) unsigned char smem[];
  float* pub =
      reinterpret_cast<float*>(smem + merge_bytes(kMmaRows, a.hd));
  if (w.tile0 >= w.tile1) {
    write_empty<__nv_bfloat16>(a, w, pub);
  } else if constexpr (kPace == 3) {
    stream_read<TC>(a, w);
    __syncthreads();
    write_empty<__nv_bfloat16>(a, w, pub);
  } else {
    mma_walk<TC, HD>(a, w, pub);
  }
  if (kPace != 4 && w.n_split > 1) merge_splits<__nv_bfloat16>(a, w, pub);
}

// Launches a kernel with its ring of 1-4 stages in about `budget` bytes,
// the warps' merge state and the published rows, which alias the ring
// where `alias` is set, as one cluster of (n_split, 1, 1) CTAs per row
// block. `raised` holds the kernel's own flags, one per device: its
// shared-memory limit is raised once on each, so that a launch under
// graph capture makes no attribute call. A cluster launch the card
// refuses returns its error.
template <typename TC>
int launch_split(void (*kernel)(Args), bool* raised, Args a, int b,
                 int n_split, int rb, bool alias, size_t budget,
                 cudaStream_t stream) {
  const bool quantized = a.ks != nullptr;
  const size_t per_stage = stage_bytes<TC>(a.hd, quantized);
  const size_t tail = merge_bytes(rb, a.hd) + pub_bytes(rb, a.hd);
  const size_t bars = 2 * kMaxStages * 8;
  auto total = [&](int stages) {
    const size_t ring = stages * per_stage;
    return (alias ? (ring > tail ? ring : tail) : ring + tail) + bars;
  };
  int stages = (int)(budget / per_stage);
  stages = stages < 1 ? 1 : (stages > kMaxStages ? kMaxStages : stages);
  if (stages < 2 && total(2) <= kMaxSmem) stages = 2;
  const size_t smem = total(stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_pass = kConsumerWarps * rb;
  a.n_pass = (a.rep + rows_per_pass - 1) / rows_per_pass;
  a.stages = stages;
  if (smem > 48 * 1024 && !(dev < kMaxDevices && raised[dev])) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_split, a.h_kv, b * a.n_pass);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, int LPS, int PPL>
int launch_fma(const Args& a, int b, int n_split, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  return launch_split<TC>(flash_decode_fma_kernel<TQ, TC, LPS, PPL>,
                          raised, a, b, n_split, Layout<TC, LPS, PPL>::RB,
                          false, kFmaRingBytes, stream);
}

template <typename TC, int HD>
int launch_mma(const Args& a, int b, int n_split, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  return launch_split<TC>(flash_decode_mma_kernel<TC, HD>, raised, a, b,
                          n_split, kMmaRows, true,
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
      n_split < 1 || n_split > kMaxSplits || n_split > a.L / kTile)
    return (int)cudaErrorInvalidValue;
  return launch_layout<TQ, TC>(a, b, n_split, stream);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; quantized: the cache holds int8
// codes and ks/vs are its f32 scales (else the cache is in q's dtype and
// ks/vs are ignored). The position is `*pos_dev` (an int32 on the
// device, read by the kernel) when pos_dev is not null, else pos_host.
// n_split (1 to min(8, L / 64)) comes from L, b * h_kv and the SM count
// only. One launch; returns a cudaError_t (0 = success).
extern "C" int flash_decode_attention_launch(
    int q_dtype, int quantized, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, const void* pos_dev, int pos_host,
    void* out, int b, int h_kv, int rep, int hd, int L, int n_split,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = quantized ? static_cast<const float*>(ks) : nullptr;
  a.vs = quantized ? static_cast<const float*>(vs) : nullptr;
  a.pos_dev = static_cast<const int*>(pos_dev);
  a.out = out;
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
