// The tensor-core single-query read shared by B5's and B4's kernels
// (decode_attention.cu, paged_attention.cu) on Hopper (sm_90a): the
// mbarrier and bulk-copy helpers that feed shared memory, and one warp's
// round of 16 slots of K/V against up to 8 query rows on mma.sync
// m16n8k16 (bf16 in, f32 out), with the online softmax.
//
// A round takes the scores transposed, S^T = K Q^T, with 16 slots as M and
// the warp's 8 query rows as N (rows past the GQA group are 0), and the
// output too, O^T += V^T P^T, with 16 head dims as M: the few query rows
// sit in the narrow N side, so an accumulator holds half of what Q K^T
// would, and each slot's exp is taken once per query row. A GQA group of
// 8 (Gemma-class heads: 8 query heads over one KV head) fills the n8
// side exactly.
//
// Fragments without a transpose through shared memory: the dot products
// may sum the head dims in any order, so k index (2t + e + 8 g) of
// k-step (2c + h) is head dim 32 c + 8 t + 4 h + 2 g + e (t = lane % 4),
// and lane t reads 16 contiguous bytes of a K row (4 bf16 pairs, or 8
// int8 codes widened exactly) for two k-steps; the q fragments hold the
// same dims. P^T comes from S^T's accumulators by one movmatrix.trans
// for each 8 slots. V^T pairs two slots of one head dim: rows g and
// g + 8 of m-tile j of head-dim group G are dims 64 G + 8 g + 2 j and
// + 1, so a lane reads 16 contiguous bytes of each of its four slots' V
// rows and packs pairs with one byte permute each. The output's dim
// order is undone when the state is stored.
//
// Rows are unpadded (a tile arrives as one bulk copy), so a fragment's
// slots of one head dim share banks: K's loads conflict two ways and
// V's four at any head dim, which costs less than the tile's copy from
// device memory at these reads' one operation per byte.
//
// Head dims below HD (a multiple of 8) read as 0 past hd. Slots at or
// past `live` are excluded by select, never multiplied by 0: a NaN in a
// stale ring slot or past the live range cannot reach a sum.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_decode {

constexpr int kMmaRows = 8;       // query rows: the n8 side of a fragment
constexpr int kRound = 16;        // slots per round: the m16 side
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of bulk-copy traffic
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 8 consecutive cache elements in shared memory as 4 bf16 pairs
template <typename TC> struct Pairs8;
template <> struct Pairs8<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              uint32_t (&w)[4]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  }
};
// int8 codes widen exactly: byte c ^ 0x80 (= c + 128) goes into the
// mantissa of 2^23, and 2^23 + 128 is taken off in f32 (a byte permute
// and an add per code, where a conversion instruction runs at a quarter
// of the rate)
template <> struct Pairs8<int8_t> {
  __device__ __forceinline__ static float code(uint32_t biased, int i) {
    const uint32_t sel = 0x7650u | (uint32_t)i;
    return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) -
           8388736.f;
  }
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              uint32_t (&w)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t x[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(
          code(x[i / 2], 2 * (i % 2)), code(x[i / 2], 2 * (i % 2) + 1));
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// the transpose of an 8 x 8 bf16 matrix held a row per lane quad
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// d += a b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// q fragments (B of S^T): query row `row` (lane group g's) as dims 32 c +
// 8 t + [0, 8) in 4 bf16 pairs, 0 where the row is absent or past hd
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qf)[HD / 32][4],
                                       const uint16_t* row, bool have,
                                       int hd, int t) {
#pragma unroll
  for (int c = 0; c < HD / 32; ++c) {
    const int d0 = 32 * c + 8 * t;
    const bool in = have && d0 < hd;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qf[c][i] = in ? (uint32_t)row[d0 + 2 * i] |
                          ((uint32_t)row[d0 + 2 * i + 1] << 16)
                    : 0u;
  }
}

// One warp's online-softmax state: O^T accumulators (m-tile 4 G + j holds
// dims 64 G + 8 g + 2 j, + 1 in c2 and c3, against query rows 2 t and
// 2 t + 1), and m, l of rows 2 t and 2 t + 1
template <int HD> struct Walk {
  static constexpr int kGroups = HD / 64;   // 64-dim groups: 4 m-tiles each
  float o[4 * kGroups][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < 4 * kGroups; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // One round: the slots [slot0, slot0 + 16) of a K/V tile in shared
  // memory (rows of `row_bytes`), of which those below `live` are
  // visible. With `kscale` (an int8 cache) each score is multiplied by
  // its slot's K scale before `sm_scale`, and P by the V scale for P V;
  // l sums P unscaled, and P V takes it in bf16.
  template <typename TC>
  __device__ __forceinline__ void round16(const uint32_t (&qf)[HD / 32][4],
                                        const unsigned char* kt,
                                        const unsigned char* vt,
                                        int row_bytes, int slot0, int live,
                                        const float* kscale,
                                        const float* vscale, float sm_scale,
                                        int hd, int g, int t) {
    constexpr int kChunks = HD / 32;   // 32-dim chunks: two k-steps each
    constexpr int kEl = (int)sizeof(TC);
    const bool whole = slot0 + kRound <= live;
    // S^T = K Q^T: slots slot0 + g (c0, c1) and slot0 + 8 + g (c2, c3)
    // against rows 2t, 2t + 1, in two chains of k-steps (h) for a shorter
    // latency
    float st[4] = {0.f, 0.f, 0.f, 0.f}, st2[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const unsigned char* k0 = kt + (slot0 + g) * row_bytes;
      const unsigned char* k1 = k0 + 8 * row_bytes;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        uint32_t kw[4] = {0u, 0u, 0u, 0u}, kx[4] = {0u, 0u, 0u, 0u};
        if (32 * c + 8 * t < hd) {
          Pairs8<TC>::load(k0 + (32 * c + 8 * t) * kEl, kw);
          Pairs8<TC>::load(k1 + (32 * c + 8 * t) * kEl, kx);
        }
        mma_bf16(st, kw[0], kx[0], kw[1], kx[1], qf[c][0], qf[c][1]);
        mma_bf16(st2, kw[2], kx[2], kw[3], kx[3], qf[c][2], qf[c][3]);
      }
    }
    // the online update per query row (e & 1), its max over the slots of
    // the 8 lane quads
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = slot0 + g + 8 * (e >> 1);
      float x = st[e] + st2[e];
      if (kscale != nullptr) x *= kscale[slot];
      x *= sm_scale;
      st[e] = (whole || slot < live) ? x : kNegInf;
      mx[e & 1] = fmaxf(mx[e & 1], st[e]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // P, by select past the live slots (a NaN there adds nothing); l sums
    // it unscaled, and P V takes it times the V scale in bf16
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = slot0 + g + 8 * (e >> 1);
      const bool valid = whole || slot < live;
      p[e] = valid ? expf(st[e] - m[e & 1]) : 0.f;
      l[e & 1] += p[e];
      if (vscale != nullptr && valid) p[e] *= vscale[slot];
    }
    const uint32_t pb0 = transpose8x8(pack_bf16(p[0], p[1]));
    const uint32_t pb1 = transpose8x8(pack_bf16(p[2], p[3]));
#pragma unroll
    for (int n = 0; n < 4 * kGroups; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[1];
      o[n][2] *= alpha[0];
      o[n][3] *= alpha[1];
    }
    // O^T += V^T P^T: the lane's slots slot0 + {2t, 2t + 1, 2t + 8,
    // 2t + 9}, dims 64 G + 8 g + [0, 8)
#pragma unroll
    for (int G = 0; G < kGroups; ++G) {
      uint32_t vw[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int slot = slot0 + 2 * t + (x & 1) + 8 * (x >> 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) vw[x][i] = 0u;
        if (64 * G + 8 * g < hd && (whole || slot < live))
          Pairs8<TC>::load(vt + slot * row_bytes + (64 * G + 8 * g) * kEl,
                           vw[x]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(o[4 * G + j], __byte_perm(vw[0][j], vw[1][j], 0x5410u),
                 __byte_perm(vw[0][j], vw[1][j], 0x7632u),
                 __byte_perm(vw[2][j], vw[3][j], 0x5410u),
                 __byte_perm(vw[2][j], vw[3][j], 0x7632u), pb0, pb1);
    }
  }

  // l summed over the 8 lane quads (m is theirs already); the whole warp
  // calls it
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o2 = 4; o2 < 32; o2 <<= 1)
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], o2);
  }

  // the warp's query rows below `wrows` into `rows` ([8][stride] f32:
  // acc in dims [0, hd), m at hd, l at hd + 1), in head-dim order
  __device__ __forceinline__ void store(float* rows, int wrows, int hd,
                                        int stride, int g, int t) const {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * t + e;
      if (r >= wrows) continue;
      float* row = rows + r * stride;
#pragma unroll
      for (int G = 0; G < kGroups; ++G)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int d = 64 * G + 8 * g + 2 * j + hi;
            if (d < hd) row[d] = o[4 * G + j][2 * hi + e];
          }
      if (g == 0) {
        row[hd] = m[e];
        row[hd + 1] = l[e];
      }
    }
  }
};

}  // namespace mma_decode
