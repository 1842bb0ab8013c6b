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
// H100's ~295 bf16 tensor-core operations per byte.
//
// Design: the TPU kernels carry their state across a sequential
// superblock grid axis in VMEM scratch; Hopper has no ordered grid, so
// each CTA walks its own KV tiles (forward, dq) or q tiles (dk/dv) in a
// loop and nothing carries between CTAs. One CTA per (q tile, b * h) for
// the forward and dq, one per (KV tile, b * h_kv) for dk/dv, which loops
// over the GQA group's heads itself: no atomics, and the result does
// not change from run to run. Loops start and stop at the causal,
// window and prefix bounds, so tiles wholly outside the band are never
// loaded. bf16 products run on the tensor cores through WMMA (16x16x16,
// f32 accumulate) from 64-row tiles in shared memory; the f32
// instantiation multiplies with plain FMAs on 32-row tiles, so its
// comparison with the plain version is tight. Running max, sum and the
// accumulators live in shared memory. Not here yet: wgmma, TMA,
// accumulators in registers and overlap of loads with products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxHeadDim = 128;

// rows per tile and row padding (elements) of the dtype's tiles
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kB = 64;
  static constexpr int kPad = 8;
};
template <> struct Cfg<float> {
  static constexpr int kB = 32;
  static constexpr int kPad = 4;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = threadIdx.x >> 5;
    constexpr int tn = B / 16;
    for (int tile = warp; tile < tn * tn; tile += kWarps) {
      const int tr = tile / tn;
      const int tc = tile - tr * tn;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < d; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, A + tr * 16 * ld + k0, ld);
        wmma::load_matrix_sync(fb, Bm + tc * 16 * ld + k0, ld);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(C + tr * 16 * ldc + tc * 16, c, ldc,
                              wmma::mem_row_major);
    }
  } else {
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
}

// C[B, d] (f32) += A[B, B] . Bm[B, d], A and Bm tiles of T in shared memory
template <typename T>
__device__ void mm_ab_acc(const T* A, int lda, const T* Bm, int ldb, int d,
                          float* C, int ldc) {
  constexpr int B = Cfg<T>::kB;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = threadIdx.x >> 5;
    const int tn = d / 16;
    for (int tile = warp; tile < (B / 16) * tn; tile += kWarps) {
      const int tr = tile / tn;
      const int tc = tile - tr * tn;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* cp = C + tr * 16 * ldc + tc * 16;
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      for (int k0 = 0; k0 < B; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, A + tr * 16 * lda + k0, lda);
        wmma::load_matrix_sync(fb, Bm + k0 * ldb + tc * 16, ldb);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < B * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      const T* ar = A + r * lda;
      float s = C[r * ldc + c];
      for (int k = 0; k < B; ++k) s = fmaf(to_f(ar[k]), to_f(Bm[k * ldb + c]), s);
      C[r * ldc + c] = s;
    }
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

// B1, replaces `_flash_kernel` (ops/attention.py:105). Bound by
// operations: 4 d per visible pair against 2 d bytes per row of q and
// out. One CTA per (q tile, b * h) keeps its q tile and f32 accumulator
// in shared memory for the whole KV walk, so q is read once and K/V once
// per q tile; the walk stops at the causal, window and prefix bounds.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
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

// B2, replaces `_flash_bwd_dq_kernel` (ops/attention.py:528). Bound by
// operations: 6 d per visible pair. One CTA per (q tile, b * h) holds q,
// dO, lse and D for its rows and the dq accumulator, rebuilds P from
// (q, k, lse) tile by tile and never writes P or dS out.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
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

// B3, replaces `_flash_bwd_dkv_kernel` (ops/attention.py:635). Bound by
// operations: 8 d per visible pair. One CTA per (KV tile, b * h_kv)
// walks every head of its GQA group and the q tiles that can see its
// columns (from the diagonal on), so dk and dv are summed over the group
// in shared memory: no atomics, the same result from run to run.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
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
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_backward_dq_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dq, int b, int h, int h_kv, int t,
    int tkv, int d, int causal, int window, int row_offset, int prefix,
    void* stream) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dq<float>(a, s);
  if (dtype == 1) return launch_dq<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_backward_dkv_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dd, void* dk, void* dv, int b, int h,
    int h_kv, int t, int tkv, int d, int causal, int window, int row_offset,
    int prefix, void* stream) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dkv<float>(a, s);
  if (dtype == 1) return launch_dkv<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
