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
// sequence, against 4 * h * hd flops per slot: about one operation per
// byte, far below the H100's ~295 operations per byte of bf16 tensor
// work, so the least time is those bytes over 3.35 TB/s.
//
// Design. The TPU walked the cache as a sequential grid axis; here the
// live slots of each (sequence, KV head) are split into contiguous runs
// of 64-slot sub-tiles, one CTA per run, so that even a batch of 8 with
// 4 KV heads puts a few hundred CTAs on the 132 SMs (flash-decoding).
// Each CTA keeps its GQA group's `rep` query rows together, so every
// K/V byte is read from device memory once, and streams its sub-tiles
// into shared memory with cp.async, double-buffered so the next
// sub-tile's loads are in flight while this one is computed. Scores are
// one thread per (query row, slot), read in 16-byte chunks from rows
// padded by 16 bytes (no bank conflicts); the online softmax is one warp
// per query row, in f32. Each CTA writes its (m, l, acc) partial state;
// a second kernel merges a row's partials with the usual rescaling
// (when one CTA covers the whole range it writes the output itself).
// Not here yet: wgmma for the products, TMA, and an L2-aware split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSubT = 64;       // slots of K and V staged per step
constexpr int kPad = 16;        // bytes of padding per staged row
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return (float)x;
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

// one 16-byte chunk of a cache row, widened to f32
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
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
template <> struct Chunk<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = (float)c[i];
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

size_t smem_bytes(int stages, int rep, int hd, int row_stride) {
  return 2 * (size_t)stages * kSubT * row_stride      // K and V sub-tiles
         + (2 * (size_t)rep * hd                      // q rows, accumulator
            + (size_t)rep * kSubT                     // scores / probs
            + 2 * (size_t)stages * kSubT              // K and V scales
            + 3 * (size_t)rep) * sizeof(float);       // m, l, alpha
}

// grid (n_split, h_kv, b): CTA (s, head, seq) covers sub-tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) of the live slots.
template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ k,
    const TC* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, TQ* __restrict__ out,
    float* __restrict__ part, int h_kv, int rep, int hd, int L, int n_live,
    int tiles_per_split, int stages, float sm_scale) {
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int64_t bh = (int64_t)blockIdx.z * h_kv + blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool quantized = ks != nullptr;
  const int row_bytes = hd * (int)sizeof(TC);
  const int row_stride = row_bytes + kPad;
  const size_t tile_bytes = (size_t)kSubT * row_stride;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;                            // [stages][kSubT][row]
  unsigned char* v_s = smem + stages * tile_bytes;
  float* q_s = reinterpret_cast<float*>(smem + 2 * stages * tile_bytes);
  float* acc_s = q_s + rep * hd;                        // [rep, hd]
  float* p_s = acc_s + rep * hd;                        // [rep, kSubT]
  float* ks_s = p_s + rep * kSubT;                      // [stages][kSubT]
  float* vs_s = ks_s + stages * kSubT;
  float* m_s = vs_s + stages * kSubT;
  float* l_s = m_s + rep;
  float* alpha_s = l_s + rep;

  // query row r of this KV head is head (blockIdx.y * rep + r)
  for (int i = tid; i < rep * hd; i += kThreads) {
    q_s[i] = to_f(q[bh * rep * hd + i]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k) + bh * L * row_bytes;
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v) + bh * L * row_bytes;
  const int chunks_per_row = row_bytes / 16;
  const int n_tiles = (n_live + kSubT - 1) / kSubT;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);

  // start the copies of sub-tile `tile` into buffer `stage`
  auto load_tile = [&](int tile, int stage) {
    const int t0 = tile * kSubT;
    const int nt = min(kSubT, n_live - t0);
    unsigned char* kd = k_s + stage * tile_bytes;
    unsigned char* vd = v_s + stage * tile_bytes;
    const unsigned char* ksrc = kb + (int64_t)t0 * row_bytes;
    const unsigned char* vsrc = vb + (int64_t)t0 * row_bytes;
    for (int i = tid; i < nt * chunks_per_row; i += kThreads) {
      const int r = i / chunks_per_row;
      const int c = i - r * chunks_per_row;
      cp_async16(kd + r * row_stride + c * 16, ksrc + (int64_t)i * 16);
      cp_async16(vd + r * row_stride + c * 16, vsrc + (int64_t)i * 16);
    }
    if (quantized) {
      for (int i = tid; i < nt; i += kThreads) {
        cp_async4(ks_s + stage * kSubT + i, ks + bh * L + t0 + i);
        cp_async4(vs_s + stage * kSubT + i, vs + bh * L + t0 + i);
      }
    }
  };

  if (tile_begin < tile_end) load_tile(tile_begin, 0);
  cp_async_commit();
  for (int j = tile_begin; j < tile_end; ++j) {
    const int st = stages == 2 ? (j - tile_begin) & 1 : 0;
    if (stages == 2) {
      // the next sub-tile's loads go out before this one is computed
      if (j + 1 < tile_end) load_tile(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int nt = min(kSubT, n_live - j * kSubT);
    const unsigned char* kt = k_s + st * tile_bytes;
    const unsigned char* vt = v_s + st * tile_bytes;
    const float* kscale = ks_s + st * kSubT;
    const float* vscale = vs_s + st * kSubT;

    // scores s[r, t] = (q_r . k_t) (* ks_t) * sm_scale, a thread each
    for (int idx = tid; idx < rep * kSubT; idx += kThreads) {
      const int r = idx / kSubT;
      const int t = idx - r * kSubT;
      if (t < nt) {
        const unsigned char* krow = kt + t * row_stride;
        const float* qr = q_s + r * hd;
        float s = 0.f;
        for (int c = 0; c < hd; c += Chunk<TC>::N) {
          float kv[Chunk<TC>::N];
          Chunk<TC>::load(krow + c * (int)sizeof(TC), kv);
#pragma unroll
          for (int e = 0; e < Chunk<TC>::N; ++e) s += qr[c + e] * kv[e];
        }
        if (quantized) s *= kscale[t];
        p_s[r * kSubT + t] = s * sm_scale;
      }
    }
    __syncthreads();

    // online softmax, one warp per query row; P is scaled by the V scale
    // and rounded to q's dtype for the P.V product, after l has summed it
    for (int r = warp; r < rep; r += kWarps) {
      float* pr = p_s + r * kSubT;
      float mx = kNegInf;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        float p = expf(pr[t] - m_new);
        sum += p;
        if (quantized) p *= vscale[t];
        pr[t] = round_to<TQ>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r, d] = acc * alpha + sum_t P[r, t] * V[t, d]
    for (int idx = tid; idx < rep * hd; idx += kThreads) {
      const int r = idx / hd;
      const int d = idx - r * hd;
      const float* pr = p_s + r * kSubT;
      float a = acc_s[idx] * alpha_s[r];
      for (int t = 0; t < nt; ++t)
        a += pr[t] *
             to_f(reinterpret_cast<const TC*>(vt + t * row_stride)[d]);
      acc_s[idx] = a;
    }
    __syncthreads();
    if (stages == 1 && j + 1 < tile_end) {
      load_tile(j + 1, 0);
      cp_async_commit();
    }
  }

  if (n_split == 1) {
    for (int idx = tid; idx < rep * hd; idx += kThreads) {
      const int r = idx / hd;
      out[bh * rep * hd + idx] = from_f<TQ>(acc_s[idx] / l_s[r]);
    }
    return;
  }
  // partial state [bh, split, r, 0:hd] = acc, [hd] = m, [hd + 1] = l
  const int stride = hd + 2;
  float* mine = part + ((bh * n_split + split) * rep) * stride;
  for (int idx = tid; idx < rep * hd; idx += kThreads) {
    const int r = idx / hd;
    mine[r * stride + idx - r * hd] = acc_s[idx];
  }
  for (int r = tid; r < rep; r += kThreads) {
    mine[r * stride + hd] = m_s[r];
    mine[r * stride + hd + 1] = l_s[r];
  }
}

// one CTA per (sequence, KV head): merges the n_split partial states of
// each of its query rows, rescaled to their common maximum
template <typename TQ>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ part, TQ* __restrict__ out, int rep, int hd,
    int n_split) {
  const int64_t bh = blockIdx.x;
  const int stride = hd + 2;
  const int64_t split_stride = (int64_t)rep * stride;
  for (int idx = threadIdx.x; idx < rep * hd; idx += kThreads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const float* base = part + (bh * n_split * rep + r) * stride;
    float m = kNegInf;
    for (int s = 0; s < n_split; ++s)
      m = fmaxf(m, base[s * split_stride + hd]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = base + s * split_stride;
      const float w = expf(ps[hd] - m);
      l += ps[hd + 1] * w;
      a += ps[d] * w;
    }
    out[bh * rep * hd + idx] = from_f<TQ>(a / l);
  }
}

template <typename TQ, typename TC>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* out, void* part, int b, int h_kv, int rep,
           int hd, int L, int n_live, int tiles_per_split, int n_split,
           cudaStream_t stream) {
  if (hd % 16 != 0 || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int row_stride = hd * (int)sizeof(TC) + kPad;
  int stages = 2;
  size_t smem = smem_bytes(stages, rep, hd, row_stride);
  if (smem > kMaxSmem) {
    stages = 1;
    smem = smem_bytes(stages, rep, hd, row_stride);
  }
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<TQ, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_split, h_kv, b);
  decode_kernel<TQ, TC><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<TQ*>(out),
      static_cast<float*>(part), h_kv, rep, hd, L, n_live, tiles_per_split,
      stages, (float)(1.0 / sqrt((double)hd)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  combine_kernel<TQ><<<b * h_kv, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<TQ*>(out), rep, hd,
      n_split);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_q(int quantized, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, void* out, void* part, int b,
             int h_kv, int rep, int hd, int L, int n_live,
             int tiles_per_split, int n_split, cudaStream_t stream) {
  if (quantized)
    return launch<TQ, int8_t>(q, k, v, ks, vs, out, part, b, h_kv, rep, hd,
                              L, n_live, tiles_per_split, n_split, stream);
  return launch<TQ, TQ>(q, k, v, nullptr, nullptr, out, part, b, h_kv, rep,
                        hd, L, n_live, tiles_per_split, n_split, stream);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; quantized: the cache holds int8
// codes and ks/vs are its f32 scales (else the cache is in q's dtype and
// ks/vs are ignored). `part` is f32 scratch [b * h_kv, n_split, rep,
// hd + 2], needed when n_split > 1. Returns a cudaError_t (0 = success).
extern "C" int flash_decode_attention_launch(
    int q_dtype, int quantized, const void* q, const void* k, const void* v,
    const void* ks, const void* vs, void* out, void* part, int b, int h_kv,
    int rep, int hd, int L, int n_live, int tiles_per_split, int n_split,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(quantized, q, k, v, ks, vs, out, part, b, h_kv,
                           rep, hd, L, n_live, tiles_per_split, n_split, s);
  if (q_dtype == 1)
    return launch_q<__nv_bfloat16>(quantized, q, k, v, ks, vs, out, part, b,
                                   h_kv, rep, hd, L, n_live, tiles_per_split,
                                   n_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
