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
// least time is live K+V bytes over 3.35 TB/s.
//
// Design: one CTA per (KV head, sequence). The CTA reads its own
// lens[seq] and table[seq, j] (Hopper has no scalar prefetch) and loops
// over the live blocks, which the TPU ran as a sequential grid axis. The
// GQA group's `rep` query rows stay together in the CTA, so each K/V
// tile is read from device memory once and serves every query head of
// its group. Tiles are staged in shared memory in sub-tiles of at most
// kSubT tokens with 16-byte loads, and only the valid rows of the last
// block are read, so device traffic is O(lens). The softmax is the
// online (running max / normaliser) form in f32. Not here yet: TMA,
// wgmma, and a split of a sequence's blocks across CTAs; at the serving
// shapes the grid is b * h_kv CTAs, far fewer than the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSubT = 64;        // tokens of K and V staged per step
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline int sub_tokens(int block_t) { return block_t < kSubT ? block_t : kSubT; }

template <typename T>
size_t smem_bytes(int rep, int hd, int block_t) {
  const size_t st = sub_tokens(block_t);
  return 2 * st * hd * sizeof(T)                       // K and V sub-tiles
         + (2 * (size_t)rep * hd                       // q rows, accumulator
            + (size_t)rep * st                         // scores / probs
            + 3 * (size_t)rep) * sizeof(float);        // m, l, alpha
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const int* __restrict__ table,
    const int* __restrict__ lens, T* __restrict__ out, int h_kv, int rep,
    int hd, int block_t, int max_blocks, int n_live_blocks, float sm_scale) {
  const int head = blockIdx.x;
  const int seq = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int st = block_t < kSubT ? block_t : kSubT;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)st * hd;
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)st * hd);
  float* acc_s = q_s + rep * hd;
  float* p_s = acc_s + rep * hd;  // [rep, st]
  float* m_s = p_s + rep * st;
  float* l_s = m_s + rep;
  float* alpha_s = l_s + rep;

  const int len = lens[seq];
  // query row of (seq, head * rep + r) is (seq * h_kv + head) * rep + r
  const int64_t row0 = ((int64_t)seq * h_kv + head) * rep;
  for (int i = tid; i < rep * hd; i += kThreads) {
    q_s[i] = to_f(q[row0 * hd + i]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const bool vec =
      ((reinterpret_cast<uintptr_t>(pool_k) |
        reinterpret_cast<uintptr_t>(pool_v)) % 16 == 0) &&
      ((size_t)hd * sizeof(T)) % 16 == 0;
  const int n_blk = min(n_live_blocks, (len + block_t - 1) / block_t);
  const int64_t tile = (int64_t)block_t * hd;

  for (int j = 0; j < n_blk; ++j) {
    const int64_t blk = table[(int64_t)seq * max_blocks + j];
    const T* kb = pool_k + (blk * h_kv + head) * tile;
    const T* vb = pool_v + (blk * h_kv + head) * tile;
    const int valid = min(block_t, len - j * block_t);
    for (int t0 = 0; t0 < valid; t0 += st) {
      const int nt = min(st, valid - t0);
      const T* ksrc = kb + (int64_t)t0 * hd;
      const T* vsrc = vb + (int64_t)t0 * hd;
      if (vec) {
        const int n_vec = (int)((size_t)nt * hd * sizeof(T) / 16);
        const uint4* k4 = reinterpret_cast<const uint4*>(ksrc);
        const uint4* v4 = reinterpret_cast<const uint4*>(vsrc);
        uint4* kd = reinterpret_cast<uint4*>(k_s);
        uint4* vd = reinterpret_cast<uint4*>(v_s);
        for (int i = tid; i < n_vec; i += kThreads) {
          kd[i] = k4[i];
          vd[i] = v4[i];
        }
      } else {
        for (int i = tid; i < nt * hd; i += kThreads) {
          k_s[i] = ksrc[i];
          v_s[i] = vsrc[i];
        }
      }
      __syncthreads();

      // scores s[r, t] = (q_r . k_t) * sm_scale, one warp per (r, t)
      for (int idx = warp; idx < rep * nt; idx += kWarps) {
        const int r = idx / nt;
        const int t = idx - r * nt;
        float s = 0.f;
        for (int d = lane; d < hd; d += 32)
          s += q_s[r * hd + d] * to_f(k_s[t * hd + d]);
        s = warp_sum(s);
        if (lane == 0) p_s[r * st + t] = s * sm_scale;
      }
      __syncthreads();

      // online softmax, one warp per query row
      for (int r = warp; r < rep; r += kWarps) {
        float mx = kNegInf;
        for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, p_s[r * st + t]);
        mx = warp_max(mx);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < nt; t += 32) {
          const float p = expf(p_s[r * st + t] - m_new);
          p_s[r * st + t] = p;
          sum += p;
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

      // acc[r, d] = acc * alpha + sum_t P[r, t] (in V's dtype) * V[t, d]
      for (int idx = tid; idx < rep * hd; idx += kThreads) {
        const int r = idx / hd;
        const int d = idx - r * hd;
        const float* pr = p_s + r * st;
        float a = acc_s[idx] * alpha_s[r];
        for (int t = 0; t < nt; ++t)
          a += to_f(from_f<T>(pr[t])) * to_f(v_s[t * hd + d]);
        acc_s[idx] = a;
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < rep * hd; idx += kThreads) {
    const int r = idx / hd;
    out[row0 * hd + idx] = from_f<T>(acc_s[idx] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* table, const void* lens, void* out, int b, int h,
           int h_kv, int hd, int block_t, int max_blocks, int n_live_blocks,
           cudaStream_t stream) {
  const int rep = h / h_kv;
  const size_t smem = smem_bytes<T>(rep, hd, block_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(h_kv, b);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<T*>(out), h_kv, rep, hd,
      block_t, max_blocks, n_live_blocks, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int paged_decode_attention_launch(
    int dtype, const void* q, const void* pool_k, const void* pool_v,
    const void* table, const void* lens, void* out, int b, int h, int h_kv,
    int hd, int block_t, int max_blocks, int n_live_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pool_k, pool_v, table, lens, out, b, h, h_kv, hd,
                         block_t, max_blocks, n_live_blocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pool_k, pool_v, table, lens, out, b, h,
                                 h_kv, hd, block_t, max_blocks,
                                 n_live_blocks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
