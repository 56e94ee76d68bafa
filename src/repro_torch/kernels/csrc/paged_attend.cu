// K6: paged decode/verify attention over a page-table KV cache.
//
// Replaces the Pallas kernel paged_attend (src/repro/kernels/
// paged_attend.py:97, body _kernel :41).  A slot's logical ring buffer is
// the concatenation of the pages its table row names; the kernel streams
// that chain page by page with an online softmax and never gathers it
// into a dense (B, context, ...) copy.
//
// Bound on the H100: bytes.  Each (slot, kv head) reads its query tile,
// the K and V rows of every page of its chain, and writes its output:
// bytes = Q + chain pages touched (K and V) + O, against 4 * L * n_rep *
// head_dim flops per cache row, far below the card's balance point.
// Design, kept simple for a first port:
//   * grid (n_kv, B): one block per (slot, kv head), 4 warps.  GQA rides
//     inside the block: the (L * n_rep, head_dim) query tile of the
//     head's n_rep query heads at all L positions lives in shared memory
//     in f32, beside the online-softmax state (m, l, acc);
//   * the block reads each page id from its own table row (no scalar
//     prefetch on Hopper) and loads the page's K and V rows of its kv
//     head into shared memory as f32 (bf16 or f32 in the pool);
//   * scores: one warp per (query row, page row), lanes over head_dim,
//     a fixed-order FMA sum and a warp tree; masked to -1e30 with the
//     ring-validity rule of the TPU kernel (paged_attend.py:64-71):
//     p_s from lin, slot_q, wraps; valid iff 0 <= p_s <= pos + l and
//     lin < context, which also masks every null-page row;
//   * online softmax with precise expf (no fast math), one warp per row;
//     acc += p @ V by one thread per (row, dim) over the page's rows;
//   * output acc / max(l, 1e-30) in q's dtype.
// Every sum runs in a fixed order, so the output is the same bits from
// one run to the next; against the plain version it agrees within
// tolerance (exp and the sums run in another order).  No wgmma, TMA or
// split chain: B * n_kv blocks leave most of the 132 SMs idle at small
// batch, which flash-decoding across CTAs would fix in a later change.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Max over the 32 lanes of a warp, broadcast to every lane.
__device__ __forceinline__ float warp_max_f32(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const T* __restrict__ pool_k, const T* __restrict__ pool_v,
                    const int* __restrict__ table, const int* __restrict__ pos,
                    const T* __restrict__ q, T* __restrict__ out, int n_chain,
                    int P, int n_kv, int D, int L, int R, int C, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;                   // kv head
  const int b = blockIdx.y;                   // slot
  const int LR = L * R;
  const int nq = n_kv * R;
  float* s_q = smem;                          // (LR, D)
  float* s_acc = s_q + LR * D;                // (LR, D)
  float* s_k = s_acc + LR * D;                // (P, D)
  float* s_v = s_k + P * D;                   // (P, D)
  float* s_p = s_v + P * D;                   // (LR, P) scores, then probs
  float* s_m = s_p + LR * P;                  // (LR,)
  float* s_l = s_m + LR;                      // (LR,)
  float* s_corr = s_l + LR;                   // (LR,)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // query row r = l * R + rep is q[b, l, h * R + rep, :]
  for (int i = tid; i < LR * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long src =
        ((static_cast<long long>(b) * L + r / R) * nq + h * R + r % R) * D + d;
    s_q[i] = to_f32(q[src]);
    s_acc[i] = 0.0f;
  }
  for (int r = tid; r < LR; r += kThreads) {
    s_m[r] = -__int_as_float(0x7f800000);      // -inf
    s_l[r] = 0.0f;
  }
  const int pos_b = pos[b];
  const int* chain = table + static_cast<long long>(b) * n_chain;
  __syncthreads();

  for (int j = 0; j < n_chain; ++j) {
    const long long pid = chain[j];
    for (int i = tid; i < P * D; i += kThreads) {
      const long long src = ((pid * P + i / D) * n_kv + h) * D + i % D;
      s_k[i] = to_f32(pool_k[src]);
      s_v[i] = to_f32(pool_v[src]);
    }
    __syncthreads();

    for (int rp = warp; rp < LR * P; rp += kWarps) {
      const int r = rp / P, p = rp % P;
      float part = 0.0f;
      for (int d = lane; d < D; d += 32)
        part = fmaf(s_q[r * D + d], s_k[p * D + d], part);
      part = warp_sum_f32(part);
      if (lane == 0) {
        const int pq = pos_b + r / R;
        const int slot_q = pq % C;
        const int wraps = pq / C;
        const int lin = j * P + p;
        const int p_s = lin <= slot_q ? wraps * C + lin : (wraps - 1) * C + lin;
        const bool valid = p_s >= 0 && p_s <= pq && lin < C;
        s_p[rp] = valid ? part * scale : kMasked;
      }
    }
    __syncthreads();

    for (int r = warp; r < LR; r += kWarps) {
      float mx = -__int_as_float(0x7f800000);
      for (int p = lane; p < P; p += 32) mx = fmaxf(mx, s_p[r * P + p]);
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max_f32(mx));
      float sum = 0.0f;
      for (int p = lane; p < P; p += 32) {
        const float e = expf(s_p[r * P + p] - m_new);
        s_p[r * P + p] = e;
        sum += e;
      }
      sum = warp_sum_f32(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[r] = corr;
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < LR * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float a = s_acc[i] * s_corr[r];
      for (int p = 0; p < P; ++p) a = fmaf(s_p[r * P + p], s_v[p * D + d], a);
      s_acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < LR * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long dst =
        ((static_cast<long long>(b) * L + r / R) * nq + h * R + r % R) * D + d;
    store(out + dst, s_acc[i] / fmaxf(s_l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* pool_k, const void* pool_v, const int* table,
           const int* pos, const void* q, void* out, int B, int n_chain, int P,
           int n_kv, int D, int L, int R, int C, float scale,
           cudaStream_t stream) {
  const int LR = L * R;
  const size_t smem =
      sizeof(float) * (2 * LR * D + 2 * P * D + LR * P + 3 * LR);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attend_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(n_kv, B);
  paged_attend_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(pool_k), static_cast<const T*>(pool_v), table, pos,
      static_cast<const T*>(q), static_cast<T*>(out), n_chain, P, n_kv, D, L,
      R, C, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pool_k, pool_v: (n_pages, P, n_kv, D); table: (B, n_chain) int32;
// pos: (B,) int32; q, out: (B, L, n_kv * R, D).  All contiguous, one
// element type: bf16 when is_bf16, else f32.
extern "C" int paged_attend_launch(const void* pool_k, const void* pool_v,
                                   const int* table, const int* pos,
                                   const void* q, void* out, int B,
                                   int n_chain, int P, int n_kv, int D, int L,
                                   int R, int C, float scale, int is_bf16,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(pool_k, pool_v, table, pos, q, out, B,
                                 n_chain, P, n_kv, D, L, R, C, scale, s);
  return launch<float>(pool_k, pool_v, table, pos, q, out, B, n_chain, P,
                       n_kv, D, L, R, C, scale, s);
}

