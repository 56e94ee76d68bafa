// K6: paged decode/verify attention over a page-table KV cache.
//
// Replaces the Pallas kernel paged_attend (src/repro/kernels/
// paged_attend.py:97, body _kernel :41).  A slot's logical ring buffer is
// the concatenation of the pages its table row names; the kernel streams
// that chain page by page with an online softmax and never gathers it
// into a dense (B, context, ...) copy.
//
// Bound on the H100: bytes.  Each (slot, kv head) reads its query tile,
// the K and V rows of the pages its queries can see, and writes its
// output: bytes = Q + pages touched (K and V) + O, against 4 * L * n_rep
// * head_dim flops per cache row, far below the card's balance point.
// Design: split-chain flash-decoding.
//   * grid (n_split, n_kv, B), 128 threads.  n_split is a pure function
//     of the shape (kernels/paged_attend.py::split_geometry: about two
//     blocks per SM, capped by the chain), never of the data, so results
//     are the same bits from run to run.  Split s takes the chain's pages
//     [s * pps, (s + 1) * pps) and writes its partial (m, l, acc) in f32
//     to scratch the wrapper allocates.
//   * GQA rides inside the block: the (L * n_rep, head_dim) query tile of
//     the kv head's n_rep query heads at all L positions, in f32 shared
//     memory, beside the split's online-softmax state.
//   * Pages come in by 16-byte cp.async into a ring of 4 pages and stay in
//     the pool's dtype (bf16 or f32) in shared memory; the next pages'
//     copies overlap the current page's math, and the query tile's load
//     overlaps the first pages'.  Page ids come from the block's own
//     table row: the first ones read together with pos, each later one a
//     page ahead of its copy.  head_dim is a template parameter, so no
//     index divides by it at run time.
//   * Validity: the TPU kernel's ring rule (paged_attend.py:64-71; p_s
//     from lin, slot_q, wraps; valid iff 0 <= p_s <= pos + l and
//     lin < context) reduces to lin < min(pos + l + 1, context), one bound
//     per query row computed once.  A page at or past the largest bound
//     has no valid row for any query and is never read; that is exact, by
//     the argument of K7's skipped tiles (a masked page is a no-op after a
//     valid one; its garbage before the first valid one, p = 1 against
//     m = -1e30, is wiped by corr = exp(-1e30 - m) = 0).  Null-page rows
//     lie past the bound too.
//   * One warp per query row.  Scores: lanes l and l + 16 take page row
//     l % 16 (and l % 16 + 16, ...), the even and the odd 8-column chunks
//     of it, and add their halves by one xor shuffle (K rows padded by 16
//     bytes in shared memory, so those reads hit distinct banks); then the
//     online softmax with precise expf and xor-butterfly max and sum (every
//     lane holds the same bits); then acc += p V with each lane on its own
//     columns.  The bound is bytes, and L * n_rep rows are few (4 on the
//     served path), so the products stay on the CUDA cores in f32.
//   * A second kernel, launched back to back from the same C entry point,
//     merges the splits in split order: m = max m_s, weights exp(m_s - m),
//     l and acc summed in split order, out = acc / max(l, 1e-30) in q's
//     dtype.  A split with no valid page keeps m = -inf, l = 0, acc = 0
//     and weighs exactly 0; every row has a valid split (its own
//     position).
// Every sum runs in a fixed order, so the output is the same bits from
// one run to the next; against the plain version with the same n_split it
// agrees within float tolerance (exp and the sums in another order).
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;                    // pages in flight per block
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// N consecutive elements from shared memory as f32 (N * sizeof(T) bytes
// aligned to its size, one vector load).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&o)[N]) {
  if constexpr (N == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&o)[N]) {
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Max and sum over the 32 lanes of a warp by xor butterflies: every lane
// ends with the same bits (each level adds the same two values, in one
// order or the other).
__device__ __forceinline__ float warp_max_all(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum_all(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// K rows in the ring are padded by 16 bytes, so the lanes of a warp that
// read one column chunk of 8 different rows hit 8 different bank groups.
template <typename T, int D>
__host__ __device__ constexpr int k_stride() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Shared memory of one split block, in bytes (kernels/paged_attend.py::
// smem_bytes mirrors it): the page ring (K padded, then V, per page),
// then q and acc (LR x D f32), scores (LR x P f32), m and l (LR f32
// each), the row bounds (LR int).
template <typename T, int D>
__host__ __device__ constexpr size_t ring_bytes(int P) {
  return static_cast<size_t>(kStages) * P * (k_stride<T, D>() + D) *
         sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ pool_k, const T* __restrict__ pool_v,
                   const int* __restrict__ table, const int* __restrict__ pos,
                   const T* __restrict__ q, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int n_chain, int pps, int P, int n_kv, int L, int R, int C,
                   float scale) {
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr int kRowChunks = D / kVec;        // copies per page row
  constexpr int kChunks = D / 8;              // 8-column chunks of a row
  constexpr int kPerLane = D >= 32 ? D / 32 : 1;   // P V columns per lane
  constexpr int kKStride = k_stride<T, D>();
  static_assert(D % 16 == 0 && D <= 256, "unsupported head_dim");
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int h = blockIdx.y;                   // kv head
  const int b = blockIdx.z;                   // slot
  const int n_split = gridDim.x;
  const int LR = L * R;
  const int nq = n_kv * R;
  const int page_elems = P * (kKStride + D);  // one page of the ring
  T* s_ring = reinterpret_cast<T*>(smem);     // [kStages][K (padded), V]
  float* s_q = reinterpret_cast<float*>(smem + ring_bytes<T, D>(P));
  float* s_acc = s_q + LR * D;                // (LR, D)
  float* s_p = s_acc + LR * D;                // (LR, P)
  float* s_m = s_p + LR * P;                  // (LR,)
  float* s_l = s_m + LR;                      // (LR,)
  int* s_hi = reinterpret_cast<int*>(s_l + LR);   // (LR,) valid lin < hi
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the position and the split's first page ids, all loads in flight at
  // once (ids past the valid pages are read but never used)
  const int j0 = split * pps;
  const int* chain = table + static_cast<long long>(b) * n_chain;
  const int pos_b = pos[b];
  int pid_first[kStages];
#pragma unroll
  for (int t = 0; t < kStages; ++t)
    pid_first[t] = j0 + t < n_chain ? chain[j0 + t] : 0;
  // pages past the largest bound hold no valid row for any query
  const int hi_max = min(pos_b + L, C);
  const int j1 = min(min(j0 + pps, n_chain), (hi_max + P - 1) / P);
  const int n_pages = max(j1 - j0, 0);

  auto load_page = [&](int i, long long pid) {
    T* dk = s_ring + static_cast<size_t>(i % kStages) * page_elems;
    T* dv = dk + P * kKStride;
    for (int c = tid; c < P * kRowChunks; c += kThreads) {
      const int row = c / kRowChunks;
      const int col = (c % kRowChunks) * kVec;
      const long long src = ((pid * P + row) * n_kv + h) * D + col;
      cp_async16(dk + row * kKStride + col, pool_k + src);
      cp_async16(dv + row * D + col, pool_v + src);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_pages) load_page(i, pid_first[i]);
    cp_async_commit();
  }
  // the id of the page the loop loads next, one page ahead of its use
  int pid_ahead = pid_first[kStages - 1];

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
    s_hi[r] = min(pos_b + r / R + 1, C);
  }

  const int half = lane >> 4;                 // scores: which column half
  const int col0 = lane * kPerLane;           // P V: this lane's columns
  const bool has_cols = col0 < D;
  for (int i = 0; i < n_pages; ++i) {
    if (i + kStages - 1 < n_pages) load_page(i + kStages - 1, pid_ahead);
    cp_async_commit();
    if (i + kStages < n_pages) pid_ahead = chain[j0 + i + kStages];
    cp_async_wait<kStages - 1>();             // page i has landed
    __syncthreads();
    const T* pk = s_ring + static_cast<size_t>(i % kStages) * page_elems;
    const T* pv = pk + P * kKStride;
    const int lin0 = (j0 + i) * P;

    // one warp per query row: scores, online softmax, then acc += p V
    for (int r = warp; r < LR; r += kWarps) {
      const int lim = s_hi[r] - lin0;         // keys p < lim are valid
      const float* qr = s_q + r * D;
      float* pr = s_p + r * P;
      float mx = -__int_as_float(0x7f800000);
      // lanes l and l + 16 take page row p = l % 16 (+ 16 k), the even
      // and the odd 8-column chunks of it, and add their halves
      for (int pb = 0; pb < P; pb += 16) {
        const int p = pb + (lane & 15);
        float part = 0.0f;
        if (p < P) {
#pragma unroll
          for (int c2 = 0; c2 < kChunks / 2; ++c2) {
            const int c = 8 * (2 * c2 + half);
            float kv[8], qv[8];
            load_f32(pk + p * kKStride + c, kv);
            load_f32(qr + c, qv);
#pragma unroll
            for (int e = 0; e < 8; ++e) part = fmaf(qv[e], kv[e], part);
          }
        }
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 16));
        if (p < P) {
          const float x = p < lim ? part * scale : kMasked;
          if (half == 0) pr[p] = x;
          mx = fmaxf(mx, x);
        }
      }
      __syncwarp();
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max_all(mx));
      float sum = 0.0f;
      for (int p = lane; p < P; p += 32) {
        const float e = expf(pr[p] - m_new);
        pr[p] = e;
        sum = __fadd_rn(sum, e);
      }
      sum = warp_sum_all(sum);
      const float corr = expf(m_old - m_new);
      __syncwarp();
      if (has_cols) {
        float a[kPerLane];
        load_f32(s_acc + r * D + col0, a);
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) a[c] *= corr;
        for (int p = 0; p < P; ++p) {
          const float e = pr[p];
          float vr[kPerLane];
          load_f32(pv + p * D + col0, vr);
#pragma unroll
          for (int c = 0; c < kPerLane; ++c) a[c] = fmaf(e, vr[c], a[c]);
        }
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) s_acc[r * D + col0 + c] = a[c];
      }
      if (lane == 0) {
        s_l[r] = __fadd_rn(__fmul_rn(s_l[r], corr), sum);
        s_m[r] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();                          // the ring slot is free again
  }
  cp_async_wait<0>();
  __syncthreads();

  const long long part_row =
      ((static_cast<long long>(b) * n_kv + h) * n_split + split) * LR;
  for (int r = tid; r < LR; r += kThreads) {
    part_m[part_row + r] = s_m[r];
    part_l[part_row + r] = s_l[r];
  }
  for (int i = tid; i < LR * D; i += kThreads)
    part_acc[part_row * D + i] = s_acc[i];
}

// Merge the splits in split order: one thread per output element of a
// (slot, kv head), grid (ceil(L * R * D / 128), n_kv, B).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int n_split, int n_kv, int L, int R) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int LR = L * R;
  if (i >= LR * D) return;
  const int r = i / D, d = i % D;
  const int nq = n_kv * R;
  const long long base =
      (static_cast<long long>(b) * n_kv + h) * n_split * LR + r;
  float m = -__int_as_float(0x7f800000);
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_m[base + s * LR]);
  float l = 0.0f, acc = 0.0f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const long long row = base + s * LR;
    const float w = expf(part_m[row] - m);
    l = __fadd_rn(l, __fmul_rn(w, part_l[row]));
    acc = __fadd_rn(acc, __fmul_rn(w, part_acc[row * D + d]));
  }
  const long long dst =
      ((static_cast<long long>(b) * L + r / R) * nq + h * R + r % R) * D + d;
  store(out + dst, acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch(const void* pool_k, const void* pool_v, const int* table,
           const int* pos, const void* q, void* out, float* scratch, int B,
           int n_chain, int P, int n_kv, int L, int R, int C, int n_split,
           int pps, float scale, cudaStream_t stream) {
  const int LR = L * R;
  const size_t smem = ring_bytes<T, D>(P) +
                      sizeof(float) * (2 * LR * D + LR * P + 2 * LR) +
                      sizeof(int) * LR;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long rows = static_cast<long long>(B) * n_kv * n_split * LR;
  float* part_m = scratch;
  float* part_l = part_m + rows;
  float* part_acc = part_l + rows;
  paged_split_kernel<T, D><<<dim3(n_split, n_kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(pool_k), static_cast<const T*>(pool_v), table, pos,
      static_cast<const T*>(q), part_m, part_l, part_acc, n_chain, pps, P,
      n_kv, L, R, C, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_combine_kernel<T, D>
      <<<dim3((LR * D + kThreads - 1) / kThreads, n_kv, B), kThreads, 0,
         stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_split, n_kv, L, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* pool_k, const void* pool_v, const int* table,
               const int* pos, const void* q, void* out, float* scratch, int B,
               int n_chain, int P, int n_kv, int D, int L, int R, int C,
               int n_split, int pps, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(pool_k, pool_v, table, pos, q, out, scratch, B, n_chain, P, n_kv, L, R, C, n_split, pps, scale, s);
    case 32: return launch<T, 32>(pool_k, pool_v, table, pos, q, out, scratch, B, n_chain, P, n_kv, L, R, C, n_split, pps, scale, s);
    case 64: return launch<T, 64>(pool_k, pool_v, table, pos, q, out, scratch, B, n_chain, P, n_kv, L, R, C, n_split, pps, scale, s);
    case 128: return launch<T, 128>(pool_k, pool_v, table, pos, q, out, scratch, B, n_chain, P, n_kv, L, R, C, n_split, pps, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// pool_k, pool_v: (n_pages, P, n_kv, D), 16-byte aligned; table:
// (B, n_chain) int32; pos: (B,) int32; q, out: (B, L, n_kv * R, D);
// scratch: B * n_kv * n_split * L * R * (D + 2) f32.  All contiguous, one
// element type: bf16 when is_bf16, else f32.  D in {16, 32, 64, 128};
// split s covers the chain's pages [s * pps, (s + 1) * pps).
extern "C" int paged_attend_launch(const void* pool_k, const void* pool_v,
                                   const int* table, const int* pos,
                                   const void* q, void* out, void* scratch,
                                   int B, int n_chain, int P, int n_kv, int D,
                                   int L, int R, int C, int n_split, int pps,
                                   float scale, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (is_bf16)
    return launch_dim<__nv_bfloat16>(pool_k, pool_v, table, pos, q, out, sc, B,
                                     n_chain, P, n_kv, D, L, R, C, n_split,
                                     pps, scale, s);
  return launch_dim<float>(pool_k, pool_v, table, pos, q, out, sc, B, n_chain,
                           P, n_kv, D, L, R, C, n_split, pps, scale, s);
}
