// K7: causal flash-attention forward, with an optional sliding-window band.
//
// Replaces the Pallas kernel _flash_fwd_pallas (src/repro/kernels/
// flash_fwd.py:82, body _kernel :35): for every (batch, query head) the
// causal softmax attention of q over k, v, with scores, the online-softmax
// state (m, l, acc) and the P.V product in f32, masked scores at -1e30,
// out = acc / max(l, 1e-30) in q's dtype.  With window > 0 a key is seen
// only when kpos > qpos - window.  GQA: query head h reads kv head
// h / n_rep, and K/V are never repeated.
//
// Bound on the H100: operations.  A causal (B, S, H, D) call does
// 4 * B * H * D * S * (S + 1) / 2 flops against 2 * 4 * B * S * H * D
// bytes of Q, K, V and O (137.4 GFLOP and 67 MB at B=2, S=4096, H=16,
// D=128 in bf16: 0.139 ms at 989 TFLOP/s on the tensor cores, 2.05 ms at
// 67 TFLOP/s on the f32 CUDA cores, 0.02 ms of memory traffic).
// Design, kept simple for a first port (plain f32 FMAs on the CUDA cores;
// no mma.sync, wgmma or TMA yet):
//   * grid (S / 64 query tiles, H, B), 256 threads, the heaviest query
//     tiles (last in the sequence) first;
//   * the block holds its 64-row query tile in shared memory as f32,
//     transposed, and streams 64-row K and V tiles through shared memory
//     (f32, K rows padded by one float so column reads hit 32 banks);
//   * a kv tile wholly above the diagonal or wholly outside the band is
//     skipped; that is exact, because such a tile changes nothing after
//     a valid one, and any garbage it leaves before the first valid tile
//     (p = 1 against m = -1e30) is wiped by corr = exp(-1e30 - m) = 0;
//   * scores: each thread a 4 x 4 register tile (rows 4*ty + i, keys
//     tx + 16*j), summed over head_dim in order with fmaf, then scaled
//     and masked as the TPU kernel does (kpos <= qpos, the band);
//   * online softmax: one warp per row, precise expf (no fast math),
//     fixed-order warp sums; the row's (m, l, corr) in shared memory;
//   * acc (4 rows x head_dim / 16 columns per thread) stays in registers:
//     acc = acc * corr, then one fmaf per key in key order;
//   * rows and keys past S are zero-filled and never stored, so any S
//     works.
// Every sum runs in a fixed order, so the output is the same bits from
// one run to the next.  Against the TPU kernel (kv tiles of 1024) it
// agrees within float tolerance: the online softmax rescales at other
// tile edges.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // key rows per kv tile
constexpr int kThreads = 256;            // a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr int kStrideP = kBK + 1;        // score rows, padded
constexpr float kMasked = -1e30f;
static_assert(kBK == 64, "the softmax pass gives each lane two keys");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Max over the 32 lanes of a warp, broadcast to every lane.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int D>
constexpr size_t smem_floats() {
  return D * kBQ + kBK * (D + 1) + kBK * D + kBQ * kStrideP + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Hq,
                 int n_rep, int window, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kStrideK = D + 1;
  constexpr int kCols = D / 16;          // acc columns per thread
  extern __shared__ __align__(16) float smem[];
  float* s_qt = smem;                    // (D, BQ): the query tile, transposed
  float* s_k = s_qt + D * kBQ;           // (BK, D + 1)
  float* s_v = s_k + kBK * kStrideK;     // (BK, D)
  float* s_p = s_v + kBK * D;            // (BQ, BK + 1): scores, then probs
  float* s_m = s_p + kBQ * kStrideP;     // (BQ,)
  float* s_l = s_m + kBQ;                // (BQ,)
  float* s_corr = s_l + kBQ;             // (BQ,)

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hk = Hq / n_rep;
  const int q0 = q_tile * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long q_row = static_cast<long long>(Hq) * D;   // per position
  const long long k_row = static_cast<long long>(Hk) * D;
  const T* qb = q + static_cast<long long>(b) * S * q_row + h * D;
  const T* kb = k + static_cast<long long>(b) * S * k_row + (h / n_rep) * D;
  const T* vb = v + static_cast<long long>(b) * S * k_row + (h / n_rep) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i % kBQ, d = i / kBQ;
    const int p = q0 + r;
    s_qt[d * kBQ + r] = p < S ? to_f32(qb[p * q_row + d]) : 0.0f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    s_m[r] = -__int_as_float(0x7f800000);      // -inf
    s_l[r] = 0.0f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_tiles = q_last / kBK + 1;        // tiles at or below the diagonal
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;  // below the band
    __syncthreads();                           // the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int p = k0 + c;
      const bool in = p < S;
      s_k[c * kStrideK + d] = in ? to_f32(kb[p * k_row + d]) : 0.0f;
      s_v[c * D + d] = in ? to_f32(vb[p * k_row + d]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(s_qt + d * kBQ + 4 * ty);
      const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
      float ks[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ks[j] = s_k[(tx + 16 * j) * kStrideK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qs[i], ks[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool valid =
            kpos <= qpos && (window <= 0 || kpos > qpos - window);
        s_p[r * kStrideP + c] = valid ? sc[i][j] * scale : kMasked;
      }
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += kWarps) {
      float* row = s_p + r * kStrideP;
      const float a = row[lane], c = row[lane + 32];
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      row[lane] = pa;
      row[lane + 32] = pc;
      const float sum = warp_sum_f32(pa + pc);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[r] = corr;
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = s_corr[4 * ty + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float ps[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ps[i] = s_p[(4 * ty + i) * kStrideP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = s_v[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ps[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int p = q0 + r;
    if (p >= S) continue;
    const float l = fmaxf(s_l[r], 1e-30f);
    T* o = out + (static_cast<long long>(b) * S + p) * q_row + h * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(o + tx + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int n_rep, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, n_rep, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Hq, int n_rep, int D, int window, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Hq, n_rep, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Hq, n_rep, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Hq, n_rep, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Hq, n_rep, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (B, S, Hq, D); k, v: (B, S, Hq / n_rep, D).  All contiguous, one
// element type: bf16 when is_bf16, else f32.  D in {16, 32, 64, 128}.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int S, int Hq, int n_rep,
                                int D, int window, float scale, int is_bf16,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dim<__nv_bfloat16>(q, k, v, out, B, S, Hq, n_rep, D, window,
                                     scale, s);
  return launch_dim<float>(q, k, v, out, B, S, Hq, n_rep, D, window, scale, s);
}
