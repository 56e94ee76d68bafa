// K5: softmax entropy moments at many temperatures over the vocab.
//
// Replaces the Pallas kernel multi_entropy_moments
// (src/repro/kernels/multi_entropy.py:84, body _kernel :40): for a
// max-shifted row z (every element <= 0) and candidate temperatures T,
//   s[b, m] = sum_v exp(z[b, v] / T[b, m])
//   w[b, m] = sum_v (z[b, v] / T[b, m]) * exp(z[b, v] / T[b, m]).
// The wrapper finalises H = log s - w / s (multi_entropy.py:110).
//
// Bound on the H100: operations.  Each (v, m) pair costs a division, a
// precise expf, a multiply and two adds against 4 bytes per v; at M = 31
// that is above the card's f32 balance point.  Layout and reduction are
// K4's: grid (ceil(V / chunk), B), candidates in shared memory (padded
// with T = 1, whose sums are discarded), a 32-candidate register tile,
// partial sums written to a (B, n_chunks, 2, M) scratch buffer and summed
// in chunk order by a second launch, so results are bit-stable run to run.
// z / T is a true division, as multi_entropy.py:49 has it, and expf is the
// precise one (no fast math).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // candidates held in registers at once

__global__ void __launch_bounds__(kThreads)
multi_entropy_partial_kernel(const float* __restrict__ z, long long ld_z,
                             const float* __restrict__ ts, long long ld_t,
                             float* __restrict__ partial, int V, int M,
                             int m_pad, int chunk) {
  extern __shared__ float s_t[];
  __shared__ float s_warp[kThreads / 32][2][kTile];
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int m = threadIdx.x; m < m_pad; m += kThreads)
    s_t[m] = m < M ? ts[b * ld_t + m] : 1.0f;
  __syncthreads();

  const float* row = z + b * ld_z;
  const int v0 = c * chunk;
  const int v1 = min(v0 + chunk, V);
  float* dst = partial + (static_cast<long long>(b) * gridDim.x + c) * 2 * M;
  for (int m0 = 0; m0 < m_pad; m0 += kTile) {
    float t[kTile];
    float s[kTile];
    float w[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      t[j] = s_t[m0 + j];
      s[j] = 0.0f;
      w[j] = 0.0f;
    }
    for (int v = v0 + threadIdx.x; v < v1; v += kThreads) {
      const float zv = row[v];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float zt = __fdiv_rn(zv, t[j]);
        const float e = expf(zt);
        s[j] = __fadd_rn(s[j], e);
        w[j] = __fadd_rn(w[j], __fmul_rn(zt, e));
      }
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float ss = warp_sum_f32(s[j]);
      const float ww = warp_sum_f32(w[j]);
      if (lane == 0) {
        s_warp[warp][0][j] = ss;
        s_warp[warp][1][j] = ww;
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kTile) {
      const int which = threadIdx.x / kTile;        // 0: s, 1: w
      const int j = threadIdx.x % kTile;
      if (m0 + j < M) {
        float total = 0.0f;
        for (int wi = 0; wi < kThreads / 32; ++wi)
          total = __fadd_rn(total, s_warp[wi][which][j]);
        dst[which * M + m0 + j] = total;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// z: (B, V) f32 rows of stride ld_z, every element <= 0; ts: (B, M) f32
// rows of stride ld_t; partial: (B, ceil(V / chunk), 2, M) f32 scratch;
// out: (B, 2, M) f32 holding (s, w).
extern "C" int multi_entropy_launch(const float* z, long long ld_z,
                                    const float* ts, long long ld_t,
                                    float* partial, float* out, int B, int V,
                                    int M, int chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (V + chunk - 1) / chunk;
  dim3 grid(n_chunks, B);
  const int m_pad = (M + kTile - 1) / kTile * kTile;
  multi_entropy_partial_kernel<<<grid, kThreads, m_pad * sizeof(float), s>>>(
      z, ld_z, ts, ld_t, partial, V, M, m_pad, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_sum_chunks(partial, out, B, n_chunks, 2 * M, s);
  return static_cast<int>(cudaGetLastError());
}
