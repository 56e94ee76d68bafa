// K2: multi-threshold count over the vocab.
//
// Replaces the Pallas kernel multi_count (src/repro/kernels/multi_count.py:69,
// body _kernel :34):  counts[b, m] = #{v < V : x[b, v] > taus[b, m]}.
//
// Bound on the H100: bytes.  Every x element is read once (B*V*4 bytes),
// against B*V*M compare-adds; at the solver's M = 31 that is under one
// operation per byte, far below the card's balance point.  Design:
//   * grid (ceil(V / chunk), B): each block sweeps one chunk of one row,
//     so B = 4 rows still spread over the SMs (the TPU grid ran rows and
//     tiles in order on one core);
//   * the block's candidate row lives in shared memory, padded to a
//     multiple of 32 with +inf (a count of 0); each thread holds a tile
//     of 32 candidates and 32 int counters in registers;
//   * the ragged tail is masked by the loop bound, not padded;
//   * counters reduce per warp by shuffles and per block in shared memory,
//     then one integer atomicAdd per candidate into an int32 (B, M) output
//     that the wrapper zeroes and casts to f32.  Integer atomics are
//     order-free, so the counts are exact and equal the Pallas kernel's
//     f32 sums (exact below 2^24).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // candidates held in registers at once

__global__ void __launch_bounds__(kThreads)
multi_count_kernel(const float* __restrict__ x, long long ld_x,
                   const float* __restrict__ taus, long long ld_t,
                   int* __restrict__ out, int V, int M, int m_pad, int chunk) {
  extern __shared__ float s_tau[];                  // m_pad candidates
  __shared__ int s_warp[kThreads / 32][kTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int m = threadIdx.x; m < m_pad; m += kThreads)
    s_tau[m] = m < M ? taus[b * ld_t + m] : __int_as_float(0x7f800000);
  __syncthreads();

  const float* row = x + b * ld_x;
  const int v0 = blockIdx.x * chunk;
  const int v1 = min(v0 + chunk, V);
  for (int m0 = 0; m0 < m_pad; m0 += kTile) {
    float t[kTile];
    int cnt[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      t[j] = s_tau[m0 + j];
      cnt[j] = 0;
    }
    for (int v = v0 + threadIdx.x; v < v1; v += kThreads) {
      const float xv = row[v];
#pragma unroll
      for (int j = 0; j < kTile; ++j) cnt[j] += xv > t[j];
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int s = warp_sum_i32(cnt[j]);
      if (lane == 0) s_warp[warp][j] = s;
    }
    __syncthreads();
    if (threadIdx.x < kTile && m0 + threadIdx.x < M) {
      int total = 0;
      for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w][threadIdx.x];
      if (total) atomicAdd(out + b * M + m0 + threadIdx.x, total);
    }
    __syncthreads();
  }
}

}  // namespace

// x: (B, V) f32 rows of stride ld_x; taus: (B, M) f32 rows of stride ld_t;
// out: (B, M) int32, zeroed by the caller.
extern "C" int multi_count_launch(const float* x, long long ld_x,
                                  const float* taus, long long ld_t, int* out,
                                  int B, int V, int M, int chunk,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((V + chunk - 1) / chunk, B);
  const int m_pad = (M + kTile - 1) / kTile * kTile;
  multi_count_kernel<<<grid, kThreads, m_pad * sizeof(float), s>>>(
      x, ld_x, taus, ld_t, out, V, M, m_pad, chunk);
  return static_cast<int>(cudaGetLastError());
}
