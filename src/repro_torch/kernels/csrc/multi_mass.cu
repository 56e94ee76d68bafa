// K4: multi-threshold probability mass over the vocab.
//
// Replaces the Pallas kernel multi_mass (src/repro/kernels/multi_mass.py:65,
// body _kernel :31):  mass[b, m] = sum_v p[b, v] * [p[b, v] >= taus[b, m]].
//
// Bound on the H100: bytes (B*V*4 read once; two operations per
// (v, m) pair, under one per byte at M = 31).  Same grid as K2: one block
// per (chunk, row), the candidate row in shared memory padded with +inf,
// a register tile of 32 candidates with 32 f32 partial sums per thread,
// the ragged tail masked by the loop bound.
//
// The TPU kernel summed tiles into a revisited output block in grid
// order, so its result is the same on every run.  Hopper's blocks run in
// no order, and a float atomicAdd would make the sum change from run to
// run.  So each block writes its partial sums to a (B, n_chunks, M)
// scratch buffer (per thread in v order, per warp by a fixed shuffle
// tree, per block in warp order), and a second launch sums the chunks in
// chunk order.  The result is bit-stable run to run; it differs from the
// Pallas and plain versions only by the order of the f32 additions.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // candidates held in registers at once

__global__ void __launch_bounds__(kThreads)
multi_mass_partial_kernel(const float* __restrict__ p, long long ld_p,
                          const float* __restrict__ taus, long long ld_t,
                          float* __restrict__ partial, int V, int M,
                          int m_pad, int chunk) {
  extern __shared__ float s_tau[];
  __shared__ float s_warp[kThreads / 32][kTile];
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int m = threadIdx.x; m < m_pad; m += kThreads)
    s_tau[m] = m < M ? taus[b * ld_t + m] : __int_as_float(0x7f800000);
  __syncthreads();

  const float* row = p + b * ld_p;
  const int v0 = c * chunk;
  const int v1 = min(v0 + chunk, V);
  float* dst = partial + (static_cast<long long>(b) * gridDim.x + c) * M;
  for (int m0 = 0; m0 < m_pad; m0 += kTile) {
    float t[kTile];
    float acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      t[j] = s_tau[m0 + j];
      acc[j] = 0.0f;
    }
    for (int v = v0 + threadIdx.x; v < v1; v += kThreads) {
      const float pv = row[v];
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        acc[j] = __fadd_rn(acc[j], pv >= t[j] ? pv : 0.0f);
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float s = warp_sum_f32(acc[j]);
      if (lane == 0) s_warp[warp][j] = s;
    }
    __syncthreads();
    if (threadIdx.x < kTile && m0 + threadIdx.x < M) {
      float total = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w)
        total = __fadd_rn(total, s_warp[w][threadIdx.x]);
      dst[m0 + threadIdx.x] = total;
    }
    __syncthreads();
  }
}

}  // namespace

// p: (B, V) f32 rows of stride ld_p; taus: (B, M) f32 rows of stride ld_t;
// partial: (B, ceil(V / chunk), M) f32 scratch; out: (B, M) f32.
extern "C" int multi_mass_launch(const float* p, long long ld_p,
                                 const float* taus, long long ld_t,
                                 float* partial, float* out, int B, int V,
                                 int M, int chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (V + chunk - 1) / chunk;
  dim3 grid(n_chunks, B);
  const int m_pad = (M + kTile - 1) / kTile * kTile;
  multi_mass_partial_kernel<<<grid, kThreads, m_pad * sizeof(float), s>>>(
      p, ld_p, taus, ld_t, partial, V, M, m_pad, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_sum_chunks(partial, out, B, n_chunks, M, s);
  return static_cast<int>(cudaGetLastError());
}
