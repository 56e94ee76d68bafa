// Shared helpers for the hand-written kernels (K1-K6).
//
// Every C entry point of these libraries returns cudaGetLastError() as an
// int; the Python wrapper raises when it is not 0 and asks
// repro_error_string() for the message.
//
// Float arithmetic that a parity contract covers is spelled with the
// _rn intrinsics, so nvcc cannot contract a multiply and an add into an
// FMA or reorder a sum.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Tree sum over the 32 lanes of a warp in a fixed order; lane 0 holds the
// result.  The same inputs give the same bits on every run.
__device__ __forceinline__ float warp_sum_f32(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum_i32(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Second pass of the two-pass float reductions (K4, K5): out[b, j] is the
// sum of partial[b, c, j] over the chunks c, taken in chunk order 0, 1, ...
// Grid (ceil(width / blockDim), B).
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n_chunks,
                                  int width) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  const float* p = partial + static_cast<long long>(b) * n_chunks * width + j;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s = __fadd_rn(s, p[static_cast<long long>(c) * width]);
  out[static_cast<long long>(b) * width + j] = s;
}

inline void launch_sum_chunks(const float* partial, float* out, int B,
                              int n_chunks, int width, cudaStream_t stream) {
  const int threads = 128;
  dim3 grid((width + threads - 1) / threads, B);
  sum_chunks_kernel<<<grid, threads, 0, stream>>>(partial, out, n_chunks, width);
}
