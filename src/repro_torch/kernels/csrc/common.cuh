// Shared helpers for the hand-written kernels (K1-K7).
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

// Only a NaN is unequal to itself (no fast-math flag is passed: see
// kernels/build.py).
__device__ __forceinline__ bool is_nan(float x) { return x != x; }
