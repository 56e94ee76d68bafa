// K1: the paper's f(x) = sin(cos(x)) by Taylor recurrences, at M points.
//
// Replaces the Pallas kernel taylor_sincos_eval
// (src/repro/kernels/taylor_eval.py:54, body _make_kernel :22), which
// evaluates all 2**k - 1 speculative points of a runahead round in one
// call.
//
// Bound on the H100: neither bytes nor operations.  Each point is one
// dependent chain of 2 * (terms - 1) multiply-divide steps; a round's 7 or
// 31 points fill one warp, so the kernel takes the chain's latency however
// many SMs the card has.  That latency is the paper's "function latency"
// knob, so it is kept and not hidden.  Design: one thread per point, the
// two recurrences in the order of the TPU kernel,
//   t = (-t * x2) / ((2i + 1)(2i + 2)),  acc += t     (cos, t0 = acc = 1)
//   t = (-t * c2) / ((2i + 2)(2i + 3)),  acc += t     (sin, t0 = acc = c)
// with the denominator formed in f32 (it rounds once past 2**24, near
// i = 2048, as JAX's does).  Every step is an _rn intrinsic, so nvcc
// contracts nothing into an FMA and the result equals the plain version
// (repro_torch.core.paper_functions) bit for bit.  -t * x2 is computed
// as t * (-x2), which is the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float series(float x, float t0, int terms,
                                        float first) {
  const float neg_x2 = -__fmul_rn(x, x);
  float acc = t0;
  float t = t0;
  for (int i = 0; i < terms - 1; ++i) {
    const float two_i = __fmul_rn(2.0f, static_cast<float>(i));
    const float den = __fmul_rn(__fadd_rn(two_i, first),
                                __fadd_rn(two_i, first + 1.0f));
    t = __fdiv_rn(__fmul_rn(t, neg_x2), den);
    acc = __fadd_rn(acc, t);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
taylor_sincos_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int M, int terms) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const float c = series(x[m], 1.0f, terms, 1.0f);
  out[m] = series(c, c, terms, 2.0f);
}

}  // namespace

// x, out: (M,) f32, contiguous.
extern "C" int taylor_sincos_launch(const float* x, float* out, int M,
                                    int terms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  taylor_sincos_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      x, out, M, terms);
  return static_cast<int>(cudaGetLastError());
}
