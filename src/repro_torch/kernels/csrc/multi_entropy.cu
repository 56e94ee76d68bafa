// K5: softmax entropy moments at many temperatures over the vocab.
//
// Replaces the Pallas kernel multi_entropy_moments
// (src/repro/kernels/multi_entropy.py:84, body _kernel :40): for a
// max-shifted row z (every element <= 0) and candidate temperatures T,
//   s[b, m] = sum_v exp(z[b, v] / T[b, m])
//   w[b, m] = sum_v (z[b, v] / T[b, m]) * exp(z[b, v] / T[b, m]).
// The wrapper finalises H = log s - w / s (multi_entropy.py:110).
//
// Bound on the H100: the exponentials.  Every (v, m) pair needs one, and
// the SFU (MUFU) issues 16 a clock per SM: at (4, 151936, 31) that is
// 18.8 M / (132 x 16 x 1.98 GHz) = 4.5 us, against 1.1 us for the pair's
// FP32 work and 0.7 us for the row's bytes.  So a pair costs the minimum
// the algebra allows, one SFU operation and three FP32 ones:
//   a_m = RN(log2(e) / T_m), once per candidate and block;
//   e = ex2.approx.ftz(RN(z * a_m)); s_m += e; u_m = fma(z, e, u_m);
//   w_m = RN(u_m / T_m) at the end, since sum (z / T) e = (1 / T) sum z e.
// The first version paid a true division (MUFU.RCP, FCHK and a slow-path
// CALL) and a precise expf per pair.  Moving a share of the exponentials
// to the FMA pipe (a degree-5 polynomial, 15 instructions each) was tried
// and ran slower: the loop is not held to the SFU's rate alone.  Grid,
// balance and the single-launch deterministic finish are row_reduce.cuh's
// (one wave of the card, float4 loads, a ticket instead of a second
// launch).
//
// Error (contract: rtol 1e-5 / atol 1e-6 against the plain version, which
// computes exp(RN(z / T)) and sums RN(RN(z / T) e)):
//   * a_m and z * a_m are each rounded once, and log2(e) is rounded to f32,
//     so y = z a_m carries a relative error |d| <= 3 x 2^-24, and
//     2^y' = 2^y 2^(y d) = e (1 + (z / T) d + ...): the relative error of a
//     term is |z / T| |d|.  Summed, |ds| / s <= |d| E_p[|z / T|] where p is
//     the softmax at T; E_p[-z / T] = -w / s = H - log s <= H <= log V
//     (s >= 1: the max element gives e = 1 exactly, 0 * a = 0), so
//     |ds| / s <= 3 x 2^-24 x 11.93 = 2.1e-6 at V = 151936, at any T.  The
//     terms far out (|z / T| large) are exponentially small, so the bound
//     is loose: the terms that carry s and w have small |z / T|.
//   * w: |dw| / |w| <= |d| E_p[(z / T)^2] / E_p[|z / T|].  The mass of p
//     far out sits where V terms of e^(z / T) still count, |z / T| <~ log
//     V, so the ratio is of the order of log V as well, at any T; the
//     engine's extremes T = 0.05 and T = 20 (core/solver.py:313) are held
//     by the tests.  RN(u / T) adds one rounding.
//   * ex2.approx.f32 is within 2 ulp (PTX ISA), 2.4e-7 relative a term.
//   * .ftz flushes results below 2^-126 to 0 (and a subnormal z to 0,
//     which gives e = 1 as exp(z / T) rounds to).  Beside s >= 1 each
//     flushed term is below 2^-126, and V of them below 2^-108 of s.
//   * A -1e30 lane (JAX's pad sentinel) gives y = -1e30 a <= -3.6e28 at
//     T <= 20, so e = +0 and fma(z, 0, u) = u: no term, as in the plain
//     version (RN(z / T) * 0 = -0).  A -inf lane gives e = 0 and
//     fma(-inf, 0, u) = NaN, as the plain version's -inf * 0 does.
//   * Sums run in another order than the plain version's (row_reduce.cuh);
//     f32 sums of at most 151936 terms of one sign.
#include "row_reduce.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx_ftz(float y) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y));
  return e;
}

struct EntropyOp {
  static constexpr int kAcc = 2;            // s, then u = sum z e
  // a candidate past M in a live group of 8: e = 1, and its sums dropped
  static __device__ __forceinline__ float pad() { return 0.0f; }

  static __device__ __forceinline__ float prepare(float t) {
    return __fdiv_rn(kLog2e, t);
  }

  // the live candidates only, in groups of 8 (mc is the same in every
  // lane, so the test is a uniform branch, and a group is long enough for
  // the scheduler to overlap its exponentials): an exponential is the
  // scarce operation
  static __device__ __forceinline__ void add4(
      float4 z, const float (&a)[row_reduce::kTile],
      float (&acc)[2][row_reduce::kTile], int mc) {
#pragma unroll
    for (int j = 0; j < row_reduce::kTile; ++j) {
      if ((j & ~7) < mc) {
        const float e0 = ex2_approx_ftz(__fmul_rn(z.x, a[j]));
        const float e1 = ex2_approx_ftz(__fmul_rn(z.y, a[j]));
        const float e2 = ex2_approx_ftz(__fmul_rn(z.z, a[j]));
        const float e3 = ex2_approx_ftz(__fmul_rn(z.w, a[j]));
        acc[0][j] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc[0][j], e0),
                                                  e1), e2), e3);
        acc[1][j] = __fmaf_rn(z.w, e3, __fmaf_rn(z.z, e2, __fmaf_rn(
            z.y, e1, __fmaf_rn(z.x, e0, acc[1][j]))));
      }
    }
  }

  static __device__ __forceinline__ void add1(
      float z, const float (&a)[row_reduce::kTile],
      float (&acc)[2][row_reduce::kTile], int mc) {
#pragma unroll
    for (int j = 0; j < row_reduce::kTile; ++j) {
      if (j < mc) {
        const float e = ex2_approx_ftz(__fmul_rn(z, a[j]));
        acc[0][j] = __fadd_rn(acc[0][j], e);
        acc[1][j] = __fmaf_rn(z, e, acc[1][j]);
      }
    }
  }

  static __device__ __forceinline__ float finish(int k, float sum, float t) {
    return k == 0 ? sum : __fdiv_rn(sum, t);
  }
};

__global__ void __launch_bounds__(row_reduce::kThreads, 1)
multi_entropy_kernel(const float* __restrict__ z, long long ld_z,
                     const float* __restrict__ ts, long long ld_t,
                     float* __restrict__ out, float* __restrict__ partial,
                     unsigned* __restrict__ tickets, int V, int M, int nb) {
  row_reduce::row_reduce<EntropyOp>(z, ld_z, ts, ld_t, out, partial, tickets,
                                    V, M, nb);
}

}  // namespace

// z: (B, V) f32 rows of stride ld_z, every element <= 0; ts: (B, M) f32
// positive, rows of stride ld_t; out: (B, 2, M) f32 holding (s, w);
// partial: (B, nb, 2, M) f32 and tickets: (B,) u32, all 0, the wrapper's
// cached scratch (unused, and may be null, when nb = 1).
extern "C" int multi_entropy_launch(const float* z, long long ld_z,
                                    const float* ts, long long ld_t,
                                    float* out, float* partial,
                                    unsigned* tickets, int B, int V, int M,
                                    int nb, void* stream) {
  return row_reduce::launch(multi_entropy_kernel, z, ld_z, ts, ld_t, out,
                            partial, tickets, B, V, M, nb, stream);
}
