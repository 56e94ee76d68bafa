// K4: multi-threshold probability mass over the vocab.
//
// Replaces the Pallas kernel multi_mass (src/repro/kernels/multi_mass.py:65,
// body _kernel :31):  mass[b, m] = sum_v p[b, v] * [p[b, v] >= taus[b, m]].
//
// Bound on the H100: bytes (B*V*4 read once: 0.73 us at (4, 151936, 31))
// and the issue of a compare, a select and an add per (v, m) pair (18.8 M
// pairs, 1.7 us at the card's 33.4 T FP32 instructions a second; an add
// predicated on the compare ran slower).  The first version spent most of
// its time on two launches and their epilogues.  Grid, balance and the
// single-launch deterministic finish are row_reduce.cuh's (one wave of
// the card, float4 loads, a ticket instead of a second launch).  The
// compare stays per pair, so any taus are taken (the engine's midpoint
// grid is sorted, phase 3's candidates are not).  Candidates past M in
// the last tile are +inf and their sums are dropped: a guard per
// candidate would cost more issue than the one dead candidate of M = 31.
//
// The TPU kernel summed tiles into a revisited output block in grid
// order, so its result is the same on every run; here the order is
// row_reduce.cuh's, fixed too, so the result is bit-stable run to run.
// It differs from the Pallas and plain versions only by the order of the
// f32 additions.  A NaN p is never >= tau, as in the plain version.
#include "row_reduce.cuh"

namespace {

struct MassOp {
  static constexpr int kAcc = 1;
  // +inf: no p but +inf is >= it
  static __device__ __forceinline__ float pad() {
    return __int_as_float(0x7f800000);
  }

  static __device__ __forceinline__ float prepare(float tau) { return tau; }

  static __device__ __forceinline__ void add4(
      float4 p, const float (&t)[row_reduce::kTile],
      float (&acc)[1][row_reduce::kTile], int) {
#pragma unroll
    for (int j = 0; j < row_reduce::kTile; ++j) {
      float a = acc[0][j];
      a = __fadd_rn(a, p.x >= t[j] ? p.x : 0.0f);
      a = __fadd_rn(a, p.y >= t[j] ? p.y : 0.0f);
      a = __fadd_rn(a, p.z >= t[j] ? p.z : 0.0f);
      a = __fadd_rn(a, p.w >= t[j] ? p.w : 0.0f);
      acc[0][j] = a;
    }
  }

  static __device__ __forceinline__ void add1(
      float p, const float (&t)[row_reduce::kTile],
      float (&acc)[1][row_reduce::kTile], int) {
#pragma unroll
    for (int j = 0; j < row_reduce::kTile; ++j)
      acc[0][j] = __fadd_rn(acc[0][j], p >= t[j] ? p : 0.0f);
  }

  static __device__ __forceinline__ float finish(int, float sum, float) {
    return sum;
  }
};

__global__ void __launch_bounds__(row_reduce::kThreads, 1)
multi_mass_kernel(const float* __restrict__ p, long long ld_p,
                  const float* __restrict__ taus, long long ld_t,
                  float* __restrict__ out, float* __restrict__ partial,
                  unsigned* __restrict__ tickets, int V, int M, int nb) {
  row_reduce::row_reduce<MassOp>(p, ld_p, taus, ld_t, out, partial, tickets,
                                 V, M, nb);
}

}  // namespace

// p: (B, V) f32 rows of stride ld_p; taus: (B, M) f32 rows of stride
// ld_t; out: (B, M) f32; partial: (B, nb, M) f32 and tickets: (B,) u32,
// all 0, the wrapper's cached scratch (unused, and may be null, when
// nb = 1).
extern "C" int multi_mass_launch(const float* p, long long ld_p,
                                 const float* taus, long long ld_t, float* out,
                                 float* partial, unsigned* tickets, int B,
                                 int V, int M, int nb, void* stream) {
  return row_reduce::launch(multi_mass_kernel, p, ld_p, taus, ld_t, out,
                            partial, tickets, B, V, M, nb, stream);
}
