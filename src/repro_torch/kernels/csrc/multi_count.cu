// K2: multi-threshold count over the vocab.
//
// Replaces the Pallas kernel multi_count (src/repro/kernels/multi_count.py:69,
// body _kernel :34):  counts[b, m] = #{v < V : x[b, v] > taus[b, m]}, and,
// with `below`, #{v < V : x[b, v] < taus[b, m]} (the engine's count_below,
// which the reference counts as #{-x > -tau}: negation is exact, NaN
// compares false both ways and -0 equals +0, so the counts are the same).
//
// Bound on the H100: bytes (B*V*4 read once: 0.73 us at (4, 151936, 31))
// and the issue of the pairs (18.8 M at that shape).  A pair is two
// instructions: `set.gt.f32.f32` (FSET.BF: 1.0f where x > tau) on the ALU
// pipe and an FADD into the thread's f32 running count on the FMA pipe,
// 1.13 us of issue on 128 lanes an SM at 1.98 GHz, and as long for the
// ALU's 64 compares a clock an SM.  (A -1 mask from `set.s32` with one
// IADD3 for two pairs compiles to FSETP + SEL + IADD3, 2.5 a pair, all on
// the ALU; an add predicated on the compare ran slower: PERF.md.)
// A thread's counts are converted to int32 once (row_reduce.cuh to_acc),
// reduced as integers, exact in any order, and converted to f32 once, in
// the finish.  Grid, balance and the single-launch finish are
// row_reduce.cuh's (one wave of the card, float4 loads, a ticket instead
// of a second launch).  The first version was three launches a call: the
// wrapper's zero fill, the kernel's integer atomics, and a cast to f32.
// The compare stays per pair, so any taus are taken, sorted or not.
//
// The result equals the plain version's .sum().float() at any V (one
// rounding of an exact integer), and the Pallas kernel's f32 tile sums
// wherever V < 2^24.
#include "row_reduce.cuh"

namespace {

// x > t (x < t with kBelow) as 1.0f or 0.0f (FSET.BF); 0 when either is
// NaN.  Added to an f32 running count (FADD): a compare on the ALU pipe
// and an add on the FMA pipe a pair.
template <bool kBelow>
__device__ __forceinline__ float hit(float x, float t) {
  float h;
  if (kBelow)
    asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(h) : "f"(x), "f"(t));
  else
    asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(h) : "f"(x), "f"(t));
  return h;
}

template <bool kBelow>
__device__ __forceinline__ void count(float& acc, float x, float t) {
  acc = __fadd_rn(acc, hit<kBelow>(x, t));
}

// A thread's counts are f32, exact integers: a lane sees at most
// V / (256 nb) + 5 elements of a row, under 2^21 for any (B, V) that fits
// the card's 80 GB (row_reduce.py::blocks_per_row gives a row
// nb >= max(1, 132 // B) blocks), so below to_acc's 2^23; they are
// reduced as int32.
template <bool kBelow>
struct CountOp {
  using Acc = int;
  static constexpr int kAcc = 1;
  // a candidate past M in the last tile: no hit (its sum is dropped)
  static __device__ __forceinline__ float pad() {
    return kBelow ? -__int_as_float(0x7f800000) : __int_as_float(0x7f800000);
  }

  static __device__ __forceinline__ float prepare(float tau) { return tau; }

  static __device__ __forceinline__ void add4(
      float4 q, const float (&t)[row_reduce::kTile],
      float (&acc)[1][row_reduce::kTile], int) {
#pragma unroll
    for (int j = 0; j < row_reduce::kTile; ++j) {
      count<kBelow>(acc[0][j], q.x, t[j]);
      count<kBelow>(acc[0][j], q.y, t[j]);
      count<kBelow>(acc[0][j], q.z, t[j]);
      count<kBelow>(acc[0][j], q.w, t[j]);
    }
  }

  static __device__ __forceinline__ void add1(
      float x, const float (&t)[row_reduce::kTile],
      float (&acc)[1][row_reduce::kTile], int) {
#pragma unroll
    for (int j = 0; j < row_reduce::kTile; ++j)
      count<kBelow>(acc[0][j], x, t[j]);
  }

  static __device__ __forceinline__ float finish(int, int sum, float) {
    return __int2float_rn(sum);
  }
};

template <bool kBelow>
__global__ void __launch_bounds__(row_reduce::kThreads, 1)
multi_count_kernel(const float* __restrict__ x, long long ld_x,
                   const float* __restrict__ taus, long long ld_t,
                   float* __restrict__ out, float* __restrict__ partial,
                   unsigned* __restrict__ tickets, int V, int M, int nb) {
  row_reduce::row_reduce<CountOp<kBelow>>(
      x, ld_x, taus, ld_t, out, partial, tickets, V, M, nb);
}

}  // namespace

// x: (B, V) f32 rows of stride ld_x; taus: (B, M) f32 rows of stride
// ld_t; out: (B, M) f32; partial: (B, nb, M) int32 (in an f32 buffer) and
// tickets: (B,) u32, all 0, the wrapper's cached scratch (unused, and may
// be null, when nb = 1).  counts x > tau; the _below entry x < tau.
extern "C" int multi_count_launch(const float* x, long long ld_x,
                                  const float* taus, long long ld_t,
                                  float* out, float* partial,
                                  unsigned* tickets, int B, int V, int M,
                                  int nb, void* stream) {
  return row_reduce::launch(multi_count_kernel<false>, x, ld_x, taus, ld_t,
                            out, partial, tickets, B, V, M, nb, stream);
}

extern "C" int multi_count_below_launch(const float* x, long long ld_x,
                                        const float* taus, long long ld_t,
                                        float* out, float* partial,
                                        unsigned* tickets, int B, int V,
                                        int M, int nb, void* stream) {
  return row_reduce::launch(multi_count_kernel<true>, x, ld_x, taus, ld_t,
                            out, partial, tickets, B, V, M, nb, stream);
}
