// K1: the paper's f(x) = sin(cos(x)) by Taylor recurrences, at M points.
//
// Replaces the Pallas kernel taylor_sincos_eval
// (src/repro/kernels/taylor_eval.py:54, body _make_kernel :22), which
// evaluates all 2**k - 1 speculative points of a runahead round in one
// call.
//
// Bound on the H100: latency.  Each point is one dependent chain of
// 2 * (terms - 1) steps, the two recurrences in the order of the TPU
// kernel,
//   t = (-t * x2) / ((2i + 1)(2i + 2)),  acc += t     (cos, t0 = acc = 1)
//   t = (-t * c2) / ((2i + 2)(2i + 3)),  acc += t     (sin, t0 = acc = c)
// with the denominator formed in f32 (it rounds once past 2**24, near
// i = 2048, as JAX's does) and every operation rounded once, so the result
// equals the plain version (repro_torch.core.paper_functions) bit for bit.
// A round's 1, 7 or 31 points fill one warp, so the least time is the
// chain's length times the latency of one step, however many SMs the card
// has: 2 (terms - 1) * D * L / f_SM with D = 4 dependent operations a step
// (the numerator's multiply, q0, rho, q below) and L = 4 cycles, the
// dependent-issue latency of an f32 FMA since Volta (Jia et al., "Dissecting
// the NVIDIA Volta GPU Architecture via Microbenchmarking", 2018);
// chip_smoke.py measures L on the card with taylor_fma_latency_launch.
// That latency is the paper's "function latency" knob (Figs. 6-7), so
// every step of both series runs, also after t has reached zero.
//
// The first version divided with __fdiv_rn.  Its fast path checks its
// operands (FCHK) and sends a zero or subnormal numerator to a slow
// subroutine; past the first few dozen terms t is zero, so nearly every
// step took the slow path (150 ns a step).  Here the division is
// rebuilt from reciprocals, on a chain of four dependent floating-point
// operations:
//   off the chain, once per step index i and launch, in a shared-memory
//   table filled by the whole block:
//     y    = RN(1/den)                          (rcp.rn)
//     r_d  = RD(1/den)                          (rcp.rd)
//     eps  = fma(-den, r_d, 1) = 1 - den*r_d    (exact, >= 0)
//     r_lo = RN(eps * r_d) >= 0                 (r_d + r_lo = 1/den
//                                                within 2^-45 relative)
//   per point and step, off the chain: c = RN(x2n * r_lo), x2n = -x*x;
//   on the chain, from the previous term t:
//     n    = RN(t * x2n)         the numerator, as the plain version forms it
//     e    = RN(t * c)           beside n: about n * r_lo
//     q0   = fma(n, r_d, e)
//     rho' = fma(q0, den, -n)    = den*q0 - n
//     q    = fma(-rho', y, q0)
// Claim: q = RN(n / den) whenever 2^-52 <= |n| < inf, |x2n| >= 2^-60 and
// den <= 2^48 (the "fast range").  Proof, with u = 2^-24 and z = n / den,
// so that 2^-100 <= |z| < 2^127 (den >= 2):
//   1. 1/den - r_d < ulp(r_d), so 0 <= eps < 2u, eps is exact (a multiple
//      of ulp(den) ulp(r_d) below 2^24 of them) and
//      |r_d + r_lo - 1/den| = |r_lo - eps/den| <= 7u^2 / den.
//   2. n*r_d + e - z = e - n*eps/den.  The rounding of r_lo costs at most
//      7u^2 |z|; those of n, c and e at most 3u^2 (1 + u)^3 |z| relative
//      and 2^-150 absolute each; the absolute part of c is scaled by
//      |t| = |n / x2n| (1 + u) <= |z| 2^48 2^60 (1 + u), so it costs at most
//      2^-42 (1 + u) |z|, and that of e at most 2^-150 <= 2^-50 |z|.  In all
//      |n*r_d + e - z| < 2^-41 |z|, far below half an ulp of z.
//   3. So q0 = RN(n*r_d + e) lies within one ulp of z (a faithful
//      quotient).  Note that RN(n * y) alone is not: when n's significand
//      is below den's it can be 1.5 ulps off.
//   4. Markstein's theorem (P. Markstein, IBM J. Res. Dev. 34(1), 1990;
//      J.-M. Muller et al., Handbook of Floating-Point Arithmetic, the
//      FMA-based division): if y is within half an ulp of 1/den and q0
//      within one ulp of n/den, then rho = n - den*q0 is exact and
//      RN(q0 + rho * y) = RN(n / den), unless something underflows or
//      overflows.  rho' = -rho exactly, so q = RN(q0 + rho * y).
//      |z| >= 2^-100 keeps q0 and q normal; rho is a multiple of
//      min(ulp(n), ulp(den) ulp(q0)) >= 2^-147, with at most 24 significant
//      bits, so it is exact even when subnormal; a finite n keeps every
//      step finite (the fma's product den*q0 is exact inside it).
// A zero n needs no test: n / den is then a zero of n's sign (den > 0),
// and so is q.  |t * x2n| <= 2^-150 with |x2n| = 0 or >= 2^-149, so
// |t| <= 1/2 or c = 0, and e = RN(t * c) is a zero; as r_lo >= 0 and
// x2n <= -0, c <= -0 and e has the sign of -t, which is n's.  q0 is the sum
// of two zeros of n's sign, rho' = q0*den - n of two zeros of opposite
// signs, so +0, and q = -0 + q0 = q0 = n.  Any other n outside the fast
// range (tiny, subnormal, huge, inf or NaN: a few steps around the term
// where t underflows) takes __fdiv_rn itself.
//
// Design: one thread per point, 128 threads a block; the block fills the
// table for 2048 step indices at a time (a chunk), then the warps that
// hold points run the chunk's steps, 16 at a time with no branch: each
// step's quotient is the fast one and a flag records a nonzero n outside
// the fast range.  After 16 steps a warp vote (__any_sync) runs the block
// again from its start with __fdiv_rn at those steps; that happens around
// the term where t underflows, once or twice a series.  A branch or a
// select on every step would put the test's latency on the chain.
// tests/test_torch_cuda.py holds this division against the card's IEEE
// division on 10^7 triples (taylor_div_probe_launch).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;                 // table entries per fill
constexpr int kBlock = 16;                   // steps between warp votes

// Table entry for one step index: {den, r_d, r_lo, y}.
__device__ __forceinline__ float4 table_entry(float den) {
  const float r_d = __frcp_rd(den);
  const float eps = __fmaf_rn(-den, r_d, 1.0f);
  return make_float4(den, r_d, __fmul_rn(eps, r_d), __frcp_rn(den));
}

// (2i + first)(2i + first + 1) in f32, rounded as the plain version rounds it.
__device__ __forceinline__ float denominator(int i, float first) {
  const float two_i = __fmul_rn(2.0f, static_cast<float>(i));
  return __fmul_rn(__fadd_rn(two_i, first), __fadd_rn(two_i, first + 1.0f));
}

// The fast step: with n = RN(t * x2n), RN(n / den) (den = e.x) when n is
// in the fast range or zero, and `slow` set when n is neither.  No branch
// and no predicate is on the chain t -> n -> q0 -> rho' -> q.
// c = RN(x2n * e.z); `fast_ok` is |x2n| >= 2^-60 and den <= 2^48.
__device__ __forceinline__ float fast_term(float t, float x2n, float c,
                                           float4 e, bool fast_ok,
                                           bool& slow) {
  const float n = __fmul_rn(t, x2n);
  const float lo = __fmul_rn(t, c);
  const float q0 = __fmaf_rn(n, e.y, lo);
  const float rho_neg = __fmaf_rn(q0, e.x, -n);
  const float q = __fmaf_rn(-rho_neg, e.w, q0);
  const float an = fabsf(n);
  slow |= n != 0.0f && !(fast_ok && an >= 0x1p-52f && an < INFINITY);
  return q;
}

// One exact step in every case: the fast step, or __fdiv_rn where n is
// neither zero nor in the fast range.
__device__ __forceinline__ float next_term(float t, float x2n, bool fast_ok,
                                           float c, float4 e) {
  bool slow = false;
  const float q = fast_term(t, x2n, c, e, fast_ok, slow);
  return slow ? __fdiv_rn(__fmul_rn(t, x2n), e.x) : q;
}

// One series for this thread's point; every thread of the block calls it
// (the table fill needs them all), only warps holding a point step it:
// kBlock fast steps, then a warp vote; a block in which any lane left the
// fast range is run again from its start with next_term.
__device__ float series(float4* tab, bool stepping, float x, float t0,
                        int terms, float first) {
  const float x2n = -__fmul_rn(x, x);
  const int steps = terms - 1;
  const bool fast_ok = fabsf(x2n) >= 0x1p-60f && steps <= (1 << 23);
  float acc = t0;
  float t = t0;
  for (int base = 0; base < steps; base += kChunk) {
    const int len = min(kChunk, steps - base);
    __syncthreads();                         // the last chunk is consumed
    for (int j = threadIdx.x; j < len; j += kThreads)
      tab[j] = table_entry(denominator(base + j, first));
    __syncthreads();
    if (!stepping) continue;
    int j = 0;
    for (; j + kBlock <= len; j += kBlock) {
      const float t_in = t;
      const float acc_in = acc;
      bool slow = false;
#pragma unroll
      for (int u = 0; u < kBlock; ++u) {
        const float4 e = tab[j + u];
        t = fast_term(t, x2n, __fmul_rn(x2n, e.z), e, fast_ok, slow);
        acc = __fadd_rn(acc, t);
      }
      if (__any_sync(0xffffffffu, slow)) {
        t = t_in;
        acc = acc_in;
        for (int u = 0; u < kBlock; ++u) {
          const float4 e = tab[j + u];
          t = next_term(t, x2n, fast_ok, __fmul_rn(x2n, e.z), e);
          acc = __fadd_rn(acc, t);
        }
      }
    }
    for (; j < len; ++j) {
      const float4 e = tab[j];
      t = next_term(t, x2n, fast_ok, __fmul_rn(x2n, e.z), e);
      acc = __fadd_rn(acc, t);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
taylor_sincos_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int M, int terms) {
  __shared__ float4 tab[kChunk];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool stepping = blockIdx.x * kThreads + (threadIdx.x & ~31) < M;
  const float xm = m < M ? x[m] : 0.0f;
  const float c = series(tab, stepping, xm, 1.0f, terms, 1.0f);
  const float s = series(tab, stepping, c, c, terms, 2.0f);
  if (m < M) out[m] = s;
}

// The first version's recurrence (one __fdiv_rn a step), kept to time the
// division it paid for: with kZeroShortcut a zero numerator skips it.
template <bool kZeroShortcut>
__device__ float reference_series(float x, float t0, int terms, float first) {
  const float x2n = -__fmul_rn(x, x);
  float acc = t0;
  float t = t0;
  for (int i = 0; i < terms - 1; ++i) {
    const float n = __fmul_rn(t, x2n);
    const float den = denominator(i, first);
    t = kZeroShortcut && n == 0.0f ? n : __fdiv_rn(n, den);
    acc = __fadd_rn(acc, t);
  }
  return acc;
}

template <bool kZeroShortcut>
__global__ void __launch_bounds__(kThreads)
taylor_sincos_reference_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int M, int terms) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const float c = reference_series<kZeroShortcut>(x[m], 1.0f, terms, 1.0f);
  out[m] = reference_series<kZeroShortcut>(c, c, terms, 2.0f);
}

// The division alone: q[i] = next_term(t[i], x2n[i], ...) with den[i]'s
// table entry, i.e. RN(RN(t * x2n) / den).
__global__ void taylor_div_probe_kernel(const float* __restrict__ t,
                                        const float* __restrict__ x2n,
                                        const float* __restrict__ den,
                                        float* __restrict__ q, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float4 e = table_entry(den[i]);
  const float a = x2n[i];
  const bool fast_ok = fabsf(a) >= 0x1p-60f && e.x <= 0x1p48f;
  q[i] = next_term(t[i], a, fast_ok, __fmul_rn(a, e.z), e);
}

// One thread, `reps` x 64 dependent fma.rn.f32: SM cycles between.
__global__ void fma_latency_kernel(long long* cycles, float* sink, int reps,
                                   float a, float b) {
  float v = a;
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < 64; ++j)
      asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(v) : "f"(a), "f"(b));
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = v;
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

// Measurement and test entries (not on the path).
extern "C" int taylor_sincos_reference_launch(const float* x, float* out,
                                              int M, int terms,
                                              int zero_shortcut, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (M + kThreads - 1) / kThreads;
  if (zero_shortcut)
    taylor_sincos_reference_kernel<true><<<blocks, kThreads, 0, s>>>(
        x, out, M, terms);
  else
    taylor_sincos_reference_kernel<false><<<blocks, kThreads, 0, s>>>(
        x, out, M, terms);
  return static_cast<int>(cudaGetLastError());
}

// t, x2n, den, q: (N,) f32.
extern "C" int taylor_div_probe_launch(const float* t, const float* x2n,
                                       const float* den, float* q, int N,
                                       void* stream) {
  const int threads = 256;
  taylor_div_probe_kernel<<<(N + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(t, x2n, den,
                                                                 q, N);
  return static_cast<int>(cudaGetLastError());
}

// cycles: (1,) int64, sink: (1,) f32.
extern "C" int taylor_fma_latency_launch(long long* cycles, float* sink,
                                         int reps, void* stream) {
  fma_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      cycles, sink, reps, 1.0000001f, 1e-30f);
  return static_cast<int>(cudaGetLastError());
}
