// K3: fused multi-round runahead top-k threshold solve.
//
// Replaces the Pallas kernel runahead_topk_threshold
// (src/repro/kernels/runahead_threshold.py:123, body _make_kernel :45,
// grid _midpoint_grid :33): for each row, the (lo, hi) bracket of the
// k-th largest value after `rounds` rounds of 2^spec_k-way runahead
// bisection, every round inside one launch.
//
// The TPU kernel kept the whole row in VMEM across all rounds
// (runahead_threshold.py:13).  That does not carry to Hopper: a
// 151936-wide f32 row is 594 KiB and a block gets at most 227 KB of
// shared memory.  So one block per row re-reads its row from device
// memory / L2 in every round (B rows of 594 KiB stay resident in the 50 MB
// L2), and only the candidate grid, the counts and the walk live in
// shared memory.
//
// Bound on the H100: operations.  The row is read from device memory once
// (B*V*4 bytes), but it is compared against 2 + 1 + rounds*(2^spec_k - 1)
// values (min, max, the lo0 probe, every round's candidates); at the
// sampler's rounds = 8, spec_k = 5 that is about 60 compares per byte.
// With one block per row, B = 4 rows use 4 of the 132 SMs: this first
// version is simple and exact, not fast.
//
// It mirrors the Pallas kernel step for step, and so equals the generic
// engine loop over K2 bit for bit:
//   * lo0 = min(row) - 1, hi0 = max(row) + 1 over the real lanes (:51-53);
//   * the sign of f(lo0) = k - count(row > lo0) comes from a count at lo0
//     (:60), not from the engine's statically known sign;
//   * midpoints are (a + b) / 2 in f32, level by level (:33-41);
//   * the walk runs over sign_vec = [sign(lo)] + signs (:70-84).
// Counts are exact integers; every float operation is an _rn intrinsic,
// so nothing is contracted or reassociated.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSpecK = 8;                 // also checked by the wrapper
constexpr int kMaxN = 1 << kMaxSpecK;
constexpr int kTile = 32;

// sign bit of f(tau) = k - count(row > tau): 1 iff negative.
__device__ __forceinline__ bool count_sign(int k_target, int count) {
  return __fsub_rn(static_cast<float>(k_target), static_cast<float>(count)) < 0.0f;
}

__global__ void __launch_bounds__(kThreads)
runahead_topk_kernel(const float* __restrict__ x, long long ld_x,
                     float* __restrict__ out_lo, float* __restrict__ out_hi,
                     int V, int k_target, int rounds, int spec_k) {
  __shared__ float s_pts[kMaxN + 1];         // the round's midpoint grid
  __shared__ int s_cnt[kMaxN];               // s_cnt[m - 1]: count at pts[m]
  __shared__ float s_min[kThreads / 32];
  __shared__ float s_max[kThreads / 32];
  __shared__ float s_lo, s_hi;
  __shared__ bool s_sl;                      // sign bit at s_lo
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = 1 << spec_k;
  const float* row = x + b * ld_x;

  // bracket: lane-masked min - 1 and max + 1 (the loop bound is the mask)
  float mn = __int_as_float(0x7f800000);
  float mx = __int_as_float(0xff800000);
  for (int v = threadIdx.x; v < V; v += kThreads) {
    mn = fminf(mn, row[v]);
    mx = fmaxf(mx, row[v]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  if (lane == 0) {
    s_min[warp] = mn;
    s_max[warp] = mx;
  }
  if (threadIdx.x == 0) s_cnt[0] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      mn = fminf(mn, s_min[w]);
      mx = fmaxf(mx, s_max[w]);
    }
    s_lo = __fsub_rn(mn, 1.0f);
    s_hi = __fadd_rn(mx, 1.0f);
  }
  __syncthreads();

  // sign of f(lo0), by counting at lo0
  {
    const float lo0 = s_lo;
    int c = 0;
    for (int v = threadIdx.x; v < V; v += kThreads) c += row[v] > lo0;
    c = warp_sum_i32(c);
    if (lane == 0) atomicAdd(&s_cnt[0], c);
    __syncthreads();
    if (threadIdx.x == 0) s_sl = count_sign(k_target, s_cnt[0]);
    __syncthreads();
  }

  for (int r = 0; r < rounds; ++r) {
    if (threadIdx.x == 0) {
      s_pts[0] = s_lo;
      s_pts[n] = s_hi;
      for (int level = 1; level <= spec_k; ++level) {
        const int d = 1 << (spec_k - level);
        for (int m = d; m < n; m += 2 * d)
          s_pts[m] = __fdiv_rn(__fadd_rn(s_pts[m - d], s_pts[m + d]), 2.0f);
      }
    }
    for (int m = threadIdx.x; m < n - 1; m += kThreads) s_cnt[m] = 0;
    __syncthreads();

    // count every candidate pts[1 .. n-1], kTile at a time in registers
    for (int m0 = 1; m0 < n; m0 += kTile) {
      float t[kTile];
      int cnt[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        // past the last candidate: +inf, a count of 0, never stored
        t[j] = m0 + j < n ? s_pts[m0 + j] : __int_as_float(0x7f800000);
        cnt[j] = 0;
      }
      for (int v = threadIdx.x; v < V; v += kThreads) {
        const float xv = row[v];
#pragma unroll
        for (int j = 0; j < kTile; ++j) cnt[j] += xv > t[j];
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int s = warp_sum_i32(cnt[j]);
        if (lane == 0 && m0 + j < n) atomicAdd(&s_cnt[m0 + j - 1], s);
      }
    }
    __syncthreads();

    // serial-exact index walk over sign_vec[i] = sign of grid point i
    if (threadIdx.x == 0) {
      int li = 0, hi_i = n;
      bool s_cur = s_sl;
      for (int step = 0; step < spec_k; ++step) {
        const int mid = (li + hi_i) / 2;     // always interior: 0 < mid < n
        const bool s_m = count_sign(k_target, s_cnt[mid - 1]);
        const bool go_left = s_cur != s_m;
        hi_i = go_left ? mid : hi_i;
        li = go_left ? li : mid;
        s_cur = go_left ? s_cur : s_m;
      }
      s_sl = li == 0 ? s_sl : count_sign(k_target, s_cnt[li - 1]);
      s_lo = s_pts[li];
      s_hi = s_pts[hi_i];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out_lo[b] = s_lo;
    out_hi[b] = s_hi;
  }
}

}  // namespace

extern "C" int runahead_topk_max_spec_k() { return kMaxSpecK; }

// x: (B, V) f32 rows of stride ld_x; out_lo, out_hi: (B,) f32.
extern "C" int runahead_topk_launch(const float* x, long long ld_x,
                                    float* out_lo, float* out_hi, int B, int V,
                                    int k_target, int rounds, int spec_k,
                                    void* stream) {
  runahead_topk_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ld_x, out_lo, out_hi, V, k_target, rounds, spec_k);
  return static_cast<int>(cudaGetLastError());
}
