// K3: fused multi-round runahead top-k threshold solve, one thread-block
// cluster per row with the row resident in shared memory.
//
// Replaces the Pallas kernel runahead_topk_threshold
// (src/repro/kernels/runahead_threshold.py:123, body _make_kernel :45,
// grid _midpoint_grid :33): for each row, the (lo, hi) bracket of the
// k-th largest value after `rounds` rounds of 2^spec_k-way runahead
// bisection, every round inside one launch.
//
// The TPU kernel's point is that the row is read from device memory once
// and stays on-chip for every round (runahead_threshold.py:3-15).  A
// 151936-wide f32 row is 594 KiB and one block gets at most 227 KB of
// shared memory, so here a cluster of C CTAs holds it: CTA r copies its
// contiguous slice [r * slice, (r + 1) * slice) of the row into dynamic
// shared memory once, with bulk TMA copies (cp.async.bulk, completion on
// an mbarrier) of the 16-byte-aligned body and plain loads of the few
// elements around it, and keeps it there for every round.  C and slice
// come from the wrapper (runahead_threshold.py::cluster_geometry, a pure
// function of the shape): 16 CTAs of 9496 elements at V = 151936 and
// B <= 8, 8 CTAs of 18992 above.
//
// Bound on the H100: the row's bytes, read once (B * V * 4), and the
// compares the serial bisection it equals needs (2 + 1 + rounds * spec_k
// an element) take about the same time; chip_smoke.py computes both.
// The first version compared every element against all 2^spec_k - 1
// candidates of every round (31 at spec_k = 5) on one block a row, 4 of
// 132 SMs at the sampler's B = 4.  Here, per round:
//   * Bins, not candidates.  The midpoint grid is non-decreasing (the
//     midpoint of a <= b rounds into [a, b]), so the set {m : x > pts[m]}
//     is a prefix, and one element's counts follow from one number,
//       b'(x) = #{m in [0, n - 1] : x > pts[m]},   n = 2^spec_k:
//     0 if !(x > pts[0]) (NaN lanes too), n if x > pts[n], else 1 + the
//     number of pts[1..n-1] below x, estimated from x's position in the
//     nearly uniform grid and moved until exact (a binary search where
//     the bracket is not finite).  Per-warp histograms of b' and a suffix
//     sum give count(x > pts[m]) = #{x : b'(x) >= m + 1}: exact integers,
//     equal to the direct counts whenever pts[0..n] is non-decreasing with
//     no NaN.  The count at pts[0] of round 0 is the count at lo0 that
//     gives sign(f(lo0)), so no separate pass is needed for it.
//   * Compaction.  Each warp owns a list, its share of the slice, and from
//     round 1 on keeps in it only the elements inside the round's bracket
//     (lo, hi].  An element dropped above hi stays above every later hi
//     while the grid stays non-decreasing (hi only falls), so a CTA-wide
//     count of them is added to every count; one dropped at or below lo
//     never counts again.  After round 1 a list holds a few elements, so
//     a round costs its exchange and its walk, not a pass over the slice.
//   * Direct counting.  A grid that is not non-decreasing or holds a NaN
//     (a row holding +inf and -inf makes NaN midpoints; midpoints near
//     FLT_MAX overflow) turns every later round to counting each candidate
//     directly over the lists, with no more compaction: every finite grid
//     point then lies within the last compacting round's bracket, so the
//     elements dropped above count at every point below +inf, and those
//     dropped below (NaN and -inf lanes apart) only at -inf.
//
// Cluster protocol:
//   1. each CTA reduces its slice's min and max (as it loads and then over
//      the bulk-copied body); barrier.cluster; warp 0 of every CTA reads
//      the C partials through distributed shared memory (map_shared_rank)
//      and forms lo0 = min - 1, hi0 = max + 1.  fminf/fmaxf do not depend
//      on order, so any split gives the same bits.  They skip a NaN, and
//      the reference's jnp.min / jnp.max do not, so each thread carries a
//      flag of the NaN lanes it loaded; a warp with one makes its min and
//      max NaN, and from there on min_nan / max_nan let NaN win.  A row
//      holding a NaN gets lo0 = hi0 = NaN, a grid of NaN, direct counts of
//      0 at every point, and the final bracket (NaN, NaN), as the plain
//      version gives.
//   2. each round warp 0 of every CTA builds the same midpoint grid from
//      the same (lo, hi) with the same _rn operations; the CTA counts its
//      lists into n partial counts; warps q < C push them into CTA q's
//      shared memory with st.async, which completes the bytes on CTA q's
//      mbarrier for that round's parity; warp 0 of every CTA waits on its
//      own mbarrier, sums the C partials and runs the same serial-exact
//      walk, so nothing is broadcast back and no cluster barrier is
//      needed.  Double buffering by round parity is safe: a CTA pushes
//      round r + 2's counts only after its round r + 1 walk, which needs
//      every CTA's round r + 1 counts, each pushed after that CTA has read
//      its round r ones.
//   3. rank 0 writes (lo, hi).  After a round no CTA touches another's
//      shared memory again; with no round a last barrier.cluster keeps
//      every CTA's min and max readable until its peers have read them.
//
// It mirrors the Pallas kernel step for step, and so equals the generic
// engine loop over K2 bit for bit:
//   * lo0 = min(row) - 1, hi0 = max(row) + 1 over the real lanes, NaN if
//     any lane is NaN (:51-53);
//   * the sign of f(lo0) = k - count(row > lo0) comes from a count at lo0
//     (:60), not from the engine's statically known sign;
//   * midpoints are (a + b) / 2 in f32, level by level (:33-41);
//   * the walk runs over sign_vec = [sign(lo)] + signs (:70-84).
#include "common.cuh"

#include <cooperative_groups.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpecK = 8;                 // also checked by the wrapper
constexpr int kMaxN = 1 << kMaxSpecK;
constexpr int kMaxClusters = 16;             // non-portable above 8
constexpr int kSliceMax = 44032;             // elements of one CTA's slice
constexpr int kSmemMax = 232448;             // a block's shared memory
constexpr int kPieces = 8;                   // bulk copies of the body
constexpr unsigned kFull = 0xffffffffu;

struct Static {
  float pts[kMaxN + 1];                      // the round's midpoint grid
  int part[2][kMaxN];                        // this CTA's counts, by parity
  unsigned sign_bits[kMaxN / 32];            // signs of the cluster's counts
  float wmin[kWarps], wmax[kWarps];
  float mm[2];                               // this CTA's slice min, max
  float lo, hi;
  int sl;                                    // sign bit at lo
  int direct;                                // count directly from now on
  int above;                                 // elements dropped above hi
  unsigned long long bar;                    // the row copy's mbarrier
  unsigned long long in_bar[2];              // the peers' counts, by parity
};

// Dynamic shared memory: the slice (element v at row[pad + v], pad < 4 so
// that the body lands 16-byte aligned), one histogram of n + 1 bins per
// warp, and the partial counts the C CTAs push here, [2][C][n] by round
// parity.
__host__ __device__ constexpr int row_floats(int slice) {
  return (slice + 3 + 3) / 4 * 4;
}

__host__ __device__ constexpr long long dyn_bytes(int slice, int n, int C) {
  return 4LL * (row_floats(slice) + kWarps * (n + 1) + 2LL * C * n);
}

static_assert(sizeof(Static) + dyn_bytes(kSliceMax, kMaxN, kMaxClusters) <=
                  kSmemMax,
              "the largest slice must fit one block's shared memory");

// sign bit of f(tau) = k - count(row > tau): 1 iff negative.
__device__ __forceinline__ bool count_sign(int k_target, int count) {
  return __fsub_rn(static_cast<float>(k_target), static_cast<float>(count)) < 0.0f;
}

// min and max in which a NaN operand wins (fminf / fmaxf skip it)
__device__ __forceinline__ float min_nan(float a, float b) {
  return is_nan(a) || is_nan(b) ? __int_as_float(0x7fffffff)
                                : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) || is_nan(b) ? __int_as_float(0x7fffffff)
                                : fmaxf(a, b);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(const unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// v into CTA `rank`'s copy of *local (same layout in every CTA), counted
// on that CTA's copy of *bar.
__device__ __forceinline__ void push(int* local, int v,
                                     unsigned long long* bar, int rank) {
  unsigned dst, dst_bar;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(dst) : "r"(smem_addr(local)), "r"(rank));
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(dst_bar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      :: "r"(dst), "r"(v), "r"(dst_bar) : "memory");
}

__device__ __forceinline__ int warp_sum_all(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The round's midpoint grid from (lo, hi) into s.pts, by one warp; and
// s.direct set for good once a grid is not non-decreasing or holds a NaN.
// The TPU kernel builds the grid level by level, each point the midpoint
// of its two neighbours one level up; here lane m follows point m's chain
// of midpoints from (lo, hi) down (spec_k steps at most), which forms the
// same values with the same operations.  (a + b) * 0.5 rounds exactly as
// (a + b) / 2: both are the real (a + b) / 2 rounded once.
__device__ void build_grid(Static& s, float lo, float hi, int spec_k,
                           int lane) {
  const int n = 1 << spec_k;
  for (int m = lane; m <= n; m += 32) {
    float a = lo, b = hi, p = m == 0 ? lo : hi;
    int ia = 0, ib = n;
    while (m != 0 && m != n) {
      const int im = (ia + ib) >> 1;
      p = __fmul_rn(__fadd_rn(a, b), 0.5f);
      if (m == im) break;
      if (m < im) {
        b = p;
        ib = im;
      } else {
        a = p;
        ia = im;
      }
    }
    s.pts[m] = p;
  }
  __syncwarp();
  bool monotone = true;                      // false on NaN too
  for (int m = lane; m < n; m += 32) monotone &= s.pts[m] <= s.pts[m + 1];
  monotone = __all_sync(kFull, monotone);
  if (lane == 0) s.direct |= !monotone;
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
runahead_topk_cluster_kernel(const float* __restrict__ x, long long ld_x,
                             float* __restrict__ out_lo,
                             float* __restrict__ out_hi, int V, int slice,
                             int k_target, int rounds, int spec_k) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ Static s;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = 1 << spec_k;

  // ---- the slice, copied into shared memory once ----
  const long long start = static_cast<long long>(rank) * slice;
  const int len = start >= V ? 0
                             : static_cast<int>(min(static_cast<long long>(slice),
                                                    V - start));
  const float* src = x + blockIdx.y * ld_x + start;
  const int pad = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* row = dyn + pad;
  int* hist = reinterpret_cast<int*>(dyn + row_floats(slice)) + warp * (n + 1);
  int* part_in = reinterpret_cast<int*>(dyn + row_floats(slice)) +
                 kWarps * (n + 1);
  const int head = min(len, (4 - pad) & 3);            // before 16 B
  const int body = (len - head) / 4 * 4;               // bulk copies
  const int piece = (body / 4 + kPieces - 1) / kPieces * 4;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&s.bar)) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&s.in_bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&s.in_bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    s.direct = 0;
    s.above = 0;
  }
  for (int i = lane; i <= n; i += 32) hist[i] = 0;
  __syncthreads();
  if (warp == 0 && body > 0) {
    const unsigned bar = smem_addr(&s.bar);
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(4u * static_cast<unsigned>(body))
                   : "memory");
    __syncwarp();
    const int first = head + lane * piece;
    const int size = min(piece, head + body - first);
    if (lane < kPieces && size > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :: "r"(smem_addr(row + first)),
             "l"(reinterpret_cast<uint64_t>(src + first)),
             "r"(4u * static_cast<unsigned>(size)), "r"(bar)
          : "memory");
  }
  float mn = __int_as_float(0x7f800000);
  float mx = __int_as_float(0xff800000);
  bool nan = false;                          // this thread saw a NaN
  for (int v = tid; v < head; v += kThreads) {
    row[v] = src[v];
    mn = fminf(mn, row[v]);
    mx = fmaxf(mx, row[v]);
    nan |= is_nan(row[v]);
  }
  for (int v = head + body + tid; v < len; v += kThreads) {
    row[v] = src[v];
    mn = fminf(mn, row[v]);
    mx = fmaxf(mx, row[v]);
    nan |= is_nan(row[v]);
  }
  if (body > 0) {
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(smem_addr(&s.bar)) : "memory");
  }

  // ---- lo0, hi0: min and max over the cluster ----
  {
    const float4* body4 = reinterpret_cast<const float4*>(row + head);
    for (int v = tid; v < body / 4; v += kThreads) {
      const float4 q = body4[v];
      mn = fminf(mn, fminf(fminf(q.x, q.y), fminf(q.z, q.w)));
      mx = fmaxf(mx, fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w)));
      nan |= is_nan(q.x) | is_nan(q.y) | is_nan(q.z) | is_nan(q.w);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(kFull, mn, off));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    }
    // a NaN lane makes the warp's min and max NaN, as jnp.min / jnp.max
    // have it; every later step lets a NaN win
    if (__any_sync(kFull, nan)) mn = mx = __int_as_float(0x7fffffff);
    if (lane == 0) {
      s.wmin[warp] = mn;
      s.wmax[warp] = mx;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) {
        mn = min_nan(mn, s.wmin[w]);
        mx = max_nan(mx, s.wmax[w]);
      }
      s.mm[0] = mn;
      s.mm[1] = mx;
    }
  }
  cluster.sync();
  if (warp == 0) {
    float lo_mn = __int_as_float(0x7f800000);
    float hi_mx = __int_as_float(0xff800000);
    for (int q = lane; q < C; q += 32) {
      const float* peer = cluster.map_shared_rank(s.mm, q);
      lo_mn = min_nan(lo_mn, peer[0]);
      hi_mx = max_nan(hi_mx, peer[1]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo_mn = min_nan(lo_mn, __shfl_xor_sync(kFull, lo_mn, off));
      hi_mx = max_nan(hi_mx, __shfl_xor_sync(kFull, hi_mx, off));
    }
    const float lo = __fsub_rn(lo_mn, 1.0f);
    const float hi = __fadd_rn(hi_mx, 1.0f);
    if (rounds > 0) build_grid(s, lo, hi, spec_k, lane);
    for (int m = lane; m < n; m += 32) s.part[0][m] = s.part[1][m] = 0;
    if (lane == 0) {
      s.lo = lo;
      s.hi = hi;
    }
  }
  __syncthreads();

  // Each warp keeps a list, its share of the slice, compacted in place from
  // round 1 on to the elements inside the round's bracket (hi0 = max + 1
  // is above no element, so round 0 drops none).  An element dropped above
  // hi stays above every later hi (hi only falls while the grid is
  // non-decreasing): s.above counts them for the CTA.  One dropped at or
  // below lo stays below every later lo; the lanes count them (NaN and -inf
  // lanes never count), for the direct counts only.
  const int seg = (len + kWarps - 1) / kWarps;
  float* list = row + warp * seg;
  int count = max(0, min(seg, len - warp * seg));
  int below = 0;

  for (int r = 0; r < rounds; ++r) {
    int* in = part_in + (r & 1) * C * n;
    int* part = s.part[r & 1];
    const float lo = s.pts[0];
    const float hi = s.pts[n];
    // the grid is close to uniform on [lo, hi]: an element's bin is first
    // estimated from its position, then moved until it is exact
    const float width = __fsub_rn(hi, lo);
    const bool uniform = width > 0.0f && width < __int_as_float(0x7f800000);
    const float scale = uniform ? __fdiv_rn(static_cast<float>(n), width) : 0.0f;
    if (!s.direct) {
      int written = 0;
      int above = 0;                         // dropped above hi this round
      bool binned = false;
      for (int i0 = 0; i0 < count; i0 += 4 * 32) {
        float xs[4];
        bool inside[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * 32 + lane;
          xs[u] = i < count ? list[i] : __int_as_float(0x7fffffff);  // NaN
          const bool up = xs[u] > hi;
          const bool in_lo = xs[u] > lo;
          above += up;
          below += r > 0 && !in_lo && xs[u] > __int_as_float(0xff800000);
          inside[u] = in_lo && !up;
        }
        const bool any = inside[0] || inside[1] || inside[2] || inside[3];
        if (!__any_sync(kFull, any)) continue;
        binned = true;
        if (any) {
          int pos[4];                        // #{m in [1, n-1] : x > pts[m]}
          if (uniform) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float f = __fmul_rn(__fsub_rn(xs[u], lo), scale);
              pos[u] = inside[u] ? min(n - 1, static_cast<int>(f)) : 0;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              int g = pos[u];
              while (g > 0 && !(xs[u] > s.pts[g])) --g;
              while (g < n - 1 && xs[u] > s.pts[g + 1]) ++g;
              pos[u] = g;
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) pos[u] = 0;
            for (int step = n >> 1; step > 0; step >>= 1) {
#pragma unroll
              for (int u = 0; u < 4; ++u)
                pos[u] += xs[u] > s.pts[pos[u] + step] ? step : 0;
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (inside[u]) atomicAdd(&hist[pos[u] + 1], 1);
        }
        if (r > 0) {
          __syncwarp();                      // every lane has read its xs
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const unsigned keep = __ballot_sync(kFull, inside[u]);
            if (inside[u])
              list[written + __popc(keep & ((1u << lane) - 1))] = xs[u];
            written += __popc(keep);
          }
        }
      }
      if (r > 0) count = written;
      if (__any_sync(kFull, above != 0)) {
        above = warp_sum_all(above);
        if (lane == 0) atomicAdd(&s.above, above);
      }
      if (binned) {
        // this warp's counts at pts[m] = #{x : b'(x) >= m + 1}: a suffix
        // sum over its bins, 32 at a time from the top; the bins are
        // cleared for the next round as they are read
        __syncwarp();
        int carry = 0;
        for (int base = (n - 1) & ~31; base >= 0; base -= 32) {
          const int bin = base + lane + 1;
          int v = 0;
          if (bin <= n) {
            v = hist[bin];
            hist[bin] = 0;
          }
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_down_sync(kFull, v, off);
            v += lane + off < 32 ? o : 0;
          }
          v += carry;
          if (base + lane < n && v != 0) atomicAdd(&part[base + lane], v);
          carry = __shfl_sync(kFull, v, 0);
        }
      }
    } else {
      // A grid with NaN or overflowed midpoints (a row holding +inf and
      // -inf, or values near FLT_MAX): from now on no compaction, and
      // every candidate is counted directly.  Every finite grid point
      // lies within the last compacting round's bracket, so the elements
      // dropped above count unless the point is +inf or NaN, and those
      // dropped below only at -inf.
      const int below_w = warp_sum_all(below);
      for (int m = 0; m < n; ++m) {
        const float t = s.pts[m];
        int c = 0;
        for (int i = lane; i < count; i += 32) c += list[i] > t;
        c = warp_sum_all(c) +
            (t == __int_as_float(0xff800000) ? below_w : 0);
        if (lane == 0 && c != 0) atomicAdd(&part[m], c);
      }
    }
    __syncthreads();
    // warps q < C: this CTA's counts into CTA q's slot for this rank, with
    // st.async, counted on CTA q's in_bar; the elements dropped above are
    // added to every count a grid point below +inf takes (every one while
    // the grid is non-decreasing)
    if (warp == 0 && lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_addr(&s.in_bar[r & 1])),
                      "r"(4u * static_cast<unsigned>(C * n))
                   : "memory");
    if (warp < C) {
      const int above_all = s.above;
      for (int m = lane; m < n; m += 32)
        push(in + rank * n + m,
             part[m] + (s.pts[m] < __int_as_float(0x7f800000) ? above_all : 0),
             &s.in_bar[r & 1], warp);
    }
    // warp 0: the cluster's counts, once every CTA's have landed; the
    // serial-exact walk over sign_vec[i] = sign of grid point i (every lane
    // walks the same path); the next round's grid
    if (warp == 0) {
      mbar_wait(&s.in_bar[r & 1], (r >> 1) & 1);
      // sign bits of the cluster's counts: in a register for n <= 32
      unsigned signs = 0;
      for (int w = 0; w * 32 < n; ++w) {
        const int m = w * 32 + lane;
        int c = 0;
        if (m < n) {
          for (int q = 0; q < C; ++q) c += in[q * n + m];
          s.part[(r + 1) & 1][m] = 0;
        }
        const unsigned bits = __ballot_sync(kFull, m < n && count_sign(k_target, c));
        if (w == 0) signs = bits;
        if (lane == 0) s.sign_bits[w] = bits;
      }
      __syncwarp();
      auto sign_at = [&](int i) -> bool {
        return ((i < 32 ? signs : s.sign_bits[i >> 5]) >> (i & 31)) & 1u;
      };
      bool sl = r == 0 ? sign_at(0) : s.sl;
      int li = 0, hi_i = n;
      bool s_cur = sl;
      for (int step = 0; step < spec_k; ++step) {
        const int mid = (li + hi_i) / 2;     // always interior: 0 < mid < n
        const bool s_m = sign_at(mid);
        const bool go_left = s_cur != s_m;
        hi_i = go_left ? mid : hi_i;
        li = go_left ? li : mid;
        s_cur = go_left ? s_cur : s_m;
      }
      sl = li == 0 ? sl : sign_at(li);
      const float new_lo = s.pts[li];
      const float new_hi = s.pts[hi_i];
      __syncwarp();
      if (r + 1 < rounds) build_grid(s, new_lo, new_hi, spec_k, lane);
      if (lane == 0) {
        s.lo = new_lo;
        s.hi = new_hi;
        s.sl = sl;
      }
    }
    __syncthreads();
  }
  // after a round's sync no CTA touches a peer's shared memory again; with
  // no round, peers may still be reading s.mm
  if (rounds == 0) cluster.sync();
  if (rank == 0 && tid == 0) {
    out_lo[blockIdx.y] = s.lo;
    out_hi[blockIdx.y] = s.hi;
  }
}

}  // namespace

extern "C" int runahead_topk_max_spec_k() { return kMaxSpecK; }
extern "C" int runahead_topk_max_clusters() { return kMaxClusters; }
extern "C" int runahead_topk_slice_max() { return kSliceMax; }

namespace {
const char* g_failed_step = "";

int fail(const char* step, cudaError_t err) {
  g_failed_step = step;
  return static_cast<int>(err);
}
}  // namespace

// The step of the last launch that failed, for the wrapper's message.
extern "C" const char* runahead_topk_failed_step() { return g_failed_step; }

// x: (B, V) f32 rows of stride ld_x; out_lo, out_hi: (B,) f32.  One
// cluster of `clusters` CTAs per row, each holding `slice` elements
// (clusters * slice >= V; the last CTAs' slices may be short or empty).
extern "C" int runahead_topk_launch(const float* x, long long ld_x,
                                    float* out_lo, float* out_hi, int B, int V,
                                    int k_target, int rounds, int spec_k,
                                    int clusters, int slice, void* stream) {
  if (clusters < 1 || clusters > kMaxClusters || slice < 1 ||
      slice > kSliceMax || static_cast<long long>(clusters) * slice < V ||
      spec_k < 1 || spec_k > kMaxSpecK)
    return fail("arguments", cudaErrorInvalidValue);
  // the dynamic shared memory this device lets the kernel ask for
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, runahead_topk_cluster_kernel);
  if (err != cudaSuccess) return fail("device attributes", err);
  const long long limit = optin - static_cast<long long>(fa.sharedSizeBytes);
  const long long smem = dyn_bytes(slice, 1 << spec_k, clusters);
  if (smem > limit) return fail("shared memory size", cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(runahead_topk_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(limit));
  if (err != cudaSuccess) return fail("cudaFuncSetAttribute(shared memory)", err);
  if (clusters > 8) {
    err = cudaFuncSetAttribute(runahead_topk_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return fail("cudaFuncSetAttribute(cluster)", err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, runahead_topk_cluster_kernel, x, ld_x, out_lo,
                           out_hi, V, slice, k_target, rounds, spec_k);
  if (err != cudaSuccess) return fail("cudaLaunchKernelEx", err);
  err = cudaGetLastError();
  return err == cudaSuccess ? 0 : fail("after the launch", err);
}
