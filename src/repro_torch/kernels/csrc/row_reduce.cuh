// The single-launch, whole-card skeleton of K4 (multi_mass) and K5
// (multi_entropy_moments): per row b of a (B, V) f32 operand and per
// candidate m of a (B, M) f32 candidate row, one or two float sums over
// the row's V elements, each term a function of (x[b, v], cand[b, m]).
//
// Grid and balance.  One wave of one block of 256 threads per SM: the
// wrapper gives each row nb blocks (kernels/row_reduce.py::blocks_per_row:
// the card's SM count over B, fewer where the row is short), so B * nb
// blocks fill the card at once.  A block's 8 warps issue on the SM's 4
// schedulers (warp w on w % 4), and each scheduler pair of warps is one
// "slot": a row's float4s are cut into units of 32 (one per lane, 512
// bytes a warp), the row's units are spread over its nb * 4 slots as
// evenly as integers allow, and a slot's units over its 2 warps.  So every
// scheduler of the card gets the same number of units, give or take one,
// whatever B and V are.  The row is read as float4 from its first
// 16-byte-aligned element (rows may sit at any stride); the at most 3
// elements before it and 3 after the last whole float4 go to the row's
// last warp, one per lane.
//
// Candidates.  Each thread holds kTile = 32 candidates' terms in
// registers (the Op's per-candidate value, computed once per block into
// shared memory) and 32 (or 2 x 32) running sums; M > 32 runs the tiles
// one after another over the row again (from L2).
//
// Reduction, in a fixed order, so results are bit-identical run to run
// (no float atomics):
//   * a thread sums its elements in row order;
//   * a warp's 32 sums of 32 candidates are reduced at once by a
//     transposing butterfly (31 shuffles, not 32 x 5): lane j ends with the
//     warp's sum of candidate j;
//   * a block sums its 8 warps in warp order;
//   * with nb = 1 the block writes the result.  Otherwise each block writes
//     its sums to a (B, nb, kAcc, M) scratch and takes a ticket for its row
//     with an integer atomicInc (acq_rel, gpu scope) that wraps at nb - 1;
//     the block that draws the last ticket (so the counter is back at 0 for
//     the next launch) sums the nb blocks' sums, in a fixed order (the
//     block's threads each a strided share of the blocks, then those
//     shares in order), and writes the result.  Which block comes last
//     does not change the order.  A thread-block cluster per row,
//     reducing through distributed shared memory, would hold a row to at
//     most 16 SMs: at B = 4 that is 64 of the 132, half the SFU rate K5
//     is bound by, so the ticket it is.
// One launch per call and no second pass.  The scratch and the tickets
// are the wrapper's buffers, cached per device, so their addresses stay
// fixed for CUDA-graph replay; every launch leaves the tickets at 0.
//
// What a call costs beyond its units is a chain of L2 round trips: the
// candidates, the ticket (its release fence and the atomic), and the last
// block's loads of the other blocks' sums; the stage clock below measures
// each (chip_smoke.py phase 3).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace row_reduce {

// The stage clock, in a build with -DROW_REDUCE_STAGES only
// (kernels/row_reduce.py::stage_times): thread 0 of each block writes the
// %globaltimer (ns) at each stage into g_stages[block][stage]:
//   0 start, 1 the first tile's candidates ready, 2 its units summed,
//   3 the block's sums written, 4 the ticket drawn, 5 the finish done.
#ifdef ROW_REDUCE_STAGES
constexpr int kStages = 6;
constexpr int kStageBlocks = 4096;
__device__ unsigned long long g_stages[kStageBlocks * kStages];
#define ROW_REDUCE_STAGE(k)                                                \
  do {                                                                     \
    if (threadIdx.x == 0 && blockIdx.x < kStageBlocks) {                   \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
      row_reduce::g_stages[blockIdx.x * kStages + (k)] = t_;               \
    }                                                                      \
  } while (0)
#else
#define ROW_REDUCE_STAGE(k) \
  do {                      \
  } while (0)
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSchedulers = 4;          // warp w issues on scheduler w % 4
constexpr int kTile = 32;               // candidates held in registers
constexpr int kAhead = 2;               // a warp's unit loads in flight
constexpr int kLoads = 16;              // a thread's finish loads in flight
constexpr unsigned kFull = 0xffffffffu;

// v[j] summed over the 32 lanes for every j at once: afterwards lane j
// holds the warp's sum of v[j].  At each step (kHalf = 16, 8, ..., 1, a
// template argument, so every index is a constant and v stays in
// registers) a lane keeps the half of its sums that its lane bit kHalf
// says and adds its partner's copy of that half: 31 shuffles in a fixed
// order.
template <int kHalf = kTile / 2>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kTile],
                                                    int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, kHalf));
  }
  if constexpr (kHalf > 1) return warp_transpose_sum<kHalf / 2>(v, lane);
  return v[0];
}

// Op is a struct of static device functions:
//   kAcc                 sums per candidate (1: mass; 2: s and u)
//   prepare(c)           a candidate's per-pair value, once per block
//   pad()                the value of a candidate past M in the last tile
//   add4(q, prm, acc, mc), add1(x, prm, acc, mc)
//                        adds the terms of four (one) elements for the
//                        mc <= 32 live candidates of the tile
//   finish(k, sum, c)    the result of sum k for candidate value c
template <class Op>
__device__ __forceinline__ void row_reduce(const float* __restrict__ x,
                                           long long ld_x,
                                           const float* __restrict__ cand,
                                           long long ld_c,
                                           float* __restrict__ out,
                                           float* __restrict__ partial,
                                           unsigned* __restrict__ tickets,
                                           int V, int M, int nb) {
  constexpr int kAcc = Op::kAcc;
  __shared__ float s_cand[kTile];
  __shared__ float s_prm[kTile];
  __shared__ float s_red[kWarps][kAcc][kTile];
  __shared__ bool s_last;
  __shared__ float s_fin[kThreads];
  const int b = blockIdx.x / nb;
  const int c = blockIdx.x % nb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  ROW_REDUCE_STAGE(0);
  const float* row = x + b * ld_x;
  const float* crow = cand + b * ld_c;

  // the row's aligned body of float4s, and its ragged edges
  const int head = min(V, static_cast<int>(
      (4 - ((reinterpret_cast<uintptr_t>(row) >> 2) & 3)) & 3));
  const long long n4 = (V - head) / 4;
  const int tail = V - head - static_cast<int>(4 * n4);
  const float4* body = reinterpret_cast<const float4*>(row + head);
  // this warp's units: slot (block c, scheduler warp % 4) of the row's
  // nb * 4, then its half of the slot's units
  const long long units = (n4 + 31) / 32;
  const long long slots = static_cast<long long>(nb) * kSchedulers;
  const long long slot = static_cast<long long>(c) * kSchedulers +
                         warp % kSchedulers;
  const long long s0 = slot * units / slots;
  const long long s1 = (slot + 1) * units / slots;
  const int half = warp / kSchedulers;
  constexpr int kHalves = kWarps / kSchedulers;
  const long long u0 = s0 + half * (s1 - s0) / kHalves;
  const long long u1 = s0 + (half + 1) * (s1 - s0) / kHalves;
  const bool edge_warp = c == nb - 1 && warp == kWarps - 1;
  const int n_edge = head + tail;
  float edge = 0.0f;
  if (edge_warp && lane < n_edge)
    edge = lane < head ? row[lane] : row[head + 4 * n4 + (lane - head)];
  float* dst = partial + (static_cast<long long>(b) * nb + c) * kAcc * M;
  // unit u's float4 for this lane (zeros past the warp's units or the row)
  auto load = [&](long long u) {
    const long long i = u * 32 + lane;
    return u < u1 && i < n4 ? __ldg(body + i)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  // kAhead units' loads in flight while one is summed; the first tile's
  // go out before the candidates are read
  float4 ring[kAhead];
#pragma unroll
  for (int r = 0; r < kAhead; ++r) ring[r] = load(u0 + r);

  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int mc = min(kTile, M - m0);
    if (tid < mc) {
      s_cand[tid] = crow[m0 + tid];
      s_prm[tid] = Op::prepare(s_cand[tid]);
    }
    __syncthreads();
    if (m0 == 0) ROW_REDUCE_STAGE(1);
    float prm[kTile];
    float acc[kAcc][kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      prm[j] = j < mc ? s_prm[j] : Op::pad();
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k][j] = 0.0f;
    }
    if (m0 > 0) {
#pragma unroll
      for (int r = 0; r < kAhead; ++r) ring[r] = load(u0 + r);
    }
    // the ring shifts by register moves, so the Op's body is compiled once
    for (long long u = u0; u < u1; ++u) {
      const float4 q = ring[0];
#pragma unroll
      for (int r = 0; r + 1 < kAhead; ++r) ring[r] = ring[r + 1];
      ring[kAhead - 1] = load(u + kAhead);
      if (u * 32 + lane < n4) Op::add4(q, prm, acc, mc);
    }
    if (edge_warp && lane < n_edge) Op::add1(edge, prm, acc, mc);

#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const float sum = warp_transpose_sum(acc[k], lane);
      s_red[warp][k][lane] = sum;
    }
    __syncthreads();
    if (m0 == 0) ROW_REDUCE_STAGE(2);
    if (tid < kAcc * kTile) {
      const int k = tid / kTile;
      const int j = tid % kTile;
      if (j < mc) {
        float total = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          total = __fadd_rn(total, s_red[w][k][j]);
        if (nb == 1)
          out[(static_cast<long long>(b) * kAcc + k) * M + m0 + j] =
              Op::finish(k, total, s_cand[j]);
        else
          dst[k * M + m0 + j] = total;
      }
    }
    __syncthreads();
  }
  ROW_REDUCE_STAGE(3);
  if (nb == 1) return;

  // The row's last block to finish sums every block's sums in block order.
  // The ticket is an acq_rel atomicInc by thread 0 after the tile loop's
  // last barrier: it releases the block's stores above, and the last
  // block's acquires every other block's.
  if (tid == 0) {
    unsigned ticket;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(ticket)
                 : "l"(tickets + b), "r"(static_cast<unsigned>(nb - 1))
                 : "memory");
    s_last = ticket == static_cast<unsigned>(nb - 1);
  }
  __syncthreads();
  ROW_REDUCE_STAGE(4);
  if (!s_last) return;
  // Thread (g, col) sums column col0 + col over the blocks g, g + G, ...
  // (kLoads loads in flight at once), then thread col adds the G sums in
  // g order: a fixed order, so the result is the same whichever block
  // comes last.
  const int cols = kAcc * M;
  const long long stride = cols;
  const float* src = partial + static_cast<long long>(b) * nb * stride;
  const int w = min(cols, kThreads);
  const int groups = kThreads / w;
  const int g = tid / w;
  const int col = tid - g * w;
  for (int col0 = 0; col0 < cols; col0 += w) {
    const int wc = min(w, cols - col0);
    const float c_own = tid < wc ? crow[(col0 + tid) % M] : 0.0f;
    if (g < groups && col < wc) {
      const float* p = src + col0 + col;
      float part = 0.0f;
      for (int blk0 = g; blk0 < nb; blk0 += groups * kLoads) {
        float v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int blk = blk0 + u * groups;
          v[u] = blk < nb ? __ldcg(p + blk * stride) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (blk0 + u * groups < nb) part = __fadd_rn(part, v[u]);
      }
      s_fin[g * w + col] = part;
    }
    __syncthreads();
    if (tid < wc) {
      float total = 0.0f;
      for (int q = 0; q < groups; ++q)
        total = __fadd_rn(total, s_fin[q * w + tid]);
      out[static_cast<long long>(b) * cols + col0 + tid] =
          Op::finish((col0 + tid) / M, total, c_own);
    }
    __syncthreads();
  }
  ROW_REDUCE_STAGE(5);
}

// The C entry's checks and launch: B * nb blocks of kThreads.
template <class Kernel>
int launch(Kernel kernel, const float* x, long long ld_x, const float* cand,
           long long ld_c, float* out, float* partial, unsigned* tickets,
           int B, int V, int M, int nb, void* stream) {
  if (B < 1 || V < 1 || M < 1 || nb < 1 ||
      static_cast<long long>(B) * nb > 0x7fffffffLL ||
      (nb > 1 && (partial == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<B * nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ld_x, cand, ld_c, out, partial, tickets, V, M, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace row_reduce

#ifdef ROW_REDUCE_STAGES
// The stage clock's records into host (kStageBlocks * kStages u64), or,
// with host null, all set to 0.
extern "C" int row_reduce_stages(unsigned long long* host) {
  static unsigned long long zeros[row_reduce::kStageBlocks *
                                  row_reduce::kStages];
  return static_cast<int>(
      host == nullptr
          ? cudaMemcpyToSymbol(row_reduce::g_stages, zeros, sizeof(zeros))
          : cudaMemcpyFromSymbol(host, row_reduce::g_stages, sizeof(zeros)));
}
#endif
