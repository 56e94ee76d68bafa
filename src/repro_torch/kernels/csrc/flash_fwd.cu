// K7: causal flash-attention forward, with an optional sliding-window band.
//
// Replaces the Pallas kernel _flash_fwd_pallas (src/repro/kernels/
// flash_fwd.py:82, body _kernel :35): for every (batch, query head) the
// causal softmax attention of q over k, v, with scores and the online-
// softmax state (m, l, acc) in f32, masked scores at -1e30, out = acc /
// max(l, 1e-30) in q's dtype.  With window > 0 a key is seen only when
// kpos > qpos - window.  GQA: query head h reads kv head h / n_rep, and
// K/V are never repeated.
//
// Bound on the H100: operations.  A causal (B, S, H, D) call does
// 4 * B * H * D * S * (S + 1) / 2 flops against 2 * 2 * B * S * D * (H +
// H_kv) bytes of Q, K, V and O (137.4 GFLOP and 50 MB at B=2, S=4096,
// H=16/8, D=128 in bf16: 0.139 ms at 989 TFLOP/s on the tensor cores).
//
// bf16 (the training path): flash_fwd_tc_kernel, on the tensor cores.
//   * grid (H, B, S / 128 query tiles), so the heaviest (last) query
//     tiles of every head go first; 288 threads: two consumer warpgroups
//     of 64 query rows each and one producer warp.
//   * The producer's lane 0 loads the 128-row Q tile once, then K and V
//     tiles (64 keys at head_dim 128, else 128) into a ring of 4 stages,
//     all by TMA (cp.async.bulk.tensor, 4-D maps over (D, heads, S, B),
//     so kv head h / n_rep is a coordinate and rows past S arrive as
//     zeros).  Full barriers per stage for K and for V, an empty barrier
//     per stage that the 8 consumer warps release.  Tiles land in 128-,
//     64- or 32-byte swizzled panels of 64, 32 or 16 columns.
//   * S = Q K^T: wgmma.mma_async m64nNk16, both operands in shared memory
//     (K-major descriptors), f32 accumulators in registers.
//   * O += P V: P rounded to bf16 in registers (the accumulator fragment
//     of S is the A fragment of wgmma m64nDk16), V read in its row-major
//     layout through the transpose bit of the B descriptor.  JAX's
//     flash_attend, which attend runs at S >= 4096, also casts p to bf16
//     before P V.
//   * Software pipeline per warpgroup: S(t) = Q K(t)^T and O += P(t-1)
//     V(t-1) are issued together; the thread rescales O while they run,
//     then takes the softmax of S(t) while P(t-1) V(t-1) still runs.  S,
//     P and O then live in registers together, which is why the key tile
//     is 64 at head_dim 128: at 128 keys the kernel spilled, and
//     setmaxnreg did not raise the registers ptxas gives it.  As built,
//     the four head dims take 136 to 164 registers a thread and spill
//     nothing (ptxas -v, which chip_smoke.py's build phase prints).
//   * The two consumer warpgroups take turns issuing to the tensor cores
//     (named barriers 1 and 2), so one's softmax runs under the other's
//     products.
//   * Online softmax in registers: each thread holds two rows; row max by
//     two xor shuffles over the 4 lanes of a row, row sums per thread in
//     column order, summed across the 4 lanes once at the end.  p =
//     2**(s * scale * log2(e) - m): one FMA and ex2.approx.ftz (about 2
//     ulp; p below 2**-126 flushes to 0), far below the bf16 rounding of
//     p.  Only tiles that cross the diagonal or the band edge are masked,
//     their masked scores at -inf, and a row's running max is held at
//     >= -1e30, so a row with no valid key yet has p = 0 and m = -1e30:
//     the TPU kernel's -1e30 sentinel gives the same output (its p = 1
//     garbage is wiped by corr = exp(-1e30 - m) = 0 at the row's first
//     valid key).  Tiles wholly above the diagonal or below the band are
//     never loaded, which is exact by the same argument.
//   * out = acc / max(l, 1e-30) in bf16, stored from registers; rows at
//     or past S are never stored.
//   * Tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//     taken from the driver through cudaGetDriverEntryPoint(ByVersion),
//     so nothing links -lcuda; they reach the kernel as
//     __grid_constant__ parameters.
// f32: flash_fwd_kernel, the first port's kernel, on the CUDA cores in
// f32 (64-row q tiles, 64-key K/V tiles through shared memory as f32,
// 4 x 4 register score tiles, precise expf, fixed-order warp sums).
// It serves the f32 parity checks and compute_dtype=float32.
// Every sum runs in a fixed order, so the output is the same bits from
// one run to the next.  Against the TPU kernel (kv tiles of 1024) both
// agree within float tolerance: the online softmax rescales at other
// tile edges.
#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------


constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // key rows per kv tile
constexpr int kThreads = 256;            // a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr int kStrideP = kBK + 1;        // score rows, padded
constexpr float kMasked = -1e30f;
static_assert(kBK == 64, "the softmax pass gives each lane two keys");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// Max over the 32 lanes of a warp, broadcast to every lane.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int D>
constexpr size_t smem_floats() {
  return D * kBQ + kBK * (D + 1) + kBK * D + kBQ * kStrideP + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Hq,
                 int n_rep, int window, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kStrideK = D + 1;
  constexpr int kCols = D / 16;          // acc columns per thread
  extern __shared__ __align__(16) float smem[];
  float* s_qt = smem;                    // (D, BQ): the query tile, transposed
  float* s_k = s_qt + D * kBQ;           // (BK, D + 1)
  float* s_v = s_k + kBK * kStrideK;     // (BK, D)
  float* s_p = s_v + kBK * D;            // (BQ, BK + 1): scores, then probs
  float* s_m = s_p + kBQ * kStrideP;     // (BQ,)
  float* s_l = s_m + kBQ;                // (BQ,)
  float* s_corr = s_l + kBQ;             // (BQ,)

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hk = Hq / n_rep;
  const int q0 = q_tile * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long q_row = static_cast<long long>(Hq) * D;   // per position
  const long long k_row = static_cast<long long>(Hk) * D;
  const T* qb = q + static_cast<long long>(b) * S * q_row + h * D;
  const T* kb = k + static_cast<long long>(b) * S * k_row + (h / n_rep) * D;
  const T* vb = v + static_cast<long long>(b) * S * k_row + (h / n_rep) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i % kBQ, d = i / kBQ;
    const int p = q0 + r;
    s_qt[d * kBQ + r] = p < S ? to_f32(qb[p * q_row + d]) : 0.0f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    s_m[r] = -__int_as_float(0x7f800000);      // -inf
    s_l[r] = 0.0f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_tiles = q_last / kBK + 1;        // tiles at or below the diagonal
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;  // below the band
    __syncthreads();                           // the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int p = k0 + c;
      const bool in = p < S;
      s_k[c * kStrideK + d] = in ? to_f32(kb[p * k_row + d]) : 0.0f;
      s_v[c * D + d] = in ? to_f32(vb[p * k_row + d]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(s_qt + d * kBQ + 4 * ty);
      const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
      float ks[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ks[j] = s_k[(tx + 16 * j) * kStrideK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qs[i], ks[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool valid =
            kpos <= qpos && (window <= 0 || kpos > qpos - window);
        s_p[r * kStrideP + c] = valid ? sc[i][j] * scale : kMasked;
      }
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += kWarps) {
      float* row = s_p + r * kStrideP;
      const float a = row[lane], c = row[lane + 32];
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      row[lane] = pa;
      row[lane + 32] = pc;
      const float sum = warp_sum_f32(pa + pc);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[r] = corr;
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = s_corr[4 * ty + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float ps[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ps[i] = s_p[(4 * ty + i) * kStrideP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = s_v[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ps[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int p = q0 + r;
    if (p >= S) continue;
    const float l = fmaxf(s_l[r], 1e-30f);
    T* o = out + (static_cast<long long>(b) * S + p) * q_row + h * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(o + tx + 16 * j, acc[i][j] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, Q/K/V by TMA
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;                 // query rows per block
constexpr int kTcStages = 4;                 // K/V ring depth
constexpr int kTcConsumers = 2;              // warpgroups of 64 query rows
constexpr int kTcThreads = 128 * kTcConsumers + 32;   // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcGeom {
  static_assert(D % 16 == 0 && D <= 256, "head_dim must be 16k, <= 256");
  static constexpr int kSwz = D * 2 < 128 ? D * 2 : 128;  // bytes per row
  static constexpr int kPanelCols = kSwz / 2;            // bf16 columns
  static constexpr int kPanels = D / kPanelCols;
  // keys per K/V tile: S (kKeys / 2 f32), P (kKeys / 4 bf16 pairs) and O
  // (D / 2 f32) stay in registers together with no spill
  static constexpr int kKeys = D >= 128 ? 64 : 128;
  static constexpr int kQBytes = kTcRows * D * 2;
  static constexpr int kKvBytes = kKeys * D * 2;
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr int kLayout = kSwz == 128 ? 1 : (kSwz == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kTmaSwizzle =
      kSwz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : (kSwz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_32B);
  // 1024 B of slack to align the tiles, the tiles, then the barriers
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kTcStages * kKvBytes + 8 * (1 + 3 * kTcStages);
  static_assert(kSmem <= 232448, "a block has at most 227 KB");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.  A
// wait that outlasts 2**28 polls (seconds; a real one takes microseconds)
// is a pipeline fault: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16 B units) and the swizzle layout type.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  uint64_t d = (addr & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(layout) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The wgmma instructions used here; d is the thread's accumulator
// fragment (D/2 or 64 f32), a the bf16 A fragment of one k16 step.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q K^T of one key tile: D/16 k-steps, both operands K-major in
// swizzled panels; the first step overwrites s.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[TcGeom<D>::kKeys / 2],
                                        uint32_t q_base, uint32_t k_base) {
  using G = TcGeom<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int panel = kk * 16 / G::kPanelCols;
    const uint32_t cb = (kk * 16 % G::kPanelCols) * 2;
    wgmma_ss<G::kKeys>(
        s,
        gmma_desc(q_base + panel * kTcRows * G::kSwz + cb, 16, 8 * G::kSwz,
                  G::kLayout),
        gmma_desc(k_base + panel * G::kKeys * G::kSwz + cb, 16, 8 * G::kSwz,
                  G::kLayout),
        kk > 0);
  }
}

// O += P V of one tile: P from registers, V row-major (MN-major B, the
// transpose bit), its D columns spread over the panels (LBO).
template <int D>
__device__ __forceinline__ void pv_tile(
    float (&o)[D / 2], const uint32_t (&pa)[TcGeom<D>::kKeys / 16][4],
    uint32_t v_base) {
  using G = TcGeom<D>;
#pragma unroll
  for (int kk = 0; kk < G::kKeys / 16; ++kk)
    wgmma_rs<D>(o, pa[kk],
                gmma_desc(v_base + kk * 16 * G::kSwz, G::kKeys * G::kSwz,
                          8 * G::kSwz, G::kLayout));
}

// 2**x by ex2.approx.ftz: one MUFU op (exp2f adds a denormal rescale
// around it); results below 2**-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 order the two consumer warpgroups' tensor-core
// issue: each waits for its turn, issues, then hands the turn over.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(256) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(256) : "memory");
}

// The online softmax over one tile of N raw scores s per row pair, for
// this thread's rows r0 and r0 + 8: masks the tile when it crosses the
// diagonal or the band edge, takes the row max in the log2 domain (-1e30
// while a row has seen no valid key), writes p = exp2(s * scale - m) over
// s, folds the row sums into l and returns the rescale factors of acc in
// corr.
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&s)[N / 2], bool edge, int k0, int r0, int c_lane, int window,
    float scale_log2, float (&m)[2], float (&l)[2], float (&corr)[2]) {
  const float ninf = -__int_as_float(0x7f800000);
  float mx[2] = {ninf, ninf};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int h = (i / 2) % 2;               // row r0 + 8 * h
    if (edge) {
      const int kpos = k0 + 8 * (i / 4) + c_lane + (i % 2);
      const int qpos = r0 + 8 * h;
      if (kpos > qpos || (window > 0 && kpos <= qpos - window)) s[i] = ninf;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
  float m_new[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    m_new[h] = fmaxf(m[h], fmaxf(mx[h] * scale_log2, kMasked));
    corr[h] = exp2_approx(m[h] - m_new[h]);
    m[h] = m_new[h];
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int h = (i / 2) % 2;
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -m_new[h]));
    s[i + 1] = exp2_approx(fmaf(s[i + 1], scale_log2, -m_new[h]));
    sum[h] = __fadd_rn(sum[h], __fadd_rn(s[i], s[i + 1]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), sum[h]);
}

// p (f32, in s) to the bf16 A fragments of the P V product: the
// accumulator fragment of k16 step kk is s[8 kk .. 8 kk + 7].
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N / 2],
                                       uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2)
    pa[i / 8][(i / 2) % 4] = pack_bf16(s[i], s[i + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i / 2) % 2];
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, int S, int Hq, int n_rep,
                    int window, float scale_log2) {
  using G = TcGeom<D>;
  constexpr int kKeys = G::kKeys;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;
  const uint32_t s_k = s_q + G::kQBytes;                 // kTcStages tiles
  const uint32_t s_v = s_k + kTcStages * G::kKvBytes;    // kTcStages tiles
  const uint32_t bar_q = s_v + kTcStages * G::kKvBytes;
  const uint32_t bar_k = bar_q + 8;                      // [kTcStages]
  const uint32_t bar_v = bar_k + 8 * kTcStages;          // [kTcStages]
  const uint32_t bar_free = bar_v + 8 * kTcStages;       // [kTcStages]

  const int q_tile = gridDim.z - 1 - blockIdx.z;   // heaviest first, all heads
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = q_tile * kTcRows;
  const int kt_hi = (min(q0 + kTcRows, S) - 1) / kKeys;   // the diagonal
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kKeys : 0;
  const int n_tiles = kt_hi - kt_lo + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_free + 8 * s, 4 * kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kTcConsumers) {
    // the producer warp: one lane issues every copy
    if (lane == 0) {
      const int hk = h / n_rep;
      mbar_expect_tx(bar_q, G::kQBytes);
      for (int p = 0; p < G::kPanels; ++p)
        tma_load_4d(s_q + p * kTcRows * G::kSwz, &tm_q, bar_q,
                    p * G::kPanelCols, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kTcStages;
        if (it >= kTcStages)   // the consumers released this stage's last use
          mbar_wait(bar_free + 8 * st, ((it / kTcStages) & 1) ^ 1);
        const int k0 = (kt_lo + it) * kKeys;
        const uint32_t dk = s_k + st * G::kKvBytes;
        const uint32_t dv = s_v + st * G::kKvBytes;
        mbar_expect_tx(bar_k + 8 * st, G::kKvBytes);
        for (int p = 0; p < G::kPanels; ++p)
          tma_load_4d(dk + p * kKeys * G::kSwz, &tm_k, bar_k + 8 * st,
                      p * G::kPanelCols, hk, k0, b);
        mbar_expect_tx(bar_v + 8 * st, G::kKvBytes);
        for (int p = 0; p < G::kPanels; ++p)
          tma_load_4d(dv + p * kKeys * G::kSwz, &tm_v, bar_v + 8 * st,
                      p * G::kPanelCols, hk, k0, b);
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows; this thread holds rows r0 and
  // r0 + 8.  Software pipeline: while the tensor cores run S(t) = Q K(t)^T
  // and O += P(t-1) V(t-1), the thread rescales O, then takes the softmax
  // of S(t) once its product is done.
  const int wg = warp / 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int c_lane = 2 * (lane % 4);           // first of its column pair
  const int wg_first = q0 + wg * 64;
  const int wg_last = wg_first + 63;
  const uint32_t q_base = s_q + wg * 64 * G::kSwz;
  auto is_edge = [&](int k0) {
    return k0 + kKeys - 1 > wg_first || (window > 0 && k0 <= wg_last - window);
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.0f;
  uint32_t pa[kKeys / 16][4];
  float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  float l[2] = {0.0f, 0.0f};                   // this thread's columns only
  float corr[2];
  mbar_wait(bar_q, 0);
  // the turn order: warpgroup 0 issues first
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) bar_arrive(their_turn);

  mbar_wait(bar_k, 0);
  bar_sync(my_turn);
  hold(s);
  wgmma_fence();
  qk_tile<D>(s, q_base, s_k);
  wgmma_commit();
  bar_arrive(their_turn);
  wgmma_wait<0>();
  hold(s);
  softmax_tile<kKeys>(s, is_edge(kt_lo * kKeys), kt_lo * kKeys, r0, c_lane,
               window, scale_log2, m, l, corr);
  pack_p<kKeys>(s, pa);

  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % kTcStages;
    const int prev = (it - 1) % kTcStages;
    mbar_wait(bar_k + 8 * st, (it / kTcStages) & 1);
    bar_sync(my_turn);
    hold(s);
    wgmma_fence();
    qk_tile<D>(s, q_base, s_k + st * G::kKvBytes);
    wgmma_commit();
    rescale(o, corr);
    mbar_wait(bar_v + 8 * prev, ((it - 1) / kTcStages) & 1);
    hold(o);
    hold(pa);
    wgmma_fence();
    pv_tile<D>(o, pa, s_v + prev * G::kKvBytes);
    wgmma_commit();
    bar_arrive(their_turn);
    wgmma_wait<1>();
    hold(s);
    const int k0 = (kt_lo + it) * kKeys;
    softmax_tile<kKeys>(s, is_edge(k0), k0, r0, c_lane, window, scale_log2, m, l,
                 corr);
    wgmma_wait<0>();
    hold(o);
    hold(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_free + 8 * prev);
    pack_p<kKeys>(s, pa);
  }
  {
    // the last tile's P V
    const int last = (n_tiles - 1) % kTcStages;
    rescale(o, corr);
    mbar_wait(bar_v + 8 * last, ((n_tiles - 1) / kTcStages) & 1);
    bar_sync(my_turn);
    hold(o);
    hold(pa);
    wgmma_fence();
    pv_tile<D>(o, pa, s_v + last * G::kKvBytes);
    wgmma_commit();
    if (wg == 0) bar_arrive(their_turn);   // warpgroup 1 is last
    wgmma_wait<0>();
    hold(o);
    hold(pa);
  }

  // the row sums across the 4 lanes of a row, then out = acc / max(l, 1e-30)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = __fadd_rn(l[hh], __shfl_xor_sync(0xffffffffu, l[hh], 1));
    l[hh] = __fadd_rn(l[hh], __shfl_xor_sync(0xffffffffu, l[hh], 2));
  }
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  const long long row = static_cast<long long>(Hq) * D;
  __nv_bfloat16* o0 = out + (static_cast<long long>(b) * S + r0) * row + h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + c_lane;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * row + col) =
          __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (B, S, H, D) bf16 tensor, innermost first:
// boxes of (one panel of columns, 1 head, ``rows`` positions, 1 batch);
// positions past S read as zeros.
template <int D>
bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
                int S, int H, int rows) {
  using G = TcGeom<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(H) * D * 2,
      static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kPanelCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             G::kTmaSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int Hq, int n_rep, int window, float scale,
              cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode_map<D>(enc, &tq, q, B, S, Hq, kTcRows) ||
      !encode_map<D>(enc, &tk, k, B, S, Hq / n_rep, TcGeom<D>::kKeys) ||
      !encode_map<D>(enc, &tv, v, B, S, Hq / n_rep, TcGeom<D>::kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = TcGeom<D>::kSmem;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  dim3 grid(Hq, B, (S + kTcRows - 1) / kTcRows);
  flash_fwd_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, Hq, n_rep, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Hq, int n_rep, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<float, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Hq, n_rep,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int n_rep, int window, float scale, int is_bf16,
           cudaStream_t stream) {
  return is_bf16 ? launch_tc<D>(q, k, v, out, B, S, Hq, n_rep, window, scale,
                                stream)
                 : launch_f32<D>(q, k, v, out, B, S, Hq, n_rep, window, scale,
                                 stream);
}

}  // namespace

// q, out: (B, S, Hq, D); k, v: (B, S, Hq / n_rep, D).  All contiguous, one
// element type: bf16 when is_bf16 (16-byte aligned, for TMA), else f32.
// D in {16, 32, 64, 128}.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int S, int Hq, int n_rep,
                                int D, int window, float scale, int is_bf16,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, out, B, S, Hq, n_rep, window, scale, is_bf16, s);
    case 32: return launch<32>(q, k, v, out, B, S, Hq, n_rep, window, scale, is_bf16, s);
    case 64: return launch<64>(q, k, v, out, B, S, Hq, n_rep, window, scale, is_bf16, s);
    case 128: return launch<128>(q, k, v, out, B, S, Hq, n_rep, window, scale, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
