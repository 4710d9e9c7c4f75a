// Householder reduction of masked row blocks (CUDA C++, sm_90a).
//
// Each block b of Z [B, R, C] (contiguous f64: the M target columns first,
// then the K feature columns) is reduced by K Householder reflections of
// its feature columns, applied to the targets too, and the first K rows of
// the result are written to T [B, K, C]: the upper-triangular factor R of
// the features (K x K, in columns M..C-1) beside Q^T Y (K x M, in columns
// 0..M-1). Rows whose mask byte w [B, R] is 0 are selected away (read as
// zero rows), never multiplied by zero, so a NaN in a padding slot stays
// out. A block of fewer than K rows gives zero rows below its last.
//
// Replaces the XLA reduction of polars_ols_tpu/ops/linalg.py:382
// _householder_reduce (and its lane-major form householder_lanes, :435),
// which the JAX package runs under every multi-target fit and explicit
// 'svd' solve; there is no Pallas kernel for it. The arithmetic is the
// plain version's (polars_ols_tpu_torch/ops/linalg.py:_householder_reduce):
// alpha = -sign(c_jj) ||col||, sign(0) = +1, v = col - alpha e_j,
// beta = 1 / (sigma - c_jj alpha), and beta = 0 (the identity) for a zero
// pivot column. So kernel and plain version agree entry for entry, signs
// included; only the order of the sums differs. The groups' factors of
// several blocks are stacked and reduced again by the same kernel
// (ops/householder.py:reduce_groups, the TSQR tree).
//
// What bounds it: device-memory bytes. A block is read once (R C doubles
// and R mask bytes) for ~4 R sum_j (C - j) flops: at the reference suite's
// multi-target width (S = 20,000 blocks of R = 512, C = 7) 0.59 GB against
// ~1 GFLOP, 0.18 ms at 3.35 TB/s against 0.03 ms at 34 TFLOP/s.
//
// The design (an earlier one kept the panel in shared memory and spent
// three passes over it and two barriers a reflection, the load and the
// reflections in series; ~25 % of the bound):
// - The panel lives in registers. A thread owns RPT rows (t, t + T, ...)
//   of all the columns, a template bucket of NC columns: NC = 8 with RPT = 4
//   (C <= 8, 128 threads at R = 512), 16 and 33 with 2 (256 threads; at
//   one row a thread and 512 threads, 128 registers, C = 33 spilled).
//   In the registers the feature columns come first and the targets after
//   them, and the reflections are unrolled, so that reflection j's pivot is
//   register column j and the columns it updates (j on) are known at
//   compile time: no per-column selects or branches in the loop (the first
//   form of this design, in Z's column order with a runtime pivot, took
//   about 1.6 times as long; PERF.md has both forms' times).
// - The load: persistent blocks (as many as the card holds at once) walk
//   the row blocks; a block's panel and mask bytes arrive by two
//   cp.async.bulk copies on an mbarrier into one shared-memory stage
//   (rounded out to 16-byte words, as csrc/moments.cu's), each thread
//   takes its rows from there into registers, and behind one barrier the
//   next row block's copy is started, so it runs under the current one's
//   reflections. (Per-warp contiguous loads staged through 2.3 KB a warp,
//   tried first, left the load in series with the reflections.)
// - One pass and one barrier a reflection. With g_k = sum_{r >= j} a_rj a_rk
//   over the targets and the features from the pivot on (g of the pivot
//   column is sigma), the plain version's dot products are
//   v^T a_k = g_k - alpha a_jk. Each thread forms its rows' g, a warp sums
//   them by reduce-scatters of shuffles (8 columns: 9 shuffles in place of
//   40; wider buckets 8 columns at a time) and posts them to shared
//   memory, as the owner of row j posts that row; behind one barrier (the
//   partials are double-buffered, so the next reflection needs no second
//   one) every thread sums the warps' partials in one order, derives
//   sigma, alpha, beta and the dots, and updates its own rows in
//   registers.
// - Feature columns left of the pivot are not touched again (the plain
//   version subtracts round-off from them); the pivot column itself is
//   updated like the others, so R's diagonal is alpha and its entries
//   below the diagonal are the same round-off as the plain version's.


//
// The wide form (C > 33: more than 32 features, or targets beside the
// features past 33 columns) cannot keep a thread's rows of all columns in
// registers. One CTA of 256 threads reduces one row block of any number of
// rows, as blocked (compact WY) reflections, LAPACK's dgeqrt / dlarft:
// - Panels of kNb = 8 feature columns. The panel's reflections are the
//   column arithmetic above, over the panel's columns only: a thread holds
//   its rows of the 8 columns in registers (up to kCachedRows rows a
//   thread; rows past those are read in place), the dots g_c = sum_{r >= j}
//   a_rj a_rc of the pivot column with every panel column are a
//   reduce-scatter of shuffles a warp, the warps' partials posted to
//   shared memory (double-buffered, as is row j, which its owner posts),
//   and behind one barrier lanes 0..7 of every warp add the warps'
//   partials in warp order (the same bits in every warp). With them v^T a_c
//   = g_c - alpha a_jc, also for the panel's earlier columns c < j, where it
//   is v_c^T v_j, the dlarft product. The pivot column keeps v below the
//   diagonal (LAPACK's storage) and alpha on it, v_j in a slot of its own;
//   the reflected columns' entries below the diagonal are written out as
//   zeros (the plain version leaves round-off there).
// - Then the trailing columns (the targets and the features past the
//   panel) take the panel's reflections at once: A -= V (T^T (V^T A)),
//   with T the 8 x 8 triangle of the compact WY form (lanes 0..7 of one
//   warp build a row each). The products are the FP64 tensor cores'
//   mma.sync.aligned ... .f64 (DMMA), in the shapes that issue at their
//   peak on sm_90 (m8n8k4, csrc/moments.cu's, reaches half of it): (V^T A)^T
//   = A^T V as m16n8k16 steps (16 trailing columns by 16 rows by the 8
//   reflections), the warps over rows, every column tile of a pass of
//   kTrail = 48 columns in flight, the warps' partial tiles added in warp
//   order; then T^T and -Y a thread a column; then A += V (-Y) as one
//   m16n8k8 a 16-row by 8-column tile, a warp a row tile. So a panel takes
//   nbp + 4 barriers (one a reflection, then V written back, V^T A, -Y and
//   done) where the form before took 4 a reflection.
// - Where the panel fits one CTA's shared memory (B's 512 x 41 blocks) it
//   arrives by two cp.async.bulk copies on an mbarrier (rows and mask
//   bytes, rounded out to 16-byte words as the register form's), masked
//   rows then zeroed in place. Where it fits the shared memory of a
//   cluster of 2, 4 or 8 CTAs (A's 512 x 101 blocks: 4 CTAs of 128 rows),
//   each CTA holds a contiguous range of rows; a reflection's and V^T A's
//   CTA totals go through distributed shared memory (mapa,
//   ld.shared::cluster) behind a cluster barrier, every CTA adding them in
//   rank order, so every CTA derives the same reflections. Elsewhere the
//   panel lives in a device-memory workspace [B, R, C] (read from L2). The
//   three are separate instantiations, so the shared paths address the
//   panel with shared-memory instructions. One CTA unrolls a panel's eight
//   reflections; a cluster, whose reflections wait on its barriers, keeps
//   one copy (the smaller code is the faster there, the unrolled at B).
// The arithmetic of the reflections is the register form's (the same
// sigma, alpha, beta, the zero-pivot identity, the sign rule); the order of
// the sums and the blocked update differ from the plain version's, so they
// agree up to the reduction's forward error (which a near-singular pivot
// amplifies in the rows below it: chip_smoke.householder_shared_stream_edges).
// What bounds it: device-memory bytes at B (R C doubles and R mask bytes a
// block, read once; 0.07 ms at 3.35 TB/s); with a CTA an SM there, a
// block's load, its 40 reflections (a barrier each) and five block updates
// follow each other, so the blocks' waves add up latencies.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 512;
constexpr int kMaxCols = 33;
// the wide form
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kNb = 8;           // reflections a panel: the m8n8k4 tile's 8
constexpr int kCachedRows = 4;   // a thread's rows held in registers through a panel
constexpr int kTrail = 48;       // trailing columns a pass of the block update (B's 33 in one)
constexpr int kColTiles = kTrail / 16;  // V^T A's 16-column tiles a pass
constexpr int kUpdTiles = kTrail / 8;   // the update's 8-column tiles a pass
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;
// the most dynamic shared memory a block can opt in to on sm_90
constexpr size_t kMaxSmem = 232448;

// Warp totals of v[0..N) (N a power of two <= 32): xor offset O halves the
// values a lane keeps while N > 1 (the lane with bit O set keeps the upper
// half), then plain xor steps finish. Lane l ends with the total of column
// l / (32 / N); lanes of one column hold the same bits.
template <int N, int O>
__device__ __forceinline__ void scatter_sum(double* v, int lane) {
  if constexpr (N > 1) {
    const bool hi = (lane & O) != 0;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const double send = hi ? v[k] : v[k + N / 2];
      const double keep = hi ? v[k + N / 2] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, O);
    }
    scatter_sum<N / 2, O / 2>(v, lane);
  } else if constexpr (O > 0) {
    v[0] += __shfl_xor_sync(kFull, v[0], O);
    scatter_sum<1, O / 2>(v, lane);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// Thread 0: arm the barrier with block b's bytes (its panel and its mask
// bytes, each rounded out to 16-byte words) and start the two bulk copies
// into the stage.
__device__ __forceinline__ void issue(const double* z, const uint8_t* w, int64_t b, int R, int C,
                                      uint32_t stage, int z_bytes, uint32_t bar) {
  const uint8_t* zb = reinterpret_cast<const uint8_t*>(z + b * R * C);
  const uint8_t* mb = w + b * R;
  const int z_shift = static_cast<int>(reinterpret_cast<uintptr_t>(zb) & 15);
  const int m_shift = static_cast<int>(reinterpret_cast<uintptr_t>(mb) & 15);
  const uint32_t zn = static_cast<uint32_t>(round16(z_shift + 8 * R * C));
  const uint32_t mn = static_cast<uint32_t>(round16(m_shift + R));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(zn + mn) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(stage), "l"(zb - z_shift), "r"(zn), "r"(bar) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(stage + z_bytes), "l"(mb - m_shift), "r"(mn), "r"(bar) : "memory");
}

// The block's layout in dynamic shared memory: the bulk copies' barrier,
// the warps' partial g (double-buffered), row j (double-buffered), and the
// stage that one row block's panel and mask bytes land in.
struct Smem {
  int part, prow, stage, z_bytes, bytes;  // byte offsets and sizes
  __host__ __device__ Smem(int W, int NC, int R, int C) {
    part = 16;
    prow = part + 8 * 2 * W * NC;
    stage = round16(prow + 8 * 2 * NC);
    z_bytes = round16(8 + 8 * R * C);
    bytes = stage + z_bytes + round16(15 + R);
  }
};

// N columns in the shuffle reductions (8 at a time), X one more column
// (index N) summed by a plain butterfly, RPT rows a thread. Persistent: a
// block reduces row blocks blockIdx.x, + gridDim.x, ...; the next one's
// bulk copy runs behind the current one's reflections.
template <int N, bool X, int RPT>
__global__ void __launch_bounds__(kMaxRows / RPT)
householder_blocks(const double* __restrict__ z, const uint8_t* __restrict__ w, int64_t B, int R,
                   int C, int K, int reflections, double* __restrict__ t) {
  constexpr int NC = N + (X ? 1 : 0);  // columns a thread holds
  constexpr int NG = 8;                // columns a reduce-scatter takes
  constexpr int PS = NC;               // a warp's partials: stride
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int W = T >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Smem lay(W, NC, R, C);
  double* part = reinterpret_cast<double*>(smem + lay.part);  // [2][W][PS] the warps' g
  double* prow = reinterpret_cast<double*>(smem + lay.prow);  // [2][NC] row j
  unsigned char* stage = smem + lay.stage;
  const uint32_t bar = shared_addr(smem);
  const uint32_t stage_addr = shared_addr(stage);

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    issue(z, w, blockIdx.x, R, C, stage_addr, lay.z_bytes, bar);
  }
  __syncthreads();

  const int M = C - K;
  int steps = K < R ? K : R;  // reflections past the last row are the identity
  if (reflections < steps) steps = reflections;
  uint32_t parity = 0;
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    // this block's rows from the stage, masked rows selected away. In the
    // registers the K feature columns come first and the M targets after
    // them, so that reflection j's pivot is register column j: a
    // compile-time index once the reflections are unrolled
    wait_parity(bar, parity);
    parity ^= 1u;
    const uint8_t* zb = reinterpret_cast<const uint8_t*>(z + b * R * C);
    const double* zs = reinterpret_cast<const double*>(stage + (reinterpret_cast<uintptr_t>(zb) & 15));
    const uint8_t* ms = stage + lay.z_bytes + (reinterpret_cast<uintptr_t>(w + b * R) & 15);
    double a[RPT][NC];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tid + i * T;
      const bool keep = r < R && ms[r] != 0;
#pragma unroll
      for (int c = 0; c < NC; ++c) a[i][c] = keep && c < C ? zs[r * C + (c < K ? M + c : c - K)] : 0.0;
    }
    __syncthreads();  // the stage is read: the next block's copy may land
    if (tid == 0 && b + gridDim.x < B) {
      issue(z, w, b + gridDim.x, R, C, stage_addr, lay.z_bytes, bar);
    }

#pragma unroll
    for (int j = 0; j < NC - 1; ++j) {
      if (j >= steps) break;
      double* pb = part + (j & 1) * W * PS;
      double* rb = prow + (j & 1) * NC;
      // this thread's rows' g over rows r >= j and register columns from j
      // on (the features from the pivot on, then the targets), then the
      // warp's, NG columns at a time
      double pm[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pm[i] = tid + i * T >= j ? a[i][j] : 0.0;
#pragma unroll
      for (int h = 0; h < N / NG; ++h) {
        double v[NG];
#pragma unroll
        for (int c = 0; c < NG; ++c) {
          v[c] = 0.0;
          if (h * NG + c >= j) {
#pragma unroll
            for (int i = 0; i < RPT; ++i) v[c] += pm[i] * a[i][h * NG + c];
          }
        }
        scatter_sum<NG, 16>(v, lane);
        if ((lane & (32 / NG - 1)) == 0) pb[warp * PS + h * NG + lane / (32 / NG)] = v[0];
      }
      if constexpr (X) {
        double vx = 0.0;
#pragma unroll
        for (int i = 0; i < RPT; ++i) vx += pm[i] * a[i][N];
        vx = warp_sum(vx);
        if (lane == 0) pb[warp * PS + N] = vx;
      }
      if (tid == j) {
#pragma unroll
        for (int c = j; c < NC; ++c) rb[c] = a[0][c];
      }
      __syncthreads();

      // the block's g: lane c sums column c over the warps, in warp order
      double gl = 0.0;
      for (int q = 0; q < W; ++q) gl += pb[q * PS + (lane & (N - 1))];
      double gx = 0.0;
      if constexpr (X) {
        for (int q = 0; q < W; ++q) gx += pb[q * PS + N];
      }
      const double sigma = __shfl_sync(kFull, gl, j);
      const double piv = rb[j];
      const double alpha = -(piv >= 0.0 ? 1.0 : -1.0) * sqrt(sigma);
      const double vj = piv - alpha;
      const double denom = sigma - piv * alpha;  // = ||v||^2 / 2
      const double beta = denom > 0.0 ? 1.0 / denom : 0.0;
      // a_rk -= beta v_r (g_k - alpha a_jk) for register columns from j on;
      // rows above j have v_r = 0 (a frozen row is left as it is)
      double bv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tid + i * T;
        bv[i] = r < j ? 0.0 : beta * (r == j ? vj : a[i][j]);
      }
#pragma unroll
      for (int c = j; c < NC; ++c) {
        const double g = c < N ? __shfl_sync(kFull, gl, c) : gx;
        const double dot = g - alpha * rb[c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i][c] -= bv[i] * dot;
      }
    }

    // row r < K of T is thread r's first row, back in Z's column order
    if (tid < K) {
      double* tr = t + (b * K + tid) * C;
      const bool real = tid < R;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < C) tr[c < K ? M + c : c - K] = real ? a[0][c] : 0.0;
      }
    }
  }
}

// The FP64 tensor-core products (DMMA). With g = lane / 4 and t = lane %
// 4, a lane holds A(g + 8 (j % 2), t + 4 (j / 2)) as a[j], B(t + 4 j, g) as
// b[j] and D(g + 8 (j / 2), 2 t + j % 2) as d[j]. m16n8k8 and m16n8k16 issue
// at the FP64 tensor peak on sm_90, twice m8n8k4's rate.
// d (16 x 8) += A (16 x 8) B (8 x 8)
__device__ __forceinline__ void dmma_k8(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// d (16 x 8) += A (16 x 16) B (16 x 8)
__device__ __forceinline__ void dmma_k16(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_ctas() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of every CTA of the cluster: the writes before it are seen
// by every CTA after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the double at p (this CTA's shared memory) in cluster CTA `rank`'s
__device__ __forceinline__ double ld_peer(const double* p, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(shared_addr(p)), "r"(rank));
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n" : "=d"(v) : "r"(remote) : "memory");
  return v;
}

// The wide form's dynamic shared memory (byte offsets): the bulk copy's
// barrier; the warps' partial dots [2][warps][kNb] and the CTA's [2][kNb]
// (a cluster's), row j [2][kNb]; the panel's beta, v_j, v_c^T v_j [kNb][kNb]
// and T [kNb][kNb]; (V^T A)^T's partial tiles, a warp's [kTrail][kNb]; the
// CTA's V^T A [2][kNb][kTrail] (a cluster's) and -Y [2][kNb][kTrail]; then,
// where the panel is here, its rows [rows][C] and their mask bytes.
struct WideSmem {
  int64_t part, ctap, prow, beta, vdiag, wvv, tm, wpart, wmc, ym, stage, z_bytes, bytes;
  __host__ __device__ WideSmem(int64_t rows, int64_t C, bool panel_here) {
    part = 16;
    ctap = part + 8 * 2 * kWideWarps * kNb;
    prow = ctap + 8 * 2 * kNb;
    beta = prow + 8 * 2 * kNb;
    vdiag = beta + 8 * kNb;
    wvv = vdiag + 8 * kNb;
    tm = wvv + 8 * kNb * kNb;
    wpart = tm + 8 * kNb * kNb;
    wmc = wpart + 8 * kWideWarps * kTrail * kNb;
    ym = wmc + 8 * 2 * kNb * kTrail;
    stage = ym + 8 * 2 * kNb * kTrail;
    z_bytes = panel_here ? (8 + 8 * rows * C + 15) / 16 * 16 : 0;
    bytes = stage + (panel_here ? z_bytes + (15 + rows + 15) / 16 * 16 : 0);
  }
};

// CTAs a row block of R x C takes with its panel in shared memory: 1, or
// a cluster of 2, 4 or 8 (contiguous ranges of rows); 0 where even 8 do
// not hold it (the panel then lives in device memory)
int wide_ctas(int64_t R, int64_t C) {
  for (int n = 1; n <= kMaxCluster; n *= 2) {
    if (WideSmem((R + n - 1) / n, C, true).bytes <= static_cast<int64_t>(kMaxSmem)) return n;
  }
  return 0;
}

// The form at (R, C): 0 the register form, 1 the wide form with the panel
// in one CTA's shared memory, 2 the wide form with the panel in device
// memory, 3 the wide form with the panel in a cluster's shared memory, -1
// none (C < 2, R < 1, or R > 512 at C <= 33).
int form_of(int64_t R, int64_t C) {
  if (C < 2 || R < 1) return -1;
  if (C <= kMaxCols) return R <= kMaxRows ? 0 : -1;
  const int n = wide_ctas(R, C);
  return n == 1 ? 1 : (n > 1 ? 3 : 2);
}

// Block b = blockIdx.x / (CTAs a block) of the wide form (above): rows
// [lo, hi) of it in this CTA (kShared: its shared memory; else all rows in
// the workspace `work` [B, R, C]).
template <bool kShared, bool kCluster>
__global__ void __launch_bounds__(kWideThreads)
householder_wide(const double* __restrict__ z, const uint8_t* __restrict__ w, int R, int C, int K,
                 int reflections, int rows_cta, double* __restrict__ work, double* __restrict__ t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned ncl = kCluster ? cluster_ctas() : 1u;
  const unsigned rank = kCluster ? cluster_rank() : 0u;
  const int64_t b = blockIdx.x / ncl;
  const int lo = kShared ? static_cast<int>(rank) * rows_cta : 0;
  const int hi = kShared ? (R < lo + rows_cta ? R : lo + rows_cta) : R;
  const WideSmem lay(kShared ? rows_cta : 0, C, kShared);
  double* part = reinterpret_cast<double*>(smem + lay.part);
  double* ctap = reinterpret_cast<double*>(smem + lay.ctap);
  double* prow = reinterpret_cast<double*>(smem + lay.prow);
  double* bet = reinterpret_cast<double*>(smem + lay.beta);
  double* vdiag = reinterpret_cast<double*>(smem + lay.vdiag);
  double* wvv = reinterpret_cast<double*>(smem + lay.wvv);
  double* tm = reinterpret_cast<double*>(smem + lay.tm);
  double* wpart = reinterpret_cast<double*>(smem + lay.wpart);
  double* wmc = reinterpret_cast<double*>(smem + lay.wmc);
  double* ym = reinterpret_cast<double*>(smem + lay.ym);
  const int M = C - K;

  // the panel, masked rows selected away: row r at a + (r - lo) C
  double* a;
  if constexpr (kShared) {
    const uint8_t* zb = reinterpret_cast<const uint8_t*>(z + (b * R + lo) * static_cast<int64_t>(C));
    const uint8_t* mb = w + b * R + lo;
    const int z_shift = static_cast<int>(reinterpret_cast<uintptr_t>(zb) & 15);
    const int m_shift = static_cast<int>(reinterpret_cast<uintptr_t>(mb) & 15);
    a = reinterpret_cast<double*>(smem + lay.stage + z_shift);
    const uint8_t* ms = smem + lay.stage + lay.z_bytes + m_shift;
    if (hi > lo) {
      const uint32_t bar = shared_addr(smem);
      if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      __syncthreads();
      if (tid == 0) {
        const uint32_t zn = static_cast<uint32_t>(round16(z_shift + 8 * (hi - lo) * C));
        const uint32_t mn = static_cast<uint32_t>(round16(m_shift + (hi - lo)));
        const uint32_t stage = shared_addr(smem + lay.stage);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(zn + mn) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            :: "r"(stage), "l"(zb - z_shift), "r"(zn), "r"(bar) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            :: "r"(stage + static_cast<uint32_t>(lay.z_bytes)), "l"(mb - m_shift), "r"(mn), "r"(bar)
            : "memory");
      }
      wait_parity(bar, 0);
      for (int r = warp; r < hi - lo; r += kWideWarps) {
        if (ms[r] == 0) {
          for (int c = lane; c < C; c += 32) a[static_cast<int64_t>(r) * C + c] = 0.0;
        }
      }
    }
  } else {
    a = work + b * R * static_cast<int64_t>(C);
    for (int r = warp; r < R; r += kWideWarps) {
      const bool keep = w[b * R + r] != 0;
      const double* zr = z + (b * R + r) * static_cast<int64_t>(C);
      for (int c = lane; c < C; c += 32) a[static_cast<int64_t>(r) * C + c] = keep ? zr[c] : 0.0;
    }
  }
  __syncthreads();
  auto rowp = [&](int r) { return a + static_cast<int64_t>(r - lo) * C; };

  int steps = K < R ? K : R;  // reflections past the last row are the identity
  if (reflections < steps) steps = reflections;
  int chunk = 0;  // passes of the block update so far: their buffers' parity
  for (int j0 = 0; j0 < steps; j0 += kNb) {
    const int pw = K - j0 < kNb ? K - j0 : kNb;           // the panel's columns
    const int nbp = steps - j0 < kNb ? steps - j0 : kNb;  // its reflections
    const int pc = M + j0;                                // its first column in Z's order
    // this thread's rows lo + tid + i T of the panel's columns
    double x[kCachedRows][kNb];
#pragma unroll
    for (int i = 0; i < kCachedRows; ++i) {
      const int r = lo + tid + i * kWideThreads;
#pragma unroll
      for (int c = 0; c < kNb; ++c) x[i][c] = r < hi && c < pw ? rowp(r)[pc + c] : 0.0;
    }
    // x[i][ii] by selects (ii may be known only at run time, below)
    auto pick = [](const double (&row)[kNb], int c) {
      double p = row[0];
#pragma unroll
      for (int k = 1; k < kNb; ++k) p = c == k ? row[k] : p;
      return p;
    };
    auto reflect = [&](const int ii) {
      const int j = j0 + ii;  // the pivot row
      double* pb = part + (ii & 1) * kWideWarps * kNb;
      double* cb = ctap + (ii & 1) * kNb;
      double* rb = prow + (ii & 1) * kNb;
      double v[kNb];
#pragma unroll
      for (int c = 0; c < kNb; ++c) v[c] = 0.0;
#pragma unroll
      for (int i = 0; i < kCachedRows; ++i) {
        const int r = lo + tid + i * kWideThreads;
        if (r >= j && r < hi) {
          const double xp = pick(x[i], ii);
#pragma unroll
          for (int c = 0; c < kNb; ++c) v[c] = fma(xp, x[i][c], v[c]);
        }
      }
      for (int r = lo + tid + kCachedRows * kWideThreads; r < hi; r += kWideThreads) {
        if (r < j) continue;
        const double* ar = rowp(r) + pc;
        double y[kNb];
#pragma unroll
        for (int c = 0; c < kNb; ++c) y[c] = c < pw ? ar[c] : 0.0;
        const double yp = pick(y, ii);
#pragma unroll
        for (int c = 0; c < kNb; ++c) v[c] = fma(yp, y[c], v[c]);
      }
      scatter_sum<kNb, 16>(v, lane);
      if ((lane & 3) == 0) pb[warp * kNb + lane / 4] = v[0];
      if (j >= lo && j < hi && (j - lo) % kWideThreads == tid) {  // row j is this thread's
        const int i = (j - lo) / kWideThreads;
        if (i >= kCachedRows) {
#pragma unroll
          for (int c = 0; c < kNb; ++c) rb[c] = c < pw ? rowp(j)[pc + c] : 0.0;
        }
#pragma unroll
        for (int k = 0; k < kCachedRows; ++k) {
          if (k == i) {
#pragma unroll
            for (int c = 0; c < kNb; ++c) rb[c] = x[k][c];
          }
        }
      }
      // the block's g (lane c of a warp: column c & 7) and row j, the same
      // bits in every warp (and every CTA of a cluster)
      double g = 0.0, rj;
      if constexpr (kCluster) {
        __syncthreads();
        if (warp == 0 && lane < kNb) {
          double s = 0.0;
          for (int q = 0; q < kWideWarps; ++q) s += pb[q * kNb + lane];
          cb[lane] = s;
        }
        cluster_sync();
        for (unsigned q = 0; q < ncl; ++q) g += ld_peer(cb + (lane & 7), q);
        rj = ld_peer(rb + (lane & 7), static_cast<unsigned>(j / rows_cta));
      } else {
        __syncthreads();
        for (int q = 0; q < kWideWarps; ++q) g += pb[q * kNb + (lane & 7)];
        rj = rb[lane & 7];
      }
      const double sigma = __shfl_sync(kFull, g, ii);
      const double piv = __shfl_sync(kFull, rj, ii);
      const double alpha = -(piv >= 0.0 ? 1.0 : -1.0) * sqrt(sigma);
      const double vj = piv - alpha;
      const double denom = sigma - piv * alpha;  // = ||v||^2 / 2
      const double beta = denom > 0.0 ? 1.0 / denom : 0.0;
      // d_c = v^T a_c, lane c's: the dots of the columns it updates (c >
      // ii, handed to every lane) and, for c < ii, v_c^T v_j (T's column ii)
      const double dl = g - alpha * rj;
      double d[kNb];
#pragma unroll
      for (int c = 0; c < kNb; ++c) d[c] = __shfl_sync(kFull, dl, c);
      if (warp == 0 && lane < ii) wvv[lane * kNb + ii] = dl;
      if (tid == 0) {
        bet[ii] = beta;
        vdiag[ii] = vj;
      }
      // a_rc -= beta v_r d_c on this thread's rows r >= j, the panel's
      // columns past the pivot; the pivot row's pivot entry becomes alpha
      // (the rows below keep v)
#pragma unroll
      for (int i = 0; i < kCachedRows; ++i) {
        const int r = lo + tid + i * kWideThreads;
        if (r >= j && r < hi) {
          const double bv = beta * (r == j ? vj : pick(x[i], ii));
#pragma unroll
          for (int c = 0; c < kNb; ++c) {
            const double upd = x[i][c] - bv * d[c];
            x[i][c] = c > ii ? upd : (c == ii && r == j ? alpha : x[i][c]);
          }
        }
      }
      for (int r = lo + tid + kCachedRows * kWideThreads; r < hi; r += kWideThreads) {
        if (r < j) continue;
        double* ar = rowp(r) + pc;
        const double bv = beta * (r == j ? vj : ar[ii]);
#pragma unroll
        for (int c = 0; c < kNb; ++c) {
          if (c > ii && c < pw) ar[c] -= bv * d[c];
        }
        if (r == j) ar[ii] = alpha;
      }
    };
    // one CTA: the reflections unrolled (ii known at compile time, so the
    // selects fold away); a cluster, where the barriers dominate: one copy
    // of the reflection, a smaller kernel
    if constexpr (kCluster) {
      for (int ii = 0; ii < nbp; ++ii) reflect(ii);
    } else {
#pragma unroll
      for (int ii = 0; ii < kNb; ++ii) {
        if (ii < nbp) reflect(ii);
      }
    }
#pragma unroll
    for (int i = 0; i < kCachedRows; ++i) {
      const int r = lo + tid + i * kWideThreads;
      if (r < hi) {
#pragma unroll
        for (int c = 0; c < kNb; ++c) {
          if (c < pw) rowp(r)[pc + c] = x[i][c];
        }
      }
    }
    __syncthreads();  // V and the panel's scalars are in place

    // T of the compact WY form (dlarft, forward, columnwise): lane k of
    // warp 0 builds row k, T[k][i] = -beta_i sum_{k <= m < i} T[k][m] v_m^T v_i
    if (warp == 0 && lane < kNb) {
      double tr[kNb];
#pragma unroll
      for (int i = 0; i < kNb; ++i) {
        double s = 0.0;
#pragma unroll
        for (int m = 0; m < i; ++m) {
          if (m >= lane) s += tr[m] * wvv[m * kNb + i];
        }
        tr[i] = i >= nbp || i < lane ? 0.0 : (i == lane ? bet[i] : -bet[i] * s);
        tm[lane * kNb + i] = tr[i];
      }
    }
    // v_i's entry at row r: zero above its pivot row j0 + i, v_j on it
    auto vval = [&](int r, int i) -> double {  // no branch: selects and a predicated load
      const int p = j0 + i;
      const bool in = i < nbp && r >= p && r < hi;
      const double below = in && r != p ? rowp(r)[pc + i] : 0.0;
      return in && r == p ? vdiag[i] : below;
    };

    // the trailing columns (targets, then the features past the panel),
    // kTrail at a time: trailing column u is Z's column u, or M + j0 + pw +
    // (u - M). Warps take rows; each keeps the pass's column tiles in
    // flight, so that their products are independent
    const int n_trail = M + K - j0 - pw;
    const int shift = j0 + pw;
    const int g8 = lane >> 2, t4 = lane & 3;
    for (int t0 = 0; t0 < n_trail; t0 += kTrail, ++chunk) {
      const int nt = n_trail - t0 < kTrail ? n_trail - t0 : kTrail;
      double* wmp = wmc + (chunk & 1) * kNb * kTrail;
      double* ymp = ym + (chunk & 1) * kNb * kTrail;
      auto zcol = [&](int tt) { return tt < nt ? (t0 + tt < M ? t0 + tt : t0 + tt + shift) : -1; };
      // (V^T A)^T = A^T V, m16n8k16: 16 trailing columns by 16 rows by the
      // 8 reflections; warp w over a contiguous share of the 16-row steps
      // from the panel's first row (rows above it have v = 0)
      const int tiles16 = (nt + 15) / 16;
      const int r_first = lo > j0 ? lo : j0;
      const int ksteps = hi > r_first ? (hi - r_first + 15) / 16 : 0;
      {
        const int ks0 = ksteps * warp / kWideWarps, ks1 = ksteps * (warp + 1) / kWideWarps;
        int zc[kColTiles][2];
#pragma unroll
        for (int ct = 0; ct < kColTiles; ++ct) {
          zc[ct][0] = zcol(16 * ct + g8);
          zc[ct][1] = zcol(16 * ct + g8 + 8);
        }
        double acc[kColTiles][4];
#pragma unroll
        for (int ct = 0; ct < kColTiles; ++ct) acc[ct][0] = acc[ct][1] = acc[ct][2] = acc[ct][3] = 0.0;
        for (int ks = ks0; ks < ks1; ++ks) {
          const int r = r_first + 16 * ks + t4;
          double vb[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) vb[q] = vval(r + 4 * q, g8);
          double av[kColTiles][8];
#pragma unroll
          for (int ct = 0; ct < kColTiles; ++ct) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int rq = r + 4 * (q / 2);
              const int zq = zc[ct][q % 2];
              av[ct][q] = rq < hi && zq >= 0 ? rowp(rq)[zq] : 0.0;
            }
          }
#pragma unroll
          for (int ct = 0; ct < kColTiles; ++ct) {
            if (ct < tiles16) dmma_k16(acc[ct], av[ct], vb);
          }
        }
#pragma unroll
        for (int ct = 0; ct < kColTiles; ++ct) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 16 * ct + g8 + 8 * (q / 2), n = 2 * t4 + q % 2;
            wpart[(warp * kTrail + i) * kNb + n] = acc[ct][q];
          }
        }
      }
      __syncthreads();
      // the CTA's V^T A (a cluster's: the CTAs' in rank order), then -Y =
      // -T^T V^T A, a thread a column
      double wm[kNb];
      if (tid < nt) {
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          double s = 0.0;
          for (int q = 0; q < kWideWarps; ++q) s += wpart[(q * kTrail + tid) * kNb + k];
          wm[k] = s;
        }
      }
      if constexpr (kCluster) {
        if (tid < nt) {
#pragma unroll
          for (int k = 0; k < kNb; ++k) wmp[k * kTrail + tid] = wm[k];
        }
        cluster_sync();
        if (tid < nt) {
#pragma unroll
          for (int k = 0; k < kNb; ++k) {
            double s = 0.0;
            for (unsigned q = 0; q < ncl; ++q) s += ld_peer(wmp + k * kTrail + tid, q);
            wm[k] = s;
          }
        }
      }
      if (tid < nt) {
#pragma unroll
        for (int i = 0; i < kNb; ++i) {
          double y = 0.0;
#pragma unroll
          for (int k = 0; k < kNb; ++k) y += tm[k * kNb + i] * wm[k];
          ymp[i * kTrail + tid] = -y;
        }
      }
      __syncthreads();
      // A += V (-Y), m16n8k8: warp w takes 16-row tiles w, w + warps, ... of
      // this CTA's rows from the panel's first, every 8-column tile at
      // once; -Y's fragments are the same for every row tile
      const int tiles8 = (nt + 7) / 8;
      double yb[kUpdTiles][2];
#pragma unroll
      for (int ct = 0; ct < kUpdTiles; ++ct) {
        const int tb = 8 * ct + g8;
        yb[ct][0] = tb < nt ? ymp[t4 * kTrail + tb] : 0.0;
        yb[ct][1] = tb < nt ? ymp[(t4 + 4) * kTrail + tb] : 0.0;
      }
      const int nrt = hi > r_first ? (hi - r_first + 15) / 16 : 0;
      for (int rt = warp; rt < nrt; rt += kWideWarps) {
        const int r = r_first + 16 * rt + g8;
        const double va[4] = {vval(r, t4), vval(r + 8, t4), vval(r, t4 + 4), vval(r + 8, t4 + 4)};
        double cc[kUpdTiles][4];
        int zs[kUpdTiles][2];
#pragma unroll
        for (int ct = 0; ct < kUpdTiles; ++ct) {
          zs[ct][0] = zcol(8 * ct + 2 * t4);
          zs[ct][1] = zcol(8 * ct + 2 * t4 + 1);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int rq = r + 8 * (q / 2);
            const int zq = zs[ct][q % 2];
            cc[ct][q] = rq < hi && zq >= 0 ? rowp(rq)[zq] : 0.0;
          }
        }
#pragma unroll
        for (int ct = 0; ct < kUpdTiles; ++ct) {
          if (ct < tiles8) dmma_k8(cc[ct], va, yb[ct]);
        }
#pragma unroll
        for (int ct = 0; ct < kUpdTiles; ++ct) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int rq = r + 8 * (q / 2);
            const int zq = zs[ct][q % 2];
            if (rq < hi && zq >= 0) rowp(rq)[zq] = cc[ct][q];
          }
        }
      }
    }
    __syncthreads();  // the panel's update is in place
  }

  // rows r < K of T, in Z's column order: the reflected columns' entries
  // below the diagonal (v) are zero, as are rows below a block's last
  const int top = hi < K ? hi : K;
  for (int r = lo + warp; r < top; r += kWideWarps) {
    const double* ar = rowp(r);
    double* tr = t + (b * K + r) * static_cast<int64_t>(C);
    for (int c = lane; c < C; c += 32) {
      const int k = c - M;
      tr[c] = k >= 0 && k < steps && r > k ? 0.0 : ar[c];
    }
  }
  if (rank == 0) {
    for (int r = R + warp; r < K; r += kWideWarps) {
      for (int c = lane; c < C; c += 32) t[(b * K + r) * static_cast<int64_t>(C) + c] = 0.0;
    }
  }
  if constexpr (kCluster) cluster_sync();  // no CTA leaves while a peer may read its shared memory
}

template <bool kShared, bool kCluster>
int launch_wide_as(const double* z, const uint8_t* w, int64_t B, int64_t R, int64_t C, int64_t K,
                   int reflections, int ctas, double* work, double* t, cudaStream_t stream) {
  auto kernel = householder_wide<kShared, kCluster>;
  const int rows_cta = static_cast<int>((R + ctas - 1) / ctas);
  const size_t smem = static_cast<size_t>(WideSmem(kShared ? rows_cta : 0, C, kShared).bytes);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * ctas), 1, 1);
  cfg.blockDim = dim3(kWideThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, z, w, static_cast<int>(R), static_cast<int>(C), static_cast<int>(K),
                           reflections, rows_cta, work, t);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const double* z, const uint8_t* w, int64_t B, int64_t R, int64_t C, int64_t K,
                int reflections, int form, double* work, double* t, cudaStream_t stream) {
  if (form == 2 && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1) return launch_wide_as<true, false>(z, w, B, R, C, K, reflections, 1, nullptr, t, stream);
  if (form == 3) {
    return launch_wide_as<true, true>(z, w, B, R, C, K, reflections, wide_ctas(R, C), nullptr, t, stream);
  }
  return launch_wide_as<false, false>(z, w, B, R, C, K, reflections, 1, work, t, stream);
}

template <int N, bool X, int RPT>
int launch(const double* z, const uint8_t* w, int64_t B, int64_t R, int64_t C, int64_t K,
           int reflections, double* t, cudaStream_t stream) {
  constexpr int NC = N + (X ? 1 : 0);
  const int rows = 32 * RPT;
  const int threads = static_cast<int>((R + rows - 1) / rows) * 32;
  const Smem lay(threads / 32, NC, static_cast<int>(R), static_cast<int>(C));
  const size_t smem = static_cast<size_t>(lay.bytes);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = householder_blocks<N, X, RPT>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // persistent: as many blocks as the card holds at once, at most B
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(B < resident ? B : resident);
  kernel<<<grid, threads, smem, stream>>>(z, w, B, static_cast<int>(R), static_cast<int>(C),
                                          static_cast<int>(K), reflections, t);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

// The form pols_householder_blocks takes at (R, C): 0 the register form
// (C <= 33, R <= 512), 1 the wide form with the panel in one CTA's shared
// memory, 2 the wide form with the panel in a device-memory workspace of
// B * R * C doubles, 3 the wide form with the panel in the shared memory
// of a cluster of CTAs (pols_householder_ctas of them a block), -1 none.
int pols_householder_form(int64_t R, int64_t C) { return form_of(R, C); }

// CTAs the wide form gives a block of R x C: 1 (forms 1 and 2) or the
// cluster's 2, 4 or 8 (form 3); 0 where the register form or none applies.
int pols_householder_ctas(int64_t R, int64_t C) {
  const int form = form_of(R, C);
  return form == 3 ? wide_ctas(R, C) : (form == 1 || form == 2 ? 1 : 0);
}

// The first K rows T [B, K, C] of each block of Z [B, R, C] (contiguous f64,
// targets first) under the row mask w [B, R] (bool bytes), after the first
// `reflections` Householder reflections of the feature columns: K for the
// reduction; fewer (0: the load and the store alone) time the kernel's
// phases apart. `work` is the wide form's panel workspace (B * R * C
// doubles) where pols_householder_form says 2, else unused. Launches on
// `stream` without synchronising; returns the CUDA error code of the launch
// (0 on success).
int pols_householder_blocks(const double* z, const uint8_t* w, int64_t B, int64_t R,
                            int64_t C, int64_t K, int64_t reflections, double* work, double* t,
                            void* stream) {
  const int form = form_of(R, C);
  if (B < 0 || B > INT32_MAX / kMaxCluster || R > INT32_MAX || form < 0 || K < 1 || K >= C ||
      reflections < 0 || reflections > K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(reflections);
  if (form > 0) return launch_wide(z, w, B, R, C, K, r, form, work, t, s);
  if (C <= 8) return launch<8, false, 4>(z, w, B, R, C, K, r, t, s);
  if (C <= 16) return launch<16, false, 2>(z, w, B, R, C, K, r, t, s);
  return launch<32, true, 2>(z, w, B, R, C, K, r, t, s);
}

// Message for an error code returned above.
const char* pols_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
