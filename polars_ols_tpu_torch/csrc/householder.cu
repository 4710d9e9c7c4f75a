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
// registers, and a 512-row panel of 101 columns (414 KB) fits neither the
// registers nor a block's 227 KB of shared memory. One block of 1,024
// threads reduces one row block of any number of rows; the panel [R, C]
// (Z's column order) lives in shared memory where it fits beside the
// scratch, else in a device-memory workspace [B, R, C] that the wrapper
// allocates (read back from L2; the same code through a generic pointer).
// A reflection is three passes with a barrier each: row j staged in
// shared memory (the pivot column v is read in place from the panel, so a
// block's rows are not bounded by a staging buffer); the dots
// g_q = sum_{r >= j} v_r a_rq of the active columns (the
// targets and the features from the pivot on), lanes over columns and
// warps over rows, kWideChunk columns a pass, the warps' partials summed in
// warp order; then every (row >= j, active column) updated as
// a_rq -= beta v_r (g_q - alpha a_jq), coalesced along the row. The
// arithmetic is the register form's (the same sigma, alpha, beta, the
// same zero-pivot identity, the columns left of the pivot untouched), so
// it too agrees with the plain version entry for entry up to the order of
// the sums. What bounds it: the panel is read and written once a
// reflection, so its traffic is ~3 K R C doubles against a shared-memory
// or L2 rate, not the R C doubles that device memory must bring once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 512;
constexpr int kMaxCols = 33;
// the wide form
constexpr int kWideThreads = 1024;  // 32 warps: a block an SM must hide its own latency
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideChunk = 128;  // columns a pass of the dots: 4 a lane
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

// The wide form's dynamic shared memory: the dots g [C], row j [C], the
// warps' partial dots [kWideWarps][kWideChunk] and, where it fits, the
// panel [R][C] (byte offsets).
struct WideSmem {
  int64_t g, prow, part, panel, bytes;
  __host__ __device__ WideSmem(int64_t R, int64_t C, bool panel_here) {
    g = 0;
    prow = g + 8 * C;
    part = prow + 8 * C;
    panel = part + 8 * kWideWarps * kWideChunk;
    bytes = panel + (panel_here ? 8 * R * C : 0);
  }
};

// The form at (R, C): 0 the register form, 1 the wide form with the panel
// in shared memory, 2 the wide form with the panel in device memory, -1
// none (C < 2, R < 1, R > 512 at C <= 33, or the wide form's scratch past
// shared memory).
int form_of(int64_t R, int64_t C) {
  if (C < 2 || R < 1) return -1;
  if (C <= kMaxCols) return R <= kMaxRows ? 0 : -1;
  if (WideSmem(R, C, true).bytes <= static_cast<int64_t>(kMaxSmem)) return 1;
  return WideSmem(R, C, false).bytes <= static_cast<int64_t>(kMaxSmem) ? 2 : -1;
}

// Block b's reflections on its panel a (shared or device memory): see the
// wide form above. Active column q is target q (q < M) or feature column
// M + j + (q - M) at reflection j.
__global__ void __launch_bounds__(kWideThreads)
householder_wide(const double* __restrict__ z, const uint8_t* __restrict__ w, int R, int C, int K,
                 int reflections, int panel_here, double* work, double* __restrict__ t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WideSmem lay(R, C, panel_here != 0);
  double* g = reinterpret_cast<double*>(smem + lay.g);
  double* prow = reinterpret_cast<double*>(smem + lay.prow);
  double* part = reinterpret_cast<double*>(smem + lay.part);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int M = C - K;
  int steps = K < R ? K : R;  // reflections past the last row are the identity
  if (reflections < steps) steps = reflections;
  const int64_t b = blockIdx.x;  // one block a row block
  double* a = panel_here ? reinterpret_cast<double*>(smem + lay.panel) : work + b * R * C;
  const double* zb = z + b * R * C;
  const uint8_t* mb = w + b * R;
  for (int r = warp; r < R; r += kWideWarps) {  // masked rows selected away
    const bool keep = mb[r] != 0;
    for (int c = lane; c < C; c += 32) a[static_cast<int64_t>(r) * C + c] = keep ? zb[static_cast<int64_t>(r) * C + c] : 0.0;
  }
  __syncthreads();

  for (int j = 0; j < steps; ++j) {
    const int jc = M + j;      // the pivot column
    const int nq = M + K - j;  // the active columns
    for (int q = tid; q < nq; q += kWideThreads) prow[q] = a[static_cast<int64_t>(j) * C + (q < M ? q : jc + q - M)];
    __syncthreads();
    for (int q0 = 0; q0 < nq; q0 += kWideChunk) {
      double acc[kWideChunk / 32];
      int cq[kWideChunk / 32];
#pragma unroll
      for (int u = 0; u < kWideChunk / 32; ++u) {
        const int q = q0 + 32 * u + lane;
        acc[u] = 0.0;
        cq[u] = q < nq ? (q < M ? q : jc + q - M) : -1;
      }
      for (int r = j + warp; r < R; r += kWideWarps) {
        const double vr = a[static_cast<int64_t>(r) * C + jc];
        const double* ar = a + static_cast<int64_t>(r) * C;
#pragma unroll
        for (int u = 0; u < kWideChunk / 32; ++u) {
          if (cq[u] >= 0) acc[u] = fma(vr, ar[cq[u]], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kWideChunk / 32; ++u) part[warp * kWideChunk + 32 * u + lane] = acc[u];
      __syncthreads();
      if (tid < kWideChunk && q0 + tid < nq) {
        double sum = 0.0;
        for (int k = 0; k < kWideWarps; ++k) sum += part[k * kWideChunk + tid];
        g[q0 + tid] = sum;
      }
      __syncthreads();
    }
    const double sigma = g[M];
    const double piv = prow[M];
    const double alpha = -(piv >= 0.0 ? 1.0 : -1.0) * sqrt(sigma);
    const double vj = piv - alpha;
    const double denom = sigma - piv * alpha;  // = ||v||^2 / 2
    const double beta = denom > 0.0 ? 1.0 / denom : 0.0;
    for (int r = j + warp; r < R; r += kWideWarps) {
      double* ar = a + static_cast<int64_t>(r) * C;
      const double bv = beta * (r == j ? vj : ar[jc]);
      __syncwarp();  // every lane has v_r before one of them updates it
      for (int q = lane; q < nq; q += 32) ar[q < M ? q : jc + q - M] -= bv * (g[q] - alpha * prow[q]);
    }
    __syncthreads();
  }

  // rows r < K of T, in Z's column order; zero below a block's last row
  double* tb = t + b * K * C;
  for (int r = warp; r < K; r += kWideWarps) {
    for (int c = lane; c < C; c += 32) {
      tb[static_cast<int64_t>(r) * C + c] = r < R ? a[static_cast<int64_t>(r) * C + c] : 0.0;
    }
  }
}

int launch_wide(const double* z, const uint8_t* w, int64_t B, int64_t R, int64_t C, int64_t K,
                int reflections, int form, double* work, double* t, cudaStream_t stream) {
  const bool here = form == 1;
  if (!here && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(WideSmem(R, C, here).bytes);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(householder_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  householder_wide<<<static_cast<unsigned>(B), kWideThreads, smem, stream>>>(
      z, w, static_cast<int>(R), static_cast<int>(C), static_cast<int>(K), reflections, here ? 1 : 0,
      work, t);
  return static_cast<int>(cudaGetLastError());
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
// (C <= 33, R <= 512), 1 the wide form with the panel in shared memory, 2
// the wide form with the panel in a device-memory workspace of B * R * C
// doubles, -1 none.
int pols_householder_form(int64_t R, int64_t C) { return form_of(R, C); }

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
  if (B < 0 || B > INT32_MAX || R > INT32_MAX || form < 0 || K < 1 || K >= C ||
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
