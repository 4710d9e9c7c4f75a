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
// multi-target width (S = 20,000 blocks of R = 512, C = 7) 0.57 GB against
// ~1 GFLOP, 0.17 ms at 3.35 TB/s against 0.03 ms at 34 TFLOP/s.
//
// The design (a first one: right and simple):
// - One thread block a row block. The masked panel lives in shared memory
//   (R x ld doubles, ld = C rounded up to an odd count, so that the rows of
//   one column fall on distinct banks); up to 135 KB at R = 512, C = 33,
//   which needs the dynamic shared-memory opt-in above 48 KB. A thread
//   has kLoads values and their mask bytes in flight before the first
//   lands (one load at a time cost ~5 % more at the main path's blocks).
// - Reflection j: every warp forms the pivot column's squared norm from
//   shared memory by itself (so no barrier is spent on it) and derives
//   alpha, v_j and beta; then one warp a column forms v^T a_k for the
//   targets and the features from the pivot on (lanes stride the rows,
//   a shuffle tree sums them); after a barrier each thread updates whole
//   rows, a_rk -= beta v_r (v^T a_k). Two barriers a reflection.
// - Feature columns left of the pivot are not touched again (the plain
//   version subtracts round-off from them); the pivot column itself is
//   updated like the others, so R's diagonal is alpha and its entries
//   below the diagonal are the same round-off as the plain version's.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kLoads = 8;
constexpr int kMaxCols = 33;
constexpr unsigned kFull = 0xffffffffu;
// the most dynamic shared memory a block can opt in to on sm_90
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
householder_blocks(const double* __restrict__ z, const uint8_t* __restrict__ w,
                   int R, int C, int K, int ld, double* __restrict__ t) {
  extern __shared__ double smem[];
  double* a = smem;                                   // [R][ld] the panel
  double* dots = smem + static_cast<size_t>(R) * ld;  // [C] v^T a_k
  const int64_t b = blockIdx.x;
  const double* zb = z + b * R * C;
  const uint8_t* wb = w + b * R;
  const int n = R * C;
  for (int e0 = threadIdx.x; e0 < n; e0 += kLoads * blockDim.x) {
    double v[kLoads];
    uint8_t keep[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < n ? zb[e] : 0.0;
      keep[u] = e < n ? wb[e / C] : 0;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n) {
        const int r = e / C;
        a[r * ld + (e - r * C)] = keep[u] ? v[u] : 0.0;
      }
    }
  }
  __syncthreads();

  const int M = C - K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int steps = K < R ? K : R;  // reflections past the last row are the identity
  for (int j = 0; j < steps; ++j) {
    const int cj = M + j;  // the pivot column
    double s = 0.0;
#pragma unroll 4
    for (int r = j + lane; r < R; r += 32) {
      const double x = a[r * ld + cj];
      s += x * x;
    }
    const double sigma = warp_sum(s);
    const double piv = a[j * ld + cj];
    const double alpha = -(piv >= 0.0 ? 1.0 : -1.0) * sqrt(sigma);
    const double vj = piv - alpha;
    const double denom = sigma - piv * alpha;  // = ||v||^2 / 2
    const double beta = denom > 0.0 ? 1.0 / denom : 0.0;

    // v^T a_k: the M targets, then the features from the pivot on
    const int ncols = M + K - j;
    for (int q = warp; q < ncols; q += warps) {
      const int k = q < M ? q : cj + (q - M);
      double d = 0.0;
#pragma unroll 4
      for (int r = j + lane; r < R; r += 32) {
        const double v = r == j ? vj : a[r * ld + cj];
        d += v * a[r * ld + k];
      }
      d = warp_sum(d);
      if (lane == 0) dots[k] = d;
    }
    __syncthreads();
    for (int r = j + threadIdx.x; r < R; r += blockDim.x) {
      double* row = a + r * ld;
      const double bv = beta * (r == j ? vj : row[cj]);
      for (int k = 0; k < M; ++k) row[k] -= bv * dots[k];
      for (int k = cj; k < C; ++k) row[k] -= bv * dots[k];
    }
    __syncthreads();
  }

  double* tb = t + b * K * C;
  for (int e = threadIdx.x; e < K * C; e += blockDim.x) {
    const int r = e / C;
    tb[e] = r < R ? a[r * ld + (e - r * C)] : 0.0;
  }
}

}  // namespace

extern "C" {

// The first K rows T [B, K, C] of each block of Z [B, R, C] (contiguous f64,
// targets first) under the row mask w [B, R] (bool bytes), after K
// Householder reflections of the feature columns. Launches on `stream`
// without synchronising; returns the CUDA error code of the launch (0 on
// success).
int pols_householder_blocks(const double* z, const uint8_t* w, int64_t B, int64_t R,
                            int64_t C, int64_t K, double* t, void* stream) {
  if (B < 0 || B > INT32_MAX || R < 1 || C < 2 || C > kMaxCols || K < 1 || K >= C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const int ld = static_cast<int>(C) | 1;
  const size_t smem = (static_cast<size_t>(R) * ld + C) * sizeof(double);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        householder_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = R >= 256 ? 256 : (R >= 128 ? 128 : 64);
  householder_blocks<<<static_cast<unsigned>(B), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      z, w, static_cast<int>(R), static_cast<int>(C), static_cast<int>(K), ld, t);
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned above.
const char* pols_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
