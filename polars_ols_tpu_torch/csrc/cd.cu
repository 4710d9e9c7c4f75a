// Cyclic coordinate descent for lasso / elastic net / NNLS on the per-group
// moments XtX [G, K, K], Xty [G, K], K <= 32 (CUDA C++, sm_90a).
//
// Replaces the XLA loop of polars_ols_tpu/ops/cd.py:_cd_cov_single (a
// lax.while_loop over sweeps around a lax.fori_loop over coordinates,
// vmapped over groups; no Pallas kernel). As eager torch ops each sweep
// costs ~K^2 launches and a host sync for the convergence check; here the
// whole solve of every group is one launch.
//
// Groups are packed into warps by K: a segment of KB lanes (KB the bucket
// 8, 16 or 32 that holds K, a template parameter) serves one group, so a
// warp solves 32 / KB groups at once. Lane j of a segment holds row j of
// its group's XtX in registers (row[KB], a compile-time size) and owns w_j;
// w lives in shared memory. Coordinate j is updated by lane j of every
// segment at once, with the reference's rule (src/least_squares.rs:423-434):
//   rho = Xty_j - (XtX w)_j + XtX_jj w_j,
//   w_j = S(rho, a_l1) / (XtX_jj + a_l2)   (denominator <= 0 -> 1),
// clamped at 0 when positive; with active_set a coordinate is frozen for
// good the first time its update lands below tol. After each sweep every
// lane of a segment forms ||w_new - w_old||^2 from the same shuffled
// squares (a segmented shuffle of width KB, in k-order), so each group's
// stop test (< tol, or max_iter sweeps) is uniform across its segment.
// Each group keeps its own sweep count; the warp sweeps while any of its
// groups runs, and a finished group's lanes are predicated off, so control
// flow stays uniform and no group's iterates change. (XtX w)_j and the
// squared norm are sequential sums in k-order of separately rounded
// products (__dmul_rn / __dadd_rn, never fused): the plain version
// ops/cd.py:solve_elastic_net_cov_ref makes the same sums, so both give the
// same bits and the same sweep counts.
//
// What bounds it: neither bytes (a group's moments are K^2 + K + 1 doubles,
// read once: ~3 MB and under 1 us at the main path's 10,000 groups of K = 5)
// nor flops, but the chain of K dependent K-term dot products and divisions
// per sweep, and so how many groups share each instruction and how many
// warps the SMs hold at once. At K = 5 four groups share a warp (2,500
// warps for 10,000 groups, one wave), and row[8] keeps the registers low;
// __launch_bounds__ caps them so that the wave fits.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;

// blocks an SM must hold: caps the registers at 64 a thread for KB = 8,
// 85 for 16 and 128 for 32
constexpr int min_blocks(int KB) { return KB == 8 ? 8 : (KB == 16 ? 6 : 4); }

// torch.maximum(v, 0): NaN stays NaN, -0 stays -0
__device__ __forceinline__ double max0(double v) {
  return (v != v) ? v : (v < 0.0 ? 0.0 : v);
}

// torch.sign: 0 for zero and NaN (the product with a NaN magnitude is NaN)
__device__ __forceinline__ double sgn(double v) {
  return v > 0.0 ? 1.0 : (v < 0.0 ? -1.0 : 0.0);
}

template <int KB>
__global__ void __launch_bounds__(kThreads, min_blocks(KB))
cd_cov(const double* __restrict__ xtx, const double* __restrict__ xty,
       const double* __restrict__ n_valid, int64_t G, int K, double alpha,
       double l1_ratio, double l2_ratio, int max_iter, double tol,
       int positive, int active_set, double* __restrict__ w_out,
       int* __restrict__ sweeps_out) {
  constexpr int kSegs = 32 / KB;
  __shared__ double w_s[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int seg = lane / KB;
  const int l = lane % KB;  // the lane's coordinate in its group
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kSegs + seg;
  const bool live = g < G;  // lanes past the last group stay for the shuffles
  double* w = w_s[warp] + seg * KB;
  const bool mine = live && l < K;

  double row[KB];
  const double* A = xtx + (live ? g : 0) * K * K + static_cast<int64_t>(mine ? l : 0) * K;
#pragma unroll
  for (int k = 0; k < KB; ++k) row[k] = (mine && k < K) ? A[k] : 0.0;
  const double diag = mine ? A[l] : 0.0;
  const double b = mine ? xty[g * K + l] : 0.0;

  const double nv = live ? n_valid[g] : 0.0;
  const double a = __dmul_rn(alpha, nv < 1.0 ? 1.0 : nv);
  const double a_l1 = __dmul_rn(a, l1_ratio);
  const double a_l2 = __dmul_rn(a, l2_ratio);
  double denom = __dadd_rn(diag, a_l2);
  denom = denom > 0.0 ? denom : 1.0;

  if (mine) w[l] = 0.0;
  bool act = true;
  __syncwarp();

  int it = 0;
  double delta = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  bool run = live && it < max_iter && delta >= tol;
  while (__any_sync(kFull, run)) {
    const double w_old = mine ? w[l] : 0.0;
    for (int j = 0; j < K; ++j) {
      if (run && l == j) {
        double acc = __dmul_rn(row[0], w[0]);
#pragma unroll
        for (int k = 1; k < KB; ++k) {
          if (k < K) acc = __dadd_rn(acc, __dmul_rn(row[k], w[k]));
        }
        const double wj = w[j];
        const double rho = __dadd_rn(__dsub_rn(b, acc), __dmul_rn(diag, wj));
        double st = __dmul_rn(sgn(rho), max0(__dsub_rn(fabs(rho), a_l1)));
        if (positive) st = max0(st);
        double wn = __ddiv_rn(st, denom);
        if (active_set) {
          if (!act) wn = wj;
          act = act && (fabs(wn) >= tol);
        }
        w[j] = wn;
      }
      __syncwarp();
    }
    const double dw = (run && mine) ? __dsub_rn(w[l], w_old) : 0.0;
    const double sq_mine = __dmul_rn(dw, dw);
    double sq = __shfl_sync(kFull, sq_mine, 0, KB);
    for (int k = 1; k < K; ++k) {
      sq = __dadd_rn(sq, __shfl_sync(kFull, sq_mine, k, KB));
    }
    if (run) {
      delta = __dsqrt_rn(sq);
      ++it;
      run = it < max_iter && delta >= tol;
    }
  }
  if (mine) w_out[g * K + l] = w[l];
  if (live && l == 0) sweeps_out[g] = it;
}

template <int KB>
int launch(const double* xtx, const double* xty, const double* n_valid,
           int64_t G, int K, double alpha, double l1_ratio, double l2_ratio,
           int max_iter, double tol, int positive, int active_set,
           double* w_out, int* sweeps_out, cudaStream_t stream) {
  constexpr int64_t per_block = kWarps * (32 / KB);
  const int64_t blocks = (G + per_block - 1) / per_block;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cd_cov<KB><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      xtx, xty, n_valid, G, K, alpha, l1_ratio, l2_ratio, max_iter, tol,
      positive, active_set, w_out, sweeps_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// w [G, K] and sweeps [G] (int32) of covariance-form cyclic coordinate
// descent on XtX [G, K, K], Xty [G, K], n_valid [G] (contiguous f64),
// 1 <= K <= 32. alpha is scaled by max(n_valid, 1) per group; l2_ratio is
// 1 - l1_ratio as the caller computed it. Launches on `stream` without
// synchronising; returns the CUDA error code of the launch (0 on success).
int pols_cd_cov(const double* xtx, const double* xty, const double* n_valid,
                int64_t G, int64_t K, double alpha, double l1_ratio,
                double l2_ratio, int max_iter, double tol, int positive,
                int active_set, double* w_out, int* sweeps_out,
                void* stream) {
  if (G < 0 || K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(K);
  auto run = K <= 8 ? launch<8> : (K <= 16 ? launch<16> : launch<32>);
  return run(xtx, xty, n_valid, G, k, alpha, l1_ratio, l2_ratio, max_iter, tol,
             positive, active_set, w_out, sweeps_out, st);
}

// Message for an error code returned above.
const char* pols_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
