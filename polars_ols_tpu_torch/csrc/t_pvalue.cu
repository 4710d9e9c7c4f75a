// Two-sided Student-t p-values p = I_x(dof/2, 1/2), x = dof / (dof + t^2)
// (CUDA C++, sm_90a).
//
// Replaces the XLA code of polars_ols_tpu/ops/linalg.py:t_two_sided_p_value
// (jax.scipy.special.betainc, a 600-step continued fraction inside the
// statistics program; no Pallas kernel). torch has no incomplete beta, and
// the same continued fraction as eager tensor ops costs ~15 launches per
// iteration.
//
// One thread per element of t [G, K] (dof [G] broadcast along K), the
// arithmetic of the plain version ops/special.py:betainc_half_ref:
//   - a = dof/2 >= 15 and -log x <= 1: the large-a expansion of DiDonato and
//     Morris (TOMS 708 bgrat), terms c_n Gamma(1/2 + 2n, z) / T^2n with
//     T = a - 1/4, z = -T log x, from erfc(sqrt(z)) by recurrence;
//   - otherwise the continued fraction of DLMF 8.17.22 by the forward
//     recurrence of its convergents A_n / B_n (two multiply-adds a half
//     step, a convergence test by cross-multiplication, one division at the
//     end), with I_x(a, b) = 1 - I_{1-x}(b, a) past x = (a+1)/(a+b+2), at
//     most 200 iterations (~25 needed over this region).
// x is formed with separately rounded operations, as torch forms it: a
// fused dof + t*t would move x by an ulp, and p by ~a ulps.
//
// What bounds it: one thread's chain of dependent f64 instructions, not
// bytes (24 bytes an element) and not the f64 pipes: a division, log or exp
// is a chain of 25 to 40 of them, the statistics query's [10,000, 5] puts
// ~12 warps on an SM, and sharing what depends on the row alone between a
// row's threads (through shared memory, by extra row threads) changed
// nothing measurable on the H100, so every thread keeps computing its own.
// The design shortens the chain instead: log x is computed once and feeds
// both branches; the continued fraction's loop carries two multiply-adds a
// half step where the modified Lentz form carried two dependent divisions
// (its coefficients' divisions hang off the chain); the series multiplies
// by 1 / T^2 where it divided twice a term; log1p(-x) is only computed where
// the continued fraction needs it. Blocks of 128 threads: 391 blocks for
// 50,000 elements, three to each of the 132 SMs, all resident at once.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr double kEps = 2.220446049250313e-16;  // 2^-52
constexpr double kCfBig = 1.6069380442589903e60;    // 2^200
constexpr double kCfSmall = 6.223015277861142e-61;  // 2^-200
constexpr int kCfMaxIter = 200;
// what a launch computes: everything, or a part of it for the timing
// breakdown (the loads, x and the store; those and the front factor of the
// continued-fraction branch without the fraction)
constexpr int kStageAll = 0, kStageLoadStore = 1, kStageFront = 2;
constexpr double kASeries = 15.0;
constexpr double kUSeries = 1.0;
constexpr double kLogSqrtPi = 0.57236494292470008;  // log(pi) / 2
constexpr double kLogHalf = -0.6931471805599453;    // log(1 / 2)
constexpr double kInvSqrtPi = 0.56418958354775628;  // 1 / sqrt(pi)
constexpr int kSeriesTerms = 16;
// Taylor coefficients of (sinh(w/2) / (w/2))^(-1/2) in w^2 (the plain
// version's SERIES_COEFFS)
__constant__ double kSeries[kSeriesTerms] = {
    1.0,
    -0.020833333333333332,
    0.000390625,
    -7.879670965608466e-06,
    1.6967665791721782e-07,
    -3.805064191721906e-09,
    8.748377596315407e-11,
    -2.044523359411974e-12,
    4.833351797967704e-14,
    -1.152434101767386e-15,
    2.76605204359937e-17,
    -6.67428195089166e-19,
    1.61745507718158e-20,
    -3.93397792009138e-22,
    9.597634062586047e-24,
    -2.347690291162632e-25,
};

// sum_k B_2k / (2k (2k-1) z^(2k-1)), k = 1..7
__device__ double stirling_tail(double z) {
  const double z2 = 1.0 / (z * z);
  double s = z2 * (1.0 / 156.0);
  s = z2 * (-691.0 / 360360.0 + s);
  s = z2 * (1.0 / 1188.0 + s);
  s = z2 * (-1.0 / 1680.0 + s);
  s = z2 * (1.0 / 1260.0 + s);
  s = z2 * (-1.0 / 360.0 + s);
  return (1.0 / 12.0 + s) / z;
}

// lgamma(a + 1/2) - lgamma(a), a > 0
__device__ double log_gamma_ratio_half(double a) {
  if (a < 8.0) return lgamma(a + 0.5) - lgamma(a);
  return 0.5 * log(a) + a * log1p(0.5 / a) - 0.5 +
         (stirling_tail(a + 0.5) - stirling_tail(a));
}

// continued fraction of I_z(p, q): the convergents' forward recurrence
__device__ double continued_fraction(double p, double q, double z) {
  const double qab = p + q, qap = p + 1.0, qam = p - 1.0;
  double am = 1.0, bm = 1.0, az = 1.0;
  double bz = 1.0 - qab * z / qap;
  for (int m = 1; m <= kCfMaxIter; ++m) {
    const double m2 = 2.0 * m;
    double aa = (m * (q - m)) / ((qam + m2) * (p + m2)) * z;
    const double ap = az + aa * am;
    const double bp = bz + aa * bm;
    aa = -((p + m) * (qab + m)) / ((p + m2) * (qap + m2)) * z;
    const double app = ap + aa * az;
    const double bpp = bp + aa * bz;
    const double scale = fabs(bpp) > kCfBig ? kCfSmall : (fabs(bpp) < kCfSmall ? kCfBig : 1.0);
    am = ap * scale;
    bm = bp * scale;
    az = app * scale;
    bz = bpp * scale;
    if (fabs(app * bp - ap * bpp) <= kEps * fabs(ap * bpp)) break;
  }
  return az / bz;
}

// lx = log x
template <int kStage>
__device__ double betainc_half_cf(double a, double x, double lx) {
  const bool direct = x < (a + 1.0) / (a + 2.5);
  const double p = direct ? a : 0.5;
  const double log_front = a * lx + 0.5 * log1p(-x) + log_gamma_ratio_half(a) - kLogSqrtPi -
                           (direct ? log(a) : kLogHalf);
  const double h = kStage == kStageFront ? 1.0
                                          : continued_fraction(p, direct ? 0.5 : a, direct ? x : 1.0 - x);
  const double val = exp(log_front) * h;
  return direct ? val : 1.0 - val;
}

__device__ double betainc_half_series(double a, double u) {
  const double T = a - 0.25;
  const double z = T * u;
  const double inv_T2 = 1.0 / (T * T), z2 = z * z;
  double H = erfc(sqrt(z));
  double E = sqrt(z) * exp(-z) * kInvSqrtPi;
  double s = H;
  for (int n = 1; n < kSeriesTerms; ++n) {
    const double sn = 2.0 * n - 1.5;
    H = ((sn + 1.0) * sn * H + ((sn + 1.0) + z) * E) * inv_T2;
    E = E * z2 * inv_T2;
    const double term = kSeries[n] * H;
    s += term;
    if (fabs(term) <= kEps * fabs(s)) break;
  }
  return exp(log_gamma_ratio_half(a) - 0.5 * log(T)) * s;
}

// I_x(a, 1/2) with jnp's edge values decided first: true where (a, x) is
// an edge, with its value in *out
__device__ bool betainc_half_edge(double a, double x, double* out) {
  if (a < 0.0 || x < 0.0 || x > 1.0 || isnan(a) || isnan(x)) {
    *out = nan("");
  } else if ((a == 0.0 && x != 0.0) || (isinf(a) && x == 1.0)) {
    *out = 1.0;
  } else if (isinf(a) || a == 0.0 || x == 0.0) {
    *out = 0.0;
  } else if (x == 1.0) {
    *out = 1.0;
  } else {
    return false;
  }
  return true;
}

template <int kStage>
__global__ void __launch_bounds__(kThreads)
t_pvalue(const double* __restrict__ t, const double* __restrict__ dof,
         int64_t G, int64_t K, double* __restrict__ p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= G * K) return;
  const double d = dof[i / K];
  const double ti = t[i];
  const double x = __ddiv_rn(d, __dadd_rn(d, __dmul_rn(ti, ti)));
  const double a = d / 2.0;
  double value;
  if (kStage == kStageLoadStore) {
    value = x + a;
  } else if (kStage == kStageFront) {
    value = betainc_half_cf<kStage>(a, x, log(x));
  } else if (!betainc_half_edge(a, x, &value)) {
    const double lx = log(x);
    value = (a >= kASeries && -lx <= kUSeries) ? betainc_half_series(a, -lx)
                                               : betainc_half_cf<kStage>(a, x, lx);
  }
  p[i] = value;
}

// The hardware's f64 reciprocal and reciprocal-square-root estimates, on
// which the Jacobi SVD kernel's Newton divisions and roots start.
__device__ __forceinline__ double rcp_approx(double x) {
  double r;
  asm volatile("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  return r;
}

__device__ __forceinline__ double rsqrt_approx(double x) {
  double r;
  asm volatile("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  return r;
}

// One step of a chain of dependent f64 operations of one kind; every map
// keeps its value in a bounded positive range. All but the multiply-add
// carry one more dependent add or multiply.
template <int kOp>
__device__ double chain_step(double acc) {
  switch (kOp) {
    case 0: return fma(acc, 0.999999999, 1.0e-9);
    case 1: return 1.5 / (acc + 0.5);
    case 2: return sqrt(acc + 1.0);
    case 3: return log(acc + 2.0);
    case 4: return log1p(acc + 0.5);
    case 5: return exp(-0.5 * acc);
    case 6: return erfc(0.5 * acc);
    case 7: return rcp_approx(acc + 0.5);
    default: return rsqrt_approx(acc + 0.5);
  }
}

// n dependent operations of kind kOp in each thread of one warp: the
// yardstick of the latency bound (time per dependent operation = the
// difference of two chain lengths' times over the difference of the lengths)
template <int kOp>
__global__ void f64_chain(int64_t n, double* __restrict__ out) {
  double acc = out[0];
  for (int64_t i = 0; i < n; ++i) acc = chain_step<kOp>(acc);
  if (acc == -1.0) out[0] = acc;  // never true: keeps the chain alive
}

}  // namespace

extern "C" {

// p [G, K] = two-sided Student-t p-values of t [G, K] (contiguous f64) with
// dof [G] degrees of freedom per row. stage 0 computes them; stage 1 only
// loads, forms x and stores, stage 2 adds the continued-fraction branch's
// front factor (both for the timing breakdown: p is then no p-value).
// Launches on `stream` without synchronising; returns the CUDA error code
// of the launch (0 on success).
int pols_t_pvalue(const double* t, const double* dof, int64_t G, int64_t K,
                  double* p, int stage, void* stream) {
  if (G < 0 || K < 0 || stage < 0 || stage > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = G * K;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == kStageLoadStore) {
    t_pvalue<kStageLoadStore><<<grid, kThreads, 0, st>>>(t, dof, G, K, p);
  } else if (stage == kStageFront) {
    t_pvalue<kStageFront><<<grid, kThreads, 0, st>>>(t, dof, G, K, p);
  } else {
    t_pvalue<kStageAll><<<grid, kThreads, 0, st>>>(t, dof, G, K, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Runs n dependent f64 operations of kind op (0 multiply-add, 1 divide,
// 2 sqrt, 3 log, 4 log1p, 5 exp, 6 erfc, 7 rcp.approx, 8 rsqrt.approx) on
// one warp, seeded from out[0] (in [0, 1]); writes nothing. For timing only.
int pols_f64_chain(int op, int64_t n, double* out, void* stream) {
  if (n < 0 || op < 0 || op > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: f64_chain<0><<<1, 32, 0, st>>>(n, out); break;
    case 1: f64_chain<1><<<1, 32, 0, st>>>(n, out); break;
    case 2: f64_chain<2><<<1, 32, 0, st>>>(n, out); break;
    case 3: f64_chain<3><<<1, 32, 0, st>>>(n, out); break;
    case 4: f64_chain<4><<<1, 32, 0, st>>>(n, out); break;
    case 5: f64_chain<5><<<1, 32, 0, st>>>(n, out); break;
    case 6: f64_chain<6><<<1, 32, 0, st>>>(n, out); break;
    case 7: f64_chain<7><<<1, 32, 0, st>>>(n, out); break;
    default: f64_chain<8><<<1, 32, 0, st>>>(n, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned above.
const char* pols_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
