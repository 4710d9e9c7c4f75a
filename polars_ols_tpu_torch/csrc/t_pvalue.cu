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
//   - otherwise the continued fraction of DLMF 8.17.22 (modified Lentz),
//     with I_x(a, b) = 1 - I_{1-x}(b, a) past x = (a+1)/(a+b+2), at most
//     200 iterations (~25 needed over this region).
// x is formed with separately rounded operations, as torch forms it: a
// fused dof + t*t would move x by an ulp, and p by ~a ulps.
//
// What bounds it: neither bytes (24 bytes an element) nor flops at the
// statistics query's [10,000, 5]; it is a few dozen dependent f64
// operations per thread, so the launch is latency bound and one thread per
// element keeps all lanes busy. No shared memory, no atomics.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr double kEps = 2.220446049250313e-16;  // 2^-52
constexpr double kTiny = 1.0e-300;
constexpr int kCfMaxIter = 200;
constexpr double kASeries = 15.0;
constexpr double kUSeries = 1.0;
constexpr double kLogSqrtPi = 0.57236494292470008;  // log(pi) / 2
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

__device__ double floor_tiny(double v) { return fabs(v) < kTiny ? kTiny : v; }

// continued fraction of I_z(p, q), Numerical Recipes' betacf
__device__ double lentz(double p, double q, double z) {
  const double qab = p + q, qap = p + 1.0, qam = p - 1.0;
  double c = 1.0;
  double d = 1.0 / floor_tiny(1.0 - qab * z / qap);
  double h = d;
  for (int m = 1; m <= kCfMaxIter; ++m) {
    const double m2 = 2.0 * m;
    double aa = m * (q - m) * z / ((qam + m2) * (p + m2));
    d = 1.0 / floor_tiny(1.0 + aa * d);
    c = floor_tiny(1.0 + aa / c);
    h *= d * c;
    aa = -(p + m) * (qab + m) * z / ((p + m2) * (qap + m2));
    d = 1.0 / floor_tiny(1.0 + aa * d);
    c = floor_tiny(1.0 + aa / c);
    const double de = d * c;
    h *= de;
    if (fabs(de - 1.0) <= kEps) break;
  }
  return h;
}

__device__ double betainc_half_cf(double a, double x) {
  const bool direct = x < (a + 1.0) / (a + 2.5);
  const double p = direct ? a : 0.5;
  const double h = lentz(p, direct ? 0.5 : a, direct ? x : 1.0 - x);
  const double log_front = a * log(x) + 0.5 * log1p(-x) +
                           log_gamma_ratio_half(a) - kLogSqrtPi - log(p);
  const double val = exp(log_front) * h;
  return direct ? val : 1.0 - val;
}

__device__ double betainc_half_series(double a, double u) {
  const double T = a - 0.25;
  const double z = T * u;
  const double T2 = T * T, z2 = z * z;
  double H = erfc(sqrt(z));
  double E = sqrt(z) * exp(-z) * kInvSqrtPi;
  double s = H;
  for (int n = 1; n < kSeriesTerms; ++n) {
    const double sn = 2.0 * n - 1.5;
    H = ((sn + 1.0) * sn * H + ((sn + 1.0) + z) * E) / T2;
    E = E * z2 / T2;
    const double term = kSeries[n] * H;
    s += term;
    if (fabs(term) <= kEps * fabs(s)) break;
  }
  return exp(log_gamma_ratio_half(a) - 0.5 * log(T)) * s;
}

// I_x(a, 1/2) with jnp's edge values
__device__ double betainc_half(double a, double x) {
  if (a < 0.0 || x < 0.0 || x > 1.0 || isnan(a) || isnan(x)) return nan("");
  if ((a == 0.0 && x != 0.0) || (isinf(a) && x == 1.0)) return 1.0;
  if (isinf(a) || a == 0.0) return 0.0;
  if (x == 0.0) return 0.0;
  if (x == 1.0) return 1.0;
  const double u = -log(x);
  if (a >= kASeries && u <= kUSeries) return betainc_half_series(a, u);
  return betainc_half_cf(a, x);
}

__global__ void __launch_bounds__(kThreads)
t_pvalue(const double* __restrict__ t, const double* __restrict__ dof,
         int64_t G, int64_t K, double* __restrict__ p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= G * K) return;
  const double d = dof[i / K];
  const double ti = t[i];
  const double x = __ddiv_rn(d, __dadd_rn(d, __dmul_rn(ti, ti)));
  p[i] = betainc_half(d / 2.0, x);
}

}  // namespace

extern "C" {

// p [G, K] = two-sided Student-t p-values of t [G, K] (contiguous f64) with
// dof [G] degrees of freedom per row. Launches on `stream` without
// synchronising; returns the CUDA error code of the launch (0 on success).
int pols_t_pvalue(const double* t, const double* dof, int64_t G, int64_t K,
                  double* p, void* stream) {
  if (G < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = G * K;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  t_pvalue<<<static_cast<unsigned>(blocks), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(t, dof, G, K, p);
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned above.
const char* pols_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
