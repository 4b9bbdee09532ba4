// Radial profiles of the stationary covariance families, shared by the K build
// and K backward kernels (stationary_k.cu). They replace the JAX package's
// pallas_kernels._k_of_r and _k_dr_over_r. Family ids follow
// pallas_kernels._FAMILIES:
//   0 rbf, 1 exponential, 2 ou, 3 matern32, 4 matern52, 5 cosine, 6 ratquad.
//
// The family is a template argument, so a kernel holds one profile and no
// switch. One evaluation gives both K / variance and (dK/dr) / r from ONE
// exponential; a kernel that uses only one of the two lets the compiler drop
// the other.
//
// The kernels are bound by the instruction rate, not by memory, so the profile
// uses the card's one-instruction special functions in place of the IEEE
// forms, whose slow paths cost about ten instructions each. What each costs
// in accuracy (NVIDIA's CUDA C++ documentation, intrinsic functions; u = 2^-24):
//   * sqrt.approx.ftz   r from r^2: relative error <= 2^-23 (2 u); sqrt(0) = 0
//                       exactly, so the diagonal of K(X, X) stays exact.
//   * ex2.approx.ftz    exp(a r) as 2^((a log2 e) r): 2 ulp of the result,
//                       plus the rounding of the pre-scaled argument, which
//                       is |arg| 2^-23 relative in the result: 2.5e-6 at
//                       K / variance = 1e-9, less above.
//   * lg2.approx.ftz    ratquad's log1p(r^2 / 2) as ln 2 * lg2(1 + r^2 / 2):
//                       absolute error <= 2^-22 near 1, so K is off by
//                       power * 1.7e-7 relative and the power gradient's
//                       terms by 1.7e-7 |G K|.
//   * rcp.approx.ftz    1 / r (exponential, cosine) and 1 / (1 + r^2 / 2)
//                       (ratquad) in the backward only: 1 ulp.
//   * .ftz              results under 1.2e-38 become 0.
// Each error is inside the kernels' checks against their plain versions (rtol
// 2e-5 forward, 1e-4 backward), but they are not unbiased: against a float64 K
// on an H100 the mean error of K's entries is +6.7e-9 of the variance where the
// plain version's is -2.9e-9 (5 x 4096 x 4096 ARD Matern52), and B2's
// parameter gradients +2e-7 where the plain ones are -8e-8; at a fitted point
// with cond(Ky) ~ 1e8 the float32 LML feels that bias (ROADMAP C9). The
// exponential's comes from pre-scaling its argument by log2 e: ex2.approx of
// t = x log2(e)_hi, corrected by the FMA residual of that product, removes it
// (gaussian_process_optimization_tpu_torch/prof_b1_bias.py measures each form).
// The cosine family keeps cosf / sinf: the one-instruction forms lose
// absolute accuracy as r grows past pi, and r is not bounded. They are called,
// not inlined: their range reduction is long, a kernel holds 16 entries'
// worth of code, and no path of the package runs this family hot.
#pragma once

#include <cuda_runtime.h>

namespace gpo {

constexpr int kRbf = 0, kExponential = 1, kOu = 2, kMatern32 = 3, kMatern52 = 4,
              kCosine = 5, kRatquad = 6;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

static __device__ __noinline__ float cos_exact(float x) { return cosf(x); }
static __device__ __noinline__ float sin_exact(float x) { return sinf(x); }

// From r2 = r^2 >= 0:
//   k    = K_of_r / variance;
//   dk   = (dK_of_r/dr) / r, variance included, with the r -> 0 limit where it
//          exists; for exponential / ou the guarded value at r = 0 is never
//          used: every use multiplies it by a difference that is 0 there;
//   log1 = log1p(r2 / 2), ratquad only (0 otherwise).
template <int FAMILY>
__device__ __forceinline__ void profile(float r2, float variance, float power, float& k,
                                        float& dk, float& log1) {
  log1 = 0.0f;
  if (FAMILY == kRbf) {
    k = ex2_approx((-0.5f * kLog2e) * r2);
    dk = -variance * k;
  } else if (FAMILY == kExponential || FAMILY == kOu) {
    const float r = sqrt_approx(r2);
    k = ex2_approx(-kLog2e * r);
    dk = -variance * k * rcp_approx(fmaxf(r, 1e-30f));
  } else if (FAMILY == kMatern32) {
    const float r = sqrt_approx(r2);
    const float e = ex2_approx((-kSqrt3 * kLog2e) * r);
    k = fmaf(kSqrt3, r, 1.0f) * e;
    dk = -3.0f * variance * e;
  } else if (FAMILY == kMatern52) {
    const float r = sqrt_approx(r2);
    const float e = ex2_approx((-kSqrt5 * kLog2e) * r);
    const float lin = fmaf(kSqrt5, r, 1.0f);
    k = fmaf(5.0f / 3.0f, r2, lin) * e;
    dk = (-5.0f / 3.0f) * variance * lin * e;
  } else if (FAMILY == kCosine) {
    const float r = sqrt_approx(r2);
    k = cos_exact(r);
    dk = r < 1e-12f ? -variance : -variance * sin_exact(r) * rcp_approx(fmaxf(r, 1e-30f));
  } else {  // ratquad
    const float base = fmaf(0.5f, r2, 1.0f);
    const float l2 = lg2_approx(base);
    k = ex2_approx(-power * l2);
    dk = -variance * power * k * rcp_approx(base);
    log1 = kLn2 * l2;
  }
}

}  // namespace gpo
