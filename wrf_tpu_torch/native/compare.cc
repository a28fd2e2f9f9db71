// Native comparator suite: the reference's differential-verification metrics
// (equal/different counts, max relative error, max absolute error, max ULP
// distance, RMSE, NaN tripwires; reference: advance_mu_t_driver.c:543-653,
// common.cu:51-164).

#include "wrf_tpu_native.h"

#include <cmath>
#include <cstring>

extern "C" int64_t wrf_float_ulps(float a, float b) {
  int32_t ai, bi;
  std::memcpy(&ai, &a, 4);
  std::memcpy(&bi, &b, 4);
  // Map onto a lexicographically ordered two's-complement scale so adjacent
  // representable floats differ by 1 (reference: common.cu:51-66).
  int64_t al = ai, bl = bi;
  if (al < 0) al = INT64_C(-0x80000000) - al;
  if (bl < 0) bl = INT64_C(-0x80000000) - bl;
  const int64_t d = al - bl;
  return d < 0 ? -d : d;
}

extern "C" void wrf_compare(const float* actual, const float* golden,
                            int64_t n, wrf_compare_result* out) {
  out->n = n;
  out->equal = 0;
  out->different = 0;
  out->max_rel_err = 0.0f;
  out->max_abs_err = 0.0f;
  out->max_ulp = 0;
  out->rmse = 0.0;
  out->nan_seen = 0;

  double sq_sum = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const float a = actual[i];
    const float g = golden[i];
    if (std::isnan(a) || std::isnan(g)) {
      ++out->nan_seen;
      continue;
    }
    const float abs_err = std::fabs(g - a);
    const float ga = std::fabs(g), aa = std::fabs(a);
    // Zero-handling per the reference: if either side is exactly zero, the
    // "relative" error is the other side's magnitude.
    const float rel_err =
        (ga != 0.0f && aa != 0.0f) ? abs_err / (ga > aa ? ga : aa)
                                   : (ga > aa ? ga : aa);
    if (rel_err > out->max_rel_err) out->max_rel_err = rel_err;
    if (abs_err > out->max_abs_err) out->max_abs_err = abs_err;
    const int64_t ulp = wrf_float_ulps(a, g);
    if (ulp > out->max_ulp) out->max_ulp = ulp;
    sq_sum += static_cast<double>(abs_err) * abs_err;
    if (a == g) {
      ++out->equal;
    } else {
      ++out->different;
    }
  }
  const int64_t counted = out->equal + out->different;
  out->rmse = counted > 0 ? std::sqrt(sq_sum / counted) : 0.0;
}
