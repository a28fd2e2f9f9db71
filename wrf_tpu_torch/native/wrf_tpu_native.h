// wrf_tpu native runtime: scalar golden kernel, binary codec, comparators.
//
// This is the framework's native tier — the equivalent of the reference's
// C99 implementation role (reference: advance_mu_t.c, advance_mu_t.h): a
// compiled, FP-order-exact scalar oracle used to mint golden fixtures and to
// differentially verify the TPU device paths.  Built with -ffp-contract=off
// so no FMA contraction changes results across tiers (the reference's
// -fmad=false policy, Makefile:12).
//
// Design differences from the reference API (deliberate, framework-native):
//   * the kernel takes an already-resolved 0-based compute window instead of
//     the 18-bound index-triple convention — the Python layer owns index
//     normalization and boundary-condition shrinking (wrf_tpu/grid.py);
//   * all buffers are caller-owned; the kernel is pure apart from the
//     designated output arrays (inputs are never written).
//
// Array layout: 3-D fields are (j, k, i) C-order, i contiguous; 2-D are
// (j, i); 1-D vertical vectors are (k,).  All float32.

#pragma once
#include <cstdint>

extern "C" {

// Compute window, 0-based inclusive offsets into the allocated arrays.
typedef struct {
  int32_t jdim, kdim, idim;          // allocated extents
  int32_t i0, i1, j0, j1, k0, k1;    // BC-aware loop window (inclusive)
  int32_t kde;                       // 0-based domain-top k index (wdtn=0 there)
} wrf_window;

// One acoustic small step of the mu/theta update (advance_mu_t).
// Outputs: ww (in/out), mu (in/out), t (in/out), t_ave (in/out),
//          muave/muts/mudf (out; window cells written, rest untouched).
// Scratch is allocated internally.  Returns 0 on success.
int32_t wrf_advance_mu_t(
    const wrf_window* w,
    float* ww, const float* ww_1,
    const float* u, const float* u_1,
    const float* v, const float* v_1,
    float* mu, const float* mut, float* muave, float* muts,
    const float* muu, const float* muv,
    float* mudf, float* t, const float* t_1,
    float* t_ave, const float* ft, const float* mu_tend,
    float rdx, float rdy, float dts, float epssm,
    const float* dnw, const float* fnm, const float* fnp, const float* rdnw,
    const float* msfuy, const float* msfvx_inv,
    const float* msftx, const float* msfty);

// advance_mu_t with phase-boundary debug capture: when all five cap_*
// buffers are non-null, the phase-A outputs (muave/mu/mudf/muts 2-D,
// ww 3-D) are snapshotted into them BETWEEN phase A and phase B — the
// framework analog of the reference's "*_before_theta.bin" mid-kernel
// dumps (module_small_step_em.f90:175-189).
int32_t wrf_advance_mu_t_capture(
    const wrf_window* w,
    float* ww, const float* ww_1,
    const float* u, const float* u_1,
    const float* v, const float* v_1,
    float* mu, const float* mut, float* muave, float* muts,
    const float* muu, const float* muv,
    float* mudf, float* t, const float* t_1,
    float* t_ave, const float* ft, const float* mu_tend,
    float rdx, float rdy, float dts, float epssm,
    const float* dnw, const float* fnm, const float* fnp, const float* rdnw,
    const float* msfuy, const float* msfvx_inv,
    const float* msftx, const float* msfty,
    float* cap_muave, float* cap_mu, float* cap_mudf, float* cap_muts,
    float* cap_ww);

// Linearized-acoustic wind substep (advance_uv): u/v updated in place from
// the horizontal gradient of cs2*mu over the edge-point windows interior to
// the mass window (see wrf_tpu_torch/ops/advance_uv.py for the scheme).
// mudf may be null (no damping); smdiv scales the divergence-damping
// term cs2*smdiv*mudf added to the pressure (see ops/advance_uv.py).
int32_t wrf_advance_uv(
    const wrf_window* w,
    float* u, float* v, const float* mu,
    const float* muu, const float* muv,
    const float* msfuy, const float* msfvx_inv,
    float rdx, float rdy, float dts, float cs2,
    const float* mudf, float smdiv);

// Vertically-implicit acoustic w/pressure substep (advance_w): per-column
// tridiagonal Thomas solve of the epssm-off-centered linearized vertical
// acoustic system; w and pp updated in place on the mass window, theta
// coupling gw*t on the RHS (see wrf_tpu_torch/ops/advance_w.py for the scheme).
int32_t wrf_advance_w(
    const wrf_window* w,
    float* w_field, float* pp, const float* t,
    const float* rdn, const float* rdnw,
    float dts, float epssm, float cw, float gw);

// --- comparator suite (reference metrics: equal/diff counts, max rel/abs
//     error, max ULP distance, RMSE; advance_mu_t_driver.c:543-653) -------
typedef struct {
  int64_t n, equal, different;
  float max_rel_err, max_abs_err;
  int64_t max_ulp;
  double rmse;
  int64_t nan_seen;  // NaN tripwire: counts NaNs on either side
} wrf_compare_result;

void wrf_compare(const float* actual, const float* golden, int64_t n,
                 wrf_compare_result* out);

// 4-D layout reorder between the reference's two memory orders
// (swap_data_4d, common.cu:330-342): in is (j, m, k, i) C-order ("ikmj"),
// out is (m, j, k, i) ("ikjm"); i contiguous in both.
void wrf_swap_4d(const float* in, float* out, int64_t idim, int64_t kdim,
                 int64_t jdim, int64_t mdim);

// Lexicographic two's-complement ULP distance (reference: common.cu:51-66).
int64_t wrf_float_ulps(float a, float b);

}  // extern "C"
