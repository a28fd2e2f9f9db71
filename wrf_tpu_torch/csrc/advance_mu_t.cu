// K1 — the C entry of the fused acoustic substep and its float-stream
// instances without the in-kernel exchange.  The kernel, its forms and its
// dispatch are in csrc/advance_mu_t_kernel.cuh; the other instances are in
// advance_mu_t_overlap.cu, advance_mu_t_bf16.cu and
// advance_mu_t_bf16_overlap.cu.

#include "advance_mu_t_kernel.cuh"

namespace k1 {

cudaError_t launch_f32(const Args& a, int fuse_uv, int lean, int ww_mode,
                       int with_tave, int fuse_w, int rows,
                       cudaStream_t s) {
  return dispatch_group<false, float, true>(a, fuse_uv, lean, ww_mode,
                                            with_tave, fuse_w, rows, s);
}

}  // namespace k1

// Plain C entry for ctypes.  Pointers the mode does not use may be NULL;
// the outputs the mode writes may not (t_out always, ww_out under full /
// final, ww_row_out under lite, t_ave_out with t_ave, w_out and pp_out
// with fuse_w).  The kernel writes no input.
// ``const_bf16``: the constant streams (ww_1, u_1, v_1, t_1, ft, tconst,
// dvdxi_const, and u and v without fuse_uv) point at bf16 elements.  A
// non-null mu_lo turns on the in-kernel exchange (mu_hi and v_hi then too,
// and mudf_lo / mudf_hi with mudf_in).  Launches on ``stream`` and returns
// cudaGetLastError() of the launch (0 on success); it neither allocates nor
// synchronises.  ``rows``: the rows of a block along j (1 to kMaxRows; the
// block is kLanes columns wide along i).
extern "C" int wrf_tpu_torch_advance_mu_t(
    const float* ww, const void* ww_1, const void* u, const void* u_1,
    const void* v, const void* v_1, const float* t, const void* t_1,
    const float* t_ave, const void* ft, const void* tconst,
    const void* dvdxi_const,
    const float* mu, const float* mudf_in, const float* mut,
    const float* muu, const float* muv,
    const float* mu_tend, const float* msfuy, const float* msfvx_inv,
    const float* msftx, const float* msfty, const float* ww_row,
    const float* ww1_k0,
    const float* dnw, const float* fnm, const float* fnp, const float* rdnw,
    const float* w, const float* pp, const float* aw, const float* cpv,
    const float* denv, const float* crdn, const float* erdn,
    float* mu_out, float* muave, float* muts, float* mudf, float* u_out,
    float* v_out, float* t_out, float* ww_out, float* t_ave_out,
    float* ww_row_out, float* w_out, float* pp_out,
    float* cap_muave, float* cap_mu, float* cap_mudf, float* cap_muts,
    float* cap_ww,
    const float* mu_lo, const float* mu_hi, const float* v_hi,
    const float* mudf_lo, const float* mudf_hi,
    float rdx, float rdy, float dts, float epssm, float cs2, float dampc,
    float wind_scale, float c_w, float g_t, float beta, float alfa,
    int J, int K, int I, int i0, int i1, int j0, int j1, int j_off,
    int i_off, int k0, int k1,
    int fuse_uv, int lean, int ww_mode, int with_tave, int fuse_w,
    int const_bf16, int rows, void* stream) {
  using namespace k1;
  if (J < 3 || K < 1 || I < 1 || k0 < 0 || k1 >= K || k0 > k1 ||
      rows < 1 || rows > kMaxRows)
    return cudaErrorInvalidValue;
  // damping belongs to the fused wind update; the captures come all five
  // together and only on the full-ww path; mudf_in is read at neighbour
  // columns while mudf is written
  if ((mudf_in && !fuse_uv) || (mudf_in && mudf_in == mudf))
    return cudaErrorInvalidValue;
  if (!t_out || (ww_mode == kLite ? !ww_row_out : !ww_out) ||
      (with_tave && !t_ave_out) || (fuse_w && (!w_out || !pp_out)))
    return cudaErrorInvalidValue;
  const int n_cap = (cap_muave != nullptr) + (cap_mu != nullptr) +
                    (cap_mudf != nullptr) + (cap_muts != nullptr) +
                    (cap_ww != nullptr);
  if ((n_cap != 0 && n_cap != 5) || (n_cap && (ww_mode != kFull || lean)))
    return cudaErrorInvalidValue;
  // the in-kernel exchange belongs to the fused wind update too and takes
  // its three rows together (five under damping)
  const bool overlap = mu_lo != nullptr;
  if (overlap && (!fuse_uv || !mu_hi || !v_hi ||
                  (mudf_in && (!mudf_lo || !mudf_hi))))
    return cudaErrorInvalidValue;
  const Args a{ww, ww_1, u, u_1, v, v_1, t, t_1, t_ave, ft, tconst,
               dvdxi_const, mu, mudf_in, mut, muu, muv, mu_tend, msfuy,
               msfvx_inv,
               msftx, msfty, ww_row, ww1_k0, dnw, fnm, fnp, rdnw,
               w, pp, aw, cpv, denv, crdn, erdn,
               mu_out, muave, muts, mudf, u_out, v_out,
               t_out, ww_out, t_ave_out, ww_row_out, w_out, pp_out,
               cap_muave, cap_mu, cap_mudf, cap_muts, cap_ww,
               mu_lo, mu_hi, v_hi, mudf_lo, mudf_hi,
               rdx, rdy, dts, epssm, cs2, dampc, wind_scale, c_w, g_t, beta,
               alfa,
               J, K, I, i0, i1, j0, j1, j_off, i_off, k0, k1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto group = const_bf16 ? (overlap ? launch_bf16_overlap : launch_bf16)
                                : (overlap ? launch_f32_overlap : launch_f32);
  return static_cast<int>(
      group(a, fuse_uv, lean, ww_mode, with_tave, fuse_w, rows, s));
}
