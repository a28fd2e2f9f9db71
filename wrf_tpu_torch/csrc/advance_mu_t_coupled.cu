// K3 — the C entry of the depth-S coupled trapezoid and its float-stream
// instances without the in-kernel exchange.  The kernel, its forms and its
// dispatch are in csrc/advance_mu_t_coupled_kernel.cuh; the other instances
// are in advance_mu_t_coupled_overlap.cu, advance_mu_t_coupled_bf16.cu and
// advance_mu_t_coupled_bf16_overlap.cu.

#include "advance_mu_t_coupled_kernel.cuh"

namespace k3 {

cudaError_t launch_f32(const Args& a, int n_inner, bool fuse_w,
                       cudaStream_t s) {
  return dispatch_group<false, float>(a, n_inner, fuse_w, s);
}

}  // namespace k3

// Plain C entry for ctypes.  Launches on ``stream`` and returns
// cudaGetLastError() of the launch (0 on success); it neither allocates nor
// synchronises.  n_inner is the depth S, 2..8.  The w/pp pointers may be NULL
// unless fuse_w.  ``form``, the tile (tj, ti) and ``smem`` (the dynamic
// shared memory it computed) are the wrapper's plan: kStreaming, or kStaged
// with ti a multiple of 8; a plan whose smem is not the kernel's own
// form_smem is refused, so the two layouts cannot drift apart.  ``const_bf16``: t_1, tconst
// and dvdxi_const point at bf16 elements.  A non-null mu_lo turns on the
// in-kernel exchange (the other five neighbour pointers then too).
extern "C" int wrf_tpu_torch_coupled_multistep(
    const float* u, const float* v, float* t, const void* t_1,
    const void* tconst, const void* dvdxi_const, const float* ww1_k0,
    float* ww_row, const float* mu, const float* mu_tend, const float* msftx,
    const float* msfty, const float* cu, const float* cv, const float* msft2,
    const float* dnw, const float* fnm, const float* fnp, const float* rdnw,
    float* w, float* pp, const float* aw, const float* cpv,
    const float* denv, const float* crdn, const float* erdn,
    float* u_out, float* v_out, float* mu_out,
    const float* mu_lo, const float* mu_hi, const float* u_lo,
    const float* u_hi, const float* v_lo, const float* v_hi,
    float rdx, float rdy, float dts, float cs2,
    float c_w, float g_t, float beta, float alfa,
    int J, int K, int I, int i0, int i1, int j0, int j1, int j_off,
    int i_off, int k0, int k1, int n_inner, int fuse_w, int const_bf16,
    int tj, int ti, int form, int smem, void* stream) {
  using namespace k3;
  if (n_inner < 2 || n_inner > kMaxInner || J - 2 * n_inner < 1 || K < 1 ||
      I < 1 || k0 < 0 || k1 >= K || k0 > k1 || tj < 1 || ti < 1 ||
      (form != kStreaming && form != kStaged) ||
      (form == kStaged && ti % 8 != 0) ||
      (size_t)smem != form_smem(form, n_inner, K, tj, ti,
                                const_bf16 ? 2 : 4))
    return cudaErrorInvalidValue;
  const bool overlap = mu_lo != nullptr;
  if (overlap && (!mu_hi || !u_lo || !u_hi || !v_lo || !v_hi))
    return cudaErrorInvalidValue;
  const Args a{u, v, t, t_1, tconst, dvdxi_const, ww1_k0, ww_row, mu,
               mu_tend, msftx, msfty, cu, cv, msft2, dnw, fnm, fnp, rdnw,
               w, pp, aw, cpv, denv, crdn, erdn,
               u_out, v_out, mu_out,
               mu_lo, mu_hi, u_lo, u_hi, v_lo, v_hi,
               rdx, rdy, dts, cs2,
               c_w, g_t, beta, alfa,
               J, K, I, i0, i1, j0, j1, j_off, i_off, k0, k1, tj, ti, form};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto group = const_bf16 ? (overlap ? launch_bf16_overlap : launch_bf16)
                                : (overlap ? launch_f32_overlap : launch_f32);
  return static_cast<int>(group(a, n_inner, fuse_w != 0, s));
}
