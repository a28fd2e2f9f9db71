// K1 instances: bf16 constant streams with the in-kernel j exchange
// (OVERLAP).
// The kernel and its dispatch are in csrc/advance_mu_t_kernel.cuh; the C
// entry is in csrc/advance_mu_t.cu.  A source of its own so that the
// instances build in parallel.

#include "advance_mu_t_kernel.cuh"

namespace k1 {

cudaError_t launch_bf16_overlap(
    const Args& a, int fuse_uv, int lean, int ww_mode, int with_tave,
    int fuse_w, int rows, cudaStream_t s) {
  return dispatch_group<true, __nv_bfloat16, false>(
      a, fuse_uv, lean, ww_mode, with_tave, fuse_w, rows, s);
}

}  // namespace k1
