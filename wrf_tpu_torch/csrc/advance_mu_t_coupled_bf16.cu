// K3 instances: bf16 constant streams, no in-kernel exchange.
// The kernel and its dispatch are in csrc/advance_mu_t_coupled_kernel.cuh;
// the C entry is in csrc/advance_mu_t_coupled.cu.  A source of its own so
// that the instances build in parallel.

#include "advance_mu_t_coupled_kernel.cuh"

namespace k3 {

cudaError_t launch_bf16(const Args& a, int n_inner, bool fuse_w,
                 cudaStream_t s) {
  return dispatch_group<false, __nv_bfloat16>(a, n_inner, fuse_w, s);
}

}  // namespace k3
