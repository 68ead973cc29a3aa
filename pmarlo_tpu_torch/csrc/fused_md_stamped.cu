// The stamped builds of the whole-run REMD kernels (csrc/fused_md.cu, file
// header: step-phase stamps): the device code of fused_md_body.cuh with its
// stamp macros defined, in a translation unit of its own, so that the
// unstamped kernels of fused_md.cu compile as they did without the stamps.

#define PMARLO_FUSED_MD_STAMPED
#include "fused_md_body.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads, 1) fused_remd_stamped_kernel(Args a) {
  remd_body<kUnbiased, 2>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_remd_single_stamped_kernel(Args a) {
  remd_body<kUnbiased, 1>(a);
}
__global__ void __launch_bounds__(kMaxThreads, 1) fused_remd_bias_stamped_kernel(Args a) {
  remd_body<kHarmonicOnly, 1>(a);
}

}  // namespace

// the kernel fused_md.cu launches for a stamped whole-run launch
const void* pmarlo_fused_remd_stamped_kernel(bool biased, bool single) {
  if (biased) return reinterpret_cast<const void*>(fused_remd_bias_stamped_kernel);
  return single ? reinterpret_cast<const void*>(fused_remd_single_stamped_kernel)
                : reinterpret_cast<const void*>(fused_remd_stamped_kernel);
}
