// cp.async helpers shared by the kernels that stage tiles in shared memory
// (icm_sweep.cu, ngram_sim.cu).  A copy that is not live reads nothing and
// fills its destination with zeros (src-size 0), so a ragged edge needs no
// second pass.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro
