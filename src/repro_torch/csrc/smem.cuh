// The dynamic shared memory limit of the kernels that take more than the
// default 48 KB a block (flash_attn.cu, flash_attn_sm90.cu,
// flash_attn_bwd.cu, flash_attn_bwd_sm90.cu, ngram_sim.cu).
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace repro {

// Raise kernel's dynamic shared memory limit to bytes once per device, at
// its first launch there, so that a launch captured into a CUDA graph later
// makes no attribute call.  done holds one flag a device and belongs to
// the caller: one static array for each kernel instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev].store(true);
  return err;
}

}  // namespace repro
