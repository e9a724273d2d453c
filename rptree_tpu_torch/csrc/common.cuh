// Shared helpers of the port's CUDA kernels (built by rptree_tpu_torch/_cuda.py
// with nvcc into one shared library with a plain C interface).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rpt {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Factored squared L2 in the Pallas kernel's float order,
// max(sq - 2 * dot + qq, 0), with every step rounded on its own (no FMA
// contraction), then the square root for "l2".
__device__ __forceinline__ float factored_l2(float sq, float dot, float qq, int l2) {
  float v = __fadd_rn(__fsub_rn(sq, __fmul_rn(2.0f, dot)), qq);
  v = fmaxf(v, 0.0f);
  return l2 ? sqrtf(v) : v;
}

// Orderable bits of a float: unsigned order is float order, with -0 as +0
// (as a float compare has it), so one integer min finds the least value.
__device__ __forceinline__ unsigned orderable(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

// Raise the dynamic shared-memory limit of a kernel when a launch needs
// more than the default 48 KB (less 1 KB for its static shared memory).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 47 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rpt
