// Shared helpers of the flash-attention kernels (decode.cu, prefill.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The finite mask value of repro_torch/kernels/flash_attention/common.py:
// -inf would give exp(-inf - -inf) = NaN on fully-masked rows.
#define REPRO_NEG_INF (-0.7f * 3.402823466e38f)

// Element types a kernel accepts; the wrapper passes the code of q's dtype.
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

// Dynamic shared memory a block may use on Hopper (227 KB).
constexpr int kReproMaxSmem = 232448;

__device__ __forceinline__ float repro_to_f32(float x) { return x; }
__device__ __forceinline__ float repro_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T repro_from_f32(float x);
template <> __device__ __forceinline__ float repro_from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 repro_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float repro_warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float repro_warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Raise the block's dynamic shared-memory limit when it needs more than the
// default 48 KB; refuse what Hopper cannot give.
template <typename Kernel>
static cudaError_t repro_smem_limit(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kReproMaxSmem) return cudaErrorInvalidConfiguration;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
