// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the TPU kernels' mask value, element strides, the
// element-type to f32 conversion, and the host side's head-dim dispatch,
// launch and resource query.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace raydp_flash {

constexpr float NEG_INF = -1e30f;  // the TPU kernels' causal mask value

struct Strides {
  long long b, s, h;  // element strides; the D dimension is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// f(std::integral_constant<int, D>{}) for a head dim the kernels are
// built for; cudaErrorInvalidValue for any other.
template <typename F>
int by_head_dim(int D, F&& f) {
  switch (D) {
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launch configuration of a kernel, then cudaGetLastError.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// What a kernel holds on an SM: out[0] registers a thread, out[1] shared
// memory bytes a CTA (dynamic plus static), out[2] CTAs resident on one
// SM, out[3] local-memory (spill) bytes a thread.
template <typename Kernel>
int kernel_resources(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)(smem + attr.sharedSizeBytes);
  out[2] = ctas;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}

}  // namespace raydp_flash
