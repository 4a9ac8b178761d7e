// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the tile shape, the TPU kernels' mask value, element
// strides and the f32 <-> element-type conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace raydp_flash {

constexpr int BQ = 64;             // query rows per tile
constexpr int BKV = 64;            // key/value rows per tile
constexpr int TPR = 4;             // threads per tile row
constexpr int THREADS = BQ * TPR;  // 256
constexpr float NEG_INF = -1e30f;  // the TPU kernels' causal mask value

struct Strides {
  long long b, s, h;  // element strides; the D dimension is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T and widened back: where the TPU kernels cast a tile to
// the operand dtype before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

}  // namespace raydp_flash
