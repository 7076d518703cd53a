// Shared pieces of the port's conv kernels: element conversions, the fused
// activation, and the dtype switch of the plain C entry points.
//
// Every kernel reads fp32, bf16 or fp16, accumulates in fp32 registers,
// applies the epilogue in fp32 and converts once on the store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ilpm {

// Dtype codes, as repro_torch/kernels/_build.py passes them.
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

// Activation codes: none, relu, relu6.
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_RELU6) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

}  // namespace ilpm

// Runs the statements after T with T bound to the element type of dtype
// code CODE; an unknown code returns cudaErrorInvalidValue from the
// enclosing function.
#define ILPM_DISPATCH_DTYPE(CODE, T, ...)                              \
  switch (CODE) {                                                       \
    case ilpm::DT_F32: { using T = float; __VA_ARGS__; } break;         \
    case ilpm::DT_BF16: { using T = __nv_bfloat16; __VA_ARGS__; } break; \
    case ilpm::DT_F16: { using T = __half; __VA_ARGS__; } break;        \
    default: return (int)cudaErrorInvalidValue;                         \
  }
