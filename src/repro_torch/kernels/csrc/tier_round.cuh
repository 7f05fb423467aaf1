// Round trips through the Tri-Accel precision tiers' narrow formats, shared
// by the fused update (fused_update.cu) and the tier cast (qdq_cast.cu) so
// the rule lives in one place. Round to nearest even throughout; the plain
// PyTorch versions (kernels/fused_update.py: _fp8_round, _tier_select)
// apply the same rules.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float rt_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rt_f16(float x) {
  return __half2float(__float2half_rn(x));
}
// f32 -> fp8 e4m3 -> f32. Past the top of the range the reference (JAX's
// float8_e4m3fn cast) gives NaN: |y| > 464 (the midpoint between 448 and
// the unused 480 code) and inf; up to 464, 448 at most. __NV_SATFINITE is
// the hardware's conversion (cvt.rn.satfinite.e4m3x2.f32 on sm_89 and
// later; __NV_NOSAT is emulated in integer code): it rounds to nearest
// even, keeps NaN and clamps past 448, and the explicit test then gives
// the reference's NaN past 464 and for inf.
__device__ __forceinline__ float rt_fp8(float y) {
  __nv_fp8_storage_t s = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  float f = __half2float(__half(__nv_cvt_fp8_to_halfraw(s, __NV_E4M3)));
  return (fabsf(y) <= 464.0f) ? f : nan_f();
}
