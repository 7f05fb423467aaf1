// Tier cast (quantize-dequantize) for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/qdq_cast.py:
//   tri_qdq_cast, no amax, tpu ladder <- _qdq_fused_kernel (two-phase grid)
//   tri_qdq_cast, given amax or gpu   <- _qdq_kernel (single phase)
//
// Rounds the n elements of x to the grid of the precision tier picked by
// `code` (0 low tier, 1 bf16, 2 keep): the low tier is fp8 e4m3 scaled by
// 448/amax (tpu ladder) or fp16 (gpu ladder). Output dtype = input dtype.
//
// Bound by device-memory bytes (a handful of operations per element):
// 4 or 8 bytes read and written per element, plus one more read when the
// absmax has to be found first. Design:
//  * the flat n elements in a grid-stride loop with a tail guard: no
//    (256, 512) fold and no zero-pad copy as on the TPU;
//  * the TPU carried the absmax in SMEM across its sequential grid; Hopper
//    blocks run in no order, so pass 1 reduces |x| in each block by a warp
//    shuffle tree and folds the block's max into one word with atomicMax on
//    the float's bits (|x| is non-negative, so the unsigned order of the
//    bits is the float order, and NaN's bits sort above inf, so NaN
//    propagates as jnp.max does). Max is exact: the result is bitwise
//    whatever the order;
//  * pass 2 reads that word and derives scale = amax > 0 ? 448/amax : 1 on
//    the device, so there is no host sync between the passes;
//  * fp8 rounding with __NV_NOSAT and the reference's NaN past 464
//    (tier_round.cuh, shared with fused_update.cu); `/ scale` is a
//    division as in the reference, never a reciprocal multiply; built with
//    --fmad=false like every kernel held bitwise to its plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_round.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float FP8_MAX = 448.0f;

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float load(const float* p, long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? FP8_MAX / amax : 1.f;     // NaN amax -> 1, as jnp.where
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const T* __restrict__ x, long n, unsigned int* amax_bits) {
  unsigned int m = 0u;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long)gridDim.x * THREADS)
    m = max(m, __float_as_uint(fabsf(load(x, i))));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ unsigned int warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(amax_bits, m);
  }
}

// amax: device pointer to the absmax (tpu ladder), or null (gpu ladder)
template <typename T, bool TPU>
__global__ void __launch_bounds__(THREADS)
cast_kernel(const T* __restrict__ x, long n, int code,
            const float* __restrict__ amax, T* __restrict__ out) {
  const float scale = TPU ? scale_of(*amax) : 1.f;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long)gridDim.x * THREADS) {
    const float v = load(x, i);
    float r;
    if (code == 0) {
      r = TPU ? rt_fp8(v * scale) / scale : rt_f16(v);
    } else if (code == 1) {
      r = rt_bf16(v);
    } else {
      r = v;
    }
    store(out, i, r);
  }
}

int grid_for(long n, int sms) {
  long blocks = (n + THREADS - 1) / THREADS;
  long cap = (long)sms * 8;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename T>
int launch(const void* x, long n, int code, int tpu, const float* amax_in,
           float* amax_scratch, void* out, cudaStream_t st) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = grid_for(n, sms);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const float* amax = amax_in;
  if (tpu && amax == nullptr) {         // two-phase: find the absmax first
    cudaError_t e = cudaMemsetAsync(amax_scratch, 0, sizeof(float), st);
    if (e != cudaSuccess) return (int)e;
    absmax_kernel<T><<<grid, THREADS, 0, st>>>(
        xt, n, reinterpret_cast<unsigned int*>(amax_scratch));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    amax = amax_scratch;
  }
  if (tpu)
    cast_kernel<T, true><<<grid, THREADS, 0, st>>>(xt, n, code, amax, ot);
  else
    cast_kernel<T, false><<<grid, THREADS, 0, st>>>(xt, n, code, nullptr, ot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: n elements of `dtype` (0 f32, 1 bf16); code 0/1/2; tpu 0/1.
// amax_in: device f32 absmax, or null to find it (tpu ladder) in
// amax_scratch (one f32). Returns cudaGetLastError().
int tri_qdq_cast(const void* x, int dtype, long n, int code, int tpu,
                 const float* amax_in, float* amax_scratch, void* out,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch<float>(x, n, code, tpu, amax_in, amax_scratch, out, st);
  return launch<__nv_bfloat16>(x, n, code, tpu, amax_in, amax_scratch, out,
                               st);
}

}  // extern "C"
