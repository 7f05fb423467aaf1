// Gradient statistics for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/grad_stats.py
// (grad_stats, _stats_kernel): the sum, the sum of squares and the absmax
// of all n elements of a tensor (f32, bf16 or f16), accumulated in f32 —
// the inputs of Tri-Accel's per-layer gradient-variance EMA.
//
// Bound by device-memory bytes: each element is read once (4 or 2 bytes)
// for four operations (add, multiply-add, abs, max). Design:
//  * the flat tensor in a grid-stride loop with 16-byte vector loads (four
//    f32 or eight bf16/f16 lanes) where the pointer is 16-byte aligned,
//    four vectors in flight a thread, and a bounds-checked scalar tail: no
//    (256, 512) fold and no zero-pad copy as on the TPU;
//  * one f32 accumulator pair per vector lane, so a thread's sums are
//    short chains; lanes, then the warp (a fixed xor-shuffle tree), then
//    the block's warps in order combine into one (sum, sum_sq, absmax)
//    partial per block in scratch;
//  * the TPU carried its (1, 3) accumulator across its sequential grid;
//    Hopper blocks run in no order, so a second single-block pass reduces
//    the partials in a FIXED order (strided runs per thread, then a fixed
//    shared-memory tree): no float atomics, the result repeats bitwise
//    from run to run on one card;
//  * the absmax is an unsigned max over the bits of |x|: for non-negative
//    floats the bit order is the value order, and a NaN's bits (sign
//    cleared by fabsf) sort above inf's, so NaN propagates as jnp.max does
//    (fmaxf would drop it). The max is exact in any order, so it is bitwise
//    equal to the plain version's; the sums differ from it only by their
//    order of summation;
//  * an empty tensor launches too and gives (0, 0, 0), as the reference's
//    kernel does on its one zero-padded tile.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;          // 16-byte vectors in flight a thread
constexpr int BLOCKS_PER_SM = 4;
constexpr int RED_THREADS = 256;

enum DType { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// one 16-byte vector -> LANES f32 values
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x; v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load_vec(const __half* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[k]));
    v[2 * k] = f.x; v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void accumulate(float& s, float& ss,
                                           unsigned int& mx, float v) {
  s = s + v;
  ss = ss + v * v;
  mx = max(mx, __float_as_uint(fabsf(v)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ unsigned int warp_umax(unsigned int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// partials: (gridDim.x, 3) = per-block (sum, sum_sq, absmax); the absmax
// slot holds the bits of the largest |x| (a float, possibly NaN).
template <typename T>
__global__ void __launch_bounds__(THREADS)
stats_partials(const T* __restrict__ x, long n, int vec,
               float* __restrict__ partials) {
  constexpr int LANES = 16 / sizeof(T);
  float s[LANES], ss[LANES];
#pragma unroll
  for (int k = 0; k < LANES; ++k) { s[k] = 0.f; ss[k] = 0.f; }
  unsigned int mx = 0u;
  const long tid = (long)blockIdx.x * THREADS + threadIdx.x;
  const long stride = (long)gridDim.x * THREADS;
  long tail = 0;                     // first element the scalar loop reads
  if (vec) {
    const long nvec = n / LANES;
    long i = tid;
    for (; i + (UNROLL - 1) * stride < nvec; i += UNROLL * stride) {
      float v[UNROLL][LANES];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        load_vec(x + (i + u * stride) * LANES, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < LANES; ++k) accumulate(s[k], ss[k], mx, v[u][k]);
    }
    for (; i < nvec; i += stride) {
      float v[LANES];
      load_vec(x + i * LANES, v);
#pragma unroll
      for (int k = 0; k < LANES; ++k) accumulate(s[k], ss[k], mx, v[k]);
    }
    tail = nvec * LANES;
  }
  for (long i = tail + tid; i < n; i += stride)
    accumulate(s[0], ss[0], mx, to_f32(x[i]));

  float ts = 0.f, tss = 0.f;
#pragma unroll
  for (int k = 0; k < LANES; ++k) { ts = ts + s[k]; tss = tss + ss[k]; }
  ts = warp_sum(ts);
  tss = warp_sum(tss);
  mx = warp_umax(mx);
  __shared__ float wsum[WARPS], wsq[WARPS];
  __shared__ unsigned int wmax[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { wsum[warp] = ts; wsq[warp] = tss; wmax[warp] = mx; }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = wsum[0], bss = wsq[0];
    unsigned int bmx = wmax[0];
    for (int w = 1; w < WARPS; ++w) {
      bs = bs + wsum[w];
      bss = bss + wsq[w];
      bmx = max(bmx, wmax[w]);
    }
    float* out = partials + (long)blockIdx.x * 3;
    out[0] = bs; out[1] = bss; out[2] = __uint_as_float(bmx);
  }
}

// Fixed-order reduce of (nblk, 3) partials -> out[3], one block.
__global__ void __launch_bounds__(RED_THREADS)
reduce_partials(const float* __restrict__ partials, int nblk,
                float* __restrict__ out) {
  __shared__ float rs[RED_THREADS], rss[RED_THREADS];
  __shared__ unsigned int rmx[RED_THREADS];
  float s = 0.f, ss = 0.f;
  unsigned int mx = 0u;
  for (int b = threadIdx.x; b < nblk; b += RED_THREADS) {
    s = s + partials[(long)b * 3];
    ss = ss + partials[(long)b * 3 + 1];
    mx = max(mx, __float_as_uint(partials[(long)b * 3 + 2]));
  }
  rs[threadIdx.x] = s; rss[threadIdx.x] = ss; rmx[threadIdx.x] = mx;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      rs[threadIdx.x] = rs[threadIdx.x] + rs[threadIdx.x + w];
      rss[threadIdx.x] = rss[threadIdx.x] + rss[threadIdx.x + w];
      rmx[threadIdx.x] = max(rmx[threadIdx.x], rmx[threadIdx.x + w]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = rs[0]; out[1] = rss[0]; out[2] = __uint_as_float(rmx[0]);
  }
}

int sm_count() {
  static int sms = 0;                  // one card a process
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

int elem_bytes(int dtype) { return dtype == F32 ? 4 : 2; }

template <typename T>
int launch(const void* x, long n, float* partials, int nblk, float* out,
           cudaStream_t st) {
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  stats_partials<T><<<nblk, THREADS, 0, st>>>(static_cast<const T*>(x), n,
                                               vec, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<1, RED_THREADS, 0, st>>>(partials, nblk, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the first pass for n elements of `dtype` (0 f32, 1 bf16,
// 2 f16): enough for four vectors a thread, at most BLOCKS_PER_SM a
// streaming multiprocessor, at least one. The scratch holds 3 floats a
// block.
int tri_grad_stats_blocks(long n, int dtype) {
  const long per_block = (long)THREADS * UNROLL * (16 / elem_bytes(dtype));
  const long want = (n + per_block - 1) / per_block;
  const long cap = (long)sm_count() * BLOCKS_PER_SM;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

// x: n contiguous elements of `dtype`; partials: scratch of 3 * nblk
// floats (nblk from tri_grad_stats_blocks); out: 3 floats (sum, sum_sq,
// absmax). Returns cudaGetLastError().
int tri_grad_stats(const void* x, int dtype, long n, float* partials,
                   int nblk, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch<float>(x, n, partials, nblk, out, st);
    case BF16: return launch<__nv_bfloat16>(x, n, partials, nblk, out, st);
    default: return launch<__half>(x, n, partials, nblk, out, st);
  }
}

}  // extern "C"
