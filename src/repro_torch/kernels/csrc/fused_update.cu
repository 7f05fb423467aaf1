// Fused update phase for Hopper (sm_90a): the two slab sweeps of the
// Tri-Accel train step, hand-written in CUDA C++.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_update.py:
//   tri_fused_stats  <- fused_stats (_stats_kernel, _one_hot)
//   tri_fused_apply  <- fused_apply (_apply_kernel, _tier_select, _sr_bits,
//                                    _sr_to_bf16)
//
// Both sweep a (rows, 512) slab once and are bound by device-memory bytes
// (a few flops per element). Design:
//  * one warp per slab row, 16 lanes a thread as 4 coalesced 16-byte
//    vectors, 4 rows a warp, 8 warps (32 rows) a block;
//  * per-row reductions by a fixed warp-shuffle tree, then each block
//    segment-combines its 32 rows by the per-row layer id into per-block
//    (L, ncols) partials in scratch (the TPU kernel accumulated over its
//    sequential grid; blocks on Hopper run in no order);
//  * a second small pass reduces the partials over the blocks in a FIXED
//    order (per-thread strided runs, then a fixed shared-memory tree): no
//    float atomics, so sums repeat bitwise from run to run.
// Elementwise math follows the reference operation by operation and is
// built with --fmad=false, so masters, moments and compute copies equal
// the plain PyTorch version bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLAB_N = 512;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;
constexpr int CHUNKS = SLAB_N / (32 * 4);   // 16-byte vectors per lane-row
constexpr int RED_THREADS = 256;

enum DType { F32 = 0, BF16 = 1, F16 = 2 };
enum Kind { SGDM = 0, ADAMW = 1 };
enum Ladder { GPU = 0, TPU = 1 };

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// max that propagates NaN like jnp.max / jnp.maximum
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}

// ---- 4-element vector loads / stores in the slab's storage type --------
__device__ __forceinline__ void load4(const float* p, float* v) {
  float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float* v) {
  uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  float2 a = __half22float2(*reinterpret_cast<__half2*>(&raw.x));
  float2 b = __half22float2(*reinterpret_cast<__half2*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                        __float2bfloat16_rn(v[1]));
  __nv_bfloat162 b = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                        __float2bfloat16_rn(v[3]));
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(__half* p, const float* v) {
  __half2 a = __halves2half2(__float2half_rn(v[0]), __float2half_rn(v[1]));
  __half2 b = __halves2half2(__float2half_rn(v[2]), __float2half_rn(v[3]));
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// ---- round trips through the narrow formats (round to nearest even) ----
__device__ __forceinline__ float rt_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rt_f16(float x) {
  return __half2float(__float2half_rn(x));
}
// f32 -> fp8 e4m3 -> f32. Past the top of the range the reference (JAX's
// float8_e4m3fn cast) gives NaN: |y| > 464 (the midpoint between 448 and
// the unused 480 code) and inf. __NV_NOSAT asks the hardware for NaN on
// overflow; the explicit test pins the reference's rule whatever the
// conversion does at the edge.
__device__ __forceinline__ float rt_fp8(float y) {
  __nv_fp8_storage_t s = __nv_cvt_float_to_fp8(y, __NV_NOSAT, __NV_E4M3);
  float f = __half2float(__half(__nv_cvt_fp8_to_halfraw(s, __NV_E4M3)));
  return (fabsf(y) <= 464.0f) ? f : nan_f();
}

template <typename T> __device__ __forceinline__ float rt_container(float x);
template <> __device__ __forceinline__ float rt_container<float>(float x) { return x; }
template <> __device__ __forceinline__ float rt_container<__nv_bfloat16>(float x) { return rt_bf16(x); }
template <> __device__ __forceinline__ float rt_container<__half>(float x) { return rt_f16(x); }

// counter-based SR stream of the reference's non-TPU path (_sr_bits):
// murmur3-finalizer mix of (global row, lane, step seed), uint32 wrap
__device__ __forceinline__ uint32_t sr_bits(uint32_t r, uint32_t c,
                                            uint32_t seed) {
  uint32_t h = (r * 0x9E3779B9u) ^ (c * 0x85EBCA6Bu) ^ (seed * 0xC2B2AE35u);
  h = h ^ (h >> 16);
  h = h * 0x85EBCA6Bu;
  h = h ^ (h >> 13);
  h = h * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// stochastic round f32 -> the bf16 grid (_sr_to_bf16)
__device__ __forceinline__ float sr_to_bf16(float pn, uint32_t bits) {
  uint32_t u = __float_as_uint(pn);
  uint32_t usr = (u + (bits & 0xFFFFu)) & 0xFFFF0000u;
  return isfinite(pn) ? __uint_as_float(usr) : rt_bf16(pn);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = nanmax(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ======================================================== phase 1 ========
// partials: (gridDim.x, L, 4) = per-block per-layer (sum, sum_sq, absmax,
// nonfinite). Non-finite lanes are counted but left out of the moments.
template <typename G>
__global__ void __launch_bounds__(THREADS)
stats_partials(const G* __restrict__ g, const int* __restrict__ row_layer,
               int L, float* __restrict__ partials) {
  __shared__ float srow[ROWS_PER_BLOCK][4];
  __shared__ int slayer[ROWS_PER_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row0 = (long)blockIdx.x * ROWS_PER_BLOCK + warp * ROWS_PER_WARP;

  float x[ROWS_PER_WARP][CHUNKS][4];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
      load4(g + (row0 + r) * SLAB_N + c * 128 + lane * 4, x[r][c]);

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    float s = 0.f, ss = 0.f, nf = 0.f, mx = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = x[r][c][k];
        const bool ok = isfinite(v);
        const float xf = ok ? v : 0.f;
        s = s + xf;
        ss = ss + xf * xf;
        nf = nf + (ok ? 0.f : 1.f);
        mx = fmaxf(mx, fabsf(xf));
      }
    s = warp_sum(s);
    ss = warp_sum(ss);
    nf = warp_sum(nf);
    mx = warp_max(mx);
    if (lane == 0) {
      const int lr = warp * ROWS_PER_WARP + r;
      srow[lr][0] = s; srow[lr][1] = ss; srow[lr][2] = mx; srow[lr][3] = nf;
      slayer[lr] = row_layer[row0 + r];
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += THREADS) {
    float s = 0.f, ss = 0.f, mx = 0.f, nf = 0.f;
    for (int r = 0; r < ROWS_PER_BLOCK; ++r) {
      if (slayer[r] == l) {
        s = s + srow[r][0];
        ss = ss + srow[r][1];
        mx = fmaxf(mx, srow[r][2]);
        nf = nf + srow[r][3];
      }
    }
    float* out = partials + ((long)blockIdx.x * L + l) * 4;
    out[0] = s; out[1] = ss; out[2] = mx; out[3] = nf;
  }
}

// Fixed-order reduce of (nblk, L, ncols) partials -> out (ncols, L). One
// block per (layer, column); column bits set in max_mask take a NaN-
// propagating max, the others a sum.
__global__ void __launch_bounds__(RED_THREADS)
reduce_partials(const float* __restrict__ partials, int nblk, int L,
                int ncols, int max_mask, float* __restrict__ out) {
  __shared__ float red[RED_THREADS];
  const int col = blockIdx.x % ncols, l = blockIdx.x / ncols;
  const bool is_max = (max_mask >> col) & 1;
  float acc = 0.f;
  for (int b = threadIdx.x; b < nblk; b += RED_THREADS) {
    const float v = partials[((long)b * L + l) * ncols + col];
    acc = is_max ? nanmax(acc, v) : acc + v;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      const float o = red[threadIdx.x + w];
      red[threadIdx.x] = is_max ? nanmax(red[threadIdx.x], o)
                                : red[threadIdx.x] + o;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[(long)col * L + l] = red[0];
}

// ======================================================== phase 2 ========
struct ApplyArgs {
  const void* g;
  const float* p;
  const float* m;
  const float* v;
  const float* scalars;     // [gscale, keep, c1, c2, sr_seed]
  const int* row_layer;
  const float* lr_rows;
  const int* code_rows;
  const float* qs_rows;
  float* p_out;
  float* m_out;
  float* v_out;
  void* cp_out;
  float* partials;          // (nblk, L) per-block absmax of the copy
  int L;
  int nesterov;
  float momentum, b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

template <int KIND, int LADDER, typename CP, bool SR, typename G>
__global__ void __launch_bounds__(THREADS) apply_kernel(ApplyArgs a) {
  __shared__ float srow[ROWS_PER_BLOCK];
  __shared__ int slayer[ROWS_PER_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float gscale = a.scalars[0];
  const bool keep = a.scalars[1] > 0.f;
  const float c1 = a.scalars[2], c2 = a.scalars[3];
  const uint32_t seed = (uint32_t)a.scalars[4];
  const G* g = static_cast<const G*>(a.g);
  CP* cp = static_cast<CP*>(a.cp_out);

  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int lr = warp * ROWS_PER_WARP + r;
    const long row = (long)blockIdx.x * ROWS_PER_BLOCK + lr;
    const float lrate = a.lr_rows[row];
    const int code = a.code_rows[row];
    const float qs = a.qs_rows[row];
    float gv[CHUNKS][4], pv[CHUNKS][4], mv[CHUNKS][4], vv[CHUNKS][4];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const long off = row * SLAB_N + c * 128 + lane * 4;
      load4(g + off, gv[c]);
      load4(a.p + off, pv[c]);
      load4(a.m + off, mv[c]);
      if (KIND == ADAMW) load4(a.v + off, vv[c]);
    }
    float rmx = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      float po[4], mo[4], vo[4], co[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float gk = gv[c][k] * gscale;             // unscale + clip
        const float p = pv[c][k];
        float m2, v2 = 0.f, step;
        if (KIND == SGDM) {
          if (a.wd != 0.f) gk = gk + a.wd * p;
          m2 = a.momentum * mv[c][k] + gk;
          step = a.nesterov ? (a.momentum * m2 + gk) : m2;
        } else {
          m2 = a.b1 * mv[c][k] + a.one_minus_b1 * gk;
          v2 = a.b2 * vv[c][k] + a.one_minus_b2 * (gk * gk);
          step = (m2 / c1) / (sqrtf(v2 / c2) + a.eps);
          if (a.wd != 0.f) step = step + a.wd * p;
        }
        float pn = p - lrate * step;
        if (!keep) {                              // non-finite: skip step
          pn = p;
          m2 = mv[c][k];
          if (KIND == ADAMW) v2 = vv[c][k];
        }
        po[k] = pn; mo[k] = m2; vo[k] = v2;
        // next-step compute copy: container cast, then tier rounding
        float cwf;
        if (SR) {
          const uint32_t col = (uint32_t)(c * 128 + lane * 4 + k);
          cwf = sr_to_bf16(pn, sr_bits((uint32_t)row, col, seed));
        } else {
          cwf = rt_container<CP>(pn);
        }
        float low;
        if (LADDER == TPU) {
          low = rt_fp8(cwf * qs) / qs;
        } else {
          low = rt_f16(cwf);
        }
        const float mid = rt_bf16(cwf);
        co[k] = code == 0 ? low : (code == 1 ? mid : cwf);
        rmx = nanmax(rmx, fabsf(cwf));
      }
      const long off = row * SLAB_N + c * 128 + lane * 4;
      store4(a.p_out + off, po);
      store4(a.m_out + off, mo);
      if (KIND == ADAMW) store4(a.v_out + off, vo);
      store4(cp + off, co);
    }
    rmx = warp_max(rmx);
    if (lane == 0) { srow[lr] = rmx; slayer[lr] = a.row_layer[row]; }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < a.L; l += THREADS) {
    float mx = 0.f;
    for (int r = 0; r < ROWS_PER_BLOCK; ++r)
      if (slayer[r] == l) mx = nanmax(mx, srow[r]);
    a.partials[(long)blockIdx.x * a.L + l] = mx;
  }
}

template <int KIND, int LADDER, typename CP, bool SR>
void launch_g(int g_dtype, int nblk, cudaStream_t s, const ApplyArgs& a) {
  switch (g_dtype) {
    case F32: apply_kernel<KIND, LADDER, CP, SR, float><<<nblk, THREADS, 0, s>>>(a); break;
    case BF16: apply_kernel<KIND, LADDER, CP, SR, __nv_bfloat16><<<nblk, THREADS, 0, s>>>(a); break;
    default: apply_kernel<KIND, LADDER, CP, SR, __half><<<nblk, THREADS, 0, s>>>(a); break;
  }
}

template <int KIND, int LADDER>
void launch_cp(int cp_dtype, int sr, int g_dtype, int nblk, cudaStream_t s,
               const ApplyArgs& a) {
  switch (cp_dtype) {
    case F32: launch_g<KIND, LADDER, float, false>(g_dtype, nblk, s, a); break;
    case BF16:
      if (sr) launch_g<KIND, LADDER, __nv_bfloat16, true>(g_dtype, nblk, s, a);
      else launch_g<KIND, LADDER, __nv_bfloat16, false>(g_dtype, nblk, s, a);
      break;
    default: launch_g<KIND, LADDER, __half, false>(g_dtype, nblk, s, a); break;
  }
}

}  // namespace

extern "C" {

int tri_rows_per_block() { return ROWS_PER_BLOCK; }

// g: (rows, 512) of g_dtype; row_layer: (rows,) int32; partials: scratch of
// (rows / ROWS_PER_BLOCK) * L * 4 floats; out: (4, L) = sum, sum_sq,
// absmax, nonfinite. Returns cudaGetLastError().
int tri_fused_stats(const void* g, int g_dtype, const int* row_layer,
                    int rows, int L, float* partials, float* out,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = rows / ROWS_PER_BLOCK;
  switch (g_dtype) {
    case F32: stats_partials<float><<<nblk, THREADS, 0, s>>>(static_cast<const float*>(g), row_layer, L, partials); break;
    case BF16: stats_partials<__nv_bfloat16><<<nblk, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(g), row_layer, L, partials); break;
    default: stats_partials<__half><<<nblk, THREADS, 0, s>>>(static_cast<const __half*>(g), row_layer, L, partials); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<L * 4, RED_THREADS, 0, s>>>(partials, nblk, L, 4,
                                                 1 << 2, out);
  return (int)cudaGetLastError();
}

// kind: 0 sgdm / 1 adamw; ladder: 0 gpu / 1 tpu; dtypes: 0 f32 / 1 bf16 /
// 2 f16; sr applies only with a bf16 copy. partials: (rows /
// ROWS_PER_BLOCK) * L floats; pmax_out: (L,). Returns cudaGetLastError().
int tri_fused_apply(int kind, int ladder, int g_dtype, int cp_dtype, int sr,
                    int nesterov, float momentum, float b1,
                    float one_minus_b1, float b2, float one_minus_b2,
                    float eps, float wd, const void* g, const float* p,
                    const float* m, const float* v, const float* scalars,
                    const int* row_layer, const float* lr_rows,
                    const int* code_rows, const float* qs_rows, float* p_out,
                    float* m_out, float* v_out, void* cp_out,
                    float* partials, float* pmax_out, int rows, int L,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = rows / ROWS_PER_BLOCK;
  ApplyArgs a{g, p, m, v, scalars, row_layer, lr_rows, code_rows, qs_rows,
              p_out, m_out, v_out, cp_out, partials, L, nesterov,
              momentum, b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  const int sr_on = (sr && cp_dtype == BF16) ? 1 : 0;
  if (kind == SGDM) {
    if (ladder == GPU) launch_cp<SGDM, GPU>(cp_dtype, sr_on, g_dtype, nblk, s, a);
    else launch_cp<SGDM, TPU>(cp_dtype, sr_on, g_dtype, nblk, s, a);
  } else {
    if (ladder == GPU) launch_cp<ADAMW, GPU>(cp_dtype, sr_on, g_dtype, nblk, s, a);
    else launch_cp<ADAMW, TPU>(cp_dtype, sr_on, g_dtype, nblk, s, a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<L, RED_THREADS, 0, s>>>(partials, nblk, L, 1, 1,
                                             pmax_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
