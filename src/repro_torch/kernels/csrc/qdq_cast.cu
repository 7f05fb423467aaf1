// Tier cast (quantize-dequantize) for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/qdq_cast.py:
//   two-pass form (tpu ladder, code 0, no amax) <- _qdq_fused_kernel
//   one-pass form (amax given, the gpu ladder, or code 1/2) <- _qdq_kernel
//
// Rounds the n elements of x to the grid of the precision tier picked by
// `code` (0 low tier, 1 bf16, 2 keep): the low tier is fp8 e4m3 scaled by
// 448/amax (tpu ladder) or fp16 (gpu ladder). x is f32 or bf16; the output
// is written as f32 or bf16 (out_dtype), rounded to nearest even from the
// f32 result, as a cast after the cast would.
//
// Bound by device-memory bytes (a handful of operations per element): x
// read once and the output written once; the two-pass form reads x again,
// less what stays on the chip between its passes. Design:
//  * one launch per call and nothing else on the stream: no memset, no
//    second kernel. The two-pass form is a persistent cooperative grid
//    (cudaLaunchCooperativeKernel, at most the occupancy times the SMs, so
//    every block is resident; a refused launch returns its error); the
//    one-pass form an ordinary launch over a grid sized for the bytes;
//  * x is cut into 16-byte units (4 f32 or 8 bf16), each read with one
//    16-byte load and written with one vector store; a row is THREADS
//    units (4 KB), and rows are dealt to the blocks in turn, so the grid
//    sweeps x front to back together (a scalar head up to x's 16-byte
//    boundary and a scalar tail, both in block 0; where x and the output
//    are not aligned alike, the whole call takes the scalar path);
//  * phase 1 reduces |x| over the block's rows as unsigned bits (|x| is
//    non-negative, so the bits order as the floats do, and NaN's bits sort
//    above inf: NaN propagates as jnp.max does), warp shuffles then shared
//    memory, and writes the block's max to its own word of a per-call
//    scratch; one grid-wide sync; then every block reduces the grid's words
//    itself. No atomic, no word to zero, and max is exact, so the result is
//    bitwise whatever the order;
//  * scale = amax > 0 ? 448/amax : 1 (NaN amax -> 1), a true division;
//  * what stays on the chip between the passes is read from there: phase 2
//    walks the rows in reverse, so the lines phase 1 read last, the
//    likeliest still in the 50 MB L2, come first, and each block's first
//    HOLD rows (45 KB a block) stay in its shared memory, read from x
//    once, evict-first, so that L2 keeps other lines. Outputs are stored,
//    and phase 2 loads x, evict-first too;
//  * the caller picks the form (kernels/qdq_cast.py: form) and this file
//    launches it, refusing a form that cannot give the cast: code != 0
//    never reads the amax, so the one-pass form serves it, the same body
//    without phase 1 or the sync;
//  * fp8 rounding by the hardware's conversion and the reference's NaN
//    past 464 (tier_round.cuh, shared with fused_update.cu); `/ scale` is a
//    division as in the reference, never a reciprocal multiply; built with
//    --fmad=false like every kernel held bitwise to its plain version.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_round.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;        // units a thread has in flight
constexpr int HOLD = 11;         // rows a block keeps in shared memory
constexpr float FP8_MAX = 448.0f;

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// A unit of x: 16 bytes (V = 16 / sizeof(T): 4 f32 or 8 bf16, one 16-byte
// load) on the vector path, one element (V = 1) on the scalar path. Raw
// is its bits, as loaded and as held in shared memory between the passes;
// `load<false>` is a read-only load (phase 1), `load<true>` an evict-first
// one (x's last read: phase 2, and the one read of the one-pass form).
template <typename T, int V> struct In;

template <> struct In<float, 1> {
  using Raw = float;
  template <bool LAST>
  static __device__ __forceinline__ Raw load(const float* p) {
    return LAST ? __ldcs(p) : __ldg(p);
  }
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = r;
  }
};
template <> struct In<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  template <bool LAST>
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    const Raw* q = reinterpret_cast<const Raw*>(p);
    return LAST ? __ldcs(q) : __ldg(q);
  }
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = __uint_as_float((uint32_t)r << 16);
  }
};
template <typename T> struct In16 {
  using Raw = uint4;
  template <bool LAST>
  static __device__ __forceinline__ Raw load(const T* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    return LAST ? __ldcs(q) : __ldg(q);
  }
};
template <> struct In<float, 4> : In16<float> {
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
};
template <> struct In<__nv_bfloat16, 8> : In16<__nv_bfloat16> {
  static __device__ __forceinline__ void unpack(Raw r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// V output elements from floats, rounded to nearest even into bf16: one
// vector store of 4, 8, 16 or 32 bytes, evict-first, so the output does
// not push x's lines out of L2 between the passes.
template <typename W>
__device__ __forceinline__ void st_last(W* p, W v) {
  __stcs(p, v);
}

template <typename T, int V> struct Out;

template <> struct Out<float, 1> {
  static __device__ __forceinline__ void store(float* p, const float* f) {
    st_last(p, f[0]);
  }
};
template <> struct Out<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    p[0] = __float2bfloat16_rn(f[0]);
  }
};
template <> struct Out<float, 4> {
  static __device__ __forceinline__ void store(float* p, const float* f) {
    st_last(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  }
};
template <> struct Out<float, 8> {
  static __device__ __forceinline__ void store(float* p, const float* f) {
    Out<float, 4>::store(p, f);
    Out<float, 4>::store(p + 4, f + 4);
  }
};
template <> struct Out<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    st_last(reinterpret_cast<uint2*>(p),
            make_uint2(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3])));
  }
};
template <> struct Out<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    st_last(reinterpret_cast<uint4*>(p),
            make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                       bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7])));
  }
};

__device__ __forceinline__ long lmin(long a, long b) { return a < b ? a : b; }

__device__ __forceinline__ unsigned int abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? FP8_MAX / amax : 1.f;     // NaN amax -> 1, as jnp.where
}

__device__ __forceinline__ float round_tier(float v, int code, bool tpu,
                                            float scale) {
  if (code == 0) return tpu ? rt_fp8(v * scale) / scale : rt_f16(v);
  if (code == 1) return rt_bf16(v);
  return v;
}

// max over the block of every thread's m; every thread gets the result
__device__ __forceinline__ unsigned int block_max(unsigned int m) {
  __shared__ unsigned int warp_max[THREADS / 32];
  __shared__ unsigned int result;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) m = max(m, warp_max[w]);
    result = m;
  }
  __syncthreads();
  return result;
}

struct Geometry {
  long head;      // scalar elements before the first unit
  long units;     // units of V elements from `head` on
  long tail;      // scalar elements after the units
};

// V = 16 / sizeof(TI) (the vector path) or 1 (the scalar path: head =
// tail = 0). A block takes `steps` rows of THREADS units, thread t unit t
// of each. TWO_PASS: find the absmax first (cooperative launch;
// `partials`: gridDim.x words of scratch), keeping the block's first HOLD
// rows in shared memory for phase 2; else the scale comes from
// `amax` (tpu ladder, given) or is unused (gpu ladder, code 1/2).
template <typename TI, typename TO, int V, bool TWO_PASS>
__global__ void __launch_bounds__(THREADS)
qdq_kernel(const TI* __restrict__ x, TO* __restrict__ out, Geometry g,
           int code, int tpu, const float* __restrict__ amax,
           unsigned int* __restrict__ partials) {
  using U = In<TI, V>;
  using Raw = typename U::Raw;
  constexpr int H = TWO_PASS ? HOLD : 0;
  __shared__ Raw hold[H > 0 ? H : 1][THREADS];

  // row k of this block: units lo + k * stride + [0, THREADS), below hi
  const long stride = (long)gridDim.x * THREADS;
  const long lo = (long)blockIdx.x * THREADS, hi = g.units;
  const long steps = (g.units + stride - 1) / stride;
  const long tid = threadIdx.x;
  const TI* xu = x + g.head;
  TO* ou = out + g.head;
  // block 0's scalar extras: the head, then the tail after the units
  const long extras = blockIdx.x == 0 ? g.head + g.tail : 0;
  const long extra_at =
      tid < g.head ? tid : g.head + g.units * V + (tid - g.head);
  const bool has_extra = tid < extras;

  float scale = 1.f;
  if constexpr (TWO_PASS) {
    unsigned int m = 0u;
    float f[V];
    if (has_extra) {
      In<TI, 1>::unpack(In<TI, 1>::template load<false>(x + extra_at), f);
      m = abs_bits(f[0]);
    }
    for (long s0 = 0; s0 < steps; s0 += UNROLL) {
      Raw r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long row = s0 + u, i = lo + row * stride + tid;
        if (i < hi)          // a held row is read from x only this once
          r[u] = row < H ? U::template load<true>(xu + i * V)
                         : U::template load<false>(xu + i * V);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long row = s0 + u, i = lo + row * stride + tid;
        if (i < hi) {
          if (row < H) hold[row][tid] = r[u];
          U::unpack(r[u], f);
#pragma unroll
          for (int e = 0; e < V; ++e) m = max(m, abs_bits(f[e]));
        }
      }
    }
    m = block_max(m);
    if (tid == 0) partials[blockIdx.x] = m;
    cg::this_grid().sync();
    m = 0u;
    for (int b = tid; b < (int)gridDim.x; b += THREADS)
      m = max(m, __ldcg(partials + b));
    scale = scale_of(__uint_as_float(block_max(m)));
  } else {
    if (tpu && code == 0) scale = scale_of(__ldg(amax));
  }
  const bool t = tpu != 0;

  if (has_extra) {
    float f;
    In<TI, 1>::unpack(In<TI, 1>::template load<true>(x + extra_at), &f);
    f = round_tier(f, code, t, scale);
    Out<TO, 1>::store(out + extra_at, &f);
  }
  // phase 2 in reverse: first the rows phase 1 read last, the likeliest
  // still in L2, the held rows last
  for (long k0 = 0; k0 < steps; k0 += UNROLL) {
    Raw r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long row = steps - 1 - (k0 + u);
      const long i = lo + row * stride + tid;
      if (k0 + u < steps && i < hi)
        r[u] = TWO_PASS && row < H ? hold[row][tid]
                                   : U::template load<true>(xu + i * V);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long row = steps - 1 - (k0 + u);
      const long i = lo + row * stride + tid;
      if (k0 + u < steps && i < hi) {
        float f[V];
        U::unpack(r[u], f);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = round_tier(f[e], code, t, scale);
        Out<TO, V>::store(ou + i * V, f);
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// blocks of `kernel` resident at once on the whole card
template <typename K>
int resident_blocks(K kernel) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  return per_sm * sm_count();
}

template <typename TI, typename TO, int V, bool TWO_PASS>
int launch_form(const TI* x, TO* out, Geometry g, int code, int tpu,
                const float* amax, unsigned int* partials, int partials_len,
                cudaStream_t st) {
  auto kernel = qdq_kernel<TI, TO, V, TWO_PASS>;
  static const int cap = resident_blocks(kernel);
  // UNROLL units a thread: the one-pass form's grid is sized for the bytes;
  // the two-pass form's stays at most what is resident, each thread
  // taking more units
  const long want =
      (g.units + (long)THREADS * UNROLL - 1) / ((long)THREADS * UNROLL);
  const int grid = (int)(want < 1 ? 1 : (TWO_PASS && want > cap ? cap : want));
  if (!TWO_PASS) {
    qdq_kernel<TI, TO, V, false><<<grid, THREADS, 0, st>>>(
        x, out, g, code, tpu, amax, partials);
    return (int)cudaGetLastError();
  }
  if (grid > partials_len) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &out, &g, &code, &tpu, &amax, &partials};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(THREADS), args,
      0, st);
}

template <typename TI, typename TO>
int launch(const void* xv, void* ov, long n, int code, int tpu,
           const float* amax_in, bool two_pass, unsigned int* partials,
           int partials_len, cudaStream_t st) {
  const TI* x = static_cast<const TI*>(xv);
  TO* out = static_cast<TO*>(ov);
  // the two-pass form finds the scale itself and takes no amax; the
  // one-pass form needs one on the tpu ladder at code 0
  if (two_pass ? amax_in != nullptr : (tpu && code == 0 && !amax_in))
    return (int)cudaErrorInvalidValue;
  // the head brings x to 16 bytes; the output must then be aligned to
  // its vector store
  const uintptr_t mis = reinterpret_cast<uintptr_t>(x) % 16;
  long head = mis ? (long)((16 - mis) / sizeof(TI)) : 0;
  head = head < n ? head : n;
  constexpr int VEC = 16 / sizeof(TI);
  constexpr uintptr_t OUT_ALIGN =
      VEC * sizeof(TO) < 16 ? VEC * sizeof(TO) : 16;
  const bool vec = reinterpret_cast<uintptr_t>(out + head) % OUT_ALIGN == 0
                   && mis % sizeof(TI) == 0;
  if (vec) {
    const long units = (n - head) / VEC;
    const Geometry g{head, units, n - head - units * VEC};
    return two_pass
        ? launch_form<TI, TO, VEC, true>(x, out, g, code, tpu, amax_in,
                                         partials, partials_len, st)
        : launch_form<TI, TO, VEC, false>(x, out, g, code, tpu, amax_in,
                                          partials, partials_len, st);
  }
  const Geometry g{0, n, 0};
  return two_pass
      ? launch_form<TI, TO, 1, true>(x, out, g, code, tpu, amax_in, partials,
                                     partials_len, st)
      : launch_form<TI, TO, 1, false>(x, out, g, code, tpu, amax_in, partials,
                                      partials_len, st);
}

template <typename TI>
int launch_in(const void* x, void* out, int out_dtype, long n, int code,
              int tpu, const float* amax_in, bool two_pass,
              unsigned int* partials, int partials_len, cudaStream_t st) {
  if (out_dtype == F32)
    return launch<TI, float>(x, out, n, code, tpu, amax_in, two_pass,
                             partials, partials_len, st);
  return launch<TI, __nv_bfloat16>(x, out, n, code, tpu, amax_in, two_pass,
                                   partials, partials_len, st);
}

}  // namespace

extern "C" {

// x: n elements of `dtype`, out: n elements of `out_dtype` (0 f32, 1
// bf16); code 0/1/2; tpu 0/1. amax_in: device f32 absmax, or null.
// two_pass 1: the two-pass form, which finds the absmax itself (amax_in
// null) with `partials` as scratch (partials_len unsigned words, at least
// tri_qdq_cast_max_grid()); 0: the one-pass form. One launch of that form
// for n > 0, none for n == 0. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a form the arguments do not allow).
int tri_qdq_cast(const void* x, int dtype, void* out, int out_dtype, long n,
                 int code, int tpu, const float* amax_in, int two_pass,
                 unsigned int* partials, int partials_len, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_in<float>(x, out, out_dtype, n, code, tpu, amax_in,
                            two_pass != 0, partials, partials_len, st);
  return launch_in<__nv_bfloat16>(x, out, out_dtype, n, code, tpu, amax_in,
                                  two_pass != 0, partials, partials_len, st);
}

// The most blocks a two-pass grid can take on this card (the scratch words
// a call needs at most): the largest resident grid of its instantiations.
int tri_qdq_cast_max_grid() {
  static const int most = [] {
    const int caps[] = {
        resident_blocks(qdq_kernel<float, float, 4, true>),
        resident_blocks(qdq_kernel<float, __nv_bfloat16, 4, true>),
        resident_blocks(qdq_kernel<__nv_bfloat16, float, 8, true>),
        resident_blocks(qdq_kernel<__nv_bfloat16, __nv_bfloat16, 8, true>),
        resident_blocks(qdq_kernel<float, float, 1, true>),
        resident_blocks(qdq_kernel<float, __nv_bfloat16, 1, true>),
        resident_blocks(qdq_kernel<__nv_bfloat16, float, 1, true>),
        resident_blocks(qdq_kernel<__nv_bfloat16, __nv_bfloat16, 1, true>)};
    int m = 0;
    for (int c : caps) m = c > m ? c : m;
    return m;
  }();
  return most;
}

}  // extern "C"
