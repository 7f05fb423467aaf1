// Flash attention backward for Hopper (sm_90a), hand-written CUDA: the
// three kernels that turn the forward's saved (q, k, v, o, lse) and the
// output gradient dO into (dQ, dK, dV).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py
// (flash_attention_bwd):
//   tri_flash_bwd_delta <- _delta_kernel  (D_i = sum_d dO_id * O_id)
//   tri_flash_bwd_dq    <- _dq_kernel     (dQ over the needed k tiles)
//   tri_flash_bwd_dkv   <- _dkv_kernel    (dK, dV summed over the GQA
//                                          group's q heads and q tiles)
//
// What bounds them on this card. delta reads O and dO once and does two
// flops an element: bound by bytes. dQ does three (64 x 64 x D) products a
// needed tile pair (s = q k^T, dp = dO v^T, ds k), dK/dV four (s, dp,
// p^T dO, ds^T q), against a few bytes a row: far above the H100's ~295
// flops a byte, bound by arithmetic. These kernels compute in f32 on the
// CUDA cores, so their real ceiling is the f32 SIMT rate, some 15x below the
// bf16 tensor-core bound. bf16 calls at head dims the tensor cores take
// run dQ and dK/dV of flash_bwd_sm90.cu instead (flash_attention.bwd_route);
// these serve f32 and the other head dims, and delta serves every call.
//
// Design. The TPU kernels carry accumulators across a sequential grid axis
// (_dq_body over ki, _dkv_body over (r, qi)); here blocks run in no order,
// so that axis becomes a loop inside the block and each output tile has
// exactly one owner:
//   * dQ: one block of 256 threads per (q tile of BR rows, q head, batch
//     row). The q tile (pre-scaled, f32), dO, lse and delta stay in shared
//     memory; the block walks the BR-key tiles of its kv head that
//     _block_needed keeps (causal diagonal, window start, segment-range
//     overlap), recomputes s with the forward's mask, p = exp(s - lse),
//     dp = dO v^T, ds = p (dp - delta), and accumulates ds k in registers
//     (BR/16 rows x D/16 columns a thread); dq = acc * scale at the end.
//   * dK/dV: one block per (k tile of BR rows, kv head, batch row). K and V
//     stay in shared memory; the block loops over the H/K q heads of the
//     group and their needed q tiles, writes p and ds of each tile pair to
//     shared memory, and accumulates dv += p^T dO and dk += ds^T (q scale)
//     in registers (BR/16 key rows x D/16 columns a thread each). Each kv tile
//     has one block, so there are no float atomics and sums repeat
//     bitwise from run to run, as in fused_update.cu.
//   * delta: one warp per (b, row, head), a shuffle reduction over Dv.
// Shared-memory rows are padded to D+1 floats so the 16 threads of a half
// warp read 16 banks (as in the forward). Masked pairs keep the finite
// NEG_INF = -2e38, so exp(s - lse) is exactly 0 there. The masks are
// elementwise, so only the order of the f32 sums differs from the
// reference's 256-row tiles.
//
// Row tile. dQ and dK/dV are templated on BR, the rows of a q tile and of a
// k tile: 64 where max(D, Dv) <= 128, 32 above (the caller passes it;
// flash_attention.bwd_rows). A block keeps four (BR, D+1 or Dv+1) f32 tiles
// and one or two (BR, BR+1) score tiles in shared memory: at D = Dv = 256
// and 64 rows that is 280,832 B for dQ and 297,472 B for dK/dV, above the
// 232,448 B a block may use; at 32 rows 136,320 B and 140,544 B. Halving
// the rows also halves the register accumulators (MI = BR/16 rows a
// thread): acc[MI][NJ] in dQ, dk_acc and dv_acc in dK/dV, which at NJ = 16
// columns a thread stay at 32 and 64 floats. Every output tile still has
// one owner and its sums run in a fixed order: no float atomics.
//
// Tolerance against the plain PyTorch versions (flash_attention.py): the
// sums run in another order and nvcc contracts a*b+c (built without
// --fmad=false): ~1e-5 relative in f32, one bf16 ulp of the output where
// the working type is bf16 (flash_attention.tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -2.0e38f;

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct BwdArgs {
  const void* q;        // (B, S, H, D)
  const void* k;        // (B, S, K, D)
  const void* v;        // (B, S, K, Dv)
  const void* dout;     // (B, S, H, Dv)
  const float* lse;     // (B, H, S)
  const float* delta;   // (B, H, S)
  const int* seg;       // (B, S) or null
  void* dq;             // (B, S, H, D)
  void* dk;             // (B, S, K, D)
  void* dv;             // (B, S, K, Dv)
  int S, H, K, D, Dv, causal, window;
  float scale;
};

// _block_needed at the BR-row tile: does tile (q0, k0) hold any pair that
// the mask keeps? `segrow` is the batch row's segment ids (or null).
template <int BR>
__device__ __forceinline__ bool tile_needed(const BwdArgs& a, int q0, int k0,
                                            const int* segrow) {
  if (a.causal && k0 > q0 + BR - 1) return false;
  if (a.window > 0 && k0 + BR - 1 < q0 - (a.window - 1)) return false;
  if (segrow && !(segrow[q0 + BR - 1] >= segrow[k0] &&
                  segrow[q0] <= segrow[k0 + BR - 1]))
    return false;
  return true;
}

// _tile_mask for one pair
__device__ __forceinline__ bool pair_ok(const BwdArgs& a, int qp, int kp,
                                        int sq, int sk) {
  const int dd = qp - kp;
  bool ok = true;
  if (a.causal) ok = ok && dd >= 0;
  if (a.window > 0) ok = ok && dd < a.window;
  if (a.seg) ok = ok && sq == sk;
  return ok;
}

// Load a (BR x n) tile of head `head` (of `heads`) at sequence row r0 of
// batch row b into shared memory with leading dimension ld, as f32 times
// `mul`.
template <int BR, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int b, int r0, int S, int heads,
                                          int head, int n, float mul) {
  for (int e = threadIdx.x; e < BR * n; e += THREADS) {
    const int r = e / n, d = e - r * n;
    dst[r * ld + d] =
        to_f(src[((long)(b * S + r0 + r) * heads + head) * n + d]) * mul;
  }
}

// s = qs ks^T and dp = dos vs^T for the MI x MI pairs (rows ty+16i, cols
// tx+16j) of one (16 MI)-row tile, then p = exp(s - lse) and
// ds = p (dp - delta) with the tile's mask applied to s.
template <int MI>
__device__ __forceinline__ void tile_p_ds(const BwdArgs& a, const float* qs,
                                          const float* dos, const float* ks,
                                          const float* vs, const float* lse_s,
                                          const float* del_s, const int* sq,
                                          const int* sk, int q0, int k0,
                                          float p[MI][MI], float ds[MI][MI]) {
  const int D = a.D, Dv = a.Dv, ldd = D + 1, ldv = Dv + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[MI][MI], dp[MI][MI];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < MI; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qa[MI], kb[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) qa[i] = qs[(ty + 16 * i) * ldd + d];
#pragma unroll
    for (int j = 0; j < MI; ++j) kb[j] = ks[(tx + 16 * j) * ldd + d];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MI; ++j) sc[i][j] += qa[i] * kb[j];
  }
  for (int d = 0; d < Dv; ++d) {
    float ga[MI], vb[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) ga[i] = dos[(ty + 16 * i) * ldv + d];
#pragma unroll
    for (int j = 0; j < MI; ++j) vb[j] = vs[(tx + 16 * j) * ldv + d];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MI; ++j) dp[i][j] += ga[i] * vb[j];
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < MI; ++j) {
      const int c = tx + 16 * j;
      const bool ok = pair_ok(a, q0 + r, k0 + c, a.seg ? sq[r] : 0,
                              a.seg ? sk[c] : 0);
      const float pv = expf((ok ? sc[i][j] : NEG_INF) - lse_s[r]);
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - del_s[r]);
    }
  }
}

// ------------------------------------------------------------- delta ----
template <typename T>
__global__ void __launch_bounds__(THREADS) delta_kernel(
    const T* o, const T* dout, float* delta, long rows, int S, int H,
    int Dv) {
  // rows in (b, s, h) order: a warp reads one contiguous Dv-vector of each
  const long row = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;              // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* x = o + row * Dv;
  const T* g = dout + row * Dv;
  float acc = 0.f;
  for (int d = lane; d < Dv; d += 32) acc += to_f(x[d]) * to_f(g[d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long bs = row / H;
    const int s = (int)(bs % S);
    const long b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------- dQ ----
// NJ = column groups of 16 per thread: D <= 16 * NJ; BR = rows of a q tile
// and of a k tile
template <typename T, int NJ, int BR>
__global__ void __launch_bounds__(THREADS) dq_kernel(BwdArgs a) {
  constexpr int MI = BR / 16;            // rows a thread
  extern __shared__ float smem[];
  const int D = a.D, Dv = a.Dv, S = a.S, H = a.H, K = a.K;
  const int ldd = D + 1, ldv = Dv + 1;
  float* qs = smem;                      // BR x (D+1), scaled
  float* dos = qs + BR * ldd;            // BR x (Dv+1)
  float* ks = dos + BR * ldv;            // BR x (D+1)
  float* vs = ks + BR * ldd;             // BR x (Dv+1)
  float* dss = vs + BR * ldv;            // BR x (BR+1)
  float* lse_s = dss + BR * (BR + 1);    // BR
  float* del_s = lse_s + BR;             // BR
  int* sq = reinterpret_cast<int*>(del_s + BR);   // BR
  int* sk = sq + BR;                              // BR

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * BR;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const T* gp = static_cast<const T*>(a.dout);
  const int* segrow = a.seg ? a.seg + (long)b * S : nullptr;

  load_tile<BR>(qs, ldd, q, b, q0, S, H, h, D, a.scale);
  load_tile<BR>(dos, ldv, gp, b, q0, S, H, h, Dv, 1.f);
  if (tid < BR) {
    lse_s[tid] = a.lse[((long)b * H + h) * S + q0 + tid];
    del_s[tid] = a.delta[((long)b * H + h) * S + q0 + tid];
    if (segrow) sq[tid] = segrow[q0 + tid];
  }
  float acc[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = S / BR;
  const int kt_end = a.causal ? min(nk, (q0 + BR - 1) / BR + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BR;
    if (!tile_needed<BR>(a, q0, k0, segrow)) continue;   // uniform
    __syncthreads();                  // the previous tile's readers are done
    load_tile<BR>(ks, ldd, kp, b, k0, S, K, kh, D, 1.f);
    load_tile<BR>(vs, ldv, vp, b, k0, S, K, kh, Dv, 1.f);
    if (segrow && tid < BR) sk[tid] = segrow[k0 + tid];
    __syncthreads();
    float p[MI][MI], ds[MI][MI];
    tile_p_ds<MI>(a, qs, dos, ks, vs, lse_s, del_s, sq, sk, q0, k0, p, ds);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MI; ++j)
        dss[(ty + 16 * i) * (BR + 1) + tx + 16 * j] = ds[i][j];
    __syncthreads();
    for (int kk = 0; kk < BR; ++kk) {
      float da[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) da[i] = dss[(ty + 16 * i) * (BR + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float kb = c < D ? ks[kk * ldd + c] : 0.f;
#pragma unroll
        for (int i = 0; i < MI; ++i) acc[i][j] += da[i] * kb;
      }
    }
  }
  // s was taken against scale * q, so d/dq carries one more factor
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D)
        dq[((long)(b * S + q0 + r) * H + h) * D + c] =
            from_f<T>(acc[i][j] * a.scale);
    }
  }
}

// ------------------------------------------------------------- dK/dV ----
// NJ = column groups of 16 per thread: max(D, Dv) <= 16 * NJ; BR = rows of
// a k tile and of a q tile
template <typename T, int NJ, int BR>
__global__ void __launch_bounds__(THREADS) dkv_kernel(BwdArgs a) {
  constexpr int MI = BR / 16;            // key rows a thread
  extern __shared__ float smem[];
  const int D = a.D, Dv = a.Dv, S = a.S, H = a.H, K = a.K;
  const int rep = H / K;
  const int ldd = D + 1, ldv = Dv + 1;
  float* ks = smem;                      // BR x (D+1)
  float* vs = ks + BR * ldd;             // BR x (Dv+1)
  float* qs = vs + BR * ldv;             // BR x (D+1), scaled
  float* dos = qs + BR * ldd;            // BR x (Dv+1)
  float* ps = dos + BR * ldv;            // BR x (BR+1)
  float* dss = ps + BR * (BR + 1);       // BR x (BR+1)
  float* lse_s = dss + BR * (BR + 1);    // BR
  float* del_s = lse_s + BR;             // BR
  int* sq = reinterpret_cast<int*>(del_s + BR);   // BR
  int* sk = sq + BR;                              // BR

  const int kt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BR;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const T* gp = static_cast<const T*>(a.dout);
  const int* segrow = a.seg ? a.seg + (long)b * S : nullptr;

  load_tile<BR>(ks, ldd, kp, b, k0, S, K, g, D, 1.f);
  load_tile<BR>(vs, ldv, vp, b, k0, S, K, g, Dv, 1.f);
  if (segrow && tid < BR) sk[tid] = segrow[k0 + tid];
  // accumulators: key rows ty+16i, columns tx+16j
  float dk_acc[MI][NJ], dv_acc[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = S / BR;
  const int qt_begin = a.causal ? k0 / BR : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    for (int qt = qt_begin; qt < nq; ++qt) {
      const int q0 = qt * BR;
      if (!tile_needed<BR>(a, q0, k0, segrow)) continue;   // uniform
      __syncthreads();                // the previous tile's readers are done
      load_tile<BR>(qs, ldd, q, b, q0, S, H, h, D, a.scale);
      load_tile<BR>(dos, ldv, gp, b, q0, S, H, h, Dv, 1.f);
      if (tid < BR) {
        lse_s[tid] = a.lse[((long)b * H + h) * S + q0 + tid];
        del_s[tid] = a.delta[((long)b * H + h) * S + q0 + tid];
        if (segrow) sq[tid] = segrow[q0 + tid];
      }
      __syncthreads();
      float p[MI][MI], ds[MI][MI];
      tile_p_ds<MI>(a, qs, dos, ks, vs, lse_s, del_s, sq, sk, q0, k0, p, ds);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < MI; ++j) {
          const int e = (ty + 16 * i) * (BR + 1) + tx + 16 * j;
          ps[e] = p[i][j];
          dss[e] = ds[i][j];
        }
      __syncthreads();
      for (int rr = 0; rr < BR; ++rr) {
        float pa[MI], da[MI];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          pa[i] = ps[rr * (BR + 1) + ty + 16 * i];
          da[i] = dss[rr * (BR + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          const float gb = c < Dv ? dos[rr * ldv + c] : 0.f;
          const float qb = c < D ? qs[rr * ldd + c] : 0.f;
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            dv_acc[i][j] += pa[i] * gb;
            dk_acc[i][j] += da[i] * qb;   // q pre-scaled: dk is done
          }
        }
      }
    }
  }
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const long row = (long)(b * S + k0 + ty + 16 * i) * K + g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dk[row * D + c] = from_f<T>(dk_acc[i][j]);
      if (c < Dv) dv[row * Dv + c] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// dynamic shared memory of a block; flash_attention.bwd_smem mirrors these
size_t dq_smem(int D, int Dv, int BR) {
  return sizeof(float) * (2 * BR * (D + 1) + 2 * BR * (Dv + 1) +
                          BR * (BR + 1) + 2 * BR) +
         sizeof(int) * (2 * BR);
}

size_t dkv_smem(int D, int Dv, int BR) {
  return sizeof(float) * (2 * BR * (D + 1) + 2 * BR * (Dv + 1) +
                          2 * BR * (BR + 1) + 2 * BR) +
         sizeof(int) * (2 * BR);
}

template <typename Kern>
int launch(Kern kern, size_t smem, dim3 grid, const BwdArgs& a,
           cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// 64-row tiles take NJ in {1, 2, 4, 8} (head dims up to 128), 32-row
// tiles NJ in {4, 8, 12, 16} (up to 256)
template <typename T>
int dq_dispatch(const BwdArgs& a, int B, int rows, cudaStream_t st) {
  const dim3 grid(a.S / rows, a.H, B);
  const size_t smem = dq_smem(a.D, a.Dv, rows);
  const int nj = (a.D + 15) / 16;
  if (rows == 64) {
    if (nj <= 1) return launch(dq_kernel<T, 1, 64>, smem, grid, a, st);
    if (nj <= 2) return launch(dq_kernel<T, 2, 64>, smem, grid, a, st);
    if (nj <= 4) return launch(dq_kernel<T, 4, 64>, smem, grid, a, st);
    if (nj <= 8) return launch(dq_kernel<T, 8, 64>, smem, grid, a, st);
    return (int)cudaErrorInvalidValue;
  }
  if (nj <= 4) return launch(dq_kernel<T, 4, 32>, smem, grid, a, st);
  if (nj <= 8) return launch(dq_kernel<T, 8, 32>, smem, grid, a, st);
  if (nj <= 12) return launch(dq_kernel<T, 12, 32>, smem, grid, a, st);
  return launch(dq_kernel<T, 16, 32>, smem, grid, a, st);
}

template <typename T>
int dkv_dispatch(const BwdArgs& a, int B, int rows, cudaStream_t st) {
  const dim3 grid(a.S / rows, a.K, B);
  const size_t smem = dkv_smem(a.D, a.Dv, rows);
  const int nj = ((a.D > a.Dv ? a.D : a.Dv) + 15) / 16;
  if (rows == 64) {
    if (nj <= 1) return launch(dkv_kernel<T, 1, 64>, smem, grid, a, st);
    if (nj <= 2) return launch(dkv_kernel<T, 2, 64>, smem, grid, a, st);
    if (nj <= 4) return launch(dkv_kernel<T, 4, 64>, smem, grid, a, st);
    if (nj <= 8) return launch(dkv_kernel<T, 8, 64>, smem, grid, a, st);
    return (int)cudaErrorInvalidValue;
  }
  if (nj <= 4) return launch(dkv_kernel<T, 4, 32>, smem, grid, a, st);
  if (nj <= 8) return launch(dkv_kernel<T, 8, 32>, smem, grid, a, st);
  if (nj <= 12) return launch(dkv_kernel<T, 12, 32>, smem, grid, a, st);
  return launch(dkv_kernel<T, 16, 32>, smem, grid, a, st);
}

bool bad_dims(int S, int H, int K, int D, int Dv, int rows) {
  return (rows != 32 && rows != 64) || S % rows || K < 1 || H % K ||
         D < 1 || Dv < 1 || D > 256 || Dv > 256;
}

}  // namespace

extern "C" {

// o, dout (B,S,H,Dv) of `dtype` (0 f32, 1 bf16) -> delta (B,H,S) f32.
// Returns cudaGetLastError().
int tri_flash_bwd_delta(const void* o, const void* dout, float* delta,
                        int dtype, int B, int S, int H, int Dv,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long rows = (long)B * S * H;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  if (dtype == F32)
    delta_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta,
        rows, S, H, Dv);
  else
    delta_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), delta, rows, S, H, Dv);
  return (int)cudaGetLastError();
}

// q (B,S,H,D), k (B,S,K,D), v (B,S,K,Dv), dout (B,S,H,Dv), dq (B,S,H,D),
// all of `dtype`; lse, delta (B,H,S) f32; seg (B,S) int32 or null.
// `rows` is the row tile, 64 (max(D, Dv) <= 128) or 32; S % rows == 0,
// H % K == 0, D <= 256, Dv <= 256.
int tri_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* seg, void* dq, int dtype, int B, int S, int H,
                     int K, int D, int Dv, int causal, int window,
                     float scale, int rows, void* stream) {
  if (bad_dims(S, H, K, D, Dv, rows)) return (int)cudaErrorInvalidValue;
  BwdArgs a{q,  k,    v,       dout, lse, delta, seg, dq, nullptr, nullptr,
            S,  H,    K,       D,    Dv,  causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return dq_dispatch<float>(a, B, rows, st);
  return dq_dispatch<__nv_bfloat16>(a, B, rows, st);
}

// as tri_flash_bwd_dq, writing dk (B,S,K,D) and dv (B,S,K,Dv) of `dtype`
int tri_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* seg, void* dk, void* dv, int dtype, int B,
                      int S, int H, int K, int D, int Dv, int causal,
                      int window, float scale, int rows, void* stream) {
  if (bad_dims(S, H, K, D, Dv, rows)) return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v,  dout, lse, delta,  seg,    nullptr, dk, dv,
            S, H, K,  D,    Dv,  causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return dkv_dispatch<float>(a, B, rows, st);
  return dkv_dispatch<__nv_bfloat16>(a, B, rows, st);
}

}  // extern "C"
