// Flash attention for Hopper (sm_90a), hand-written CUDA: the prefill
// forward on the CUDA cores, for what neither tensor-core route takes
// (flash_attention.fwd_route): bf16 at head dims that are not multiples of
// 16 (flash_fwd_sm90.cu takes the rest) and f32 at head dims that are not
// multiples of 8 (flash_fwd_tf32.cu takes the rest). No model the port
// supports has such head dims; the kernel stays as the route of last
// resort, and tri_flash_fwd still takes any f32 or bf16 call (its tests
// reach it through this raw entry).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   tri_flash_fwd     <- _fwd_call (_fwd_body: causal, static window,
//                        optional segments, optional LSE residual)
// (the ragged decode is flash_decode_sm90.cu's).
//
// What bounds it on this card. The forward does 4*S*S*D*H/2 flops for
// causal attention against ~2*S*(H+K)*D bytes, far above the H100's ~295
// flops a byte: it is bound by arithmetic. This kernel computes in f32 on
// the CUDA cores, so its bound is the f32 SIMT rate, some 15x below the
// bf16 tensor-core bound that bound_ms states.
//
// Design, forward. One block of 256 threads per (q tile of 64 rows, q head,
// batch row). The q tile (pre-scaled, f32) stays in shared memory; the
// block walks the 64-key tiles of its kv head (GQA: head h reads kv head
// h / (H/K)) from the first to the causal limit, skipping a tile that no
// (q, k) pair of the tile can attend, as _block_needed does (causal,
// window, and segments that do not overlap). Each tile: K and V to shared
// memory as f32 (rows padded to D+1 floats, so the 16 threads of a half
// warp read 16 banks), a 64x64 score tile with 4x4 per thread, masked with
// the reference's finite NEG_INF = -2e38, the online-softmax update of
// (m, l) one warp per 8 rows, and acc = acc*corr + P V with 4 rows x Dv/16
// columns per thread in registers. Finalisation divides by max(l, 1e-30)
// and writes m + log(l) as the LSE, as the Pallas body does. The causal
// diagonal is in every row's last tile, so a row whose earlier tile was
// fully masked (m still NEG_INF, p = 1) is wiped there by corr = 0 exactly,
// as on the TPU.
//
// Tolerance against the plain PyTorch version (flash_attention.py): the
// sums run in another order and nvcc contracts a*b+c (this kernel is
// built without --fmad=false): ~1e-5 relative in f32, one bf16 ulp of the
// output where the working type is bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;          // forward: query rows a block
constexpr int BK = 64;          // forward: keys a tile
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// online-softmax update of `rows` score rows of width `width` (stride
// `ld`) in shared memory, one warp a row: scores become p = exp(s - m_new),
// and m, l, corr advance. `nvalid` entries of each row are live (the rest
// are skipped; the forward passes width).
__device__ __forceinline__ void softmax_rows(float* s, int ld, int rows,
                                             int nvalid, float* m, float* l,
                                             float* corr) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += WARPS) {
    float* row = s + r * ld;
    float mx = NEG_INF;
    for (int c = lane; c < nvalid; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    const float m_prev = m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int c = lane; c < nvalid; c += 32) {
      const float p = expf(row[c] - m_new);
      row[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float cr = expf(m_prev - m_new);
      corr[r] = cr;
      l[r] = l[r] * cr + sum;
      m[r] = m_new;
    }
  }
}

// ------------------------------------------------------------ forward ----
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;       // (B, S) or null
  void* o;
  float* lse;           // (B, H, S) or null
  int S, H, K, D, Dv, causal, window;
  float scale;
};

// NJ = column groups of 16 per thread: Dv <= 16 * NJ
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS) fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, Dv = a.Dv, S = a.S, H = a.H, K = a.K;
  const int ldq = D + 1;
  float* qs = smem;                       // BQ x (D+1)
  float* ks = qs + BQ * ldq;              // BK x (D+1)
  float* vs = ks + BK * ldq;              // BK x Dv
  float* ss = vs + BK * Dv;               // BQ x (BK+1)
  float* m_s = ss + BQ * (BK + 1);        // BQ
  float* l_s = m_s + BQ;                  // BQ
  float* c_s = l_s + BQ;                  // BQ
  int* sq = reinterpret_cast<int*>(c_s + BQ);   // BQ
  int* sk = sq + BQ;                            // BK

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e - r * D;
    qs[r * ldq + d] =
        to_f(q[((long)(b * S + q0 + r) * H + h) * D + d]) * a.scale;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    if (a.seg) sq[tid] = a.seg[(long)b * S + q0 + tid];
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = S / BK;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    // _block_needed: the window and segment skips (causal ends the loop)
    if (a.window > 0 && k0 + BK - 1 < q0 - (a.window - 1)) continue;
    if (a.seg) {
      const int* sr = a.seg + (long)b * S;
      if (!(sr[q0 + BQ - 1] >= sr[k0] && sr[q0] <= sr[k0 + BK - 1]))
        continue;
    }
    __syncthreads();                  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      ks[r * ldq + d] = to_f(kp[((long)(b * S + k0 + r) * K + kh) * D + d]);
    }
    for (int e = tid; e < BK * Dv; e += THREADS) {
      const int r = e / Dv, d = e - r * Dv;
      vs[r * Dv + d] = to_f(vp[((long)(b * S + k0 + r) * K + kh) * Dv + d]);
    }
    if (a.seg && tid < BK) sk[tid] = a.seg[(long)b * S + k0 + tid];
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qa[i] * kb[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int dd = (q0 + r) - (k0 + c);
        bool ok = true;
        if (a.causal) ok = ok && dd >= 0;
        if (a.window > 0) ok = ok && dd < a.window;
        if (a.seg) ok = ok && sq[r] == sk[c];
        ss[r * (BK + 1) + c] = ok ? sc[i][j] : NEG_INF;
      }
    }
    __syncthreads();
    softmax_rows(ss, BK + 1, BQ, BK, m_s, l_s, c_s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= cr;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ss[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vb = c < Dv ? vs[kk * Dv + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pa[i] * vb;
      }
    }
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < Dv)
        o[((long)(b * S + q0 + r) * H + h) * Dv + c] = from_f<T>(acc[i][j] / l);
    }
  }
  if (a.lse && tid < BQ)
    a.lse[((long)b * H + h) * S + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

size_t fwd_smem(int D, int Dv) {
  return sizeof(float) * (2 * BQ * (D + 1) + BK * Dv + BQ * (BK + 1) + 3 * BQ)
         + sizeof(int) * (BQ + BK);
}

template <typename T, int NJ>
int fwd_launch(const FwdArgs& a, int B, cudaStream_t st) {
  const size_t smem = fwd_smem(a.D, a.Dv);
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.S / BQ, a.H, B);
  fwd_kernel<T, NJ><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_dispatch(const FwdArgs& a, int B, cudaStream_t st) {
  const int nj = (a.Dv + 15) / 16;
  if (nj <= 1) return fwd_launch<T, 1>(a, B, st);
  if (nj <= 2) return fwd_launch<T, 2>(a, B, st);
  if (nj <= 4) return fwd_launch<T, 4>(a, B, st);
  if (nj <= 8) return fwd_launch<T, 8>(a, B, st);
  return fwd_launch<T, 16>(a, B, st);
}

}  // namespace

extern "C" {

// q (B,S,H,D), k (B,S,K,D), v (B,S,K,Dv), o (B,S,H,Dv), all of `dtype`
// (0 f32, 1 bf16); seg (B,S) int32 or null; lse (B,H,S) f32 or null.
// S % 64 == 0, H % K == 0, D <= 256, Dv <= 256. Returns cudaGetLastError().
int tri_flash_fwd(const void* q, const void* k, const void* v, const int* seg,
                  void* o, float* lse, int dtype, int B, int S, int H, int K,
                  int D, int Dv, int causal, int window, float scale,
                  void* stream) {
  FwdArgs a{q, k, v, seg, o, lse, S, H, K, D, Dv, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return fwd_dispatch<float>(a, B, st);
  return fwd_dispatch<__nv_bfloat16>(a, B, st);
}

}  // extern "C"
