// Ragged single-token flash decode for Hopper (sm_90a), hand-written CUDA:
// the live keys of each (batch row, kv head) are split over the blocks of a
// thread-block cluster, and the blocks' partial softmaxes are combined
// through distributed shared memory.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   tri_flash_decode <- flash_decode (_decode_kernel: row b's single query
//                       token attends cache slots [0, lengths[b]) of a
//                       (B, L, K, D) / (B, L, K, Dv) cache; GQA, rep = H/K
//                       query heads on a kv head; f32 softmax and sums, one
//                       rounding to the input type; zeros for length 0)
//
// What bounds it on this card. Each live K/V row is read once for the rep
// query heads of its group: 2*rep flops a loaded element, far below the
// H100's ~295 flops a byte, so the bound is bytes: (q + live K/V rows + o)
// over 3.35 TB/s, as chip_smoke.py's check_decode computes it. At the
// serving shape (B 4, L 2048, 9/3 heads, D 64, bf16, 4,223 live slots)
// that is 3.25 MB, 0.97 us; a launch costs a few us, so the aim is to
// reach that floor with the work spread over the card. No tensor cores: at
// rep = 3 a 64-row wgmma would waste 61 of its 64 rows.
//
// Design.
//   * Split the keys over a cluster. The grid is B*K clusters of N blocks
//     (N = flash_attention.DECODE_CLUSTER = 8, the portable size, a launch
//     attribute; 16 measured no faster at the serving shape), so it
//     depends on the shapes only: the host never reads `lengths`. Each
//     block reads len = min(max(lengths[b], 0), L) itself and takes keys
//     [r*c, min((r+1)*c, len)), c = ceil(len / N), r its rank.
//   * Loads. The block's K and V rows (D and Dv elements, K*D apart in the
//     cache) come in as 16-byte cp.async copies into a shared ring of
//     `stages` stages of `tk` keys; every copy of a stage is issued before
//     the first is waited on, and q is read while they are in flight.
//     Where a row is not a whole number of aligned 16-byte chunks (odd
//     head dims), plain element loads fill the same layout, rows padded
//     with zeros to whole chunks. The wrapper sizes the ring
//     (flash_attention.decode_geometry): one stage of ceil(L/N) keys where
//     it fits in 128 KB (the serving shape: 256 keys, 64 KB), else two.
//   * Scores. A row of 16-byte chunks is read by a group of lpr lanes (a
//     power of two, at most 32; a lane takes chunks lg and lg + lpr). Each
//     lane holds its chunks of up to RG query rows in registers as f32,
//     pre-scaled, and the (query head, key) dot products are reduced with
//     shuffles over the group's lanes into a (rep, tk) f32 score tile.
//   * Softmax and P V, per stage: one warp a head updates the block's f32
//     (m, l) online, as the reference does per k block; each thread then
//     accumulates acc = acc*corr + sum_j p_j v_j over a 16-byte chunk of
//     V columns of one head, the keys spread over slices where there are
//     fewer chunks than threads (the slices add up in a fixed order). An
//     empty block keeps m = NEG_INF (the finite -2e38 of the reference),
//     l = 0 and acc = 0, so nothing computes inf - inf.
//   * Combine through distributed shared memory. Each block writes its
//     (m, l, acc) into its slot of rank 0's shared memory
//     (st.shared::cluster through map_shared_rank), behind a relaxed
//     cluster arrive at the start whose wait (every block has started)
//     comes before the first remote write; one release/acquire cluster
//     barrier then makes the partials visible, and rank 0 rescales each
//     by exp(m_r - m) in rank order 0..N-1, divides by max(l, 1e-30),
//     casts once and writes. Rank 0 reads only its own shared memory, so
//     the other blocks may leave after that barrier: no second barrier
//     and no remote load on the path. The order of every sum is fixed
//     and there are no float atomics, so the result repeats bitwise. The
//     partials take N * (2 rep + rep Dv) floats; decode_geometry shrinks
//     N where they would pass 96 KB (rep * Dv near 2048 with many heads).
//
// Tolerance against the plain PyTorch version (flash_decode_ref, one full
// softmax): the sums run in another order and nvcc contracts a*b+c (built
// without --fmad=false): ~1e-5 relative in f32, one bf16 ulp of the output
// in bf16 (flash_attention.tolerance).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RG = 4;            // query heads a score pass holds in registers
constexpr int MAX_DEVICES = 64;
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

// a 16-byte chunk as f32: 4 floats or 8 bf16
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

struct DecArgs {
  const void* q;        // (B, 1, H, D)
  const void* k;        // (B, L, K, D)
  const void* v;        // (B, L, K, Dv)
  const int* lengths;   // (B,)
  void* o;              // (B, 1, H, Dv)
  int L, H, K, D, Dv;
  int Dp, Dvp;          // head dims padded to whole 16-byte chunks
  int tk, stages;       // keys a ring stage; ring stages (1 or 2)
  int lpr;              // lanes a shared K row (a power of two, <= 32)
  int vec;              // every K/V row is whole aligned 16-byte chunks
  float scale;
};

// Shared memory of a block, bytes: the ring (K then V stages, raw type),
// the (rep, tk) score tile, m, l, corr, a 16-byte chunk of f32 sums a
// thread for the key slices, and the cluster's partials (m, l, acc) of
// every rank, which rank 0 receives. decode_geometry mirrors it.
size_t decode_smem(const DecArgs& a, int itemsize, int N) {
  const size_t rep = a.H / a.K;
  return (size_t)a.stages * a.tk * (a.Dp + a.Dvp) * itemsize +
         4 * (rep * a.tk + 3 * rep + THREADS * (16 / itemsize) +
              (size_t)N * (2 * rep + rep * a.Dv));
}

// barrier.cluster: arrive (relaxed: orders nothing) and wait, and a full
// barrier whose arrive releases this block's writes and whose wait
// acquires the others'
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// online-softmax update of `rows` score rows of `nvalid` live entries
// (stride `ld`), one warp a row: scores become p = exp(s - m_new), and m,
// l, corr advance (as flash_attention.cu's softmax_rows)
__device__ __forceinline__ void softmax_rows(float* s, int ld, int rows,
                                             int nvalid, float* m, float* l,
                                             float* corr) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += WARPS) {
    float* row = s + r * ld;
    float mx = NEG_INF;
    for (int c = lane; c < nvalid; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int c = lane; c < nvalid; c += 32) {
      const float p = expf(row[c] - m_new);
      row[c] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float cr = expf(m_prev - m_new);
      corr[r] = cr;
      l[r] = l[r] * cr + sum;
      m[r] = m_new;
    }
  }
}

// this lane's chunks lg and lg + lpr of query heads r0 .. r0 + RG - 1, f32,
// pre-scaled (zeros past the head dim and past rep)
template <typename T, int EPC>
__device__ __forceinline__ void load_q(float (&qr)[RG][2][EPC], const T* qp,
                                       int r0, int rep, int D, int lg,
                                       int lpr, int cpr, int vec,
                                       float scale) {
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int ch = lg + cc * lpr;
      const T* qrow = qp + (r0 + i) * D;
      if (vec && r0 + i < rep && ch < cpr) {
        unpack(__ldg(reinterpret_cast<const uint4*>(qrow + ch * EPC)),
               qr[i][cc], T());
#pragma unroll
        for (int x = 0; x < EPC; ++x) qr[i][cc][x] *= scale;
      } else {
#pragma unroll
        for (int x = 0; x < EPC; ++x) {
          const int d = ch * EPC + x;
          qr[i][cc][x] =
              (r0 + i < rep && d < D) ? to_f(qrow[d]) * scale : 0.f;
        }
      }
    }
}

// ME = 16-byte column chunks of the output a thread: rep * Dvp / EPC <=
// THREADS * ME
template <typename T, int ME>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(DecArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EPC = 16 / sizeof(T);           // elements a 16-byte chunk
  cg::cluster_group cluster = cg::this_cluster();
  const int N = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int L = a.L, H = a.H, K = a.K, D = a.D, Dv = a.Dv;
  const int Dp = a.Dp, Dvp = a.Dvp, tk = a.tk, stages = a.stages;
  const int rep = H / K, E = rep * Dv;
  const int cl = blockIdx.x / N;                // (batch row, kv head)
  const int b = cl / K, g = cl - b * K;
  const int tid = threadIdx.x;

  T* ks = reinterpret_cast<T*>(smem);                      // [stages][tk][Dp]
  T* vs = ks + (size_t)stages * tk * Dp;                   // [stages][tk][Dvp]
  float* ps = reinterpret_cast<float*>(vs + (size_t)stages * tk * Dvp);
  float* m_s = ps + rep * tk;                              // [rep]
  float* l_s = m_s + rep;
  float* c_s = l_s + rep;
  float* red = c_s + rep;                                  // [THREADS][EPC]
  // rank r's partial, in rank 0: m [rep], l [rep], acc [rep][Dv]
  float* part = red + THREADS * EPC;
  const int pstride = 2 * rep + E;
  // every block of the cluster has started before one writes to another's
  // shared memory: arrive now, wait before the first remote write
  cluster_arrive_relaxed();

  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const T* qp = static_cast<const T*>(a.q) + ((long)b * H + g * rep) * D;
  // cache row (b, slot, g) = row0 + slot * K, of D (K) or Dv (V) elements
  const long row0 = (long)b * L * K + g;

  // scores: a group of lpr lanes a key row, chunks lg and lg + lpr
  const int lpr = a.lpr, cpr = Dp / EPC;
  const int grp = tid / lpr, lg = tid - grp * lpr, ngrp = THREADS / lpr;

  // this rank's keys
  const int len = min(max(a.lengths[b], 0), L);
  const int c = (len + N - 1) / N;
  const int k_begin = min(rank * c, len);
  const int n = min(k_begin + c, len) - k_begin;
  const int nst = (n + tk - 1) / tk;

  auto issue = [&](int st) {           // stage st's copies into its slot
    const int j0 = st * tk, nk = min(tk, n - j0);
    T* kd = ks + (size_t)(st % stages) * tk * Dp;
    T* vd = vs + (size_t)(st % stages) * tk * Dvp;
    const long r0 = row0 + (long)(k_begin + j0) * K;
    if (a.vec) {
      const int ck = D / EPC, cv = Dv / EPC;
      for (int e = tid; e < nk * ck; e += THREADS) {
        const int j = e / ck, ch = e - j * ck;
        cp_async16(kd + j * Dp + ch * EPC,
                   kp + (r0 + (long)j * K) * D + ch * EPC);
      }
      for (int e = tid; e < nk * cv; e += THREADS) {
        const int j = e / cv, ch = e - j * cv;
        cp_async16(vd + j * Dvp + ch * EPC,
                   vp + (r0 + (long)j * K) * Dv + ch * EPC);
      }
    } else {
      for (int e = tid; e < nk * Dp; e += THREADS) {
        const int j = e / Dp, d = e - j * Dp;
        kd[e] = d < D ? kp[(r0 + (long)j * K) * D + d] : from_f<T>(0.f);
      }
      for (int e = tid; e < nk * Dvp; e += THREADS) {
        const int j = e / Dvp, d = e - j * Dvp;
        vd[e] = d < Dv ? vp[(r0 + (long)j * K) * Dv + d] : from_f<T>(0.f);
      }
    }
    cp_async_commit();
  };
  if (nst > 0) issue(0);
  if (nst > 1 && stages > 1) issue(1);
  // where one pass holds every query head, q comes in once, while the
  // K/V rows are on their way
  float qr[RG][2][EPC];
  if (rep <= RG) load_q<T, EPC>(qr, qp, 0, rep, D, lg, lpr, cpr, a.vec,
                                a.scale);

  if (tid < rep) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  // P V: chunk eg = (head, 16-byte column chunk) of key slice `slice`
  const int cpv = Dvp / EPC, EG = rep * cpv;
  const int KS = max(1, THREADS / EG);
  const int slice = KS > 1 ? tid / EG : 0;
  const int e0 = KS > 1 ? tid - slice * EG : tid;
  float acc[ME][EPC];
#pragma unroll
  for (int t = 0; t < ME; ++t)
#pragma unroll
    for (int x = 0; x < EPC; ++x) acc[t][x] = 0.f;

  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst && stages > 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();                   // the stage (and m, l) are in place
    const int nk = min(tk, n - st * tk);
    const T* kst = ks + (size_t)(st % stages) * tk * Dp;
    const T* vst = vs + (size_t)(st % stages) * tk * Dvp;
    for (int r0 = 0; r0 < rep; r0 += RG) {
      if (rep > RG) load_q<T, EPC>(qr, qp, r0, rep, D, lg, lpr, cpr, a.vec,
                                   a.scale);
      // the loop bound is the block's, so every lane reaches the shuffles
      for (int jb = 0; jb < nk; jb += ngrp) {
        const int j = jb + grp;
        float s[RG];
#pragma unroll
        for (int i = 0; i < RG; ++i) s[i] = 0.f;
        if (j < nk) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int ch = lg + cc * lpr;
            if (ch < cpr) {
              float kf[EPC];
              unpack(*reinterpret_cast<const uint4*>(kst + j * Dp + ch * EPC),
                     kf, T());
#pragma unroll
              for (int i = 0; i < RG; ++i)
#pragma unroll
                for (int x = 0; x < EPC; ++x) s[i] += qr[i][cc][x] * kf[x];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RG; ++i)
          for (int o = lpr >> 1; o > 0; o >>= 1)
            s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
        if (j < nk && lg == 0) {
#pragma unroll
          for (int i = 0; i < RG; ++i)
            if (r0 + i < rep) ps[(r0 + i) * tk + j] = s[i];
        }
      }
    }
    __syncthreads();
    softmax_rows(ps, tk, rep, nk, m_s, l_s, c_s);
    __syncthreads();
    if (slice < KS) {
#pragma unroll
      for (int t = 0; t < ME; ++t) {
        const int eg = e0 + t * THREADS;
        if (eg < EG) {
          const int r = eg / cpv, ch = eg - r * cpv;
          const float* pr = ps + r * tk;
          const float cr = c_s[r];
#pragma unroll
          for (int x = 0; x < EPC; ++x) acc[t][x] *= cr;
          for (int j = slice; j < nk; j += KS) {
            const float p = pr[j];
            float vf[EPC];
            unpack(*reinterpret_cast<const uint4*>(vst + j * Dvp + ch * EPC),
                   vf, T());
#pragma unroll
            for (int x = 0; x < EPC; ++x) acc[t][x] += p * vf[x];
          }
        }
      }
    }
    __syncthreads();                   // the slot is free again
    if (st + stages < nst) issue(st + stages);
  }

  // this block's partial (m, l, acc), key slices added in slice order, to
  // its place in rank 0's shared memory
  cluster_wait();
  float* dst = cluster.map_shared_rank(part + rank * pstride, 0);
  for (int r = tid; r < rep; r += THREADS) {
    dst[r] = m_s[r];
    dst[rep + r] = l_s[r];
  }
  float* dacc = dst + 2 * rep;
  if (KS > 1) {
    if (slice < KS) {
#pragma unroll
      for (int x = 0; x < EPC; ++x) red[tid * EPC + x] = acc[0][x];
    }
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) {
      const int r = e / Dv, col = e - r * Dv;
      const int eg = r * cpv + col / EPC, x = col % EPC;
      float sum = 0.f;
      for (int s = 0; s < KS; ++s) sum += red[(s * EG + eg) * EPC + x];
      dacc[e] = sum;
    }
  } else {
#pragma unroll
    for (int t = 0; t < ME; ++t) {
      const int eg = tid + t * THREADS;
      if (eg < EG) {
        const int r = eg / cpv, col0 = (eg - r * cpv) * EPC;
#pragma unroll
        for (int x = 0; x < EPC; ++x)
          if (col0 + x < Dv) dacc[r * Dv + col0 + x] = acc[t][x];
      }
    }
  }
  cluster_barrier();                   // every partial is in rank 0
  if (rank != 0) return;

  // rank 0: rescale each rank's partial by exp(m_r - m), rank order 0..N-1
  T* op = static_cast<T*>(a.o) + ((long)b * H + g * rep) * Dv;
  for (int e = tid; e < E; e += THREADS) {
    const int r = e / Dv;
    float m = NEG_INF;
    for (int k = 0; k < N; ++k) m = fmaxf(m, part[k * pstride + r]);
    float l = 0.f, x = 0.f;
    for (int k = 0; k < N; ++k) {
      const float* pk = part + k * pstride;
      const float w = expf(pk[r] - m);
      l += pk[rep + r] * w;
      x += pk[2 * rep + e] * w;
    }
    op[e] = from_f<T>(x / fmaxf(l, 1e-30f));
  }
}

template <typename T, int ME>
int decode_launch(const DecArgs& a, int B, int N, cudaStream_t st) {
  auto kern = decode_split_kernel<T, ME>;
  const size_t smem = decode_smem(a, sizeof(T), N);
  // the function's attributes, set once a device (and again for a larger
  // shared memory): host work a call stays one launch
  static int set_smem[MAX_DEVICES], set_nonportable[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if ((int)smem > set_smem[dev]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    set_smem[dev] = (int)smem;
  }
  if (N > 8 && !set_nonportable[dev]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    set_nonportable[dev] = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * a.K * N));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int decode_dispatch(const DecArgs& a, int B, int N, cudaStream_t st) {
  const int groups = (a.H / a.K) * (a.Dvp / (16 / (int)sizeof(T)));
  const int me = (groups + THREADS - 1) / THREADS;
  if (me <= 1) return decode_launch<T, 1>(a, B, N, st);
  if (me <= 2) return decode_launch<T, 2>(a, B, N, st);
  if (me <= 4) return decode_launch<T, 4>(a, B, N, st);
  return decode_launch<T, 8>(a, B, N, st);
}

DecArgs make_args(const void* q, const void* k, const void* v,
                  const int* lengths, void* o, int itemsize, int L, int H,
                  int K, int D, int Dv, float scale, int tk, int stages,
                  int lpr) {
  const int epc = 16 / itemsize;
  const int Dp = (D + epc - 1) / epc * epc, Dvp = (Dv + epc - 1) / epc * epc;
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  const int vec = aligned && D == Dp && Dv == Dvp;
  return DecArgs{q,  k,  v,  lengths, o,      L,   H,   K,     D,
                 Dv, Dp, Dvp, tk,     stages, lpr, vec, scale};
}

}  // namespace

extern "C" {

// q (B,1,H,D), k (B,L,K,D), v (B,L,K,Dv), o (B,1,H,Dv), all of `dtype`
// (0 f32, 1 bf16); lengths (B,) int32, read on the card only. (H/K) * Dv
// <= 2048, D <= 256, Dv <= 256. `cluster` blocks a (row, kv head), `tk`
// keys a ring stage, `stages` ring stages and `lpr` lanes a K row come
// from flash_attention.decode_geometry. Returns the launch's cudaError_t.
int tri_flash_decode(const void* q, const void* k, const void* v,
                     const int* lengths, void* o, int dtype, int B, int L,
                     int H, int K, int D, int Dv, float scale, int cluster,
                     int tk, int stages, int lpr, void* stream) {
  if (K < 1 || H % K || D < 1 || Dv < 1 || D > 256 || Dv > 256 ||
      (H / K) * Dv > 2048 || cluster < 1 || cluster > 16 || tk < 1 ||
      stages < 1 || stages > 2 || lpr < 1 || lpr > 32 || (lpr & (lpr - 1)))
    return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == F32 ? 4 : 2;
  const int epc = 16 / itemsize;
  if ((D + epc - 1) / epc > 2 * lpr)   // a lane takes two chunks of a row
    return (int)cudaErrorInvalidValue;
  const DecArgs a = make_args(q, k, v, lengths, o, itemsize, L, H, K, D, Dv,
                              scale, tk, stages, lpr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return decode_dispatch<float>(a, B, cluster, st);
  return decode_dispatch<__nv_bfloat16>(a, B, cluster, st);
}

// the dynamic shared memory, bytes, that tri_flash_decode gives a block
// (held against flash_attention.decode_geometry on the card)
long tri_flash_decode_smem(int dtype, int L, int H, int K, int D, int Dv,
                           int cluster, int tk, int stages, int lpr) {
  const int itemsize = dtype == F32 ? 4 : 2;
  const DecArgs a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                              itemsize, L, H, K, D, Dv, 1.f, tk, stages, lpr);
  return (long)decode_smem(a, itemsize, cluster);
}

}  // extern "C"
