// Flash attention backward for Hopper (sm_90a), f32 inputs on the tensor
// cores in split TF32 ("3xTF32"): dQ and dK/dV with mma.sync m16n8k8 tf32
// for every product and a two-stage cp.async ring for every tile load.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py
// (flash_attention_bwd), for f32 inputs with head dims D, Dv each a multiple
// of 8 up to 256:
//   tri_flash_bwd_dq_tf32  <- _dq_kernel  (_dq_body: dQ over the needed k
//                                          tiles)
//   tri_flash_bwd_dkv_tf32 <- _dkv_kernel (_dkv_body: dK, dV summed over
//                                          the GQA group's q heads and q
//                                          tiles)
// bf16 inputs take flash_bwd_sm90.cu, other head dims the SIMT kernels of
// flash_attention_bwd.cu (flash_attention.bwd_route picks, from the dtype
// and the head dims alone); delta stays in flash_attention_bwd.cu.
//
// What they compute, from the forward's saved lse and delta = rowsum(dO O):
//   P = exp(scale Q K^T - lse), 0 at masked pairs; dS = P (dO V^T - delta)
//   dQ = scale dS K;  dK = scale dS^T Q;  dV = P^T dO,
// dK and dV summed over the H/K q heads of each kv head.
//
// The split (tf32.cuh, shared with the forward of flash_fwd_tf32.cu):
// every f32 operand x enters as hi = tf32(x), rounded, and lo = x - hi,
// truncated, and a product a b is taken as al bh + ah bl + ah bh on the
// tensor cores. P and dS are split the same way (a single rounded P or dS
// breaks the tolerance, as the bf16 route found). The tensor cores' f32
// sums truncate; the long sums are flushed to f32 adds (product_cols), so
// what remains is f32 accumulation in another order. P is 2^(S scale
// log2e - lse log2e) (ex2.approx, 2 ulp), as in the bf16 kernels.
//
// What bounds them on this card. dQ does three (rows x rows x D-class)
// products a needed tile pair (S = Q K^T, dP = dO V^T, dQ += dS K), dK/dV
// four (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q), each as
// three tf32 mma: bound by the dense TF32 rate (495 TFLOP/s) times three,
// far above the ~148 flops a byte (TF32) where bytes would bound.
//
// Design: mma.sync.m16n8k8 with fragments loaded from one f32 copy of each
// tile in shared memory, split hi/lo in registers. wgmma takes tf32
// operands from shared memory only K-major (the transpose bits exist for
// 16-bit types alone), and four of the seven products contract over a
// tile's row axis (dS K, P^T dO, dS^T Q, and the P^T / dS^T operands);
// with mma.sync a fragment is loaded by any indexing, so one f32 copy of
// each tile serves every product and the hi/lo split doubles nothing in
// shared memory. An accumulator's fragment becomes the A fragment of the
// next product by renaming the contraction index (tf32.cuh), so P and dS
// never leave registers.
//   * Tiles. D and Dv are both padded to one width W = 8 NT (32, 64, 96 or
//     128 on 64-row tiles, 192 or 256 on 32-row tiles), a template
//     constant, so every loop and shared offset is fixed at compile time;
//     the padding columns are zero and add nothing to a product. Rows of
//     shared tiles are W+4 floats: the fragment loads (8 rows x 4 columns,
//     or 4 row pairs x 8 columns) then hit 32 distinct banks, and every row
//     stays 16-byte aligned for cp.async.
//   * dQ: one block of 8 warps per (BR q rows, q head, batch row). Q, dO,
//     lse and delta load once; the needed BR-key tiles of K and V
//     (_block_needed) stream through a two-stage cp.async ring, the next
//     tile loading while the tensor cores run on this one. Warp w takes
//     the 16 q rows (w mod BR/16) and a 1/KS share of each key tile's keys
//     (KS = 8 / (BR/16)): S, dP, P, dS and the dQ partial over its keys
//     stay in its registers. At the end the KS partials of a row group are
//     added in a fixed order through shared memory, scaled and stored.
//   * dK/dV: one block of 8 warps per (BR keys, kv head, batch row), in the
//     transposed form. K and V load once; the group's H/K q heads and their
//     needed q tiles stream Q, dO, lse and delta through the ring. Warp w
//     takes 16 keys and a 1/QS share of each q tile's rows, accumulates
//     dK and dV partials, and the partials are added in a fixed order at
//     the end. Up to max(D, Dv) = 128 one launch accumulates both. Above,
//     dK and dV would take 256 accumulator registers a thread, so the call
//     makes two launches of the same kernel: dV (S^T and P^T only), then
//     dK (S^T, dP^T, dS^T), at most 128 accumulator registers in either.
//   * Row tile BR (the caller passes it, flash_attention.bwd_rows): 64 up
//     to max(D, Dv) = 128, 32 above, so the shared tiles fit.
//   * Each output tile has one owner and every sum runs in a fixed order:
//     no float atomics, and results repeat bitwise from run to run.
//   * Causal dQ grids put the longest blocks (the last q tiles) first.
//
// Shared memory (bwd_tf32_smem in flash_attention.py mirrors tf32_smem
// below): three tiles' worth (the block's own
// and two ring stages) of two BR x (W+4) f32 tiles, lse and delta rows
// (once for dQ, a stage each for dK/dV) and the segment ids of three tiles.
// At D = Dv = 64, BR 64: dQ 105,728 B, dK/dV 106,240 B (two blocks an SM);
// at 128, BR 64: 204,032 / 204,544 B; at 256, BR 32: 200,320 / 200,576 B,
// under the 232,448 B a block may use.
#include "tf32.cuh"

namespace {

enum Mode { BOTH = 0, DV_ONLY = 1, DK_ONLY = 2 };

struct TfArgs {
  const float* q;        // (B, S, H, D)
  const float* k;        // (B, S, K, D)
  const float* v;        // (B, S, K, Dv)
  const float* dout;     // (B, S, H, Dv)
  const float* lse;      // (B, H, S)
  const float* delta;    // (B, H, S)
  const int* seg;        // (B, S) or null
  float* dq;             // (B, S, H, D)
  float* dk;             // (B, S, K, D)
  float* dv;             // (B, S, K, Dv)
  int S, H, K, D, Dv, causal, window;
  float scale;
};

// ------------------------------------------------------------ masks -----
// _tile_mask for one (query, key) pair, segment ids sq / sk
__device__ __forceinline__ bool kept(const TfArgs& a, int qp, int kp, int sq,
                                     int sk) {
  const int d = qp - kp;
  return (!a.causal || d >= 0) && (a.window <= 0 || d < a.window) &&
         (!a.seg || sq == sk);
}

__device__ __forceinline__ float minus_inf() {
  return __uint_as_float(0xff800000u);
}

// ---------------------------------------------------------------- dQ ----
// NT: 8-column blocks of W, the width D and Dv are padded to; BR: rows of a
// q tile and of a k tile
template <int NT, int BR>
__global__ void __launch_bounds__(TF_THREADS, (BR == 64 && NT <= 8) ? 2 : 1)
    dq_tf32_kernel(const TfArgs a) {
  constexpr int W = 8 * NT, LD = W + PAD;
  constexpr int RG = BR / 16;          // row groups of 16 q rows
  constexpr int KS = TF_WARPS / RG;    // warps sharing a row group
  constexpr int KW = BR / KS;          // keys of a tile a warp takes
  constexpr int KT = KW / 8;           // 8-key blocks of them
  constexpr int STAGE = 2 * BR * LD;   // K and V of one ring stage
  extern __shared__ __align__(16) float smem[];
  const int S = a.S, H = a.H;
  float* qs = smem;                           // BR x LD
  float* dos = qs + BR * LD;                  // BR x LD
  float* ring = dos + BR * LD;                // stages of K, V
  float* lse_s = ring + TF_STAGES * STAGE;    // BR
  float* del_s = lse_s + BR;                  // BR
  int* sq = reinterpret_cast<int*>(del_s + BR);   // BR
  int* sk = sq + BR;                              // stages x BR

  const int nq = S / BR;
  const int qt = a.causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / a.K);
  const int q0 = qt * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % RG) * 16, ks = warp / RG, kw0 = ks * KW;
  const int* segrow = a.seg ? a.seg + (long)b * S : nullptr;
  const long qrow = (long)b * S * H + h;          // row (b, 0, h) of q, dO
  const long krow = (long)b * S * a.K + kh;       // row (b, 0, kh) of k, v

  if (a.D < W || a.Dv < W) zero_smem(smem, (2 + TF_STAGES * 2) * BR * LD);
  const long q_at = qrow + (long)q0 * H;
  load_tile<BR, W>(qs, a.q + q_at * a.D, (long)H * a.D, a.D);
  load_tile<BR, W>(dos, a.dout + q_at * a.Dv, (long)H * a.Dv, a.Dv);
  load_vec(lse_s, a.lse + ((long)b * H + h) * S + q0, BR);
  load_vec(del_s, a.delta + ((long)b * H + h) * S + q0, BR);
  if (segrow && tid < BR) sq[tid] = segrow[q0 + tid];

  const int kt_end = a.causal ? qt + 1 : nq;
  auto next = [&](int kt) {
    while (kt < kt_end &&
           !tile_needed<BR>(a.causal, a.window, segrow, q0, kt * BR))
      ++kt;
    return kt;
  };
  auto load_kv = [&](int stage, int kt) {
    float* kd = ring + stage * STAGE;
    const long r = krow + (long)kt * BR * a.K;
    load_tile<BR, W>(kd, a.k + r * a.D, (long)a.K * a.D, a.D);
    load_tile<BR, W>(kd + BR * LD, a.v + r * a.Dv, (long)a.K * a.Dv, a.Dv);
    if (segrow && tid < BR) sk[stage * BR + tid] = segrow[kt * BR + tid];
  };

  float acc[NT][4];
  zero(acc);
  int kt = next(0), stage = 0;
  if (kt < kt_end) load_kv(0, kt);
  cp_commit();
  const float scale_log2 = a.scale * LOG2E;
  float lse2[2], del[2];                // this thread's rows g and g + 8
  bool own = false;                     // the block's own rows are read
  while (kt < kt_end) {
    const int kn = next(kt + 1);
    if (kn < kt_end) load_kv(stage ^ 1, kn);
    cp_commit();
    cp_wait<1>();                       // this tile (and the block's own)
    __syncthreads();
    if (!own) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        lse2[hr] = lse_s[r0 + g + 8 * hr] * LOG2E;
        del[hr] = del_s[r0 + g + 8 * hr];
      }
      own = true;
    }
    const float* kd = ring + stage * STAGE;
    const float* vd = kd + BR * LD;
    const int* skd = sk + stage * BR;
    const int k0 = kt * BR;

    // S = Q K^T and dP = dO V^T over the warp's keys, then
    // P = 2^(S scale log2e - lse log2e), 0 at masked pairs;
    // dS = P (dP - delta), split into A fragments of the warp's keys
    float s[KT][4], dp[KT][4];
    product_rows<KT, LD, W>(s, qs, r0, kd, kw0, g, t);
    product_rows<KT, LD, W>(dp, dos, r0, vd, kw0, g, t);
    const bool mask = tile_masked<BR>(a.causal, a.window, segrow, q0, k0);
    uint32_t dsh[KT][4], dsl[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, r = r0 + g + 8 * hr;
        const int c = kw0 + 8 * j + 2 * t + (e & 1);
        float x = fmaf(s[j][e], scale_log2, -lse2[hr]);
        if (mask && !kept(a, q0 + r, k0 + c, segrow ? sq[r] : 0,
                          segrow ? skd[c] : 0))
          x = minus_inf();
        s[j][e] = ex2(x) * (dp[j][e] - del[hr]);
      }
      acc_as_a(s[j], dsh[j], dsl[j]);
    }
    product_cols<NT, KT, LD>(acc, dsh, dsl, kd, kw0, g, t);   // dQ += dS K
    __syncthreads();                    // this stage's readers are done
    stage ^= 1;
    kt = kn;
  }
  cp_wait<0>();
  __syncthreads();                      // qs is free: the partials' sum
  // the KS partials of a row group, added in a fixed order (KS-1 first)
  for (int w = KS - 1; w > 0; --w) {
    if (ks == w) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* p = qs + (r0 + g + 8 * (e >> 1)) * LD + 8 * n + 2 * t +
                     (e & 1);
          *p = w == KS - 1 ? acc[n][e] : acc[n][e] + *p;
        }
    }
    __syncthreads();
  }
  if (ks != 0) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    float* out = a.dq + (qrow + (long)(q0 + r) * H) * a.D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < a.D) {
        float x0 = acc[n][2 * hr], x1 = acc[n][2 * hr + 1];
        if (KS > 1) {
          x0 += qs[r * LD + c];
          x1 += qs[r * LD + c + 1];
        }
        // S was taken against q, so dQ carries the scale once
        *reinterpret_cast<float2*>(out + c) =
            make_float2(x0 * a.scale, x1 * a.scale);
      }
    }
  }
}

// ------------------------------------------------------------- dK/dV ----
// NT: 8-column blocks of W, the width D and Dv are padded to; BR: rows of a
// k tile and of a q tile; MODE: BOTH, DV_ONLY or DK_ONLY
template <int NT, int BR, int MODE>
__global__ void __launch_bounds__(TF_THREADS, (BR == 64 && NT <= 8) ? 2 : 1)
    dkv_tf32_kernel(const TfArgs a) {
  constexpr int W = 8 * NT, LD = W + PAD;
  constexpr int RG = BR / 16;          // row groups of 16 keys
  constexpr int QS = TF_WARPS / RG;    // warps sharing a row group
  constexpr int QW = BR / QS;          // q rows of a tile a warp takes
  constexpr int QT = QW / 8;           // 8-row blocks of them
  constexpr int STAGE = 2 * BR * LD + 2 * BR;   // Q, dO, lse, delta
  constexpr bool DO_DV = MODE != DK_ONLY, DO_DK = MODE != DV_ONLY;
  constexpr int NV = DO_DV ? NT : 1, NK = DO_DK ? NT : 1;
  extern __shared__ __align__(16) float smem[];
  const int S = a.S, H = a.H, K = a.K, rep = H / K;
  float* ks_ = smem;                          // BR x LD
  float* vs = ks_ + BR * LD;                  // BR x LD
  float* ring = vs + BR * LD;                 // stages of Q, dO, lse, delta
  int* sk = reinterpret_cast<int*>(ring + TF_STAGES * STAGE);   // BR
  int* sq = sk + BR;                                            // stages

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % RG) * 16, qsub = warp / RG, qw0 = qsub * QW;
  const int* segrow = a.seg ? a.seg + (long)b * S : nullptr;
  const long krow = (long)b * S * K + kvh;        // row (b, 0, kvh) of k, v

  if (a.D < W || a.Dv < W)
    zero_smem(smem, 2 * BR * LD + TF_STAGES * STAGE);
  const long k_at = krow + (long)k0 * K;
  load_tile<BR, W>(ks_, a.k + k_at * a.D, (long)K * a.D, a.D);
  if (DO_DK) load_tile<BR, W>(vs, a.v + k_at * a.Dv, (long)K * a.Dv, a.Dv);
  if (segrow && tid < BR) sk[tid] = segrow[k0 + tid];

  const int nq = S / BR, qt_begin = a.causal ? kt : 0;
  const int total = rep * nq;                     // (head r, q tile) pairs
  auto next = [&](int it) {
    for (; it < total; ++it) {
      const int qt = it % nq;
      if (qt >= qt_begin &&
          tile_needed<BR>(a.causal, a.window, segrow, qt * BR, k0))
        break;
    }
    return it;
  };
  auto load_q = [&](int stage, int it) {
    float* qd = ring + stage * STAGE;
    const int h = kvh * rep + it / nq, q0 = (it % nq) * BR;
    const long r = (long)b * S * H + (long)q0 * H + h;
    load_tile<BR, W>(qd, a.q + r * a.D, (long)H * a.D, a.D);
    load_tile<BR, W>(qd + BR * LD, a.dout + r * a.Dv, (long)H * a.Dv, a.Dv);
    float* ld = qd + 2 * BR * LD;
    load_vec(ld, a.lse + ((long)b * H + h) * S + q0, BR);
    load_vec(ld + BR, a.delta + ((long)b * H + h) * S + q0, BR);
    if (segrow && tid < BR) sq[stage * BR + tid] = segrow[q0 + tid];
  };

  float dk_acc[NK][4], dv_acc[NV][4];
  zero(dk_acc);
  zero(dv_acc);
  int it = next(0), stage = 0;
  if (it < total) load_q(0, it);
  cp_commit();
  const float scale_log2 = a.scale * LOG2E;
  while (it < total) {
    const int in = next(it + 1);
    if (in < total) load_q(stage ^ 1, in);
    cp_commit();
    cp_wait<1>();                       // this tile (and the block's own)
    __syncthreads();
    const float* qd = ring + stage * STAGE;
    const float* dod = qd + BR * LD;
    const float* lse_s = dod + BR * LD;
    const float* del_s = lse_s + BR;
    const int* sqd = sq + stage * BR;
    const int q0 = (it % nq) * BR;

    // S^T = K Q^T and dP^T = V dO^T over the warp's q rows, then
    // P^T = 2^(S^T scale log2e - lse[q] log2e), 0 at masked pairs, in s;
    // dS^T = P^T (dP^T - delta[q]), in dp
    float s[QT][4], dp[QT][4];
    product_rows<QT, LD, W>(s, ks_, r0, qd, qw0, g, t);
    if (DO_DK) product_rows<QT, LD, W>(dp, vs, r0, dod, qw0, g, t);
    const bool mask = tile_masked<BR>(a.causal, a.window, segrow, q0, k0);
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = qw0 + 8 * j + 2 * t + (e & 1);
        float x = fmaf(s[j][e], scale_log2, -lse_s[c] * LOG2E);
        if (mask && !kept(a, q0 + c, k0 + r, segrow ? sqd[c] : 0,
                          segrow ? sk[r] : 0))
          x = minus_inf();
        const float p = ex2(x);
        s[j][e] = p;
        if (DO_DK) dp[j][e] = p * (dp[j][e] - del_s[c]);
      }
    if (DO_DV) {                                   // dV += P^T dO
      uint32_t fh[QT][4], fl[QT][4];
#pragma unroll
      for (int j = 0; j < QT; ++j) acc_as_a(s[j], fh[j], fl[j]);
      product_cols<NV, QT, LD>(dv_acc, fh, fl, dod, qw0, g, t);
    }
    if (DO_DK) {                                   // dK += dS^T Q
      uint32_t fh[QT][4], fl[QT][4];
#pragma unroll
      for (int j = 0; j < QT; ++j) acc_as_a(dp[j], fh[j], fl[j]);
      product_cols<NK, QT, LD>(dk_acc, fh, fl, qd, qw0, g, t);
    }
    __syncthreads();                    // this stage's readers are done
    stage ^= 1;
    it = in;
  }
  cp_wait<0>();
  __syncthreads();                      // the ring is free: the partials
  // the QS partials of a row group, added in a fixed order (QS-1 first):
  // dK at column c of row r in red[r][c], dV in red[r][W + c]
  float* red = ring;
  constexpr int LDR = 2 * W;
  for (int w = QS - 1; w > 0; --w) {
    if (qsub == w) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* row = red + (r0 + g + 8 * (e >> 1)) * LDR + 2 * t + (e & 1);
        if (DO_DK) {
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            float* p = row + 8 * n;
            *p = w == QS - 1 ? dk_acc[n][e] : dk_acc[n][e] + *p;
          }
        }
        if (DO_DV) {
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            float* p = row + W + 8 * n;
            *p = w == QS - 1 ? dv_acc[n][e] : dv_acc[n][e] + *p;
          }
        }
      }
    }
    __syncthreads();
  }
  if (qsub != 0) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    const long row = k_at + (long)r * K;
    const float* sum = red + r * LDR;
    if (DO_DK) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < a.D) {
          float x0 = dk_acc[n][2 * hr], x1 = dk_acc[n][2 * hr + 1];
          if (QS > 1) {
            x0 += sum[c];
            x1 += sum[c + 1];
          }
          // S^T was taken against q, so dK carries the scale once
          *reinterpret_cast<float2*>(a.dk + row * a.D + c) =
              make_float2(x0 * a.scale, x1 * a.scale);
        }
      }
    }
    if (DO_DV) {
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < a.Dv) {
          float x0 = dv_acc[n][2 * hr], x1 = dv_acc[n][2 * hr + 1];
          if (QS > 1) {
            x0 += sum[W + c];
            x1 += sum[W + c + 1];
          }
          *reinterpret_cast<float2*>(a.dv + row * a.Dv + c) =
              make_float2(x0, x1);
        }
      }
    }
  }
}

// dynamic shared memory of a dQ (kernel 0) or dK/dV (kernel 1) block;
// flash_attention.bwd_tf32_smem mirrors it: three tiles' worth (the
// block's own, two ring stages) of two BR x (W + PAD) f32 tiles, the lse
// and delta rows (once for dQ, a stage each for dK/dV) and three tiles'
// segment ids
size_t tf32_smem(int kernel, int D, int Dv, int BR) {
  const size_t ld = 8 * tf32_blocks(D, Dv) + PAD;
  const size_t lse_rows = kernel == 0 ? 1 : TF_STAGES;
  return sizeof(float) * ((1 + TF_STAGES) * 2 * BR * ld + lse_rows * 2 * BR) +
         sizeof(int) * (1 + TF_STAGES) * BR;
}

int dq_dispatch(const TfArgs& a, int B, int rows, cudaStream_t st) {
  const dim3 grid(a.S / rows, a.H, B);
  const size_t smem = tf32_smem(0, a.D, a.Dv, rows);
  auto go = [&](auto kern) { return tf32_launch(kern, smem, grid, a, st); };
  switch (tf32_blocks(a.D, a.Dv)) {
    case 4: return go(dq_tf32_kernel<4, 64>);
    case 8: return go(dq_tf32_kernel<8, 64>);
    case 12: return go(dq_tf32_kernel<12, 64>);
    case 16: return go(dq_tf32_kernel<16, 64>);
    case 24: return go(dq_tf32_kernel<24, 32>);
    default: return go(dq_tf32_kernel<32, 32>);
  }
}

template <int NT>
int dkv_two_passes(const TfArgs& a, dim3 grid, size_t smem, cudaStream_t st) {
  const int rc =
      tf32_launch(dkv_tf32_kernel<NT, 32, DV_ONLY>, smem, grid, a, st);
  if (rc) return rc;
  return tf32_launch(dkv_tf32_kernel<NT, 32, DK_ONLY>, smem, grid, a, st);
}

int dkv_dispatch(const TfArgs& a, int B, int rows, cudaStream_t st) {
  const dim3 grid(a.S / rows, a.K, B);
  const size_t smem = tf32_smem(1, a.D, a.Dv, rows);
  auto go = [&](auto kern) { return tf32_launch(kern, smem, grid, a, st); };
  switch (tf32_blocks(a.D, a.Dv)) {       // 64 rows: one launch
    case 4: return go(dkv_tf32_kernel<4, 64, BOTH>);
    case 8: return go(dkv_tf32_kernel<8, 64, BOTH>);
    case 12: return go(dkv_tf32_kernel<12, 64, BOTH>);
    case 16: return go(dkv_tf32_kernel<16, 64, BOTH>);
    case 24: return dkv_two_passes<24>(a, grid, smem, st);
    default: return dkv_two_passes<32>(a, grid, smem, st);
  }
}

// the head dims the route takes (multiples of 8 in [8, 256]) and the row
// tile flash_attention.bwd_rows gives them
bool bad_tf32_dims(int dtype, int S, int H, int K, int D, int Dv, int rows) {
  const int widest = D > Dv ? D : Dv;
  return dtype != 0 || rows != (widest <= 128 ? 64 : 32) || S < rows ||
         S % rows || K < 1 || H % K || !tf32_head_dim(D) ||
         !tf32_head_dim(Dv);
}

}  // namespace

extern "C" {

// q (B,S,H,D), k (B,S,K,D), v (B,S,K,Dv), dout (B,S,H,Dv), dq (B,S,H,D),
// all f32 (`dtype` 0), contiguous and 16-byte aligned; lse, delta (B,H,S)
// f32, 16-byte aligned; seg (B,S) int32 or null. `rows` is the row tile,
// 64 (max(D, Dv) <= 128) or 32; S % rows == 0, H % K == 0, D and Dv
// multiples of 8 in [8, 256]. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernels do not take).
int tri_flash_bwd_dq_tf32(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const int* seg, void* dq,
                          int dtype, int B, int S, int H, int K, int D, int Dv,
                          int causal, int window, float scale, int rows,
                          void* stream) {
  if (B < 1 || bad_tf32_dims(dtype, S, H, K, D, Dv, rows))
    return (int)cudaErrorInvalidValue;
  const TfArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(dout),
                 lse, delta, seg, static_cast<float*>(dq), nullptr, nullptr,
                 S, H, K, D, Dv, causal, window, scale};
  return dq_dispatch(a, B, rows, static_cast<cudaStream_t>(stream));
}

// as tri_flash_bwd_dq_tf32, writing dk (B,S,K,D) and dv (B,S,K,Dv); above
// head dim 128 two launches (dV, then dK)
int tri_flash_bwd_dkv_tf32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const int* seg, void* dk,
                           void* dv, int dtype, int B, int S, int H, int K,
                           int D, int Dv, int causal, int window, float scale,
                           int rows, void* stream) {
  if (B < 1 || bad_tf32_dims(dtype, S, H, K, D, Dv, rows))
    return (int)cudaErrorInvalidValue;
  const TfArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(dout),
                 lse, delta, seg, nullptr, static_cast<float*>(dk),
                 static_cast<float*>(dv), S, H, K, D, Dv, causal, window,
                 scale};
  return dkv_dispatch(a, B, rows, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of a dQ (kernel 0) or dK/dV (kernel 1) block at
// these head dims and row tile, bytes: lets a caller check the mirror in
// flash_attention.bwd_tf32_smem
long tri_flash_bwd_tf32_smem(int kernel, int D, int Dv, int rows) {
  return (long)tf32_smem(kernel, D, Dv, rows);
}

}  // extern "C"
