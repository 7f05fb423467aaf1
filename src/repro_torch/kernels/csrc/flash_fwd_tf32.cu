// Flash attention forward for Hopper (sm_90a), f32 inputs on the tensor
// cores in split TF32 ("3xTF32"): both products on mma.sync m16n8k8 tf32,
// the scores and the online softmax in registers, a two-stage cp.async
// ring for the key and value tiles.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   tri_flash_fwd_tf32 <- _fwd_call (_fwd_body: causal, static window,
//                         optional segments, optional LSE residual), for
//                         f32 inputs with head dims D, Dv each a multiple
//                         of 8 up to 256.
// bf16 inputs take flash_fwd_sm90.cu, other head dims the SIMT kernel of
// flash_attention.cu (flash_attention.fwd_route picks, from the dtype and
// the head dims alone; the backward's bwd_route is the same rule, so an f32
// call runs forward and backward on the split-TF32 kernels).
//
// What it computes: o = softmax(scale Q K^T, masked) V a row, with the
// reference's finite NEG_INF = -2e38 at masked pairs and its online
// softmax over key tiles (a row whose kept keys have not come yet takes
// p = 1 at masked pairs and is wiped by corr = 0 later, exactly as on the
// TPU); o divided by max(l, 1e-30), and with an lse pointer the
// natural-log LSE m + log(l) (B, H, S) that the backward rebuilds P from.
//
// What bounds it on this card. A causal pair costs 2 (D + Dv) flops
// against a few bytes a row: far above the ~148 flops a byte (TF32) where
// bytes would bound. Each product runs as three tf32 mma (tf32.cuh), so
// the bound is the dense TF32 rate (495 TFLOP/s) over three times the
// flops; the f32 rate outside the tensor cores (67 TFLOP/s) is the
// SIMT kernel's.
//
// Design (the split arithmetic, fragment loaders and flushes of tf32.cuh,
// as in the backward of flash_bwd_tf32.cu):
//   * One block of 8 warps per (q head, 64 q rows, batch row). The q tile
//     loads once into shared memory; the needed BK-key tiles of K and V
//     (_block_needed) stream through a two-stage cp.async ring, the next
//     tile loading while the tensor cores run on this one. GQA: head h
//     reads kv head h / (H/K).
//   * Warp w takes the 16 q rows (w mod 4) and half of each key tile's
//     keys (w / 4): S = Q K^T for those keys lives in its registers, is
//     scaled by scale log2e, masked (only on tiles holding a masked pair)
//     and goes through the online softmax there (rows g and g+8 of a lane,
//     their max over the lane's quad by shuffles, P = 2^(S - m) by
//     ex2.approx). P is split and goes from the accumulator into the A
//     fragment of P V by the renamed contraction index: it never leaves
//     registers. Each warp keeps its own (m, l, O) over its keys; at the
//     end the two halves of a row group merge in a fixed order through
//     shared memory (m = max, each side scaled by 2^(m_side - m)), so a
//     half whose keys were all masked is wiped by a factor 0.
//   * Flushes: P V of a key tile goes into a zeroed fragment on the tensor
//     cores and is added to O corr in f32 (product_cols); S is flushed
//     every 64 columns above width 128 (product_rows). The tensor cores'
//     own sums truncate, and a sum over the whole sequence in one
//     accumulator would carry that bias past the tolerance.
//   * Widths. D and Dv are padded to one compile-time width W = 8 NT (32,
//     64, 96, 128; 192, 256) with zero columns; key tiles BK are 64 keys
//     up to W 128 and 32 above, so the shared tiles fit (fwd_smem below).
//   * Registers: the O accumulator takes W/2 a thread (128 at W 256, one
//     block an SM); up to W 64 two blocks share an SM.
//   * Each output row has one owner and every sum runs in a fixed order:
//     results repeat bitwise.
//   * The grid runs heads fastest, and causal grids put the longest q
//     tiles first: at B 1 the 144 blocks of S 1024, 9 heads are one
//     partial wave, and the last blocks handed out (an SM's second) are
//     the shortest, not the second-longest of one head.
//
// Shared memory (flash_attention.fwd_tf32_smem mirrors fwd_smem below):
// the q tile and two ring stages of K and V, (64 + 4 BK) rows of W + 4
// floats, and the segment ids of the q tile and the two stages. At D = Dv
// = 64, BK 64: 87,808 B (two blocks an SM); at 128, BK 64: 169,728 B; at
// 256, BK 32: 200,192 B, under the 232,448 B a block may use.
//
// Tolerance against the plain PyTorch version (flash_attention.py): each
// operand's split keeps it to ~2^-21, ex2.approx is within 2 ulp, and the
// sums run in another order: within flash_attention.tolerance (1e-5 of
// the largest magnitude plus 1e-5 relative), the LSE within 1e-5 of
// 1 + its largest magnitude.
#include "tf32.cuh"

namespace {

constexpr int BQ = 64;                 // query rows a block
constexpr int RG = BQ / 16;            // row groups of 16, a warp each
constexpr int KS = TF_WARPS / RG;      // warps sharing a row group's keys
constexpr float NEG_INF = -2.0e38f;

struct FwdArgs {
  const float* q;        // (B, S, H, D)
  const float* k;        // (B, S, K, D)
  const float* v;        // (B, S, K, Dv)
  const int* seg;        // (B, S) or null
  float* o;              // (B, S, H, Dv)
  float* lse;            // (B, H, S) or null
  int S, H, K, D, Dv, causal, window;
  float scale_log2;      // scale * log2(e)
};

// _tile_mask for one (query, key) pair, segment ids sq / sk
__device__ __forceinline__ bool kept(const FwdArgs& a, int qp, int kp, int sq,
                                     int sk) {
  const int d = qp - kp;
  return (!a.causal || d >= 0) && (a.window <= 0 || d < a.window) &&
         (!a.seg || sq == sk);
}

// keys a tile at NT 8-column blocks of width
constexpr int key_rows(int nt) { return nt <= 16 ? 64 : 32; }

// NT: 8-column blocks of W, the width D and Dv are padded to; BK: keys of
// a tile
template <int NT, int BK>
__global__ void __launch_bounds__(TF_THREADS, NT <= 8 ? 2 : 1)
    fwd_tf32_kernel(const FwdArgs a) {
  constexpr int W = 8 * NT, LD = W + PAD;
  constexpr int KW = BK / KS;          // keys of a tile a warp takes
  constexpr int KT = KW / 8;           // 8-key blocks of them
  constexpr int STAGE = 2 * BK * LD;   // K and V of one ring stage
  extern __shared__ __align__(16) float smem[];
  const int S = a.S, H = a.H;
  float* qs = smem;                                             // BQ x LD
  float* ring = qs + BQ * LD;                                   // K, V
  int* sq = reinterpret_cast<int*>(ring + TF_STAGES * STAGE);   // BQ
  int* sk = sq + BQ;                                  // stages x BK

  const int nq = S / BQ;
  const int qt = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int h = blockIdx.x, b = blockIdx.z, kh = h / (H / a.K);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % RG) * 16, ks = warp / RG, kw0 = ks * KW;
  const int* segrow = a.seg ? a.seg + (long)b * S : nullptr;
  const long qrow = (long)b * S * H + h;          // row (b, 0, h) of q, o
  const long krow = (long)b * S * a.K + kh;       // row (b, 0, kh) of k, v

  if (a.D < W || a.Dv < W) zero_smem(smem, (BQ + TF_STAGES * 2 * BK) * LD);
  load_tile<BQ, W>(qs, a.q + (qrow + (long)q0 * H) * a.D, (long)H * a.D,
                   a.D);
  if (segrow && tid < BQ) sq[tid] = segrow[q0 + tid];

  const int nk = S / BK;
  const int kt_end = a.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const int kt_begin =
      a.window > 0 ? max(0, (q0 - (a.window - 1)) / BK) : 0;
  auto next = [&](int kt) {
    while (kt < kt_end && !tile_needed<BQ, BK>(a.causal, a.window, segrow,
                                               q0, kt * BK))
      ++kt;
    return kt;
  };
  auto load_kv = [&](int stage, int kt) {
    float* kd = ring + stage * STAGE;
    const long r = krow + (long)kt * BK * a.K;
    load_tile<BK, W>(kd, a.k + r * a.D, (long)a.K * a.D, a.D);
    load_tile<BK, W>(kd + BK * LD, a.v + r * a.Dv, (long)a.K * a.Dv, a.Dv);
    if (segrow && tid < BK) sk[stage * BK + tid] = segrow[kt * BK + tid];
  };

  float o[NT][4];
  zero(o);
  // rows g and g + 8: running max (log2 units) and this lane's share of
  // the row sum
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  int kt = next(kt_begin), stage = 0;
  if (kt < kt_end) load_kv(0, kt);
  cp_commit();
  while (kt < kt_end) {
    const int kn = next(kt + 1);
    if (kn < kt_end) load_kv(stage ^ 1, kn);
    cp_commit();
    cp_wait<1>();                       // this tile (and the q tile)
    __syncthreads();
    const float* kd = ring + stage * STAGE;
    const float* vd = kd + BK * LD;
    const int* skd = sk + stage * BK;
    const int k0 = kt * BK;

    // S = Q K^T over the warp's keys, scaled to log2 units and masked
    // (one uniform branch: only tiles that hold a masked pair)
    float s[KT][4];
    product_rows<KT, LD, W>(s, qs, r0, kd, kw0, g, t);
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= a.scale_log2;
    if (tile_masked<BQ, BK>(a.causal, a.window, segrow, q0, k0)) {
      const int r = r0 + g;
      const int sq0 = segrow ? sq[r] : 0, sq1 = segrow ? sq[r + 8] : 0;
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, c = kw0 + 8 * j + 2 * t + (e & 1);
          if (!kept(a, q0 + r + 8 * hr, k0 + c, hr ? sq1 : sq0,
                    segrow ? skd[c] : 0))
            s[j][e] = NEG_INF;
        }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    // the online softmax: new max over the quad, corr = 2^(m - m_new)
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float mn = fmaxf(m[hr], mx[hr]);
      corr[hr] = ex2(m[hr] - mn);
      m[hr] = mn;
      l[hr] *= corr[hr];
    }
    // P = 2^(S - m), summed into l and split into A fragments
    uint32_t ph[KT][4], pl[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
      acc_as_a(s[j], ph[j], pl[j]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    product_cols<NT, KT, LD>(o, ph, pl, vd, kw0, g, t);    // O += P V
    __syncthreads();                    // this stage's readers are done
    stage ^= 1;
    kt = kn;
  }
  cp_wait<0>();
  __syncthreads();                      // qs and the ring are free

  // the KS halves of a row group merge in a fixed order (KS-1 first): the
  // partial O in red_o (the q tile's place), m and l in red_ml
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  float* red_o = qs;
  float* red_ml = ring;
  for (int w = KS - 1; w >= 0; --w) {
    if (ks == w) {
      if (w < KS - 1) {
        float fa[2], fb[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + g + 8 * hr;
          const float mb = red_ml[r], mn = fmaxf(m[hr], mb);
          fa[hr] = ex2(m[hr] - mn);
          fb[hr] = ex2(mb - mn);
          l[hr] = l[hr] * fa[hr] + red_ml[BQ + r] * fb[hr];
          m[hr] = mn;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* p = red_o + (r0 + g + 8 * (e >> 1)) * LD + 8 * n +
                             2 * t + (e & 1);
            o[n][e] = o[n][e] * fa[e >> 1] + *p * fb[e >> 1];
          }
        __syncwarp();                   // every lane has read its rows
      }
      if (w > 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red_o[(r0 + g + 8 * (e >> 1)) * LD + 8 * n + 2 * t + (e & 1)] =
                o[n][e];
        if (t == 0)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            red_ml[r0 + g + 8 * hr] = m[hr];
            red_ml[BQ + r0 + g + 8 * hr] = l[hr];
          }
      }
    }
    if (w > 0) __syncthreads();
  }
  if (ks != 0) return;

  // o = O / max(l, 1e-30); lse = m ln 2 + log(l), natural log
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    const float lc = fmaxf(l[hr], 1e-30f);
    float* out = a.o + (qrow + (long)(q0 + r) * H) * a.Dv;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < a.Dv)
        *reinterpret_cast<float2*>(out + c) =
            make_float2(o[n][2 * hr] / lc, o[n][2 * hr + 1] / lc);
    }
    if (a.lse && t == 0)
      a.lse[((long)b * H + h) * S + q0 + r] = m[hr] * LN2 + logf(lc);
  }
}

// dynamic shared memory of a block; flash_attention.fwd_tf32_smem mirrors
// it: the q tile and two ring stages of K and V tiles, rows of W + PAD
// floats, and the segment ids of the q tile and of each stage
size_t fwd_smem(int D, int Dv) {
  const int nt = tf32_blocks(D, Dv);
  const size_t ld = 8 * nt + PAD, bk = key_rows(nt);
  return sizeof(float) * (BQ + TF_STAGES * 2 * bk) * ld +
         sizeof(int) * (BQ + TF_STAGES * bk);
}

int fwd_dispatch(const FwdArgs& a, int B, cudaStream_t st) {
  const dim3 grid(a.H, a.S / BQ, B);          // heads fastest
  const size_t smem = fwd_smem(a.D, a.Dv);
  auto go = [&](auto kern) { return tf32_launch(kern, smem, grid, a, st); };
  switch (tf32_blocks(a.D, a.Dv)) {
    case 4: return go(fwd_tf32_kernel<4, key_rows(4)>);
    case 8: return go(fwd_tf32_kernel<8, key_rows(8)>);
    case 12: return go(fwd_tf32_kernel<12, key_rows(12)>);
    case 16: return go(fwd_tf32_kernel<16, key_rows(16)>);
    case 24: return go(fwd_tf32_kernel<24, key_rows(24)>);
    default: return go(fwd_tf32_kernel<32, key_rows(32)>);
  }
}

}  // namespace

extern "C" {

// q (B,S,H,D), k (B,S,K,D), v (B,S,K,Dv), o (B,S,H,Dv), all f32 (`dtype`
// 0), contiguous and 16-byte aligned; seg (B,S) int32 or null; lse (B,H,S)
// f32 or null. S % 64 == 0, H % K == 0, D and Dv multiples of 8 in
// [8, 256]. Returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernel does not take). The arguments are tri_flash_fwd's
// (flash_attention.cu).
int tri_flash_fwd_tf32(const void* q, const void* k, const void* v,
                       const int* seg, void* o, float* lse, int dtype, int B,
                       int S, int H, int K, int D, int Dv, int causal,
                       int window, float scale, void* stream) {
  if (dtype != 0 || B < 1 || S < BQ || S % BQ || K < 1 || H % K ||
      !tf32_head_dim(D) || !tf32_head_dim(Dv))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), seg, static_cast<float*>(o),
                  lse, S, H, K, D, Dv, causal, window, scale * LOG2E};
  return fwd_dispatch(a, B, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of a block at these head dims, bytes: lets a
// caller check the mirror in flash_attention.fwd_tf32_smem
long tri_flash_fwd_tf32_smem(int D, int Dv) { return (long)fwd_smem(D, Dv); }

}  // extern "C"
