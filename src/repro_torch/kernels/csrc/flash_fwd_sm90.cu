// Flash attention forward for Hopper (sm_90a) on the bf16 tensor cores:
// wgmma for both products, TMA for every tile load.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   tri_flash_fwd_tc <- _fwd_call (_fwd_body: causal, static window,
//                       optional segments, optional LSE residual), for
//                       bf16 inputs with head dims D, Dv each a multiple of
//                       16 up to 256. f32 inputs and other head dims take
//                       the SIMT kernel of flash_attention.cu
//                       (flash_attention.fwd_route picks, from the dtype
//                       and the head dims alone).
//
// What bounds it on this card. Causal attention over S keys does
// 2 * S(S+1)/2 * (D + Dv) flops a head against ~2 * S * (2D + 2Dv) bytes:
// far above the H100's ~295 flops a byte, so the bf16 tensor cores
// (989 TFLOP/s dense) bound it. At D 64 the softmax's exponentials come
// close behind: one ex2 a score on the special-function units (16 a clock
// an SM, ~3.9e12 a second on 132 SMs), 3.8e7 of them at B 8, S 1024, 9
// heads, ~10 us against the 9.8 us the tensor cores need.
//
// Design. One block per (64 query rows, q head, batch row): one consumer
// warpgroup (128 threads) that owns the 64 rows, and one producer warp.
//   * Loads. The producer's first lane issues TMA loads: the q tile once,
//     then the k/v tiles of the q head's kv head (GQA: head h reads kv head
//     h / (H/K)) into a ring of 2 stages, each completing on a "full"
//     mbarrier; the consumers release a stage on its "empty" mbarrier. The
//     tensor maps are 4-D over (D, heads, S, B) with 128-byte swizzle, so a
//     box is 64 rows x 64 columns of one head (8 KB); a head dim above 64
//     takes ceil(D/64) boxes a tile, and a head dim below a multiple of 64
//     is zero-filled by the TMA (out of bounds), which adds 0 to both
//     products. The maps are encoded on the host through
//     cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint (no
//     -lcuda), and passed as __grid_constant__ parameters. These pieces,
//     the descriptors and the wgmma/mbarrier wrappers live in sm90.cuh,
//     shared with the backward (flash_bwd_sm90.cu).
//   * S = Q K^T: D/16 wgmma m64n64k16 from shared memory (both operands
//     K-major, 128-byte swizzle descriptors matching the TMA's), f32
//     accumulators in registers (32 a thread: rows lane/4 and lane/4 + 8 of
//     the warp's 16, two columns of each 8-column block). The scores are
//     scaled in f32 after the product (scale * log2 e, so exp2 serves).
//   * Masks: only on tiles that hold a masked pair (the causal diagonal,
//     the window's edge, a tile spanning segments), in registers. Tiles no
//     pair of which is kept are skipped, as _block_needed skips them, by
//     producer and consumers alike.
//   * Online softmax in registers: row max and sum over the four threads of
//     a quad by shuffles, ex2 on the special-function units, the finite
//     NEG_INF = -2e38 at masked pairs (a row whose kept keys have not come
//     yet takes p = 1 there and is wiped by corr = 0 later, as on the TPU).
//   * O += P V: P goes to bf16 A fragments in registers (the accumulator
//     layout of S is the A-fragment layout of the product), split into
//     hi = bf16(p) and lo = bf16(p - hi), two wgmma m64n64k16 for each
//     64-column chunk of V (MN-major, trans-b). A single bf16 P would be
//     off the f32 P V of the plain version by up to 2^-9 of max|v| a term;
//     the split keeps it near 2^-17, inside flash_attention.tolerance.
//   * Output: o = acc / max(l, 1e-30) in bf16 from registers, and the LSE
//     m + log(l) in natural-log units, as the Pallas body writes them.
// The consumer waits on each product before the next step (no overlap of
// the softmax with the tensor cores inside a block; up to three blocks on
// an SM overlap each other), and the grid is independent blocks: no
// persistent grid, no clusters.
//
// Tolerance against the plain PyTorch version (flash_attention.py): the
// sums run in another order on the tensor cores, P V carries the hi/lo
// split's ~2^-17 relative error: ~1e-5 of the largest magnitude, plus one
// bf16 ulp of the output (flash_attention.tolerance).
#include "sm90.cuh"

namespace {

constexpr int BM = TILE;               // query rows a block
constexpr int BN = TILE;               // keys a tile
constexpr int STAGES = 2;              // k/v ring depth
constexpr int CONSUMERS = 128;         // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr float NEG_INF = -2.0e38f;

struct Params {
  const int* seg;          // (B, S) int32 or null
  __nv_bfloat16* o;        // (B, S, H, Dv)
  float* lse;              // (B, H, S) or null
  int S, H, K, D, Dv, causal, window;
  float scale_log2;        // scale * log2(e)
};

// ------------------------------------------------------------- kernel ---
// NV = 64-column chunks of V (Dv <= 64 * NV); q/k take ceil(D/64) chunks.
// Blocks an SM keeps: 3 at NV 1 (128 registers a thread, no spills; their
// softmax and products interleave on the SM's tensor cores), 2 at NV 2,
// 1 above (the O accumulator alone takes 32 * NV registers).
template <int NV>
__global__ void __launch_bounds__(THREADS, NV == 1 ? 3 : (NV == 2 ? 2 : 1))
    fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int NQ = (p.D + BOX - 1) / BOX;          // q/k chunks a tile
  uint8_t* q_s = smem;                           // NQ boxes
  uint8_t* k_s = q_s + NQ * BOX_BYTES;           // STAGES x NQ boxes
  uint8_t* v_s = k_s + STAGES * NQ * BOX_BYTES;  // STAGES x NV boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + STAGES * NV * BOX_BYTES);
  uint64_t* full = bars;                         // STAGES
  uint64_t* empty = bars + STAGES;               // STAGES
  uint64_t* q_full = bars + 2 * STAGES;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM;
  const int kh = h / (p.H / p.K);
  const int* segrow = p.seg ? p.seg + (long)b * p.S : nullptr;
  const int nk = p.S / BN;
  const int kt_end = p.causal ? min(nk, (q0 + BM - 1) / BN + 1) : nk;
  const int kt_begin =
      p.window > 0 ? max(0, (q0 - (p.window - 1)) / BN) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------ producer warp ----
    if (threadIdx.x != CONSUMERS) return;
    mbar_expect_tx(q_full, NQ * BOX_BYTES);
    for (int c = 0; c < NQ; ++c)
      tma_load(q_s + c * BOX_BYTES, &tq, q_full, c * BOX, h, q0, b);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * BN;
      if (!tile_needed(p.causal, p.window, segrow, q0, k0)) continue;
      mbar_wait(&empty[stage], phase ^ 1);   // the first round passes
      mbar_expect_tx(&full[stage], (NQ + NV) * BOX_BYTES);
      for (int c = 0; c < NQ; ++c)
        tma_load(k_s + (stage * NQ + c) * BOX_BYTES, &tk, &full[stage],
                 c * BOX, kh, k0, b);
      for (int c = 0; c < NV; ++c)
        tma_load(v_s + (stage * NV + c) * BOX_BYTES, &tv, &full[stage],
                 c * BOX, kh, k0, b);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // -------------------------------------------------- consumers ----------
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3;                      // column pair in a block
  const int r0 = warp * 16 + (lane >> 2);        // this thread's rows: r0
  const int r1 = r0 + 8;                         // and r0 + 8
  const int sq0 = segrow ? segrow[q0 + r0] : 0;
  const int sq1 = segrow ? segrow[q0 + r1] : 0;
  const int ksteps = p.D / 16;

  float o[NV][32];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;   // running max, log2 units
  float l0 = 0.f, l1 = 0.f;           // this thread's part of the row sums

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    if (!tile_needed(p.causal, p.window, segrow, q0, k0))   // uniform
      continue;
    mbar_wait(&full[stage], phase);
    const uint8_t* k_t = k_s + stage * NQ * BOX_BYTES;
    const uint8_t* v_t = v_s + stage * NV * BOX_BYTES;

    // S = Q K^T over the head dim, 16 at a time
    float s[32];
    wg_fence();
    for (int ks = 0; ks < ksteps; ++ks)
      wgmma_ss(s, kmajor_desc(q_s, ks), kmajor_desc(k_t, ks), ks > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(s);

#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= p.scale_log2;
    if (tile_masked(p.causal, p.window, segrow, q0, k0)) {   // uniform
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * tig + e;
          const int sk = segrow ? segrow[key] : 0;
          const int d0 = q0 + r0 - key, d1 = q0 + r1 - key;
          bool ok0 = true, ok1 = true;
          if (p.causal) {
            ok0 = ok0 && d0 >= 0;
            ok1 = ok1 && d1 >= 0;
          }
          if (p.window > 0) {
            ok0 = ok0 && d0 < p.window;
            ok1 = ok1 && d1 < p.window;
          }
          if (segrow) {
            ok0 = ok0 && sq0 == sk;
            ok1 = ok1 && sq1 == sk;
          }
          if (!ok0) s[4 * j + e] = NEG_INF;
          if (!ok1) s[4 * j + 2 + e] = NEG_INF;
        }
    }

    // online softmax over the two rows, a quad of threads a row
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = ex2(s[4 * j] - mn0);
      s[4 * j + 1] = ex2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = ex2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = ex2(s[4 * j + 3] - mn1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= corr0;
        o[c][4 * j + 1] *= corr0;
        o[c][4 * j + 2] *= corr1;
        o[c][4 * j + 3] *= corr1;
      }

    // P as bf16 hi + lo A fragments
    uint32_t ph[4][4], pl[4][4];
    frag_hilo(s, ph, pl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const uint64_t dv = mnmajor_desc(v_t, c, kk);
        wgmma_rs_n64(o[c], ph[kk], dv);
        wgmma_rs_n64(o[c], pl[kk], dv);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NV; ++c) fence_regs(o[c]);
    mbar_arrive(&empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // finalize: the row sums over the quad, o / max(l, 1e-30), lse
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int Dv = p.Dv;
  __nv_bfloat16* row0 = p.o + ((long)(b * p.S + q0 + r0) * p.H + h) * Dv;
  __nv_bfloat16* row1 = p.o + ((long)(b * p.S + q0 + r1) * p.H + h) * Dv;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * BOX + 8 * j + 2 * tig;
      if (col < Dv) {
        *reinterpret_cast<__nv_bfloat162*>(row0 + col) =
            __floats2bfloat162_rn(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
        *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
            __floats2bfloat162_rn(o[c][4 * j + 2] * inv1,
                                  o[c][4 * j + 3] * inv1);
      }
    }
  if (p.lse && tig == 0) {
    float* lrow = p.lse + ((long)b * p.H + h) * p.S + q0;
    lrow[r0] = m0 * LN2 + logf(l0);
    lrow[r1] = m1 * LN2 + logf(l1);
  }
}

// ------------------------------------------------------------- host -----
size_t fwd_tc_smem(int D, int NV) {
  const int NQ = (D + BOX - 1) / BOX;
  return 1024 + (size_t)BOX_BYTES * (NQ + STAGES * NQ + STAGES * NV) +
         sizeof(uint64_t) * (2 * STAGES + 1);
}

template <int NV>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int B, cudaStream_t st) {
  const size_t smem = fwd_tc_smem(p.D, NV);
  cudaError_t e = cudaFuncSetAttribute(
      fwd_tc_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.S / BM, p.H, B);
  fwd_tc_kernel<NV><<<grid, THREADS, smem, st>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,S,H,D), k (B,S,K,D), v (B,S,K,Dv), o (B,S,H,Dv), all bf16 and
// contiguous, 16-byte aligned; seg (B,S) int32 or null; lse (B,H,S) f32 or
// null. S % 64 == 0, H % K == 0, D and Dv multiples of 16 in [16, 256].
// Returns 0, a cudaError_t, -1 (no cuTensorMapEncodeTiled in the driver)
// or -(100 + CUresult) (a tensor map the driver refused).
int tri_flash_fwd_tc(const void* q, const void* k, const void* v,
                     const int* seg, void* o, float* lse, int B, int S, int H,
                     int K, int D, int Dv, int causal, int window, float scale,
                     void* stream) {
  if (S % BM || K < 1 || H % K || !tc_head_dim(D) || !tc_head_dim(Dv))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, B, S, H, D);
  if (!rc) rc = encode(&tk, k, B, S, K, D);
  if (!rc) rc = encode(&tv, v, B, S, K, Dv);
  if (rc) return rc;
  Params p{seg, static_cast<__nv_bfloat16*>(o), lse, S, H, K, D, Dv, causal,
           window, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((Dv + BOX - 1) / BOX) {
    case 1: return launch<1>(tq, tk, tv, p, B, st);
    case 2: return launch<2>(tq, tk, tv, p, B, st);
    case 3: return launch<3>(tq, tk, tv, p, B, st);
    default: return launch<4>(tq, tk, tv, p, B, st);
  }
}

}  // extern "C"
