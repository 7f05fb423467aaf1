// Flash attention backward for Hopper (sm_90a) on the bf16 tensor cores:
// dQ and dK/dV with wgmma for every product and TMA for every tile load.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py
// (flash_attention_bwd), for bf16 inputs with head dims D, Dv each a
// multiple of 16 up to 256:
//   tri_flash_bwd_dq_tc  <- _dq_kernel  (_dq_body: dQ over the needed k
//                                        tiles)
//   tri_flash_bwd_dkv_tc <- _dkv_kernel (_dkv_body: dK, dV summed over the
//                                        GQA group's q heads and q tiles)
// f32 inputs take the split-TF32 kernels of flash_bwd_tf32.cu, other head
// dims the SIMT kernels of flash_attention_bwd.cu (flash_attention.bwd_route
// picks, from the dtype and the head dims alone); delta stays in
// flash_attention_bwd.cu on every route.
//
// What they compute, from the forward's saved lse and delta = rowsum(dO O):
//   P = exp(scale Q K^T - lse), 0 at masked pairs; dS = P (dO V^T - delta)
//   dQ = scale dS K;  dK = scale dS^T Q;  dV = P^T dO,
// dK and dV summed over the H/K q heads of each kv head.
//
// What bounds them on this card. dQ does three 64 x 64 x D-class products
// a needed tile pair (Q K^T, dO V^T, dS K), dK/dV four (K Q^T, V dO^T,
// P^T dO, dS^T Q), against a few bytes a row: far above the H100's ~295
// flops a byte, so the bf16 tensor cores (989 TFLOP/s dense) bound both.
// The register-A products run twice (hi and lo, below): dQ issues 4 and
// dK/dV 6 product-equivalents a tile pair where the bound counts 3 and 4.
//
// Design. Blocks run in no order, so the reference's sequential grid axis
// (_dq_body over ki, _dkv_body over (r, qi)) becomes a loop inside the
// block, and each output tile has one owner: no float atomics, and the
// sums run in a fixed order, so they repeat bitwise from run to run.
// A block is one consumer warpgroup (128 threads) and one producer warp,
// whose first lane issues every load (sm90.cuh: tensor maps over (dim,
// heads, S, B), 64 x 64 boxes with 128-byte swizzle, a 2-stage ring of
// "full" / "empty" mbarriers).
//   * dQ: one block per (64 q rows, q head, batch row). Q and dO load once;
//     the K and V tiles of the head's kv head that _block_needed keeps
//     stream through the ring. S = Q K^T and dP = dO V^T are wgmma from
//     shared memory, both operands K-major; P and dS are
//     computed in registers (masks only on tiles that hold a masked pair);
//     dQ += dS K takes dS as register-A fragments and K as an MN-major
//     (trans-b) operand, the forward's P V pattern. The f32 accumulator is
//     scaled once and stored as bf16.
//   * dK/dV: one block per (64 keys, kv head, batch row), in the
//     transposed form, so P and dS never go through shared memory. K and V
//     load once; Q and dO tiles, with their rows' lse and delta (bulk
//     copies of 256 bytes), stream through the ring for each of the
//     group's H/K q heads and each needed q tile. S^T = K Q^T and
//     dP^T = V dO^T from shared memory; P^T = exp(S^T - lse[col]) and
//     dS^T = P^T (dP^T - delta[col]) index lse and delta by the column
//     (the q row); dV += P^T dO and dK += dS^T Q use register-A wgmma with
//     dO and Q MN-major. dK is scaled once at the end.
//   * Long GQA sums are split by q head. Where the caller gives f32
//     workspaces (B, S, H, *) (flash_attention.dkv_workspace does where a
//     block would sum more than 64 (q head, q tile) pairs, (H/K) (S/64)
//     of them), one block per (64 keys, q head, batch row) writes its
//     head's unscaled f32 partials there, and dkv_reduce_kernel sums each
//     group's heads in order, scales and rounds to bf16 once. One block
//     summing every pair of its group in one wgmma accumulator strayed
//     past the stated tolerance at recurrentgemma-2b's shape (rep 10,
//     S 4096, D 256: 640 pairs, 5,120 accumulations; 1 of 2.1 M dK
//     elements at window 2048, 9 dK and 3 dV unwindowed), more the longer
//     the sum; split, each chain is one head's q tiles long. At 64 pairs
//     and below (rep 2 at S 2048, rep 3 at S 1024, rep 1 at S 4096) one
//     accumulator held the tolerance, and split always, gemma3-4b's shape
//     (rep 2, S 2048) took 1.01 ms on an H100, so those sums stay whole.
//     The kernel is a template on SPLIT, so whole sums run the unsplit
//     code alone (a runtime switch in one instantiation slowed them at
//     head dims 192 and 256). The head-dim-256 instantiation has no
//     registers to spare: a flush of the accumulators inside the loop
//     spilled.
//   * Causal grids put the longest blocks first: a dQ block's work grows
//     with its q tile, a dK/dV block's shrinks with its k tile, and the
//     tile index is the grid's slowest axis.
//   * Registers. A consumer thread holds its accumulators (32 f32 per
//     64 columns: dQ; dK and dV), S and dP (KN/2 f32 each) and the hi/lo
//     fragments of P and dS (KN/4 each), and an instantiation allows no
//     spills. So S and dP are taken over sub-tiles of KN keys (dQ) or q
//     rows (dK/dV) of each 64-row tile, each followed by its register-A
//     products: KN = 64, 32 or 16 (wgmma m64nKNk16), the narrower where
//     the registers are tight. Up to max(D, Dv) = 128 the dK/dV consumer
//     accumulates dK and dV in one pass over the q tiles. Above, the two
//     64 x 256 accumulators alone would take 256 registers a thread, so
//     the block makes two passes: dV first (S^T only), then dK (S^T and
//     dP^T), at most 128 accumulator registers in either; the second pass
//     reloads Q and dO and recomputes S^T (1.5x the loads and 1.25x the
//     products of one pass), with no second warpgroup.
//     KN is the widest of 64, 32, 16 at which ptxas reports no spills,
//     and a block takes the registers of two blocks an SM where they
//     suffice (head dims <= 64: one block's elementwise work then overlaps
//     the other's products), else of one. Instantiations (ptxas -v, CUDA
//     12.8, sm_90a; registers a thread, 0 bytes spilled in every one):
//       dQ    D <= 64: KN 64, 2 blocks an SM, 161 registers;
//             <= 128: KN 64, 1 block, 207;  <= 192: KN 64, 238;
//             <= 256: KN 32, 223
//       dK/dV max(D, Dv) <= 64: one pass, KN 32, 2 blocks an SM, 168;
//             <= 128: one pass, KN 32, 1 block, 239;
//             <= 192: two passes, KN 32, 225;  <= 256: two passes, KN 16,
//             254
//
// Shared memory (bwd_tc_smem in flash_attention.py mirrors dq_tc_smem and
// dkv_tc_smem below): 1024 bytes of alignment slack, (1 + 2 stages) x
// (ceil(D/64) + ceil(Dv/64)) boxes of 8 KB, the mbarriers, and for dK/dV two
// stages of lse and delta rows (1 KB). At D = Dv = 64: dQ 50,216 B, dK/dV
// 51,240 B; at 128: 99,368 / 100,392 B; at 256: 197,672 / 198,696 B, under
// the 232,448 B a block may use.
//
// Precision against the plain PyTorch versions (flash_attention.py, f32 over
// full (S, S) matrices). Q, K, V and dO are bf16, so S and dP on the tensor
// cores lose only summation order. P and dS enter the register-A products
// split into hi = bf16(x) and lo = bf16(x - hi) (sm90.cuh frag_hilo), two
// wgmma each: ~2^-17 relative a term. A single bf16 operand (2^-9 a term)
// breaks flash_attention.tolerance 27-65x where sums cancel (a CPU
// emulation of both roundings, tests/test_torch_flash_bwd_tc.py); the split
// holds it, the remaining error being the output's bf16 rounding.
#include "sm90.cuh"

namespace {

constexpr int STAGES = 2;              // ring depth
constexpr int CONSUMERS = 128;         // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp

struct Params {
  const float* lse;        // (B, H, S), natural-log units
  const float* delta;      // (B, H, S)
  const int* seg;          // (B, S) int32 or null
  __nv_bfloat16* dq;       // (B, S, H, D)   (dQ kernel)
  __nv_bfloat16* dk;       // (B, S, K, D)   (dK/dV kernel)
  __nv_bfloat16* dv;       // (B, S, K, Dv)  (dK/dV kernel)
  int S, H, K, D, Dv, causal, window;
  float scale;             // softmax scale
  float scale_log2;        // scale * log2(e)
  float* dk_ws;            // (B, S, H, D) f32 per-head partials (SPLIT)
  float* dv_ws;            // (B, S, H, Dv) f32 (SPLIT)
};

// 64-column boxes a head dim of `d` takes
__host__ __device__ constexpr int chunks(int d) { return (d + BOX - 1) / BOX; }

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[s], 1);                    // full: the producer
      mbar_init(&bars[STAGES + s], CONSUMERS);   // empty: every consumer
    }
    mbar_init(&bars[2 * STAGES], 1);             // the block's own tiles
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// rows r0 and r0 + 8 of this thread of a 64 x (64 N) f32 accumulator, times
// `mul`, as bf16 into `row0` / `row1`, the first `n` columns
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N][32],
                                           float mul, __nv_bfloat16* row0,
                                           __nv_bfloat16* row1, int n,
                                           int tig) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * BOX + 8 * j + 2 * tig;
      if (col < n) {
        *reinterpret_cast<__nv_bfloat162*>(row0 + col) =
            __floats2bfloat162_rn(acc[c][4 * j] * mul,
                                  acc[c][4 * j + 1] * mul);
        *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
            __floats2bfloat162_rn(acc[c][4 * j + 2] * mul,
                                  acc[c][4 * j + 3] * mul);
      }
    }
}

// the same rows in f32, unscaled, into `row0` / `row1`
template <int N>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[N][32],
                                               float* row0, float* row1,
                                               int n, int tig) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * BOX + 8 * j + 2 * tig;
      if (col < n) {
        *reinterpret_cast<float2*>(row0 + col) =
            make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
        *reinterpret_cast<float2*>(row1 + col) =
            make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
      }
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][32]) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
}

// ---------------------------------------------------------------- dQ ----
// NQ = 64-column chunks of D (the dQ accumulator: 32 * NQ registers a
// thread); Dv's chunks are a runtime count. Two blocks an SM at D <= 64.
template <int NQ>
__global__ void __launch_bounds__(THREADS, NQ == 1 ? 2 : 1)
    bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const Params p) {
  constexpr int KN = NQ == 4 ? 32 : 64;   // keys of a sub-tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const int NV = chunks(p.Dv);
  uint8_t* q_s = smem;                              // NQ boxes
  uint8_t* do_s = q_s + NQ * BOX_BYTES;             // NV boxes
  uint8_t* k_s = do_s + NV * BOX_BYTES;             // STAGES x NQ boxes
  uint8_t* v_s = k_s + STAGES * NQ * BOX_BYTES;     // STAGES x NV boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + STAGES * NV * BOX_BYTES);
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* own_full = bars + 2 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int nq = p.S / TILE;
  const int qt = p.causal ? nq - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * TILE;
  const int kh = h / (p.H / p.K);
  const int* segrow = p.seg ? p.seg + (long)b * p.S : nullptr;
  const int kt_end = p.causal ? qt + 1 : nq;
  const int kt_begin =
      p.window > 0 ? max(0, (q0 - (p.window - 1)) / TILE) : 0;
  init_barriers(bars);

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------ producer warp ----
    if (threadIdx.x != CONSUMERS) return;
    mbar_expect_tx(own_full, (NQ + NV) * BOX_BYTES);
    for (int c = 0; c < NQ; ++c)
      tma_load(q_s + c * BOX_BYTES, &tq, own_full, c * BOX, h, q0, b);
    for (int c = 0; c < NV; ++c)
      tma_load(do_s + c * BOX_BYTES, &tdo, own_full, c * BOX, h, q0, b);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * TILE;
      if (!tile_needed(p.causal, p.window, segrow, q0, k0)) continue;
      mbar_wait(&empty[stage], phase ^ 1);   // the first round passes
      mbar_expect_tx(&full[stage], (NQ + NV) * BOX_BYTES);
      for (int c = 0; c < NQ; ++c)
        tma_load(k_s + (stage * NQ + c) * BOX_BYTES, &tk, &full[stage],
                 c * BOX, kh, k0, b);
      for (int c = 0; c < NV; ++c)
        tma_load(v_s + (stage * NV + c) * BOX_BYTES, &tv, &full[stage],
                 c * BOX, kh, k0, b);
      advance(stage, phase);
    }
    return;
  }

  // -------------------------------------------------- consumers ----------
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3;                      // column pair in a block
  const int r0 = warp * 16 + (lane >> 2);        // this thread's rows: r0
  const int r1 = r0 + 8;                         // and r0 + 8
  const long row_base = ((long)b * p.H + h) * p.S + q0;
  const float lse0 = p.lse[row_base + r0] * LOG2E;
  const float lse1 = p.lse[row_base + r1] * LOG2E;
  const float del0 = p.delta[row_base + r0];
  const float del1 = p.delta[row_base + r1];
  const int dsteps = p.D / 16, vsteps = p.Dv / 16;

  float dq[NQ][32];
  zero(dq);
  mbar_wait(own_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * TILE;
    if (!tile_needed(p.causal, p.window, segrow, q0, k0))   // uniform
      continue;
    mbar_wait(&full[stage], phase);
    const uint8_t* k_t = k_s + stage * NQ * BOX_BYTES;
    const uint8_t* v_t = v_s + stage * NV * BOX_BYTES;
    const bool masked =
        tile_masked(p.causal, p.window, segrow, q0, k0);   // uniform
#pragma unroll 1
    for (int kc = 0; kc < TILE; kc += KN) {      // key sub-tiles
      // S = Q K^T and dP = dO V^T over keys kc..kc+KN-1, 16 of the head
      // dim at a time
      float s[KN / 2], dp[KN / 2];
      wg_fence();
      for (int ks = 0; ks < dsteps; ++ks)
        wgmma_ss(s, kmajor_desc(q_s, ks), kmajor_desc(k_t + kc * 128, ks),
                 ks > 0);
      for (int ks = 0; ks < vsteps; ++ks)
        wgmma_ss(dp, kmajor_desc(do_s, ks), kmajor_desc(v_t + kc * 128, ks),
                 ks > 0);
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // P and dS = P (dP - delta), in s
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i0 = 4 * j + e, i1 = 4 * j + 2 + e;
          float p0 = ex2(fmaf(s[i0], p.scale_log2, -lse0));
          float p1 = ex2(fmaf(s[i1], p.scale_log2, -lse1));
          if (masked) {
            const int key = k0 + kc + 8 * j + 2 * tig + e;
            if (!pair_kept(p.causal, p.window, segrow, q0 + r0, key)) p0 = 0.f;
            if (!pair_kept(p.causal, p.window, segrow, q0 + r1, key)) p1 = 0.f;
          }
          s[i0] = p0 * (dp[i0] - del0);
          s[i1] = p1 * (dp[i1] - del1);
        }

      // dQ += dS K: dS as bf16 hi + lo A fragments, K MN-major
      uint32_t dh[KN / 16][4], dl[KN / 16][4];
      frag_hilo(s, dh, dl);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NQ; ++c) {
          const uint64_t dk = mnmajor_desc(k_t, c, kc / 16 + kk);
          wgmma_rs_n64(dq[c], dh[kk], dk);
          wgmma_rs_n64(dq[c], dl[kk], dk);
        }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NQ; ++c) fence_regs(dq[c]);
    }
    mbar_arrive(&empty[stage]);
    advance(stage, phase);
  }

  // S was taken against unscaled Q: d/dQ carries the scale once more
  __nv_bfloat16* row0 = p.dq + ((long)(b * p.S + q0 + r0) * p.H + h) * p.D;
  __nv_bfloat16* row1 = p.dq + ((long)(b * p.S + q0 + r1) * p.H + h) * p.D;
  store_rows(dq, p.scale, row0, row1, p.D, tig);
}

// ------------------------------------------------------------- dK/dV ----
enum Pass { BOTH = 0, DV_ONLY = 1, DK_ONLY = 2 };

// the consumers' view of a dK/dV block's shared memory
struct DkvTiles {
  const uint8_t* k;        // NQ boxes
  const uint8_t* v;        // NV boxes
  const uint8_t* q;        // STAGES x NQ boxes
  const uint8_t* dout;     // STAGES x NV boxes
  const float* lse;        // STAGES x 64
  const float* delta;      // STAGES x 64
  uint64_t* full;
  uint64_t* empty;
};

// One pass of the consumers over the needed (q head, q tile) pairs of the
// block's 64 keys; each pass writes the accumulators it owns. NMAX is the
// larger chunk count of D and Dv (the accumulators' width); the products
// run over the runtime counts NQ, NV <= NMAX. KN = q rows of a sub-tile
// (S^T and dP^T are taken 64 x KN at a time). SPLIT: the block sums one
// q head of the group (blockIdx.x's) into the f32 workspaces.
template <int NMAX, int KN, int MODE, bool SPLIT>
__device__ __forceinline__ void dkv_pass(const Params& p, const DkvTiles& t,
                                         int& stage, uint32_t& phase,
                                         int k0, int g, int b,
                                         const int* segrow, int qt_begin,
                                         int qt_end) {
  constexpr bool DK = MODE != DV_ONLY, DV = MODE != DK_ONLY;
  const int NQ = chunks(p.D), NV = chunks(p.Dv);
  const int dsteps = p.D / 16, vsteps = p.Dv / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;   // key rows
  const int rep = p.H / p.K;
  // SPLIT: this block's one head of the group
  const int r_end = SPLIT ? (int)blockIdx.x % rep + 1 : rep;

  float dk[DK ? NMAX : 1][32], dv[DV ? NMAX : 1][32];
  zero(dk);
  zero(dv);
  for (int r = SPLIT ? r_end - 1 : 0; r < r_end; ++r) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * TILE;
      if (!tile_needed(p.causal, p.window, segrow, q0, k0))   // uniform
        continue;
      mbar_wait(&t.full[stage], phase);
      const uint8_t* q_t = t.q + stage * NQ * BOX_BYTES;
      const uint8_t* do_t = t.dout + stage * NV * BOX_BYTES;
      const float* lse_t = t.lse + stage * TILE;
      const float* del_t = t.delta + stage * TILE;
      const bool masked =
          tile_masked(p.causal, p.window, segrow, q0, k0);   // uniform
#pragma unroll 1
      for (int qc = 0; qc < TILE; qc += KN) {    // q-row sub-tiles
        // S^T = K Q^T (and dP^T = V dO^T) over q rows qc..qc+KN-1, 16 of
        // the head dim at a time
        float s[KN / 2], dp[KN / 2];
        wg_fence();
        for (int ks = 0; ks < dsteps; ++ks)
          wgmma_ss(s, kmajor_desc(t.k, ks), kmajor_desc(q_t + qc * 128, ks),
                   ks > 0);
        if (DK)
          for (int ks = 0; ks < vsteps; ++ks)
            wgmma_ss(dp, kmajor_desc(t.v, ks),
                     kmajor_desc(do_t + qc * 128, ks), ks > 0);
        wg_commit();
        wg_wait_all();
        fence_regs(s);
        if (DK) fence_regs(dp);

        // P^T in s and dS^T = P^T (dP^T - delta) in dp; lse and delta by
        // column (the q row)
#pragma unroll
        for (int j = 0; j < KN / 8; ++j) {
          const int col = qc + 8 * j + 2 * tig;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
          const float lc[2] = {l2.x * LOG2E, l2.y * LOG2E};
          float dc[2] = {0.f, 0.f};
          if (DK) {
            const float2 d2 = *reinterpret_cast<const float2*>(del_t + col);
            dc[0] = d2.x;
            dc[1] = d2.y;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i0 = 4 * j + e, i1 = 4 * j + 2 + e;
            float p0 = ex2(fmaf(s[i0], p.scale_log2, -lc[e]));
            float p1 = ex2(fmaf(s[i1], p.scale_log2, -lc[e]));
            if (masked) {
              const int qp = q0 + col + e;
              if (!pair_kept(p.causal, p.window, segrow, qp, k0 + r0))
                p0 = 0.f;
              if (!pair_kept(p.causal, p.window, segrow, qp, k0 + r1))
                p1 = 0.f;
            }
            s[i0] = p0;
            s[i1] = p1;
            if (DK) {
              dp[i0] = p0 * (dp[i0] - dc[e]);
              dp[i1] = p1 * (dp[i1] - dc[e]);
            }
          }
        }

        // dV += P^T dO and dK += dS^T Q: bf16 hi + lo A fragments, dO and
        // Q MN-major
        uint32_t ph[KN / 16][4], pl[KN / 16][4], dh[KN / 16][4],
            dl[KN / 16][4];
        if (DV) frag_hilo(s, ph, pl);
        if (DK) frag_hilo(dp, dh, dl);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk) {
          if (DV) {
#pragma unroll
            for (int c = 0; c < NMAX; ++c)
              if (c < NV) {
                const uint64_t d = mnmajor_desc(do_t, c, qc / 16 + kk);
                wgmma_rs_n64(dv[c], ph[kk], d);
                wgmma_rs_n64(dv[c], pl[kk], d);
              }
          }
          if (DK) {
#pragma unroll
            for (int c = 0; c < NMAX; ++c)
              if (c < NQ) {
                const uint64_t d = mnmajor_desc(q_t, c, qc / 16 + kk);
                wgmma_rs_n64(dk[c], dh[kk], d);
                wgmma_rs_n64(dk[c], dl[kk], d);
              }
          }
        }
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int c = 0; c < NMAX; ++c) {
          if (DK) fence_regs(dk[c]);
          if (DV) fence_regs(dv[c]);
        }
      }
      mbar_arrive(&t.empty[stage]);
      advance(stage, phase);
    }
  }

  if constexpr (SPLIT) {   // this q head's f32 partials; dkv_reduce sums
    const long w0 = (long)(b * p.S + k0 + r0) * p.H + blockIdx.x;
    const long w1 = w0 + 8L * p.H;
    if (DK)
      store_rows_f32(dk, p.dk_ws + w0 * p.D, p.dk_ws + w1 * p.D, p.D, tig);
    if (DV)
      store_rows_f32(dv, p.dv_ws + w0 * p.Dv, p.dv_ws + w1 * p.Dv, p.Dv,
                     tig);
    return;
  }
  // dK was taken against unscaled Q: it carries the scale once
  const long row0 = (long)(b * p.S + k0 + r0) * p.K + g;
  const long row1 = (long)(b * p.S + k0 + r1) * p.K + g;
  if (DK)
    store_rows(dk, p.scale, p.dk + row0 * p.D, p.dk + row1 * p.D, p.D, tig);
  if (DV)
    store_rows(dv, 1.f, p.dv + row0 * p.Dv, p.dv + row1 * p.Dv, p.Dv, tig);
}

// NMAX = max(ceil(D/64), ceil(Dv/64)). Two blocks an SM at head dims <= 64.
// SPLIT: blockIdx.x is the q head, else the kv head.
template <int NMAX, bool SPLIT>
__global__ void __launch_bounds__(THREADS, NMAX == 1 ? 2 : 1)
    bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const Params p) {
  // one pass (dK and dV together) up to head dim 128, two above (dV, then
  // dK); q rows of a sub-tile
  constexpr int PASSES = NMAX <= 2 ? 1 : 2;
  constexpr int KN = NMAX == 4 ? 16 : 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const int NQ = chunks(p.D), NV = chunks(p.Dv);
  uint8_t* k_s = smem;                              // NQ boxes
  uint8_t* v_s = k_s + NQ * BOX_BYTES;              // NV boxes
  uint8_t* q_s = v_s + NV * BOX_BYTES;              // STAGES x NQ boxes
  uint8_t* do_s = q_s + STAGES * NQ * BOX_BYTES;    // STAGES x NV boxes
  float* lse_s = reinterpret_cast<float*>(do_s + STAGES * NV * BOX_BYTES);
  float* del_s = lse_s + STAGES * TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(del_s + STAGES * TILE);
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* own_full = bars + 2 * STAGES;

  const int rep = p.H / p.K;
  // the kv head: blockIdx.x, or with SPLIT the q head's group
  const int g = SPLIT ? (int)blockIdx.x / rep : (int)blockIdx.x;
  const int b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * TILE;
  const int nq = p.S / TILE;
  const int r_end = SPLIT ? (int)blockIdx.x % rep + 1 : rep;
  const int* segrow = p.seg ? p.seg + (long)b * p.S : nullptr;
  const int qt_begin = p.causal ? kt : 0;
  const int qt_end =
      p.window > 0 ? min(nq, (k0 + TILE - 1 + p.window - 1) / TILE + 1) : nq;
  init_barriers(bars);

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------ producer warp ----
    if (threadIdx.x != CONSUMERS) return;
    mbar_expect_tx(own_full, (NQ + NV) * BOX_BYTES);
    for (int c = 0; c < NQ; ++c)
      tma_load(k_s + c * BOX_BYTES, &tk, own_full, c * BOX, g, k0, b);
    for (int c = 0; c < NV; ++c)
      tma_load(v_s + c * BOX_BYTES, &tv, own_full, c * BOX, g, k0, b);
    int stage = 0;
    uint32_t phase = 0;
    for (int pass = 0; pass < PASSES; ++pass)
      for (int r = SPLIT ? r_end - 1 : 0; r < r_end; ++r) {
        const int h = g * rep + r;
        const long lrow = ((long)b * p.H + h) * p.S;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
          const int q0 = qt * TILE;
          if (!tile_needed(p.causal, p.window, segrow, q0, k0)) continue;
          mbar_wait(&empty[stage], phase ^ 1);   // the first round passes
          mbar_expect_tx(&full[stage],
                         (NQ + NV) * BOX_BYTES + 2 * TILE * sizeof(float));
          for (int c = 0; c < NQ; ++c)
            tma_load(q_s + (stage * NQ + c) * BOX_BYTES, &tq, &full[stage],
                     c * BOX, h, q0, b);
          for (int c = 0; c < NV; ++c)
            tma_load(do_s + (stage * NV + c) * BOX_BYTES, &tdo, &full[stage],
                     c * BOX, h, q0, b);
          bulk_load(lse_s + stage * TILE, p.lse + lrow + q0,
                    TILE * sizeof(float), &full[stage]);
          bulk_load(del_s + stage * TILE, p.delta + lrow + q0,
                    TILE * sizeof(float), &full[stage]);
          advance(stage, phase);
        }
      }
    return;
  }

  // -------------------------------------------------- consumers ----------
  const DkvTiles t{k_s, v_s, q_s, do_s, lse_s, del_s, full, empty};
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(own_full, 0);
  if constexpr (PASSES == 1) {
    dkv_pass<NMAX, KN, BOTH, SPLIT>(p, t, stage, phase, k0, g, b, segrow,
                                    qt_begin, qt_end);
  } else {
    dkv_pass<NMAX, KN, DV_ONLY, SPLIT>(p, t, stage, phase, k0, g, b, segrow,
                                       qt_begin, qt_end);
    dkv_pass<NMAX, KN, DK_ONLY, SPLIT>(p, t, stage, phase, k0, g, b, segrow,
                                       qt_begin, qt_end);
  }
}

// dK or dV of each kv head from its q heads' f32 partials: out[row] = mul
// * (ws[row, 0] + ws[row, 1] + ... + ws[row, rep-1]), rounded once to bf16;
// rows over (B, S, K), ws (B, S, H = K rep, n). A thread a column pair.
__global__ void dkv_reduce_kernel(const float* __restrict__ ws,
                                  __nv_bfloat16* __restrict__ out,
                                  long pairs, int rep, int half, float mul) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const long row = i / half;
  const float2* src =
      reinterpret_cast<const float2*>(ws) + row * rep * half + (i - row * half);
  float2 acc = src[0];
  for (int r = 1; r < rep; ++r) {
    const float2 x = src[(long)r * half];
    acc.x += x.x;
    acc.y += x.y;
  }
  reinterpret_cast<__nv_bfloat162*>(out)[i] =
      __floats2bfloat162_rn(acc.x * mul, acc.y * mul);
}

int dkv_reduce(const float* ws, void* out, long rows, int rep, int n,
               float mul, cudaStream_t st) {
  const long pairs = rows * (n / 2);
  const int threads = 256;
  dkv_reduce_kernel<<<(unsigned)((pairs + threads - 1) / threads), threads,
                      0, st>>>(ws, static_cast<__nv_bfloat16*>(out), pairs,
                               rep, n / 2, mul);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- host -----
size_t dq_tc_smem(int D, int Dv) {
  return 1024 +
         (size_t)BOX_BYTES * (1 + STAGES) * (chunks(D) + chunks(Dv)) +
         sizeof(uint64_t) * (2 * STAGES + 1);
}

size_t dkv_tc_smem(int D, int Dv) {
  return dq_tc_smem(D, Dv) + sizeof(float) * 2 * STAGES * TILE;
}

template <typename Kern>
int launch(Kern kern, size_t smem, dim3 grid, const CUtensorMap (&m)[4],
           const Params& p, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, THREADS, smem, st>>>(m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

// the dK/dV kernel of NMAX n, whole groups or split by q head
template <bool SPLIT>
int launch_dkv(int n, dim3 grid, size_t smem, const CUtensorMap (&m)[4],
               const Params& p, cudaStream_t st) {
  switch (n) {
    case 1: return launch(bwd_dkv_tc_kernel<1, SPLIT>, smem, grid, m, p, st);
    case 2: return launch(bwd_dkv_tc_kernel<2, SPLIT>, smem, grid, m, p, st);
    case 3: return launch(bwd_dkv_tc_kernel<3, SPLIT>, smem, grid, m, p, st);
    default: return launch(bwd_dkv_tc_kernel<4, SPLIT>, smem, grid, m, p, st);
  }
}

// checks shared by both entry points, then the four tensor maps: q, k, v, dO
int prepare(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
            const void* dout, const float* lse, const float* delta, int B,
            int S, int H, int K, int D, int Dv) {
  if (S % TILE || K < 1 || H % K || !tc_head_dim(D) || !tc_head_dim(Dv) ||
      (reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta)) &
          15)
    return (int)cudaErrorInvalidValue;
  int rc = encode(&m[0], q, B, S, H, D);
  if (!rc) rc = encode(&m[1], k, B, S, K, D);
  if (!rc) rc = encode(&m[2], v, B, S, K, Dv);
  if (!rc) rc = encode(&m[3], dout, B, S, H, Dv);
  return rc;
}

}  // namespace

extern "C" {

// q (B,S,H,D), k (B,S,K,D), v (B,S,K,Dv), dout (B,S,H,Dv) and the outputs,
// all bf16 and contiguous, 16-byte aligned; lse, delta (B,H,S) f32, 16-byte
// aligned; seg (B,S) int32 or null. S % 64 == 0, H % K == 0, D and Dv
// multiples of 16 in [16, 256]. Returns 0, a cudaError_t, -1 (no
// cuTensorMapEncodeTiled in the driver) or -(100 + CUresult) (a tensor map
// the driver refused).
int tri_flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        const int* seg, void* dq, int B, int S, int H, int K,
                        int D, int Dv, int causal, int window, float scale,
                        void* stream) {
  CUtensorMap m[4];
  const int rc = prepare(m, q, k, v, dout, lse, delta, B, S, H, K, D, Dv);
  if (rc) return rc;
  const Params p{lse, delta, seg, static_cast<__nv_bfloat16*>(dq), nullptr,
                 nullptr, S, H, K, D, Dv, causal, window, scale,
                 scale * LOG2E};
  const dim3 grid(H, B, S / TILE);
  const size_t smem = dq_tc_smem(D, Dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunks(D)) {
    case 1: return launch(bwd_dq_tc_kernel<1>, smem, grid, m, p, st);
    case 2: return launch(bwd_dq_tc_kernel<2>, smem, grid, m, p, st);
    case 3: return launch(bwd_dq_tc_kernel<3>, smem, grid, m, p, st);
    default: return launch(bwd_dq_tc_kernel<4>, smem, grid, m, p, st);
  }
}

// as tri_flash_bwd_dq_tc, writing dk (B,S,K,D) and dv (B,S,K,Dv). Given
// dk_ws and dv_ws (f32, (B,S,H,D) and (B,S,H,Dv), 8-byte aligned;
// overwritten), it splits by q head into them and sums after; null, each
// block sums its whole group (the caller decides: dkv_workspace)
int tri_flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const int* seg, void* dk,
                         void* dv, float* dk_ws, float* dv_ws, int B, int S,
                         int H, int K, int D, int Dv, int causal, int window,
                         float scale, void* stream) {
  CUtensorMap m[4];
  int rc = prepare(m, q, k, v, dout, lse, delta, B, S, H, K, D, Dv);
  if (rc) return rc;
  const bool split = dk_ws != nullptr;
  if (split != (dv_ws != nullptr)) return (int)cudaErrorInvalidValue;
  const Params p{lse, delta, seg, nullptr, static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), S, H, K, D, Dv, causal,
                 window, scale, scale * LOG2E, dk_ws, dv_ws};
  const size_t smem = dkv_tc_smem(D, Dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = chunks(D > Dv ? D : Dv);
  if (!split) return launch_dkv<false>(n, dim3(K, B, S / TILE), smem, m, p, st);
  rc = launch_dkv<true>(n, dim3(H, B, S / TILE), smem, m, p, st);
  if (rc) return rc;
  const long rows = (long)B * S * K;
  rc = dkv_reduce(dk_ws, dk, rows, H / K, D, scale, st);
  return rc ? rc : dkv_reduce(dv_ws, dv, rows, H / K, Dv, 1.f, st);
}

}  // extern "C"
