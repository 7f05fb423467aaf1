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
//     -lcuda), and passed as __grid_constant__ parameters.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                 // query rows a block
constexpr int BN = 64;                 // keys a tile
constexpr int BOX = 64;                // bf16 columns a 128-byte row holds
constexpr int BOX_BYTES = 64 * 128;    // one 64 x 64 bf16 box
constexpr int STAGES = 2;              // k/v ring depth
constexpr int CONSUMERS = 128;         // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr float NEG_INF = -2.0e38f;
constexpr float LN2 = 0.693147180559945309f;

struct Params {
  const int* seg;          // (B, S) int32 or null
  __nv_bfloat16* o;        // (B, S, H, Dv)
  float* lse;              // (B, H, S) or null
  int S, H, K, D, Dv, causal, window;
  float scale_log2;        // scale * log2(e)
};

// --------------------------------------------------------- primitives ---
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one 4-D box of the tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1). K-major
// tiles (q, k): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); a
// k step of 16 moves the start 32 bytes. MN-major tiles (v): the same rows
// read as 64 N-values of one k; 8 k-rows a 1024-byte group (SBO); LBO would
// step between 64-wide N groups, which a 64-wide product does not use.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(16 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64 f32, 32 a thread) += A (64 x 16, smem) * B (16 x 64, smem),
// both K-major (trans 0); `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) * B (16 x 64, smem,
// MN-major: trans-b 1)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// _block_needed at the 64-row tile: does tile (q0, k0) hold a kept pair?
__device__ __forceinline__ bool tile_needed(const Params& p, const int* segrow,
                                            int q0, int k0) {
  if (p.causal && k0 > q0 + BM - 1) return false;
  if (p.window > 0 && k0 + BN - 1 < q0 - (p.window - 1)) return false;
  if (segrow && !(segrow[q0 + BM - 1] >= segrow[k0] &&
                  segrow[q0] <= segrow[k0 + BN - 1]))
    return false;
  return true;
}

// does tile (q0, k0) hold a masked pair? (else every pair is kept)
__device__ __forceinline__ bool tile_masked(const Params& p, const int* segrow,
                                            int q0, int k0) {
  if (p.causal && k0 + BN - 1 > q0) return true;
  if (p.window > 0 && (q0 + BM - 1) - k0 >= p.window) return true;
  if (segrow && !(segrow[q0] == segrow[q0 + BM - 1] &&
                  segrow[k0] == segrow[k0 + BN - 1] &&
                  segrow[q0] == segrow[k0]))
    return true;
  return false;
}

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
      if (!tile_needed(p, segrow, q0, k0)) continue;
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
    if (!tile_needed(p, segrow, q0, k0)) continue;   // uniform
    mbar_wait(&full[stage], phase);
    const uint8_t* k_t = k_s + stage * NQ * BOX_BYTES;
    const uint8_t* v_t = v_s + stage * NV * BOX_BYTES;

    // S = Q K^T over the head dim, 16 at a time
    float s[32];
    wg_fence();
    for (int ks = 0; ks < ksteps; ++ks) {
      const int off = (ks >> 2) * BOX_BYTES + (ks & 3) * 32;
      wgmma_ss_n64(s, sw128_desc(q_s + off), sw128_desc(k_t + off), ks > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);

#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= p.scale_log2;
    if (tile_masked(p, segrow, q0, k0)) {             // uniform
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

    // P as bf16 hi + lo A fragments: k step kk holds keys 16kk..16kk+15,
    // the S accumulator's column blocks 2kk and 2kk+1
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kk + 2 * r], c = s[8 * kk + 2 * r + 1];
        const __nv_bfloat16 ah = __float2bfloat16_rn(a);
        const __nv_bfloat16 ch = __float2bfloat16_rn(c);
        ph[kk][r] = pack_bf16(__bfloat162float(ah), __bfloat162float(ch));
        pl[kk][r] = pack_bf16(a - __bfloat162float(ah),
                              c - __bfloat162float(ch));
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const uint64_t dv = sw128_desc(v_t + c * BOX_BYTES + kk * 2048);
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
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// 4-D map over a contiguous (B, S, heads, dim) bf16 tensor, innermost
// first: (dim, heads, S, B); box 64 x 1 x 64 x 1 with 128-byte swizzle
int encode(CUtensorMap* map, const void* base, int B, int S, int heads,
           int dim) {
  EncodeTiled fn = encoder();
  if (!fn) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dim * 2,
                                 (cuuint64_t)heads * dim * 2,
                                 (cuuint64_t)S * heads * dim * 2};
  const cuuint32_t box[4] = {BOX, 1, BN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(100 + (int)r);
}

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
  if (S % BM || K < 1 || H % K || D % 16 || Dv % 16 || D < 16 || Dv < 16 ||
      D > 256 || Dv > 256)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, B, S, H, D);
  if (!rc) rc = encode(&tk, k, B, S, K, D);
  if (!rc) rc = encode(&tv, v, B, S, K, Dv);
  if (rc) return rc;
  Params p{seg, static_cast<__nv_bfloat16*>(o), lse, S, H, K, D, Dv, causal,
           window, scale * 1.44269504088896341f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((Dv + BOX - 1) / BOX) {
    case 1: return launch<1>(tq, tk, tv, p, B, st);
    case 2: return launch<2>(tq, tk, tv, p, B, st);
    case 3: return launch<3>(tq, tk, tv, p, B, st);
    default: return launch<4>(tq, tk, tv, p, B, st);
  }
}

}  // extern "C"
