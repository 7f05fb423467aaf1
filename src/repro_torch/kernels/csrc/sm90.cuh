// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu, flash_bwd_tf32.cu): mbarriers, TMA
// and bulk loads, the 128-byte-swizzle wgmma descriptors, the bf16 wgmma
// m64nNk16 (N = 64, 32, 16) with A from shared memory and m64n64k16 with A
// from registers, the bf16 hi/lo split of an f32 accumulator into A
// fragments, the tile skips and masks of _block_needed / _tile_mask (at
// 64 x 64 tiles unless a caller names another size), and the host's
// tensor-map encoding.
//
// Tiles are 64 rows of 64 bf16 columns: one 128-byte row a sequence
// position, 8 KB a box, written by the TMA with 128-byte swizzle. A head
// dim above 64 takes ceil(dim/64) boxes; columns past the head dim are
// zero-filled by the TMA (outside the tensor), which adds 0 to every
// product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;               // rows of a q tile and of a k tile
constexpr int BOX = 64;                // bf16 columns a 128-byte row holds
constexpr int BOX_BYTES = 64 * 128;    // one 64 x 64 bf16 box
constexpr float LN2 = 0.693147180559945309f;
constexpr float LOG2E = 1.44269504088896341f;

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

// spin until the phase of parity `parity` of the barrier has completed; a
// phase that never completes (a load that never lands) traps after 2^28
// tries, a launch error, where it would otherwise hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, tries = 0;
  while (!done) {
    if (++tries == (1u << 28)) __trap();
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

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1). K-major
// tiles: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); a k step
// of 16 moves the start 32 bytes. MN-major tiles (trans-b): the same rows
// read as 64 N-values of one k; 8 k-rows a 1024-byte group (SBO), a k step
// of 16 moves the start 16 rows (2 KB); LBO would step between 64-wide N
// groups, which a 64-wide product does not use.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(16 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// descriptor of k step `ks` (16 columns) of a K-major tile of 64-column
// boxes
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int ks) {
  return sw128_desc(tile + (ks >> 2) * BOX_BYTES + (ks & 3) * 32);
}

// descriptor of k step `kk` (16 rows) of 64-column chunk `c` of an MN-major
// tile
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int c,
                                                 int kk) {
  return sw128_desc(tile + c * BOX_BYTES + kk * 2048);
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
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
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

// the same at N = 32: d (64 x 32 f32, 16 a thread)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the same at N = 16: d (64 x 16 f32, 8 a thread)
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
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

// A 64 x (8 N/4) f32 accumulator (N a thread: rows lane/4 and lane/4 + 8
// of the warp's 16, two columns of each 8-column block) as bf16 A
// fragments of N/8 k steps, split into hi = bf16(x) and lo = bf16(x - hi):
// k step kk holds columns 16kk..16kk+15, the accumulator's column blocks
// 2kk and 2kk+1. hi + lo keeps x to ~2^-17 where one bf16 would keep 2^-9.
template <int N>
__device__ __forceinline__ void frag_hilo(const float (&x)[N],
                                          uint32_t (&hi)[N / 8][4],
                                          uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], c = x[8 * kk + 2 * r + 1];
      const __nv_bfloat16 ah = __float2bfloat16_rn(a);
      const __nv_bfloat16 ch = __float2bfloat16_rn(c);
      hi[kk][r] = pack_bf16(__bfloat162float(ah), __bfloat162float(ch));
      lo[kk][r] = pack_bf16(a - __bfloat162float(ah), c - __bfloat162float(ch));
    }
}

// _block_needed at T-row tiles (64 unless the caller says otherwise): does
// tile (q0, k0) hold a kept pair? `segrow` is the batch row's segment ids
// (non-decreasing) or null.
template <int T = TILE>
__device__ __forceinline__ bool tile_needed(int causal, int window,
                                            const int* segrow, int q0,
                                            int k0) {
  if (causal && k0 > q0 + T - 1) return false;
  if (window > 0 && k0 + T - 1 < q0 - (window - 1)) return false;
  if (segrow && !(segrow[q0 + T - 1] >= segrow[k0] &&
                  segrow[q0] <= segrow[k0 + T - 1]))
    return false;
  return true;
}

// does tile (q0, k0) hold a masked pair? (else every pair is kept)
template <int T = TILE>
__device__ __forceinline__ bool tile_masked(int causal, int window,
                                            const int* segrow, int q0,
                                            int k0) {
  if (causal && k0 + T - 1 > q0) return true;
  if (window > 0 && (q0 + T - 1) - k0 >= window) return true;
  if (segrow && !(segrow[q0] == segrow[q0 + T - 1] &&
                  segrow[k0] == segrow[k0 + T - 1] &&
                  segrow[q0] == segrow[k0]))
    return true;
  return false;
}

// _tile_mask for one (query, key) pair
__device__ __forceinline__ bool pair_kept(int causal, int window,
                                          const int* segrow, int qp, int kp) {
  const int d = qp - kp;
  return (!causal || d >= 0) && (window <= 0 || d < window) &&
         (!segrow || segrow[qp] == segrow[kp]);
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
// first: (dim, heads, S, B); box 64 x 1 x 64 x 1 with 128-byte swizzle.
// Returns 0, -1 (no cuTensorMapEncodeTiled in the driver) or
// -(100 + CUresult) (a map the driver refused).
int encode(CUtensorMap* map, const void* base, int B, int S, int heads,
           int dim) {
  EncodeTiled fn = encoder();
  if (!fn) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dim * 2,
                                 (cuuint64_t)heads * dim * 2,
                                 (cuuint64_t)S * heads * dim * 2};
  const cuuint32_t box[4] = {BOX, 1, TILE, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(100 + (int)r);
}

// the head dims both tensor-core kernels take: multiples of 16 in [16, 256]
inline bool tc_head_dim(int d) { return d >= 16 && d <= 256 && d % 16 == 0; }

}  // namespace
