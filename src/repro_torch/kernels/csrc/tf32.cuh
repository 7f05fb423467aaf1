// Split-TF32 ("3xTF32") building blocks shared by the f32 flash kernels on
// the tensor cores (flash_fwd_tf32.cu, flash_bwd_tf32.cu): the hi/lo split
// of an f32 operand, mma.sync m16n8k8 tf32 and its three-product form, the
// fragment loaders from one f32 copy of a tile in shared memory, the two
// product shapes with their f32 flush, the padded width both head dims
// take, and the cp.async tile loads.
//
// The split. TF32 keeps 10 of f32's 23 mantissa bits, so one TF32 product
// would be off by ~2^-11 a term, far outside flash_attention.tolerance
// (1e-5). Every f32 operand x enters as hi and lo, and a product a b is
// taken as al bh + ah bl + ah bh (three mma, the small terms first); al bl
// is dropped (~2^-22 relative). hi ROUNDS x to tf32 (to nearest, ties away
// from zero: cvt.rna.tf32.f32's rounding); lo TRUNCATES x - hi to tf32
// (split, below). The CPU emulations in tests/test_torch_flash_bwd_tf32.py
// and tests/test_torch_flash_fwd_tf32.py round and truncate the same way.
// Products of two tf32 values are exact in f32.
//
// Fragments. An accumulator's fragment (rows g, g+8; columns 2t, 2t+1 of
// each 8-column block, lane (g, t) = (lane / 4, lane % 4)) becomes the A
// fragment of the next product (columns t, t+4) by renaming the
// contraction index: column 2t <-> t and 2t+1 <-> t+4, with the B fragment
// read at the same renamed rows (frag_b_cols). So a product's result (P,
// dS) goes into the next product without leaving registers. Shared rows
// are W + PAD floats: the fragment loads (8 rows x 4 columns, or 4 row
// pairs x 8 columns) then hit 32 distinct banks, and every row stays
// 16-byte aligned for cp.async.
#pragma once

#include "sm90.cuh"

namespace {

constexpr int TF_THREADS = 256;      // 8 warps a block
constexpr int TF_WARPS = TF_THREADS / 32;
constexpr int TF_STAGES = 2;         // ring depth
constexpr int PAD = 4;               // floats of padding a shared row

// ------------------------------------------------------- tf32 split -----
// hi = tf32(x) rounded to nearest, ties away from zero (the rounding of
// cvt.rna.tf32.f32, done as an integer add of half a tf32 ulp and a mask:
// two integer operations where the conversion is a slow one); lo = x - hi
// (exact in f32) truncated to tf32 (mask). The low 13 bits of both are 0.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
}

// d (16 x 8 f32) += a (16 x 8 tf32, row) * b (8 x 8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: al bh + ah bl + ah bh, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The tensor cores add into an f32 accumulator with truncation, a one-sided
// error of up to an ulp of the accumulator a step; over the thousands of
// steps of a sum over the whole sequence that bias outgrows the tolerance
// (dK broke it at B 8, S 1024, 9/3 heads on the card when every step went
// into one accumulator). So every long sum is flushed: a tile's steps
// go into a zeroed fragment on the tensor cores, which is then added to the
// accumulator in f32, rounded to nearest (product_cols, and product_rows
// above W = 128), as the SIMT kernels' sums are.

// A fragment of rows r0.., columns c0.. of a row-major shared tile with
// leading dimension LD, split. Lane (g, t) holds (g, t), (g+8, t),
// (g, t+4), (g+8, t+4).
template <int LD>
__device__ __forceinline__ void frag_a(const float* tile, int r0, int c0,
                                       int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = tile + (r0 + g) * LD + c0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * LD], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * LD + 4], hi[3], lo[3]);
}

// B fragment whose n runs along the tile's rows (B(k, n) = tile[n0+n][k0+k]:
// the product contracts over the tile's columns), split. Lane (g, t) holds
// (k t, n g) and (k t+4, n g).
template <int LD>
__device__ __forceinline__ void frag_b_rows(const float* tile, int n0, int k0,
                                            int g, int t, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const float* p = tile + (n0 + g) * LD + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// B fragment that contracts over the tile's rows (B(k, n) = tile[k0+k][n0+n])
// with the renamed contraction index of acc_as_a: k t <-> row 2t, k t+4 <->
// row 2t+1. Split.
template <int LD>
__device__ __forceinline__ void frag_b_cols(const float* tile, int k0, int n0,
                                            int g, int t, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const float* p = tile + (k0 + 2 * t) * LD + n0 + g;
  split(p[0], hi[0], lo[0]);
  split(p[LD], hi[1], lo[1]);
}

// An accumulator fragment (rows g, g+8; columns 2t, 2t+1) as the A fragment
// of a product over its columns, renamed 2t -> t, 2t+1 -> t+4. Split.
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// d = A B^T for the KT 8-row blocks of B from row n0, contracting over the
// W columns of both (A's rows r0..r0+15): 3xTF32 steps of 8 columns. Above
// W = 128 the steps of each 64 columns are summed in a zeroed fragment and
// added to d in f32 (the flush above).
template <int KT, int LD, int W>
__device__ __forceinline__ void product_rows(float (&d)[KT][4],
                                             const float* at, int r0,
                                             const float* bt, int n0, int g,
                                             int t) {
  constexpr int CHUNK = W > 128 ? 64 : W;
  zero(d);
#pragma unroll
  for (int c0 = 0; c0 < W; c0 += CHUNK) {
    float part[KT][4];
    zero(part);
#pragma unroll
    for (int kk = c0; kk < c0 + CHUNK; kk += 8) {
      uint32_t ah[4], al[4];
      frag_a<LD>(at, r0, kk, g, t, ah, al);
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_rows<LD>(bt, n0 + 8 * j, kk, g, t, bh, bl);
        mma3(part[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] += part[j][e];
  }
}

// acc (16 rows x NT 8-column blocks) += A B, A the KT split fragments of a
// 16 x 8 KT accumulator (acc_as_a), B the tile's rows k0.. (contraction)
// and its columns: each block's KT steps summed in a zeroed fragment on the
// tensor cores, then added to acc in f32
template <int NT, int KT, int LD>
__device__ __forceinline__ void product_cols(float (&acc)[NT][4],
                                             const uint32_t (&ah)[KT][4],
                                             const uint32_t (&al)[KT][4],
                                             const float* bt, int k0, int g,
                                             int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t bh[2], bl[2];
      frag_b_cols<LD>(bt, k0 + 8 * j, 8 * n, g, t, bh, bl);
      mma3(part, ah[j], al[j], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// ------------------------------------------------------------ widths ----
// the width both head dims are padded to, 8 NT: head dims up to 128 take
// NT 4, 8, 12 or 16 (W 32-128), wider ones 24 or 32 (W 192, 256);
// flash_attention.tf32_width mirrors it
inline int tf32_blocks(int D, int Dv) {
  const int n = ((D > Dv ? D : Dv) + 7) / 8;
  return n <= 4 ? 4 : n <= 8 ? 8 : n <= 12 ? 12 : n <= 16 ? 16 : n <= 24 ? 24
                                                                          : 32;
}

// the head dims the split-TF32 kernels take: multiples of 8 in [8, 256]
inline bool tf32_head_dim(int d) { return d >= 8 && d <= 256 && d % 8 == 0; }

// ------------------------------------------------------------ loads -----
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// BR rows of `width` floats (width % 4 == 0, at most W), `stride` floats
// apart from `src`, into a shared tile of row length W + PAD: 16-byte
// cp.async copies; columns [width, W) are left as they are (zero)
template <int BR, int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long stride, int width) {
  constexpr int CPR = W / 4, LD = W + PAD;
  static_assert(BR * CPR % TF_THREADS == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < BR * CPR / TF_THREADS; ++i) {
    const int e = threadIdx.x + i * TF_THREADS, r = e / CPR, c = e % CPR;
    if (4 * c < width) cp16(dst + r * LD + 4 * c, src + r * stride + 4 * c);
  }
}

// n contiguous floats (n % 4 == 0, 16-byte aligned)
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n / 4; e += TF_THREADS)
    cp16(dst + 4 * e, src + 4 * e);
}

// zero n floats of shared memory (n % 4 == 0) and wait for every thread:
// the tiles' columns past a head dim, which no copy writes
__device__ __forceinline__ void zero_smem(float* p, int n) {
  for (int e = threadIdx.x; e < n / 4; e += TF_THREADS)
    reinterpret_cast<float4*>(p)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
}

// a launch with `smem` bytes of dynamic shared memory -> cudaGetLastError()
template <typename Kern, typename Args>
int tf32_launch(Kern kern, size_t smem, dim3 grid, const Args& a,
                cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, TF_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
