// Building blocks shared by the tensor-core kernels (conv.cu K2,
// conv_grad.cu K7, stem.cu K3, attention.cuh K1, attention_dropout.cuh
// K5/K6): 3xTF32 mma.sync.m16n8k8, the one-pass TF32 product of bf16
// values widened to fp32, the bf16 mma.sync.m16n8k16 / m16n8k8 with
// ldmatrix fragment loads, the split of an fp32 value into three bf16
// pieces, cp.async with zero-fill, and the dynamic shared-memory
// attribute.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32 scheme): each fp32 operand is
// split as x = big + small, both TF32, and big*big + big*small + small*big
// is summed in fp32, which keeps the product at the fp32 level where one
// TF32 product (~3 decimal digits) would miss the 1e-4 bar.
//
// Fragments of m16n8k8 TF32 (r = lane / 4, c = lane % 4): A (16 x 8,
// row-major) a0 (r, c), a1 (r + 8, c), a2 (r, c + 4), a3 (r + 8, c + 4);
// B (8 x 8) b0 (c, r), b1 (c + 4, r); C (16 x 8) d0 (r, 2c), d1 (r, 2c +
// 1), d2 (r + 8, 2c), d3 (r + 8, 2c + 1).
//
// bf16 operands widened to fp32 (K3 under compute_dtype bfloat16): a bf16
// value has 8 significant bits and zero low bits, so it is a TF32 value as
// it is, and one TF32 product of two such values is exact (mma1).
//
// bf16 operands as they are (K1 / K5 / K6 / K7 at bf16, K2's bf16 forward
// and its input gradient): mma.sync.m16n8k16 bf16 with fp32 sums, twice the TF32
// rate and half the instructions of m16n8k8 for the same depth, each
// product of two bf16 values exact in fp32. Its fragments, 32-bit
// registers holding two bf16 (the lower column in the low half): A (16 x
// 16) a0 (r, 2c..2c+1), a1 (r + 8, 2c..), a2 (r, 2c + 8..), a3 (r + 8,
// 2c + 8..); B (16 x 8) b0 (k 2c..2c+1, n r), b1 (k 2c + 8.., n r); C as
// above. m16n8k8 bf16 takes a0, a1 and b0 alone (the tail of a depth that
// is 8 mod 16). ldmatrix loads them from shared memory: matrix i of an .x4
// load is the 8 x 8 block whose 8 rows (16 bytes each) lanes 8i..8i+7
// address; lane (r, c) receives row r, columns 2c, 2c + 1 of each, or with
// .trans column r, rows 2c, 2c + 1. Rows 16 bytes x an odd number apart
// fall on distinct banks.
//
// An fp32 operand against a bf16 one (K2's input gradient: the fp32 owner
// sums times the bf16 weight; K6: the probabilities and ds times bf16
// rows): x = hi + mid + lo, each rounded to bf16 from
// what the pieces before it leave (split_hi, split_mid_lo). hi keeps x's
// top 8 significant bits, the remainder x - hi is exact in fp32 and spans
// at most 16 bits, mid its top 8, and what mid leaves spans at most 7, so
// lo holds it exactly: the three pieces reproduce every normal fp32 value
// (and every value whose lo piece stays normal) exactly, and three bf16
// products sum x w to the fp32 level, as 3xTF32 does. Where x is a bf16
// value, mid and lo are 0.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace r3dl {

// x = big + small, both read by the tensor cores as TF32 (the top 19 bits
// of each: sign, exponent, 10 mantissa bits)
struct Split {
  uint32_t big, small;
};

// big: x rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives for finite x) in two integer instructions: add
// half of the dropped 13 bits, clear them. small: x - big, exact in fp32;
// its low 13 bits are left for the tensor cores to drop, an error of at
// most 2^-21 |x|.
__device__ __forceinline__ Split split(float x) {
  const uint32_t big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {big, __float_as_uint(x - __uint_as_float(big))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 on split fragments: the small products first
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     const Split (&b)[2]) {
  mma_tf32(d, a[0].small, a[1].small, a[2].small, a[3].small, b[0].big,
           b[1].big);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b[0].small,
           b[1].small);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

// fp32 -> T, to nearest even for bf16
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// d += a b in one TF32 pass, on fp32 fragments that hold bf16 values
__device__ __forceinline__ void mma1(float (&d)[4], float a0, float a1,
                                     float a2, float a3, float b0, float b1) {
  mma_tf32(d, __float_as_uint(a0), __float_as_uint(a1), __float_as_uint(a2),
           __float_as_uint(a3), __float_as_uint(b0), __float_as_uint(b1));
}

// ---- bf16 operands on the bf16 tensor cores ----

// two fp32 values rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// d += a b, bf16 A (16 x 16) and B (16 x 8), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, bf16 A (16 x 8) and B (8 x 8), fp32 sums
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four 8 x 8 bf16 matrices from shared memory (see the header)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two matrices: lanes 0..15 address their rows
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Two fp32 values as three bf16 pairs, hi + mid + lo (the header): each
// piece is the remainder the pieces before it leave, rounded to bf16.
// split_hi gives hi and returns the remainder (exact in fp32);
// split_mid_lo the other two from it.
__device__ __forceinline__ float2 split_hi(float2 v, uint32_t& hi) {
  hi = pack_bf16(v.x, v.y);
  const float2 h = unpack_bf16(hi);
  return make_float2(v.x - h.x, v.y - h.y);
}

__device__ __forceinline__ void split_mid_lo(float2 r, uint32_t& mid,
                                             uint32_t& lo) {
  mid = pack_bf16(r.x, r.y);
  const float2 m = unpack_bf16(mid);
  lo = pack_bf16(r.x - m.x, r.y - m.y);
}

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read) when
// !pred, so `src` may then be any valid address
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory above 48 KB, and the largest shared-memory
// carveout, so that several blocks fit on an SM.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || smem <= 48 * 1024) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace r3dl
