// Building blocks shared by the tensor-core kernels (conv.cu K2,
// conv_grad.cu K7, attention_dropout.cu K5/K6): 3xTF32 mma.sync.m16n8k8,
// the one-pass product of bf16 operands (and the two-pass product of an
// fp32 operand with a bf16 one), cp.async with zero-fill, and the dynamic
// shared-memory attribute.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32 scheme): each fp32 operand is
// split as x = big + small, both TF32, and big*big + big*small + small*big
// is summed in fp32, which keeps the product at the fp32 level where one
// TF32 product (~3 decimal digits) would miss the 1e-4 bar.
//
// Fragments of m16n8k8 (r = lane / 4, c = lane % 4): A (16 x 8, row-major)
// a0 (r, c), a1 (r + 8, c), a2 (r, c + 4), a3 (r + 8, c + 4); B (8 x 8)
// b0 (c, r), b1 (c + 4, r); C (16 x 8) d0 (r, 2c), d1 (r, 2c + 1),
// d2 (r + 8, 2c), d3 (r + 8, 2c + 1).
//
// bf16 operands (ptv3_config compute_dtype bfloat16): a bf16 value widened
// to fp32 has 8 significant bits and zero low bits, so it is a TF32 value
// as it is, its split has a zero small part, and one TF32 product of two
// such values is exact: one mma pass (mma1) computes what the three would;
// against an fp32 operand, two (mma2: its big and small parts).
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

// x rounded to bf16 (to nearest even) and widened back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += a b in two TF32 passes: a split (an fp32 operand), b fragments
// that hold TF32-exact values (bf16 widened), whose small parts are zero:
// the small product first, as mma3 adds them
__device__ __forceinline__ void mma2(float (&d)[4], const Split (&a)[4],
                                     float b0, float b1) {
  const uint32_t u0 = __float_as_uint(b0), u1 = __float_as_uint(b1);
  mma_tf32(d, a[0].small, a[1].small, a[2].small, a[3].small, u0, u1);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, u0, u1);
}

// d += a b in one TF32 pass, on fp32 fragments that hold bf16 values
__device__ __forceinline__ void mma1(float (&d)[4], float a0, float a1,
                                     float a2, float a3, float b0, float b1) {
  mma_tf32(d, __float_as_uint(a0), __float_as_uint(a1), __float_as_uint(a2),
           __float_as_uint(a3), __float_as_uint(b0), __float_as_uint(b1));
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
