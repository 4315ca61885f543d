// Shared pieces of the tensor-core kernels (kmeans_assign.cu, maxsim.cu):
// the split-precision float32 product known as 3xTF32, cp.async copies,
// and the shared-memory row layout.
//
// 3xTF32: each f32 operand v is split into hi (v rounded to TF32) and
// lo = v - hi (exact in f32, truncated to TF32 as the tensor core reads
// it), and a product is accumulated in f32 as a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, one term at a time over a warp's tiles. |lo| <= 2^-11 |v|, so
// the dropped a_lo*b_lo term and lo's truncation are about 2^-21 of
// |a||b|: a dot product lands within a few f32 ulps of a chain of f32
// FMAs, on the tensor cores (495 TFLOP/s dense TF32 on an H100 SXM through
// wgmma, against 67 TFLOP/s of f32 FMAs), three products per step.
//
// Fragments are those of mma.sync.aligned.m16n8k8 (.tf32, f32 accumulate).
// With g = lane / 4 and t = lane % 4:
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8):       c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// The product sums over the k slots in any order, so the kernels map k
// slots to columns of D as suits their shared-memory loads: one 16-byte
// load at column 4t of a 16-wide slice gives a thread the columns of two
// k steps, slots (t, t + 4) <- (4t, 4t + 1) and then (4t + 2, 4t + 3), for
// A and B alike.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// hi: v rounded to TF32 (10 explicit mantissa bits), nearest with ties
// away from zero, by an integer add and mask: what cvt.rna.tf32.f32
// computes for finite v, in two integer instructions, which both kernels
// ran faster with than with two cvt per split. lo: v - hi, exact in f32;
// the tensor core reads only its top 19 bits, so lo enters the product
// truncated to TF32.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// The A fragment of one k step from the rows g and g + 8 (x: slot t,
// y: slot t + 4).
__device__ __forceinline__ void split_a(float2 top, float2 bottom,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(top.x, hi[0], lo[0]);
  split(bottom.x, hi[1], lo[1]);
  split(top.y, hi[2], lo[2]);
  split(bottom.y, hi[3], lo[3]);
}

__device__ __forceinline__ void split_b(float2 v, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split(v.x, hi[0], lo[0]);
  split(v.y, hi[1], lo[1]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][n] += a[m] * b[n] in 3xTF32 over an M x N grid of tiles, one
// term at a time across the whole grid, so that the three products into
// one accumulator are M * N mma issues apart rather than back to back.
template <int M, int N>
__device__ __forceinline__ void mma3_tiles(float (&acc)[M][N][4],
                                           const uint32_t (&a_hi)[M][4],
                                           const uint32_t (&a_lo)[M][4],
                                           const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m) mma(acc[m][n], a_lo[m], b_hi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m) mma(acc[m][n], a_hi[m], b_lo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m) mma(acc[m][n], a_hi[m], b_hi[n]);
}

__device__ __forceinline__ float2 lo2(float4 v) { return make_float2(v.x, v.y); }
__device__ __forceinline__ float2 hi2(float4 v) { return make_float2(v.z, v.w); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (both addresses 16-byte aligned) or 4-byte asynchronous copy
// into shared memory; the bytes past src_bytes are written as zeros and
// not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory rows of d floats are padded with zeros to dp, a multiple
// of 16 (one 16-byte load per thread covers two k steps), and stored dp
// floats apart. A fragment load reads, in each 8-lane phase, rows g and
// g + 1 at columns 4t..4t+3 (t = 0..3): 16 words of each row. When dp is
// 16 mod 32 the second row's words fall in the other 16 banks by
// themselves; when dp is a multiple of 32 odd rows store their columns
// with bit 4 flipped (column c of row r sits at c ^ swizzle(r, dp)), which
// does the same without padding a row.
__host__ __device__ __forceinline__ int padded_width(int d) {
  return (d + 15) & ~15;
}

__host__ __device__ __forceinline__ int swizzle(int row, int dp) {
  return (dp & 31) == 0 ? (row & 1) << 4 : 0;
}

// Copy `rows` rows of width d (row r at src + r * d) into shared rows of
// dp floats (swizzled as above), zero-filled to dp columns and past
// `valid` rows. `vec` says d % 4 == 0 and src is 16-byte aligned.
template <int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, long long valid, int d,
                                           int dp, bool vec) {
  if (vec) {
    const int q4 = dp >> 2;
    for (int e = threadIdx.x; e < rows * q4; e += kThreads) {
      const int r = e / q4;
      const int c = (e - r * q4) << 2;
      const bool ok = r < valid && c < d;
      cp_async16(dst + r * dp + (c ^ swizzle(r, dp)),
                 ok ? src + (long long)r * d + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * dp; e += kThreads) {
      const int r = e / dp;
      const int c = e - r * dp;
      const bool ok = r < valid && c < d;
      cp_async4(dst + r * dp + (c ^ swizzle(r, dp)),
                ok ? src + (long long)r * d + c : src, ok ? 4 : 0);
    }
  }
}

}  // namespace tf32x3
