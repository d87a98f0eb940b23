// Shared helpers of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): XOR-swizzled shared tiles, cp.async staging and
// f32-accurate products on the tensor cores (3xTF32 mma.sync.m16n8k8).
//
// 3xTF32. Each operand is split as x = hi + lo, hi = x rounded to TF32 (half
// an ulp added, low 13 bits cleared: two integer ops, cheaper than cvt.rna
// and the same but for ties), lo = x - hi, and a*b ~ lo_a*hi_b + hi_a*lo_b
// + hi_a*hi_b, accumulated in f32: about f32 accuracy (one TF32 pass keeps
// about three decimal digits). mma3 runs the three terms term by term
// across N column tiles, so that N accumulator chains are in flight.
//
// Swizzle. Every shared tile is XOR-swizzled in 16-byte chunks (chunk ^
// h(row % 8), h(r) = ((r & 3) << 1) | (r >> 2 & 1)), so the row-order
// fragment loads (8 rows x 4 columns, 32- or 64-bit) and the transposed
// ones (4 rows x 8 columns) all hit distinct banks.
// tests/test_torch_fwd_design.py mirrors swz, split and the fragment
// layouts below in numpy and checks every fragment load for bank conflicts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Float offset of (r, c) in a swizzled (rows, W) shared tile, W >= 32.
__device__ __forceinline__ int swz(int r, int c, int W) {
  const int h = ((r & 3) << 1) | ((r >> 2) & 1);
  return r * W + ((((c >> 2) ^ h)) << 2) + (c & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));  // src-size 0 fills the 16 bytes with zeros
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wait until at most N of this thread's most recent copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  // TF32, round half up
  lo = __float_as_uint(x - __uint_as_float(hi));  // exact; the MMA reads its top 19 bits
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a * b[n] in 3xTF32 for N column tiles, the small terms first;
// term by term across the tiles, so that N accumulator chains are in flight
template <int N>
__device__ __forceinline__ void mma3(float (*c)[4], const uint32_t* ah, const uint32_t* al,
                                     const uint32_t (*bh)[2], const uint32_t (*bl)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], ah, bh[n]);
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4). A (16 x 8): a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4). B (8 x 8): b0 (t, g),
// b1 (t + 4, g). C (16 x 8): c0, c1 (g, 2t + {0, 1}), c2, c3 (g + 8, ...).

// A = X[m0.., k0..] of a row-major tile X
template <int W>
__device__ __forceinline__ void load_a(const float* X, int m0, int k0, int g, int t,
                                       uint32_t* hi, uint32_t* lo) {
  split(X[swz(m0 + g, k0 + t, W)], hi[0], lo[0]);
  split(X[swz(m0 + g + 8, k0 + t, W)], hi[1], lo[1]);
  split(X[swz(m0 + g, k0 + t + 4, W)], hi[2], lo[2]);
  split(X[swz(m0 + g + 8, k0 + t + 4, W)], hi[3], lo[3]);
}

// The same A and B^T, with the depth index permuted: thread t takes depths
// 2t and 2t + 1 (one 64-bit LDS each) in place of t and t + 4. Any
// permutation of the 8 depths applied to both operands of a product leaves
// it unchanged, so these pair only with each other.
template <int W>
__device__ __forceinline__ void load_a2(const float* X, int m0, int k0, int g, int t,
                                        uint32_t* hi, uint32_t* lo) {
  const float2 x0 = *reinterpret_cast<const float2*>(X + swz(m0 + g, k0 + 2 * t, W));
  const float2 x1 = *reinterpret_cast<const float2*>(X + swz(m0 + g + 8, k0 + 2 * t, W));
  split(x0.x, hi[0], lo[0]);
  split(x1.x, hi[1], lo[1]);
  split(x0.y, hi[2], lo[2]);
  split(x1.y, hi[3], lo[3]);
}

template <int W>
__device__ __forceinline__ void load_bt2(const float* X, int k0, int n0, int g, int t,
                                         uint32_t* hi, uint32_t* lo) {
  const float2 x = *reinterpret_cast<const float2*>(X + swz(n0 + g, k0 + 2 * t, W));
  split(x.x, hi[0], lo[0]);
  split(x.y, hi[1], lo[1]);
}

// A = X^T[m0.., k0..] of a tile X stored (k, m)
template <int W>
__device__ __forceinline__ void load_at(const float* X, int m0, int k0, int g, int t,
                                        uint32_t* hi, uint32_t* lo) {
  split(X[swz(k0 + t, m0 + g, W)], hi[0], lo[0]);
  split(X[swz(k0 + t, m0 + g + 8, W)], hi[1], lo[1]);
  split(X[swz(k0 + t + 4, m0 + g, W)], hi[2], lo[2]);
  split(X[swz(k0 + t + 4, m0 + g + 8, W)], hi[3], lo[3]);
}

// B = X[k0.., n0..] of a tile X stored (k, n)
template <int W>
__device__ __forceinline__ void load_b(const float* X, int k0, int n0, int g, int t,
                                       uint32_t* hi, uint32_t* lo) {
  split(X[swz(k0 + t, n0 + g, W)], hi[0], lo[0]);
  split(X[swz(k0 + t + 4, n0 + g, W)], hi[1], lo[1]);
}

}  // namespace
