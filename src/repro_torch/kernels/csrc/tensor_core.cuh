// Pieces shared by the kernels that run fp32 products on the TF32 tensor
// cores of Hopper (sm_90a) and feed them through cp.async rings:
// flash_attention.cu and ssd_chunk.cu; paged_attention.cu takes the
// cp.async pieces. Internal linkage, as each source's own helpers.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---- TF32 tensor-core pieces
// round to TF32, nearest with ties away from zero: cvt.rna.tf32.f32's
// result (finite x), at integer rate
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x), lo = tf32(x - hi); without kSplit x is TF32 already
// (a widened bf16) and lo is never read
template <bool kSplit>
__device__ __forceinline__ void frag(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kSplit) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
  }
}

// c += a.b, m16n8k8: a [16x8] row-major fragment, b [8x8] col-major
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in 3xTF32: lo.hi + hi.lo + hi.hi, small terms first; an
// operand without its lo (kLoA / kLoB false) drops that pass
template <bool kLoA, bool kLoB>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (kLoA) mma(c, al, bh);
  if constexpr (kLoB) mma(c, ah, bl);
  mma(c, ah, bh);
}

// ---- asynchronous copies
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? N : 0;  // src-size 0: zero-fill, nothing read
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- host side
// the widest copy (16, 8 or 4 bytes) that every row of row_bytes starting
// at p stays aligned to; 0 for none
inline int copy_bytes(const void* p, size_t row_bytes) {
  for (int vec = 16; vec >= 4; vec /= 2)
    if (row_bytes % vec == 0 && reinterpret_cast<uintptr_t>(p) % vec == 0)
      return vec;
  return 0;
}

}  // namespace
