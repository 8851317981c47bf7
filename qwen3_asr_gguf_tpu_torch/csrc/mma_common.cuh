// Shared pieces of the hand-written kernels: asynchronous global -> shared
// copies (cp.async) with their group bookkeeping (q4k_matvec.cu,
// attn_decode.cu, q4k_matmul_rows.cu, q4_matmul.cu, fused_mlp.cu), and the warp-level
// mma.sync tiles of the two tensor-core kernels (q4k_matmul_rows.cu,
// q4_matmul.cu).
//
// Fragment layout of mma.sync m16n8k*, with gid = lane / 4, tig = lane % 4:
//   A (16 x K, row): a0 = row gid, a1 = row gid + 8 over the first half of
//     the lane's K slots, a2 / a3 the same rows over the second half;
//   B (K x 8, col):  b0 / b1 = column gid over the same two K-slot halves;
//   C (16 x 8):      c0, c1 = row gid, columns 2*tig and 2*tig + 1;
//                    c2, c3 = row gid + 8, the same columns.
// Which K index a slot carries is free as long as A and B agree: the kernels
// pick the assignment that turns one shared-memory load into registers with
// no shuffle.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0..2) of the committed groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// Wait until at most N of the committed groups are in flight (N a constant).
template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d = A (16 x 32, s8) * B (32 x 8, s8) + c in every element, exact in int32.
__device__ __forceinline__ void m16n8k32_s8(int (&d)[4], int a0, int a1, int a2, int a3, int b0,
                                            int b1, int c) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(c));
}

// c += A (16 x 16, bf16) * B (16 x 8, bf16), f32 accumulate.
__device__ __forceinline__ void m16n8k16_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = A (16 x 16, bf16) * B (16 x 8, bf16): the first product of a sum.
__device__ __forceinline__ void m16n8k16_bf16_first(float (&d)[4], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
}

}  // namespace mma
