// Shared pieces of the q4_k kernels (q4k_matvec.cu, q4k_matmul_rows.cu):
// the weight layout of ops/q4k.py (Q4KWeight), the per-32-group int8
// activation quantization of the TPU kernels (x * (1/sx), round half to
// even, sx = max(amax, 1e-10)/127) and the signed-nibble __dp4a dots.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Inline functions: each source that includes this header compiles its own
// copy.
namespace q4k {

constexpr int GROUP = 32;
constexpr int MV_WARPS = 8;
constexpr int MAX_K = 12288;  // the wrappers' bound (ops/q4k.py)
constexpr float INV127 = (float)(1.0 / 127.0);

// Signed int4 nibbles of 4 bytes as two words of 4 signed bytes: the low
// nibbles (even channel) and the high nibbles (odd channel).
__device__ __forceinline__ void split_nibbles(uint32_t w, int& lo, int& hi) {
  lo = static_cast<int>(__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
  hi = static_cast<int>(__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
}

// Signed int4 nibbles of 4 bytes dotted with 4 int8 activations, for the
// low (even channel) and high (odd channel) nibbles.
__device__ __forceinline__ void dot4(uint32_t w, int x, int& lo, int& hi) {
  int l, h;
  split_nibbles(w, l, h);
  lo = __dp4a(l, x, lo);
  hi = __dp4a(h, x, hi);
}

}  // namespace q4k
