// Shared pieces of the q4_k kernels (q4k_matvec.cu, q4k_matmul_rows.cu):
// the weight layout of ops/q4k.py (Q4KWeight), the per-32-group int8
// activation quantization of the TPU kernels (x * (1/sx), round half to
// even, sx = max(amax, 1e-10)/127) and the signed-nibble __dp4a dots.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Inline functions, and a static kernel: each source that includes this
// header compiles its own copy.
namespace q4k {

constexpr int GROUP = 32;
constexpr int QUANT_THREADS = 256;
constexpr int MV_WARPS = 8;
constexpr int MAX_K = 12288;  // the wrappers' bound (ops/q4k.py)
constexpr float INV127 = (float)(1.0 / 127.0);

__device__ __forceinline__ float load_x(const void* x, int x_bf16, size_t i) {
  return x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i])
                : reinterpret_cast<const float*>(x)[i];
}

// Quantize 32-groups of `row` (already in final f32 form) into xq/sx/xsum.
__device__ __forceinline__ void quantize_groups(const float* row, int k, int8_t* xq,
                                                float* sx, float* xsum) {
  const int groups = k / GROUP;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const float* v = row + g * GROUP;
    float amax = 0.f, s = 0.f;
#pragma unroll
    for (int e = 0; e < GROUP; ++e) {
      amax = fmaxf(amax, fabsf(v[e]));
      s += v[e];
    }
    const float sxg = fmaxf(amax, 1e-10f) * INV127;
    const float r = 1.0f / sxg;
#pragma unroll
    for (int e = 0; e < GROUP; ++e) {
      int q = __float2int_rn(v[e] * r);
      q = min(max(q, -127), 127);
      xq[g * GROUP + e] = static_cast<int8_t>(q);
    }
    sx[g] = sxg;
    xsum[g] = s;
  }
}

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

// Factored q4_k scales of channels c and c+1 in group g: scale = sub*d and
// offset = 8*scale - min*dmin (the `_expand_group_scales` math).
struct PairScales {
  float sc0, sc1, off0, off1;
};

__device__ __forceinline__ PairScales pair_scales(const int8_t* __restrict__ sub_t,
                                                  const int8_t* __restrict__ min_t,
                                                  const float* __restrict__ dd_t, int n,
                                                  int g, int c) {
  const size_t gi = static_cast<size_t>(g) * n + c;
  const char2 sub = *reinterpret_cast<const char2*>(sub_t + gi);
  const char2 mn = *reinterpret_cast<const char2*>(min_t + gi);
  const size_t srow = static_cast<size_t>(2 * (g >> 3)) * n + c;
  const float2 dv = *reinterpret_cast<const float2*>(dd_t + srow);
  const float2 mv = *reinterpret_cast<const float2*>(dd_t + srow + n);
  PairScales p;
  p.sc0 = static_cast<float>(sub.x) * dv.x;
  p.sc1 = static_cast<float>(sub.y) * dv.y;
  p.off0 = 8.f * p.sc0 - static_cast<float>(mn.x) * mv.x;
  p.off1 = 8.f * p.sc1 - static_cast<float>(mn.y) * mv.y;
  return p;
}

// Pass A: quantize the activation row blockIdx.x (x is [rows, k]); the
// dynamic shared memory holds k floats.
static __global__ void quantize_rows_kernel(const void* x, int x_bf16, int k, int8_t* xq, float* sx,
                                     float* xsum) {
  extern __shared__ float xs[];
  const size_t off = static_cast<size_t>(blockIdx.x) * k;
  const size_t goff = static_cast<size_t>(blockIdx.x) * (k / GROUP);
  for (int i = threadIdx.x; i < k; i += blockDim.x) xs[i] = load_x(x, x_bf16, off + i);
  __syncthreads();
  quantize_groups(xs, k, xq + off, sx + goff, xsum + goff);
}

}  // namespace q4k
