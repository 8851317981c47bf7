// One token's int8 SwiGLU MLP, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of `fused_mlp_matvec`
// (qwen3_asr_gguf_tpu/ops/pallas_mlp.py, pallas_call at :85): the MLP of the
// single-stream decode step of a precision="int8" engine. Weights Wg, Wu
// int8 [M, D] with f32 scales sg, su [M]; Wd int8 [D, M] with sd [D]:
//   sx   = max(max|x| / 127, 1e-10);  xq = clip(rne(x / sx), -127, 127)
//   g[m] = f32(xq . Wg[m]) * (sx * sg[m]);  u[m] likewise with Wu, su
//   act[m] = (g * 1/(1 + exp(-g))) * u
//   per tile j of tile_m consecutive m:
//     s_j = max(max|act_j| / 127, 1e-10);  aq = clip(rne(act / s_j), -127, 127)
//     acc[d] += f32(aq_j . Wd[d, tile j]) * s_j          (tiles in order, f32)
//   out[d] = acc[d] * sd[d]
// Both quantizations DIVIDE by the scale (the q4_k kernels multiply by a
// reciprocal) and round half to even; the dots are exact int32 (__dp4a).
//
// Bound: 3*D*M weight bytes read once, 2 integer operations per byte: bound
// by device-memory bandwidth.
// Design: two launches and one f32 scratch of M values (the down product
// needs every act of a tile before it can quantize one, and blocks cannot
// wait for each other without a cooperative launch).
//   A (mlp_act_kernel): each block derives sx from x and quantizes x into
//     shared memory (D bytes), then a warp per M row takes both int8 dots
//     with 16-byte loads and writes act[m].
//   B (mlp_down_kernel): each block quantizes the M acts per tile into
//     shared memory (a warp per tile: its maximum, then its int8s), then a
//     warp per output d walks the tiles in order, one 16-byte load per lane
//     per 512-wide tile.
// Known weaknesses, for a later change: every block of B quantizes all M acts
// again (24 KB from L2 at M = 6144); two launches where a cooperative one
// would do; no overlap of the scratch round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FILL_BLOCKS = 264;  // two blocks per SM before a warp takes more rows
constexpr int MAX_RPW = 8;

__device__ __forceinline__ float load_x(const void* x, int x_bf16, size_t i) {
  return x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i])
                : reinterpret_cast<const float*>(x)[i];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-10f);
}

__device__ __forceinline__ int8_t quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));  // round half to even
  return static_cast<int8_t>(min(max(q, -127), 127));
}

__device__ __forceinline__ int dot16(const int4& w, const int4& a, int acc) {
  acc = __dp4a(w.x, a.x, acc);
  acc = __dp4a(w.y, a.y, acc);
  acc = __dp4a(w.z, a.z, acc);
  return __dp4a(w.w, a.w, acc);
}

__global__ void __launch_bounds__(THREADS)
mlp_act_kernel(const void* __restrict__ x, int x_bf16, const int8_t* __restrict__ wg,
               const float* __restrict__ sg, const int8_t* __restrict__ wu,
               const float* __restrict__ su, float* __restrict__ act, int m, int d, int rpw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS];
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float amax = 0.f;
  for (int i = threadIdx.x; i < d; i += THREADS) amax = fmaxf(amax, fabsf(load_x(x, x_bf16, i)));
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) amax = fmaxf(amax, red[w]);
  const float sx = quant_scale(amax);
  for (int i = threadIdx.x; i < d; i += THREADS) xq[i] = quant(load_x(x, x_bf16, i), sx);
  __syncthreads();

  for (int j = 0; j < rpw; ++j) {
    const int row = (blockIdx.x * WARPS + warp) * rpw + j;
    if (row >= m) break;  // uniform over the warp; no block barrier follows
    const int8_t* grow = wg + static_cast<size_t>(row) * d;
    const int8_t* urow = wu + static_cast<size_t>(row) * d;
    int gacc = 0, uacc = 0;
    for (int i = lane * 16; i < d; i += 512) {
      const int4 a = *reinterpret_cast<const int4*>(xq + i);
      gacc = dot16(__ldg(reinterpret_cast<const int4*>(grow + i)), a, gacc);
      uacc = dot16(__ldg(reinterpret_cast<const int4*>(urow + i)), a, uacc);
    }
    gacc = warp_sum(gacc);
    uacc = warp_sum(uacc);
    if (lane == 0) {
      const float g = __fmul_rn(static_cast<float>(gacc), __fmul_rn(sx, sg[row]));
      const float u = __fmul_rn(static_cast<float>(uacc), __fmul_rn(sx, su[row]));
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
      act[row] = __fmul_rn(__fmul_rn(g, sig), u);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mlp_down_kernel(const float* __restrict__ act, const int8_t* __restrict__ wd,
                const float* __restrict__ sd, void* __restrict__ out, int out_bf16, int m,
                int d, int tile_m, int rpw) {
  // aq[m] int8 | s_act[m / tile_m] f32
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* aq = reinterpret_cast<int8_t*>(smem);
  float* s_act = reinterpret_cast<float*>(smem + (m + 15) / 16 * 16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = m / tile_m;

  for (int tile = warp; tile < n_tiles; tile += WARPS) {
    const float* a = act + static_cast<size_t>(tile) * tile_m;
    float amax = 0.f;
    for (int i = lane; i < tile_m; i += 32) amax = fmaxf(amax, fabsf(a[i]));
    const float s = quant_scale(warp_max(amax));
    for (int i = lane; i < tile_m; i += 32) aq[tile * tile_m + i] = quant(a[i], s);
    if (lane == 0) s_act[tile] = s;
  }
  __syncthreads();

  for (int j = 0; j < rpw; ++j) {
    const int row = (blockIdx.x * WARPS + warp) * rpw + j;
    if (row >= d) break;
    const int8_t* wrow = wd + static_cast<size_t>(row) * m;
    float acc = 0.f;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int base = tile * tile_m;
      int y = 0;
      for (int i = lane * 16; i < tile_m; i += 512)
        y = dot16(__ldg(reinterpret_cast<const int4*>(wrow + base + i)),
                  *reinterpret_cast<const int4*>(aq + base + i), y);
      y = warp_sum(y);
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(y), s_act[tile]));  // tile order
    }
    if (lane == 0) {
      const float v = __fmul_rn(acc, sd[row]);
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[row] = __float2bfloat16_rn(v);
      else
        reinterpret_cast<float*>(out)[row] = v;
    }
  }
}

int rows_per_warp(int rows) {
  const int rpw = rows / (WARPS * FILL_BLOCKS);
  return rpw < 1 ? 1 : (rpw > MAX_RPW ? MAX_RPW : rpw);
}

}  // namespace

// x [d] (f32 or bf16) -> out [d] in x's dtype; act is an f32 scratch of m
// values. d % 16 == 0, tile_m % 16 == 0, m % tile_m == 0, d <= 32768,
// m <= 32768 (checked by the wrapper; refused here as an invalid value).
extern "C" int fused_mlp_launch(const void* x, int x_bf16, const int8_t* wg, const float* sg,
                                const int8_t* wu, const float* su, const int8_t* wd,
                                const float* sd, float* act, void* out, int m, int d,
                                int tile_m, cudaStream_t stream) {
  if (m <= 0 || d <= 0 || tile_m <= 0 || d % 16 || tile_m % 16 || m % tile_m || d > 32768 ||
      m > 32768)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpw_a = rows_per_warp(m);
  const int per_a = WARPS * rpw_a;
  mlp_act_kernel<<<(m + per_a - 1) / per_a, THREADS, d, stream>>>(x, x_bf16, wg, sg, wu, su,
                                                                   act, m, d, rpw_a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int rpw_b = rows_per_warp(d);
  const int per_b = WARPS * rpw_b;
  const size_t smem_b = (m + 15) / 16 * 16 + sizeof(float) * (m / tile_m);
  mlp_down_kernel<<<(d + per_b - 1) / per_b, THREADS, smem_b, stream>>>(
      act, wd, sd, out, x_bf16, m, d, tile_m, rpw_b);
  return static_cast<int>(cudaGetLastError());
}
