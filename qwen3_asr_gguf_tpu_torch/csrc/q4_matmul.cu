// Fused int4 dequant + matmul over the planar Q4Weight layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` via `_q4_matmul_2d`
// (qwen3_asr_gguf_tpu/ops/pallas_qmm.py, pallas_call at :85; `q4_matmul`):
// every decode matvec of a precision="q4_k" engine and the int4 encoder's
// products on inputs of at most 64 rows. Layout (ops/qmm.py, Q4Weight):
//   packed u8 [N, K/2]: with g = K/64, column c = r*g + gi holds natural
//     index gi*32 + r of the first half of K in its low nibble and of the
//     second half in its high nibble (planar, rank-major);
//   scale, minv f32 [N, K/32]: column c uses group c % g (low) and
//     g + c % g (high).
//   out[t, n] = sum_c xlo[t, c]*(lo(c)*s - m) + xhi[t, c]*(hi(c)*s - m)
// with the weight dequantized as q*s - m in f32 (a multiply, then a
// subtract, each rounded), x cast to f32, an f32 sum, out in x's dtype. No
// activation quantization and no integer dot: unlike the q4_k kernels the
// result depends on nothing but the f32 sum order.
//
// Bound: at T <= 64 rows every weight byte is read once and takes 4*T
// floating-point operations, far below the card's rate, so the kernel is
// bound by device-memory bandwidth: N*K/2 packed bytes plus 8*N*K/32 bytes of
// scales and offsets (half as much again).
// Design: a warp per output channel, 8 channels per block pass. x is staged
// in shared memory already permuted to the packed column order (so weights,
// x and the scale index all run over the same contiguous c), in chunks of
// packed columns that fit 32 KB for the TT rows of the block's row tile;
// grid.y walks the row tiles (TT = 1, 4, 8 or 16 by T), re-reading the
// weights from L2 once per tile. A lane takes 4 packed bytes per step (128
// contiguous bytes per warp), unpacks its 8 nibbles once (the 0x4B000000
// float trick instead of 8 int-to-float conversions), dequantizes them once
// and adds them into TT partial sums; a shuffle reduction ends each channel.
// Where all of K fits one chunk (every T = 1 shape here) a block keeps its x
// and walks up to 8 channels per warp, so a large N (the LM head) stages x
// 8 times less often.
// Known weaknesses, for a later change: scales and offsets are read through
// L1 at every step (four 16-byte loads per lane-step); the staging gathers x
// with a stride; no tensor cores at T = 16..64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int SMEM_FLOATS = 8192;  // 32 KB of staged x: [low | high][TT][ck]
constexpr int MAX_CPW = 8;         // channels per warp at one chunk
constexpr int FILL_BLOCKS = 264;   // two blocks per SM before a warp takes more channels

__device__ __forceinline__ float load_x(const void* x, int x_bf16, size_t i) {
  return x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i])
                : reinterpret_cast<const float*>(x)[i];
}

// An integer 0..15 as a float without a conversion instruction.
__device__ __forceinline__ float nibble_f32(uint32_t q) {
  return __uint_as_float(0x4B000000u | q) - 8388608.0f;
}

__device__ __forceinline__ float dequant(uint32_t q, float s, float m) {
  return __fsub_rn(__fmul_rn(nibble_f32(q), s), m);  // q*s - m, two roundings
}

template <int TT>
__global__ void __launch_bounds__(WARPS * 32)
q4_matmul_kernel(const void* __restrict__ x, int x_bf16, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, const float* __restrict__ minv,
                 void* __restrict__ out, int t, int n, int k, int ck, int cpw) {
  extern __shared__ __align__(16) float xs[];
  const int k2 = k / 2, g = k / 64, groups = k / 32;
  const int row0 = blockIdx.y * TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = (k2 + ck - 1) / ck;
  const bool vec_scales = (g % 4) == 0;
  float* xlo = xs;
  float* xhi = xs + TT * ck;

  for (int ci = 0; ci < cpw; ++ci) {
    const int ch = (blockIdx.x * cpw + ci) * WARPS + warp;
    float acc[TT];
#pragma unroll
    for (int r = 0; r < TT; ++r) acc[r] = 0.f;

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int c0 = chunk * ck;
      const int width = min(ck, k2 - c0);
      if (n_chunks > 1 || ci == 0) {  // uniform over the block
        __syncthreads();
        for (int i = threadIdx.x; i < TT * width; i += blockDim.x) {
          const int rt = i / width, cl = i - rt * width;
          const int c = c0 + cl;
          const int rank = c / g, gi = c - rank * g;
          const int row = row0 + rt;
          float lo = 0.f, hi = 0.f;
          if (row < t) {
            const size_t at = static_cast<size_t>(row) * k + gi * 32 + rank;
            lo = load_x(x, x_bf16, at);
            hi = load_x(x, x_bf16, at + k2);
          }
          xlo[rt * ck + cl] = lo;
          xhi[rt * ck + cl] = hi;
        }
        __syncthreads();
      }
      if (ch < n) {
        const uint8_t* prow = packed + static_cast<size_t>(ch) * k2 + c0;
        const float* srow = scale + static_cast<size_t>(ch) * groups;
        const float* mrow = minv + static_cast<size_t>(ch) * groups;
        for (int cl = lane * 4; cl < width; cl += 128) {
          const uint32_t wb = __ldg(reinterpret_cast<const uint32_t*>(prow + cl));
          const int gi0 = (c0 + cl) % g;
          float sl[4], ml[4], sh[4], mh[4];
          if (vec_scales) {  // gi0 % 4 == 0 and gi0 + 3 < g
            const float4 a = __ldg(reinterpret_cast<const float4*>(srow + gi0));
            const float4 b = __ldg(reinterpret_cast<const float4*>(mrow + gi0));
            const float4 c4 = __ldg(reinterpret_cast<const float4*>(srow + g + gi0));
            const float4 d4 = __ldg(reinterpret_cast<const float4*>(mrow + g + gi0));
            sl[0] = a.x, sl[1] = a.y, sl[2] = a.z, sl[3] = a.w;
            ml[0] = b.x, ml[1] = b.y, ml[2] = b.z, ml[3] = b.w;
            sh[0] = c4.x, sh[1] = c4.y, sh[2] = c4.z, sh[3] = c4.w;
            mh[0] = d4.x, mh[1] = d4.y, mh[2] = d4.z, mh[3] = d4.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int gi = (gi0 + e) % g;
              sl[e] = __ldg(srow + gi), ml[e] = __ldg(mrow + gi);
              sh[e] = __ldg(srow + g + gi), mh[e] = __ldg(mrow + g + gi);
            }
          }
          float wl[4], wh[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t byte = (wb >> (8 * e)) & 0xFFu;
            wl[e] = dequant(byte & 0x0Fu, sl[e], ml[e]);
            wh[e] = dequant(byte >> 4, sh[e], mh[e]);
          }
#pragma unroll
          for (int r = 0; r < TT; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(xlo + r * ck + cl);
            const float4 b = *reinterpret_cast<const float4*>(xhi + r * ck + cl);
            acc[r] += a.x * wl[0] + a.y * wl[1] + a.z * wl[2] + a.w * wl[3]
                    + b.x * wh[0] + b.y * wh[1] + b.z * wh[2] + b.w * wh[3];
          }
        }
      }
    }
    if (ch < n) {
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        float v = acc[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0 && row0 + r < t) {
          const size_t at = static_cast<size_t>(row0 + r) * n + ch;
          if (x_bf16)
            reinterpret_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v);
          else
            reinterpret_cast<float*>(out)[at] = v;
        }
      }
    }
  }
}

template <int TT>
int launch(const void* x, int x_bf16, const uint8_t* packed, const float* scale,
           const float* minv, void* out, int t, int n, int k, cudaStream_t stream) {
  const int k2 = k / 2;
  int ck = SMEM_FLOATS / (2 * TT) / 128 * 128;
  const int k2_up = (k2 + 127) / 128 * 128;
  if (ck > k2_up) ck = k2_up;
  int cpw = 1;
  if (ck >= k2) {  // one chunk: a block keeps its x across channels
    cpw = n / (WARPS * FILL_BLOCKS);
    cpw = cpw < 1 ? 1 : (cpw > MAX_CPW ? MAX_CPW : cpw);
  }
  const int per_block = WARPS * cpw;
  const dim3 grid((n + per_block - 1) / per_block, (t + TT - 1) / TT);
  const size_t smem = sizeof(float) * 2 * TT * ck;
  q4_matmul_kernel<TT><<<grid, WARPS * 32, smem, stream>>>(x, x_bf16, packed, scale, minv, out,
                                                           t, n, k, ck, cpw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [t, k] (f32 or bf16) -> out [t, n] in x's dtype. 1 <= t <= 64, k % 64 == 0
// (checked by the wrapper; refused here as an invalid value).
extern "C" int q4_matmul_launch(const void* x, int x_bf16, const uint8_t* packed,
                                const float* scale, const float* minv, void* out, int t,
                                int n, int k, cudaStream_t stream) {
  if (t <= 0 || t > 64 || n <= 0 || k <= 0 || k % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t == 1) return launch<1>(x, x_bf16, packed, scale, minv, out, t, n, k, stream);
  if (t <= 4) return launch<4>(x, x_bf16, packed, scale, minv, out, t, n, k, stream);
  if (t <= 8) return launch<8>(x, x_bf16, packed, scale, minv, out, t, n, k, stream);
  return launch<16>(x, x_bf16, packed, scale, minv, out, t, n, k, stream);
}
