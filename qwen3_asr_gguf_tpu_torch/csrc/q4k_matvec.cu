// q4_k int4-stream matvec for one activation row, for Hopper (sm_90a).
//
// Replaces the TPU kernels of qwen3_asr_gguf_tpu/ops/pallas_q4k.py:
//   q4k_matvec_launch        <- `_kernel` via `_matvec_call` (pallas_call at :324)
//   q4k_matvec_normed_launch <- `_kernel_normed` via `_matvec_call_normed` (:594)
// Same math, same weight layout (see ops/q4k.py, Q4KWeight):
//   packed u8 [N/2, K]  signed nibbles (q-8); byte [r, k] holds channel 2r in
//                       its low nibble and channel 2r+1 in its high nibble
//   sub_t  i8 [K/32, N] 6-bit sub-scales, min_t i8 [K/32, N] 6-bit sub-mins
//   dd_t   f32 [2*K/256, N] row 2s = d_s, row 2s+1 = dmin_s
//   scale = sub*d, minv = min*dmin, w = q*scale + (8*scale - minv)
//   out[n] = sum_g acc[g,n]*scale*sx[g] + xsum[g]*(8*scale - minv)
// with the activation quantized per 32-group to int8 (x * (1/sx), round half
// to even, sx = max(amax, 1e-10)/127) and acc the exact int32 group dot.
//
// Bound: decode at batch 1 reads every weight byte once per token and does
// ~2 integer ops per byte, so the kernel is bound by device-memory bandwidth
// (3.35 TB/s on an H100 SXM; 0.85 GB of int4 weights + scales per 1.7B token
// is a 0.25 ms floor). Design: pass A quantizes the row once (one small
// block); pass B gives each warp one packed row (a channel pair), each lane
// whole 32-groups read as two 16-byte loads, nibbles sign-extended in
// registers and dotted with __dp4a, the exact factored scales applied per
// group, and a warp-shuffle reduction at the end.
// Known weakness, for a later change: the [G, N] scale planes are read with
// a stride of N per group (3 bytes per 32 weights, 2 of them in separate
// planes), so their loads are not coalesced; a repacked Hopper layout with
// scales beside their weights (and wgmma/TMA for the batched case) comes later.

#include "q4k_common.cuh"

namespace {

using namespace q4k;

constexpr int MAX_GRID = 4096;
constexpr int MAX_NORMED_K = 2048;

// Pass A of q4k_matvec_normed: rms_norm(x)*w with the bf16 round-trip of
// the unfused path (rms_norm output is bf16), then the group quantization.
__global__ void norm_quantize_row_kernel(const void* x, int x_bf16, const float* norm_w,
                                         float eps, int k, int8_t* xq, float* sx,
                                         float* xsum) {
  __shared__ float xs[MAX_NORMED_K];
  __shared__ float partial[QUANT_THREADS / 32];
  __shared__ float rstd_s;
  float ss = 0.f;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float v = load_x(x, x_bf16, i);
    xs[i] = v;
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += partial[w];
    rstd_s = rsqrtf(total / (float)k + eps);
  }
  __syncthreads();
  const float rstd = rstd_s;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float v = xs[i] * rstd * norm_w[i];
    xs[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  __syncthreads();
  quantize_groups(xs, k, xq, sx, xsum);
}

// Pass B: one warp per packed row (channel pair), grid-stride over rows.
__global__ void __launch_bounds__(MV_WARPS * 32)
q4k_matvec_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                  const float* __restrict__ xsum, const uint8_t* __restrict__ packed,
                  const int8_t* __restrict__ sub_t, const int8_t* __restrict__ min_t,
                  const float* __restrict__ dd_t, void* __restrict__ out, int out_bf16,
                  int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];  // xq[k] | sx[G] | xsum[G]
  const int groups = k / GROUP;
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem);
  float* sx_s = reinterpret_cast<float*>(smem + k);
  float* xsum_s = sx_s + groups;
  for (int i = threadIdx.x; i < k / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(xq_s)[i] = reinterpret_cast<const uint4*>(xq)[i];
  for (int i = threadIdx.x; i < groups; i += blockDim.x) {
    sx_s[i] = sx[i];
    xsum_s[i] = xsum[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int rows = n / 2;
  for (int r = blockIdx.x * MV_WARPS + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * MV_WARPS) {
    const uint8_t* wrow = packed + static_cast<size_t>(r) * k;
    const int c = 2 * r;
    float acc0 = 0.f, acc1 = 0.f;
    for (int g = lane; g < groups; g += 32) {
      const uint4* wp = reinterpret_cast<const uint4*>(wrow + g * GROUP);
      const uint4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
      const uint4* xp = reinterpret_cast<const uint4*>(xq_s + g * GROUP);
      const uint4 x0 = xp[0], x1 = xp[1];
      int d0 = 0, d1 = 0;
      dot4(w0.x, static_cast<int>(x0.x), d0, d1);
      dot4(w0.y, static_cast<int>(x0.y), d0, d1);
      dot4(w0.z, static_cast<int>(x0.z), d0, d1);
      dot4(w0.w, static_cast<int>(x0.w), d0, d1);
      dot4(w1.x, static_cast<int>(x1.x), d0, d1);
      dot4(w1.y, static_cast<int>(x1.y), d0, d1);
      dot4(w1.z, static_cast<int>(x1.z), d0, d1);
      dot4(w1.w, static_cast<int>(x1.w), d0, d1);

      const PairScales ps = pair_scales(sub_t, min_t, dd_t, n, g, c);
      const float sxg = sx_s[g], xsg = xsum_s[g];
      acc0 += static_cast<float>(d0) * ps.sc0 * sxg + xsg * ps.off0;
      acc1 += static_cast<float>(d1) * ps.sc1 * sxg + xsg * ps.off1;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc0 += __shfl_xor_sync(0xffffffffu, acc0, o);
      acc1 += __shfl_xor_sync(0xffffffffu, acc1, o);
    }
    if (lane == 0) {
      if (out_bf16)
        reinterpret_cast<__nv_bfloat162*>(out)[r] = __floats2bfloat162_rn(acc0, acc1);
      else
        reinterpret_cast<float2*>(out)[r] = make_float2(acc0, acc1);
    }
  }
}

int launch_matvec(const int8_t* xq, const float* sx, const float* xsum,
                  const uint8_t* packed, const int8_t* sub_t, const int8_t* min_t,
                  const float* dd_t, void* out, int out_bf16, int n, int k,
                  cudaStream_t stream) {
  const int rows = n / 2;
  int grid = (rows + MV_WARPS - 1) / MV_WARPS;
  if (grid > MAX_GRID) grid = MAX_GRID;
  const size_t smem = static_cast<size_t>(k) + 2 * sizeof(float) * (k / GROUP);
  q4k_matvec_kernel<<<grid, MV_WARPS * 32, smem, stream>>>(xq, sx, xsum, packed, sub_t,
                                                            min_t, dd_t, out, out_bf16, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int q4k_matvec_launch(const void* x, int x_bf16, int8_t* xq, float* sx,
                                 float* xsum, const uint8_t* packed, const int8_t* sub_t,
                                 const int8_t* min_t, const float* dd_t, void* out,
                                 int out_bf16, int n, int k, cudaStream_t stream) {
  quantize_rows_kernel<<<1, QUANT_THREADS, sizeof(float) * k, stream>>>(x, x_bf16, k, xq, sx,
                                                                         xsum);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_matvec(xq, sx, xsum, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, stream);
}

extern "C" int q4k_matvec_normed_launch(const void* x, int x_bf16, const float* norm_w,
                                        float eps, int8_t* xq, float* sx, float* xsum,
                                        const uint8_t* packed, const int8_t* sub_t,
                                        const int8_t* min_t, const float* dd_t, void* out,
                                        int out_bf16, int n, int k, cudaStream_t stream) {
  if (k > MAX_NORMED_K) return static_cast<int>(cudaErrorInvalidValue);
  norm_quantize_row_kernel<<<1, QUANT_THREADS, 0, stream>>>(x, x_bf16, norm_w, eps, k, xq, sx,
                                                            xsum);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_matvec(xq, sx, xsum, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, stream);
}
