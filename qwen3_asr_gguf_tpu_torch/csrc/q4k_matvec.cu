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
// is a 0.25 ms floor); at the layer shapes (2-6 MB) the time is latency: how
// soon the whole weight is in flight.
//
// q4k_matvec (one launch). A tile is 16 channels: one packed row per warp
// of a block of 8 warps, each lane the 32-groups lane, lane + 32, ... of
// the row. There are as many blocks as the card holds at once (at most one
// per tile: N / 16 at the layer shapes), each walking tiles b, b + grid, ...
// The block's prologue (1) starts 16-byte cp.async copies of the sub_t /
// min_t / dd_t rows of its first two tiles' channels (read along N, where
// they are contiguous) into two shared-memory stages, (2) issues each lane's
// first U 32-byte groups of weights as register loads, and only then (3)
// quantizes the activation row into shared memory a warp at a time:
// 8 lanes per 32-group, 4 values each, amax and sum by three butterfly steps
// (the order of the multi-row kernel's pass A, so xsum is bit-equal to
// `quantize_act_kernel_order`). Each lane then keeps U groups in flight as a
// ring in registers, across tiles (a tile's scale stage is refilled with the
// tile two ahead once every warp is past it): nibbles sign-extended and
// dotted with __dp4a, the exact
// factored scales applied per group as acc = fma(xsum, offs, fma(dot*sx,
// scale, acc)), a warp butterfly at the end of each row. No scratch in
// device memory; `q4k_matvec_kernel_order` (ops/q4k.py) repeats its sums.
//
// q4k_matvec_normed (kernel 2, two launches): pass A
// normalizes and quantizes the row once (one small block); pass B gives each
// warp one packed row, each lane whole 32-groups read as two 16-byte loads,
// and reads the [G, N] scale planes with a stride of N per group.

#include "mma_common.cuh"
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

constexpr int U = 4;  // 32-byte weight groups each lane keeps in flight
constexpr int C_TILE = 2 * MV_WARPS;  // channels of a tile: one packed row per warp
constexpr int SMEM_LIMIT = 227 * 1024;

// Bytes of one stage of a tile's scale rows: sub[G][16] i8 | min[G][16] i8 |
// dd[G/4][16] f32 (rows 2s = d, 2s + 1 = dmin of superblock s).
__host__ __device__ inline int scale_stage_bytes(int k) {
  const int groups = k / GROUP;
  return 2 * groups * C_TILE + (groups / 4) * C_TILE * 4;
}

// Shared memory of the one-launch kernel: two scale stages, then the
// quantized row: xq[K] i8 | sx[G] | xsum[G].
__host__ __device__ inline int one_smem_bytes(int k) {
  return 2 * scale_stage_bytes(k) + k + 8 * (k / GROUP);
}

__device__ __forceinline__ void load_group(const uint8_t* __restrict__ packed, size_t off,
                                           uint4 (&w)[2]) {
  const uint4* p = reinterpret_cast<const uint4*>(packed + off);
  w[0] = __ldg(p);
  w[1] = __ldg(p + 1);
}

// One launch; see the header. Block b takes tiles b, b + gridDim.x, ... of
// 16 channels (one packed row per warp).
__global__ void __launch_bounds__(MV_WARPS * 32)
q4k_matvec_one_kernel(const void* __restrict__ x, int x_bf16, const uint8_t* __restrict__ packed,
                      const int8_t* __restrict__ sub_t, const int8_t* __restrict__ min_t,
                      const float* __restrict__ dd_t, void* __restrict__ out, int out_bf16,
                      int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = k / GROUP;
  const int stage_bytes = scale_stage_bytes(k);
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem + 2 * stage_bytes);
  float* sx_s = reinterpret_cast<float*>(xq_s + k);
  float* xsum_s = sx_s + groups;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = n / C_TILE;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  // (1) the scale rows of the block's i-th tile into stage i % 2, 16-byte
  // copies along N, as one committed group (an empty one past the last tile)
  auto stage = [&](int i) {
    if (i < my_tiles) {
      const int c0 = (blockIdx.x + i * gridDim.x) * C_TILE;
      unsigned char* st = smem + (i & 1) * stage_bytes;
      for (int gi = tid; gi < groups; gi += blockDim.x) {
        const size_t src = static_cast<size_t>(gi) * n + c0;
        mma::cp_async16(st + gi * C_TILE, sub_t + src);
        mma::cp_async16(st + (groups + gi) * C_TILE, min_t + src);
      }
      float* dd_s = reinterpret_cast<float*>(st + 2 * groups * C_TILE);
      for (int i4 = tid; i4 < groups; i4 += blockDim.x) {  // G/4 rows of 4 pieces
        const int r = i4 >> 2, sc = (i4 & 3) * 4;
        mma::cp_async16(dd_s + r * C_TILE + sc, dd_t + static_cast<size_t>(r) * n + c0 + sc);
      }
    }
    mma::cp_async_commit();
  };
  stage(0);
  stage(1);

  // (2) the lane's first U groups: unit u is (tile u / gpl, group lane + 32 * (u % gpl))
  const int gpl = (groups + 31) / 32;
  const int n_units = my_tiles * gpl;
  auto unit_off = [&](int u, bool& valid) -> size_t {
    const int ti = u / gpl, gi = lane + 32 * (u - ti * gpl);
    valid = u < n_units && gi < groups;
    const int pair = (blockIdx.x + ti * gridDim.x) * MV_WARPS + warp;
    return static_cast<size_t>(pair) * k + static_cast<size_t>(gi) * GROUP;
  };
  uint4 w[U][2];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    bool valid;
    const size_t off = unit_off(j, valid);
    if (valid) load_group(packed, off, w[j]);
  }

  // (3) the activation row, a warp at a time: 8 lanes per group, 4 values each
  for (int base = warp * 128; base < k; base += MV_WARPS * 128) {
    const int u = (base >> 2) + lane;  // k % 512 == 0: whole warps are in range
    float v[4];
    if (x_bf16) {
      const uint2 raw = reinterpret_cast<const uint2*>(x)[u];
      v[0] = __uint_as_float(raw.x << 16);
      v[1] = __uint_as_float(raw.x & 0xFFFF0000u);
      v[2] = __uint_as_float(raw.y << 16);
      v[3] = __uint_as_float(raw.y & 0xFFFF0000u);
    } else {
      const float4 raw = reinterpret_cast<const float4*>(x)[u];
      v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
    }
    float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
    float sum = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]), v[3]);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    }
    const float sxg = fmaxf(amax, 1e-10f) * INV127;
    const float rcp = 1.0f / sxg;
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int qv = __float2int_rn(v[e] * rcp);
      qv = min(max(qv, -127), 127);
      word |= static_cast<uint32_t>(qv & 0xFF) << (8 * e);
    }
    reinterpret_cast<uint32_t*>(xq_s)[u] = word;
    if ((lane & 7) == 0) {
      sx_s[u >> 3] = sxg;
      xsum_s[u >> 3] = sum;
    }
  }

  // (4) the weight stream: U groups in flight per lane, across tiles
  float acc0 = 0.f, acc1 = 0.f;
  int cur = -1;  // the tile whose scales are staged and visible
  for (int u0 = 0; u0 < n_units; u0 += U) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int u = u0 + j;
      if (u < n_units) {  // uniform over the block
        const int ti = u / gpl, c = u - ti * gpl;
        if (ti != cur) {  // a new tile: its scales landed; the stage before it is free
          if (cur >= 0) {
            __syncthreads();
            stage(cur + 2);
          }
          mma::cp_async_wait_n<1>();
          __syncthreads();  // (the first time: the quantized row too)
          cur = ti;
        }
        const unsigned char* st = smem + (ti & 1) * stage_bytes;
        const int gi = lane + 32 * c;
        if (gi < groups) {
          const uint4* xp = reinterpret_cast<const uint4*>(xq_s + gi * GROUP);
          const uint4 x0 = xp[0], x1 = xp[1];
          int d0 = 0, d1 = 0;
          dot4(w[j][0].x, static_cast<int>(x0.x), d0, d1);
          dot4(w[j][0].y, static_cast<int>(x0.y), d0, d1);
          dot4(w[j][0].z, static_cast<int>(x0.z), d0, d1);
          dot4(w[j][0].w, static_cast<int>(x0.w), d0, d1);
          dot4(w[j][1].x, static_cast<int>(x1.x), d0, d1);
          dot4(w[j][1].y, static_cast<int>(x1.y), d0, d1);
          dot4(w[j][1].z, static_cast<int>(x1.z), d0, d1);
          dot4(w[j][1].w, static_cast<int>(x1.w), d0, d1);
          const int ch = 2 * warp;  // the warp's even channel, in the tile
          const char2 sb = *reinterpret_cast<const char2*>(st + gi * C_TILE + ch);
          const char2 mn = *reinterpret_cast<const char2*>(st + (groups + gi) * C_TILE + ch);
          const float* dd = reinterpret_cast<const float*>(st + 2 * groups * C_TILE) +
                            (gi >> 3) * 2 * C_TILE + ch;
          const float2 dv = *reinterpret_cast<const float2*>(dd);
          const float2 mv = *reinterpret_cast<const float2*>(dd + C_TILE);
          const float sc0 = __fmul_rn(static_cast<float>(sb.x), dv.x);
          const float sc1 = __fmul_rn(static_cast<float>(sb.y), dv.y);
          const float off0 = __fsub_rn(__fmul_rn(8.f, sc0), __fmul_rn(static_cast<float>(mn.x), mv.x));
          const float off1 = __fsub_rn(__fmul_rn(8.f, sc1), __fmul_rn(static_cast<float>(mn.y), mv.y));
          const float sxg = sx_s[gi], xsg = xsum_s[gi];
          acc0 = __fmaf_rn(xsg, off0, __fmaf_rn(__fmul_rn(static_cast<float>(d0), sxg), sc0, acc0));
          acc1 = __fmaf_rn(xsg, off1, __fmaf_rn(__fmul_rn(static_cast<float>(d1), sxg), sc1, acc1));
        }
        bool valid;
        const size_t off = unit_off(u + U, valid);
        if (valid) load_group(packed, off, w[j]);
        if (c == gpl - 1) {  // the row's last group: sum the lanes, store the pair
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            acc0 = __fadd_rn(acc0, __shfl_xor_sync(0xffffffffu, acc0, o));
            acc1 = __fadd_rn(acc1, __shfl_xor_sync(0xffffffffu, acc1, o));
          }
          if (lane == 0) {
            const int r = (blockIdx.x + ti * gridDim.x) * MV_WARPS + warp;
            if (out_bf16)
              reinterpret_cast<__nv_bfloat162*>(out)[r] = __floats2bfloat162_rn(acc0, acc1);
            else
              reinterpret_cast<float2*>(out)[r] = make_float2(acc0, acc1);
          }
          acc0 = acc1 = 0.f;
        }
      }
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

// x [k] (f32 or bf16) -> out [n]. n % 512 == 0, k % 512 == 0, k <= 12288
// (checked by the wrapper; refused here as an invalid value). One launch, no
// scratch; as many blocks as the card holds at once, at most one per tile.
extern "C" int q4k_matvec_launch(const void* x, int x_bf16, const uint8_t* packed,
                                 const int8_t* sub_t, const int8_t* min_t, const float* dd_t,
                                 void* out, int out_bf16, int n, int k, cudaStream_t stream) {
  if (n % 512 || k % 512 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = one_smem_bytes(k);
  static int sms = 0;                        // the card's SMs
  static int per_sm[MAX_K / 512 + 1] = {};  // resident blocks per SM, by k / 512
  int& fit = per_sm[k / 512];
  if (!fit) {
    cudaError_t e = cudaFuncSetAttribute(q4k_matvec_one_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e == cudaSuccess && !sms) {
      int dev = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, q4k_matvec_one_kernel,
                                                        MV_WARPS * 32, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int tiles = n / C_TILE;
  const int grid = tiles < fit * sms ? tiles : fit * sms;
  q4k_matvec_one_kernel<<<grid, MV_WARPS * 32, smem, stream>>>(x, x_bf16, packed, sub_t, min_t,
                                                               dd_t, out, out_bf16, n, k);
  return static_cast<int>(cudaGetLastError());
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
