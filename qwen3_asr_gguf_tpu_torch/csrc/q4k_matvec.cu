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
// q4k_matvec_normed first takes rms_norm(x) * norm_w and rounds it to bf16
// and back (the unfused path's rms_norm output is bf16), for K <= 2048.
//
// Bound: decode at batch 1 reads every weight byte once per token and does
// ~2 integer ops per byte, so the kernel is bound by device-memory bandwidth
// (3.35 TB/s on an H100 SXM; 0.85 GB of int4 weights + scales per 1.7B token
// is a 0.25 ms floor); at the layer shapes (2-15 MB) the time is latency: how
// soon the whole weight is in flight.
//
// Both entry points are one launch of one kernel, `q4k_matvec_one_kernel`,
// whose NORMED flag adds the rms_norm to the prologue. A tile is 16
// channels: one packed row per warp of a block of 8 warps, each lane the
// 32-groups lane, lane + 32, ... of the row. There are as many blocks as the
// card holds at once (at most one per tile: N / 16 at the layer shapes),
// each walking tiles b, b + grid, ... The block's prologue (1) starts
// 16-byte cp.async copies of the sub_t / min_t / dd_t rows of its first two
// tiles' channels (read along N, where they are contiguous) into two
// shared-memory stages, (2) issues each lane's first U 32-byte groups of
// weights as register loads, and only then (3) quantizes the activation row
// into shared memory a warp at a time: lane l of warp w holds the four
// values 4l .. 4l + 3 of each 128-value piece w, w + 8, ...; 8 lanes per
// 32-group, amax and sum by three butterfly steps (the order of the
// multi-row kernel's pass A, so xsum is bit-equal to
// `quantize_act_kernel_order`). With NORMED the lanes first hold their
// values in registers (K <= 2048: at most 8 each) and sum their squares in
// that order (x*x then +, each rounded once), the lanes by a butterfly
// (xor 16, 8, 4, 2, 1) and the warps in warp order through shared memory;
// every block then takes rstd = 1 / sqrt(ss / K + eps) (each step correctly
// rounded) and v = bf16(x * rstd * norm_w) before the quantization. The
// normed row is rebuilt in every block (4 KB of input, 2048 products): no
// scratch round trip and no second launch; `normed_row_kernel_order`
// (ops/q4k.py) repeats it bit for bit, so the output equals q4k_matvec's on
// that row bit for bit. Each lane then keeps U groups in flight as a ring in
// registers, across tiles (a tile's scale stage is refilled with the tile
// two ahead once every warp is past it): nibbles sign-extended and dotted
// with __dp4a, the exact factored scales applied per group as
// acc = fma(xsum, offs, fma(dot*sx, scale, acc)), a warp butterfly at the
// end of each row. No scratch in device memory; `q4k_matvec_kernel_order`
// (ops/q4k.py) repeats its sums.

#include "mma_common.cuh"
#include "q4k_common.cuh"

namespace {

using namespace q4k;

constexpr int MAX_NORMED_K = 2048;
constexpr int U = 4;  // 32-byte weight groups each lane keeps in flight
constexpr int C_TILE = 2 * MV_WARPS;  // channels of a tile: one packed row per warp
constexpr int PIECE = 4 * 32;  // values of the row a warp quantizes at a time
constexpr int NORMED_PIECES = MAX_NORMED_K / (PIECE * MV_WARPS);  // per warp, at most
constexpr int SMEM_LIMIT = 227 * 1024;

// Bytes of one stage of a tile's scale rows: sub[G][16] i8 | min[G][16] i8 |
// dd[G/4][16] f32 (rows 2s = d, 2s + 1 = dmin of superblock s).
__host__ __device__ inline int scale_stage_bytes(int k) {
  const int groups = k / GROUP;
  return 2 * groups * C_TILE + (groups / 4) * C_TILE * 4;
}

// Shared memory of the kernel: two scale stages, then the quantized row:
// xq[K] i8 | sx[G] | xsum[G], then the warps' sums of squares (NORMED).
__host__ __device__ inline int one_smem_bytes(int k) {
  return 2 * scale_stage_bytes(k) + k + 8 * (k / GROUP) + 4 * MV_WARPS;
}

__device__ __forceinline__ void load_group(const uint8_t* __restrict__ packed, size_t off,
                                           uint4 (&w)[2]) {
  const uint4* p = reinterpret_cast<const uint4*>(packed + off);
  w[0] = __ldg(p);
  w[1] = __ldg(p + 1);
}

// The four values 4u .. 4u + 3 of the row as f32.
__device__ __forceinline__ void load4(const void* x, int x_bf16, int u, float (&v)[4]) {
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
}

// Quantize the four values 4u .. 4u + 3 (lane l of 8 holding a group's
// values 4l .. 4l + 3) into xq / sx / xsum in shared memory.
__device__ __forceinline__ void quantize4(const float (&v)[4], int u, int lane, int8_t* xq_s,
                                          float* sx_s, float* xsum_s) {
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

// One launch; see the header. Block b takes tiles b, b + gridDim.x, ... of
// 16 channels (one packed row per warp).
template <bool NORMED>
__global__ void __launch_bounds__(MV_WARPS * 32)
q4k_matvec_one_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ norm_w,
                      float eps, const uint8_t* __restrict__ packed,
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
  // (k % 512 == 0: whole warps are in range)
  if constexpr (NORMED) {
    float* warp_ss = xsum_s + groups;
    float v[NORMED_PIECES][4];
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NORMED_PIECES; ++c) {
      const int base = (warp + c * MV_WARPS) * PIECE;
      if (base < k) {
        load4(x, x_bf16, (base >> 2) + lane, v[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) ss = __fadd_rn(ss, __fmul_rn(v[c][e], v[c][e]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    if (lane == 0) warp_ss[warp] = ss;
    __syncthreads();
    float total = warp_ss[0];
#pragma unroll
    for (int i = 1; i < MV_WARPS; ++i) total = __fadd_rn(total, warp_ss[i]);
    const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(total, static_cast<float>(k)), eps)));
#pragma unroll
    for (int c = 0; c < NORMED_PIECES; ++c) {
      const int base = (warp + c * MV_WARPS) * PIECE;
      if (base < k) {
        const int u = (base >> 2) + lane;
        const float4 nw = reinterpret_cast<const float4*>(norm_w)[u];
        const float nws[4] = {nw.x, nw.y, nw.z, nw.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[c][e] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__fmul_rn(v[c][e], rstd), nws[e])));
        quantize4(v[c], u, lane, xq_s, sx_s, xsum_s);
      }
    }
  } else {
    for (int base = warp * PIECE; base < k; base += MV_WARPS * PIECE) {
      const int u = (base >> 2) + lane;
      float v[4];
      load4(x, x_bf16, u, v);
      quantize4(v, u, lane, xq_s, sx_s, xsum_s);
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

// As many blocks as the card holds at once, at most one per tile; the
// blocks per SM are asked of the runtime once per kernel and k.
template <bool NORMED>
int launch_one(const void* x, int x_bf16, const float* norm_w, float eps, const uint8_t* packed,
               const int8_t* sub_t, const int8_t* min_t, const float* dd_t, void* out,
               int out_bf16, int n, int k, cudaStream_t stream) {
  const int smem = one_smem_bytes(k);
  static int sms = 0;                        // the card's SMs
  static int per_sm[MAX_K / 512 + 1] = {};  // resident blocks per SM, by k / 512
  int& fit = per_sm[k / 512];
  if (!fit) {
    cudaError_t e = cudaFuncSetAttribute(q4k_matvec_one_kernel<NORMED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e == cudaSuccess && !sms) {
      int dev = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, q4k_matvec_one_kernel<NORMED>,
                                                        MV_WARPS * 32, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int tiles = n / C_TILE;
  const int grid = tiles < fit * sms ? tiles : fit * sms;
  q4k_matvec_one_kernel<NORMED><<<grid, MV_WARPS * 32, smem, stream>>>(
      x, x_bf16, norm_w, eps, packed, sub_t, min_t, dd_t, out, out_bf16, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [k] (f32 or bf16) -> out [n]. n % 512 == 0, k % 512 == 0, k <= 12288
// (checked by the wrapper; refused here as an invalid value). One launch, no
// scratch.
extern "C" int q4k_matvec_launch(const void* x, int x_bf16, const uint8_t* packed,
                                 const int8_t* sub_t, const int8_t* min_t, const float* dd_t,
                                 void* out, int out_bf16, int n, int k, cudaStream_t stream) {
  if (n % 512 || k % 512 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  return launch_one<false>(x, x_bf16, nullptr, 0.f, packed, sub_t, min_t, dd_t, out, out_bf16,
                           n, k, stream);
}

// The same product of rms_norm(x) * norm_w (f32 [k], 16-byte aligned), the
// bf16 round trip included; k <= 2048. One launch, no scratch.
extern "C" int q4k_matvec_normed_launch(const void* x, int x_bf16, const float* norm_w,
                                        float eps, const uint8_t* packed, const int8_t* sub_t,
                                        const int8_t* min_t, const float* dd_t, void* out,
                                        int out_bf16, int n, int k, cudaStream_t stream) {
  if (n % 512 || k % 512 || k > MAX_NORMED_K) return static_cast<int>(cudaErrorInvalidValue);
  return launch_one<true>(x, x_bf16, norm_w, eps, packed, sub_t, min_t, dd_t, out, out_bf16, n,
                          k, stream);
}
