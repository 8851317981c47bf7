// Kernel 8: the routed-expert int4 matvec of one activation row, for Hopper
// (sm_90a). It has no TPU counterpart: the JAX package runs no sparse-expert
// decoder. See ops/moe.py for the weight layout (ggml q4_0 split into planes):
//   qs u8  [E, N, K/2]   per 32-block 16 bytes: byte t holds element t of the
//                        block in its low nibble, element t + 16 in its high
//   d  f16 [E, N, K/32]  the block's scale; a weight is (q - 8) * d
// with gate and up [E, M, D] and down [E, D, M], and computes
//   out = sum_s wts[s] * down[ids[s]] @ (silu(gate[ids[s]] @ x) * (up[ids[s]] @ x))
// for `slots` experts whose ids (int32) and weights (f32) are read on the
// device, so the launches need no host value of the routing and can be
// captured into a CUDA graph.
//
// Activations enter the products as int8, 32 to a scale, as in kernels 1-3:
// q = rn(v * (127 / amax)) with sx = amax / 127 per 32-group (0 where amax
// is 0). A block's dot is then exact in integers, four products per
// __dp4a: sum_t (w_t - 8) q_t = dp4a(w, q) - 8 * sum_t q_t, and the block
// adds d * sx * that in f32.
//
// Bound: the chosen experts' bytes, read once (at Moonlight-16B-A3B's widths
// 6 routed + 2 shared-expert halves of 3 x 1408 x 2048 weights at 0.5625
// bytes: 39 MB a layer, 11.6 us at 3.35 TB/s).
//
// Two launches:
//  1. moe_gate_up_kernel, grid (M / 32, slots), 8 warps: the block quantizes
//     x into shared memory (a warp a 32-group at a time, amax and the sum of
//     q by butterflies), then each warp takes four rows n of slot s and
//     streams rows n of gate[e] and of up[e] (e = ids[s]), a lane a 32-block
//     at a time (one 16-byte load per block, row and matrix); per lane f32
//     sums and a butterfly give silu(g) * u for each row, and the block's 32
//     rows (one 32-group of the SwiGLU's output) are quantized by warp 0
//     into a scratch of int8 values, scales and sums of q (slots x M / 32
//     groups).
//  2. moe_down_kernel, grid (D / 8), 8 warps: the block copies that scratch
//     into shared memory (16-byte copies), then each warp takes one output
//     row n and walks the slots' blocks (s, b) flattened, a lane one block
//     at a time: the 16-byte load of down[ids[s]][n, block b], scale
//     d * sx * wts[s]; a butterfly, and lane 0 writes out[n] in x's dtype.
// In shared memory the two 16-byte halves of group g's 32 int8 values sit
// at 32 g + 16 (h ^ ((g >> 2) & 1)): the 16-byte loads of eight lanes that
// read eight consecutive groups' same half then fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int QK = 32;
constexpr int GATE_ROWS_PER_WARP = 4;  // WARPS * 4 = 32: a block computes one 32-group of act
constexpr int MAX_SLOTS = 16;
constexpr int LOADS = 8;  // 32-groups whose values a warp loads before quantizing them
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr uint32_t LO = 0x0F0F0F0Fu;

__device__ __forceinline__ int half_at(int g, int h) { return QK * g + 16 * (h ^ ((g >> 2) & 1)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool BF16>
__device__ __forceinline__ float load_value(const void* v, int i) {
  return BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(v)[i])
              : static_cast<const float*>(v)[i];
}

// one 32-group held a value a lane: (its int8 value, the group's scale, the group's sum of q)
__device__ __forceinline__ int quantize_lane(float v, float* scale, int* sum) {
  const float amax = warp_max(fabsf(v));
  const float inv = amax > 0.f ? 127.f / amax : 0.f;
  const int q = max(-127, min(127, __float2int_rn(v * inv)));
  *scale = amax / 127.f;
  *sum = warp_sum(q);
  return q;
}

// ng 32-groups of v (bf16 or f32, in device memory) as int8 into xq with
// their scales sx and sums of q qsum; warp w takes groups w, w + WARPS, ...,
// loading LOADS groups' values before quantizing them
template <bool BF16>
__device__ __forceinline__ void quantize_groups(const void* v, int ng, int8_t* xq, float* sx,
                                                int* qsum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g0 = warp; g0 < ng; g0 += LOADS * WARPS) {
    float val[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int g = g0 + u * WARPS;
      val[u] = g < ng ? load_value<BF16>(v, QK * g + lane) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int g = g0 + u * WARPS;
      if (g >= ng) break;  // uniform across the warp
      float scale;
      int sum;
      const int q = quantize_lane(val[u], &scale, &sum);
      xq[half_at(g, lane >> 4) + (lane & 15)] = static_cast<int8_t>(q);
      if (lane == 0) {
        sx[g] = scale;
        qsum[g] = sum;
      }
    }
  }
}

// sum_t (w_t - 8) q_t over block g: w its 16 nibble bytes, xq the shared int8 values
__device__ __forceinline__ int dot_block(const uint4 w, const int8_t* xq, const int g) {
  const int4 a = *reinterpret_cast<const int4*>(xq + half_at(g, 0));  // elements 0..15
  const int4 b = *reinterpret_cast<const int4*>(xq + half_at(g, 1));  // elements 16..31
  int acc = __dp4a(static_cast<int>(w.x & LO), a.x, 0);
  acc = __dp4a(static_cast<int>((w.x >> 4) & LO), b.x, acc);
  acc = __dp4a(static_cast<int>(w.y & LO), a.y, acc);
  acc = __dp4a(static_cast<int>((w.y >> 4) & LO), b.y, acc);
  acc = __dp4a(static_cast<int>(w.z & LO), a.z, acc);
  acc = __dp4a(static_cast<int>((w.z >> 4) & LO), b.z, acc);
  acc = __dp4a(static_cast<int>(w.w & LO), a.w, acc);
  return __dp4a(static_cast<int>((w.w >> 4) & LO), b.w, acc);
}

template <bool XBF16>
__global__ void __launch_bounds__(WARPS * 32)
moe_gate_up_kernel(const void* __restrict__ x, const int* __restrict__ ids,
                   const uint8_t* __restrict__ gq, const __half* __restrict__ gd,
                   const uint8_t* __restrict__ uq, const __half* __restrict__ ud,
                   int8_t* __restrict__ aq, float* __restrict__ asx, int* __restrict__ asum,
                   int m, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float act[WARPS * GATE_ROWS_PER_WARP];
  const int nb = k / QK;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* sx = reinterpret_cast<float*>(smem + k);
  int* qsum = reinterpret_cast<int*>(smem + k + 4 * nb);
  quantize_groups<XBF16>(x, nb, xq, sx, qsum);
  __syncthreads();
  const int slot = blockIdx.y;
  const size_t e = static_cast<size_t>(ids[slot]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * QK + warp * GATE_ROWS_PER_WARP;
  float ag[GATE_ROWS_PER_WARP] = {}, au[GATE_ROWS_PER_WARP] = {};
#pragma unroll 2
  for (int b = lane; b < nb; b += 32) {
    const float scale = sx[b];
    const int off = 8 * qsum[b];
#pragma unroll
    for (int r = 0; r < GATE_ROWS_PER_WARP; ++r) {
      const size_t row = e * m + row0 + r;
      const uint4 wg = __ldg(reinterpret_cast<const uint4*>(gq + row * (k / 2)) + b);
      const uint4 wu = __ldg(reinterpret_cast<const uint4*>(uq + row * (k / 2)) + b);
      const float dg = __half2float(gd[row * nb + b]), du = __half2float(ud[row * nb + b]);
      ag[r] = fmaf(dg * scale, static_cast<float>(dot_block(wg, xq, b) - off), ag[r]);
      au[r] = fmaf(du * scale, static_cast<float>(dot_block(wu, xq, b) - off), au[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < GATE_ROWS_PER_WARP; ++r) {
    const float g = warp_sum(ag[r]), u = warp_sum(au[r]);
    if (lane == 0) act[warp * GATE_ROWS_PER_WARP + r] = g / (1.f + expf(-g)) * u;
  }
  __syncthreads();
  if (warp == 0) {  // the block's 32 rows are one 32-group of the scratch
    float scale;
    int sum;
    const int q = quantize_lane(act[lane], &scale, &sum);
    const size_t grp = static_cast<size_t>(slot) * (m / QK) + blockIdx.x;
    aq[grp * QK + lane] = static_cast<int8_t>(q);
    if (lane == 0) {
      asx[grp] = scale;
      asum[grp] = sum;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
moe_down_kernel(const int8_t* __restrict__ act_q, const float* __restrict__ act_sx,
                const int* __restrict__ act_sum, const int* __restrict__ ids,
                const float* __restrict__ wts, const uint8_t* __restrict__ dq,
                const __half* __restrict__ dd, void* __restrict__ out, int out_bf16, int slots,
                int m, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sid[MAX_SLOTS];
  __shared__ float sw[MAX_SLOTS];
  const int nbm = m / QK;
  const int nblk = slots * nbm;
  int8_t* aq = reinterpret_cast<int8_t*>(smem);
  float* sx = reinterpret_cast<float*>(smem + slots * m);
  int* qsum = reinterpret_cast<int*>(smem + slots * m + 4 * nblk);
  if (threadIdx.x < slots) {
    sid[threadIdx.x] = ids[threadIdx.x];
    sw[threadIdx.x] = wts[threadIdx.x];
  }
  const uint4* src = reinterpret_cast<const uint4*>(act_q);
#pragma unroll 4
  for (int c = threadIdx.x; c < 2 * nblk; c += blockDim.x)  // 16-byte halves of the groups
    *reinterpret_cast<uint4*>(aq + half_at(c >> 1, c & 1)) = src[c];
  for (int g = threadIdx.x; g < nblk; g += blockDim.x) {
    sx[g] = act_sx[g];
    qsum[g] = act_sum[g];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= d) return;
  float acc = 0.f;
#pragma unroll 6
  for (int f = lane; f < nblk; f += 32) {
    const int s = f / nbm, b = f - s * nbm;
    const size_t row = static_cast<size_t>(sid[s]) * d + n;
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(dq + row * (m / 2)) + b);
    const float sc = __half2float(dd[row * nbm + b]) * sx[f] * sw[s];
    acc = fmaf(sc, static_cast<float>(dot_block(w, aq, f) - 8 * qsum[f]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[n] = __float2bfloat16(acc);
    } else {
      static_cast<float*>(out)[n] = acc;
    }
  }
}

// opt a kernel into more than 48 KB of dynamic shared memory, once per size
// (the first call runs eagerly, before any graph capture)
template <typename K>
int allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= DEFAULT_SMEM || bytes <= *allowed) return 0;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *allowed = bytes;
  return 0;
}

}  // namespace

// x: f32 or bf16 [d]; ids int32 [slots]; wts f32 [slots]; the six planes as
// in ops/moe.py (16-byte aligned nibble planes); scratch: 16-byte aligned,
// slots * m * 1.25 bytes (the SwiGLU's output as int8, then an f32 scale
// and an int sum per 32); out: [d] in x's dtype. m % 32 == 0, d % 32 == 0,
// 0 < slots <= 16.
extern "C" int moe_matvec_launch(const void* x, int x_bf16, const int* ids, const float* wts,
                                 const uint8_t* gq, const __half* gd, const uint8_t* uq,
                                 const __half* ud, const uint8_t* dq, const __half* dd,
                                 unsigned char* scratch, void* out, int slots, int m, int d,
                                 cudaStream_t stream) {
  static int gate_allowed[2] = {0, 0};
  static int down_allowed = 0;
  if (m % QK || d % QK || slots <= 0 || slots > MAX_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  // int8 values, then an f32 scale and an int sum per 32-group
  const int x_smem = d + 8 * (d / QK);
  const int act_smem = slots * m + 8 * (slots * m / QK);
  int8_t* aq = reinterpret_cast<int8_t*>(scratch);
  float* asx = reinterpret_cast<float*>(scratch + slots * m);
  int* asum = reinterpret_cast<int*>(scratch + slots * m + 4 * (slots * m / QK));
  const dim3 grid_a(m / QK, slots);
  int rc;
  if (x_bf16) {
    if ((rc = allow_smem(moe_gate_up_kernel<true>, x_smem, &gate_allowed[1]))) return rc;
    moe_gate_up_kernel<true><<<grid_a, WARPS * 32, x_smem, stream>>>(x, ids, gq, gd, uq, ud,
                                                                      aq, asx, asum, m, d);
  } else {
    if ((rc = allow_smem(moe_gate_up_kernel<false>, x_smem, &gate_allowed[0]))) return rc;
    moe_gate_up_kernel<false><<<grid_a, WARPS * 32, x_smem, stream>>>(x, ids, gq, gd, uq, ud,
                                                                       aq, asx, asum, m, d);
  }
  if ((rc = allow_smem(moe_down_kernel, act_smem, &down_allowed))) return rc;
  moe_down_kernel<<<(d + WARPS - 1) / WARPS, WARPS * 32, act_smem, stream>>>(
      aq, asx, asum, ids, wts, dq, dd, out, x_bf16, slots, m, d);
  return static_cast<int>(cudaGetLastError());
}
