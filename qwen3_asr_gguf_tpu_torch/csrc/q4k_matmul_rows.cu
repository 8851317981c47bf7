// q4_k int4-stream matmul over a few activation rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_rows` via `_matmul_rows_call`
// (qwen3_asr_gguf_tpu/ops/pallas_q4k.py, pallas_call at :419; the
// `q4k_matmul_rows` of the serving decode step). Same math and weight layout
// as q4k_matvec.cu (see q4k_common.cuh and ops/q4k.py, Q4KWeight):
//   out[t, n] = sum_g acc[t,g,n]*scale[g,n]*sx[t,g] + xsum[t,g]*offs[g,n]
// with every activation row t quantized per 32-group to int8 (x * (1/sx),
// round half to even) and acc the exact int32 group dot.
//
// Bound: a batched decode step at T rows (T % 8 == 0, T <= 64) still reads
// every weight byte once per T_TILE rows and does ~2*T_TILE integer ops per
// byte, far below the card's integer rate, so the kernel is bound by
// device-memory bandwidth like the matvec: the point of the TPU kernel,
// and of serving int4 weights, is that one weight stream serves all rows.
// Design: pass A quantizes the T rows (one block per row) into int8 plus
// per-(row, group) sx and xsum scratch; pass B gives each warp one packed
// row (a channel pair) and each block one tile of 8 activation rows
// (grid.y = T/8), staged in shared memory: a lane reads a 32-group of
// weights once (two 16-byte loads), sign-extends its nibbles once, and
// dots it with the 8 rows' int8 groups (__dp4a), 16 f32 accumulators per
// lane. Tiling the rows by 8 keeps the register count flat up to T = 64;
// at T > 8 the weights are re-read once per tile (from L2 where they fit),
// as the TPU kernel re-streams them per batch tile.
// Known weaknesses, for a later change: the strided scale planes of
// q4k_matvec.cu, and no tensor cores (a wgmma int8 tile over T rows would
// take the dots off the integer pipes).

#include "q4k_common.cuh"

namespace {

using namespace q4k;

constexpr int T_TILE = 8;
constexpr int MAX_ROWS_GRID = 1024;

__host__ __device__ constexpr size_t rows_smem_bytes(int k) {
  return static_cast<size_t>(T_TILE) * k + 2 * sizeof(float) * T_TILE * (k / GROUP);
}

__global__ void __launch_bounds__(MV_WARPS * 32)
q4k_matmul_rows_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                       const float* __restrict__ xsum, const uint8_t* __restrict__ packed,
                       const int8_t* __restrict__ sub_t, const int8_t* __restrict__ min_t,
                       const float* __restrict__ dd_t, void* __restrict__ out, int out_bf16,
                       int n, int k) {
  // xq[T_TILE][k] | sx[T_TILE][G] | xsum[T_TILE][G] of this block's row tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = k / GROUP;
  const int tile = blockIdx.y;
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem);
  float* sx_s = reinterpret_cast<float*>(smem + static_cast<size_t>(T_TILE) * k);
  float* xsum_s = sx_s + T_TILE * groups;
  const int8_t* xq_t = xq + static_cast<size_t>(tile) * T_TILE * k;
  for (int i = threadIdx.x; i < T_TILE * k / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(xq_s)[i] = reinterpret_cast<const uint4*>(xq_t)[i];
  const size_t goff = static_cast<size_t>(tile) * T_TILE * groups;
  for (int i = threadIdx.x; i < T_TILE * groups; i += blockDim.x) {
    sx_s[i] = sx[goff + i];
    xsum_s[i] = xsum[goff + i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int rows = n / 2;
  for (int r = blockIdx.x * MV_WARPS + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * MV_WARPS) {
    const uint8_t* wrow = packed + static_cast<size_t>(r) * k;
    const int c = 2 * r;
    float acc0[T_TILE], acc1[T_TILE];
#pragma unroll
    for (int t = 0; t < T_TILE; ++t) acc0[t] = acc1[t] = 0.f;
    for (int g = lane; g < groups; g += 32) {
      const uint4* wp = reinterpret_cast<const uint4*>(wrow + g * GROUP);
      const uint4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
      const uint32_t wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      int lo[8], hi[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) split_nibbles(wv[e], lo[e], hi[e]);
      const PairScales ps = pair_scales(sub_t, min_t, dd_t, n, g, c);
#pragma unroll
      for (int t = 0; t < T_TILE; ++t) {
        const uint4* xp = reinterpret_cast<const uint4*>(xq_s + t * k + g * GROUP);
        const uint4 x0 = xp[0], x1 = xp[1];
        const int xv[8] = {static_cast<int>(x0.x), static_cast<int>(x0.y),
                           static_cast<int>(x0.z), static_cast<int>(x0.w),
                           static_cast<int>(x1.x), static_cast<int>(x1.y),
                           static_cast<int>(x1.z), static_cast<int>(x1.w)};
        int d0 = 0, d1 = 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          d0 = __dp4a(lo[e], xv[e], d0);
          d1 = __dp4a(hi[e], xv[e], d1);
        }
        const float sxg = sx_s[t * groups + g], xsg = xsum_s[t * groups + g];
        acc0[t] += static_cast<float>(d0) * ps.sc0 * sxg + xsg * ps.off0;
        acc1[t] += static_cast<float>(d1) * ps.sc1 * sxg + xsg * ps.off1;
      }
    }
#pragma unroll
    for (int t = 0; t < T_TILE; ++t) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc0[t] += __shfl_xor_sync(0xffffffffu, acc0[t], o);
        acc1[t] += __shfl_xor_sync(0xffffffffu, acc1[t], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < T_TILE; ++t) {
        const size_t o = static_cast<size_t>(tile * T_TILE + t) * rows + r;  // pair index
        if (out_bf16)
          reinterpret_cast<__nv_bfloat162*>(out)[o] = __floats2bfloat162_rn(acc0[t], acc1[t]);
        else
          reinterpret_cast<float2*>(out)[o] = make_float2(acc0[t], acc1[t]);
      }
    }
  }
}

}  // namespace

// x [t, k] (f32 or bf16) -> out [t, n]; scratch xq [t, k] int8, sx and
// xsum [t, k/32] f32. t % 8 == 0, t <= 64, n % 512 == 0, k % 512 == 0,
// k <= 12288 (checked by the wrapper; refused here as an invalid value).
extern "C" int q4k_matmul_rows_launch(const void* x, int x_bf16, int8_t* xq, float* sx,
                                      float* xsum, const uint8_t* packed,
                                      const int8_t* sub_t, const int8_t* min_t,
                                      const float* dd_t, void* out, int out_bf16, int t,
                                      int n, int k, cudaStream_t stream) {
  if (t <= 0 || t % T_TILE || t > 64 || n % 512 || k % 512 || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;  // above 48 KB dynamic shared memory needs opting in
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        q4k_matmul_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(rows_smem_bytes(MAX_K)));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  quantize_rows_kernel<<<t, QUANT_THREADS, sizeof(float) * k, stream>>>(x, x_bf16, k, xq, sx,
                                                                         xsum);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int rows = n / 2;
  int gx = (rows + MV_WARPS - 1) / MV_WARPS;
  if (gx > MAX_ROWS_GRID) gx = MAX_ROWS_GRID;
  const dim3 grid(gx, t / T_TILE);
  q4k_matmul_rows_kernel<<<grid, MV_WARPS * 32, rows_smem_bytes(k), stream>>>(
      xq, sx, xsum, packed, sub_t, min_t, dd_t, out, out_bf16, n, k);
  return static_cast<int>(cudaGetLastError());
}
