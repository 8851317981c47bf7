// The inner loop of csrc/q4k_matmul_rows.cu in isolation: one chunk resident
// in shared memory (any bytes), walked `reps` times by every warp as the
// kernel walks it; prints cycles per (32-group, 8-row tile) per SM. Built and
// run by devtools/microbench.py.
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdint>
#include "mma_common.cuh"
#include "q4k_common.cuh"
using namespace q4k;
constexpr int KC = 512, GC = 16, ROW_STRIDE = KC + 32;
constexpr float MAGIC = 12582912.0f;
template <int TT, int VARIANT, int UNROLL>
__global__ void inner(int reps, int ct, float* sink, long long* cycles) {
  constexpr int T = TT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int warps = blockDim.x / 32;
  const int k_slices = warps / (ct / 8), pw = warp / k_slices, kw = warp % k_slices;
  const int gpw = GC / k_slices;
  const int o_w = 0, o_xq = ct * ROW_STRIDE, o_sub = o_xq + T * ROW_STRIDE, o_mn = o_sub + GC * 2 * ct,
            o_dd = o_mn + GC * 2 * ct, o_sxs = o_dd + 4 * 2 * ct * 4, bytes = o_sxs + GC * T * 8;
  for (int i = tid; i < bytes / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(smem)[i] = (i * 2654435761u) & 0x3F3F3F3Fu;
  __syncthreads();
  float acc[TT][4];
  for (int t = 0; t < TT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    const unsigned char* st = smem;
    const unsigned char* wrow = st + o_w + (pw * 8 + gid) * ROW_STRIDE + tig * 8;
    const int ch = pw * 16 + 2 * gid;
#pragma unroll UNROLL
    for (int j = 0; j < gpw; ++j) {
      const int gl = kw * gpw + j;
      const uint2 wv = *reinterpret_cast<const uint2*>(wrow + gl * GROUP);
      int a0, a1, a2, a3;
      split_nibbles(wv.x, a0, a1); split_nibbles(wv.y, a2, a3);
      const char2 sb = *reinterpret_cast<const char2*>(st + o_sub + gl * 2 * ct + ch);
      const char2 mn = *reinterpret_cast<const char2*>(st + o_mn + gl * 2 * ct + ch);
      const float* dd = reinterpret_cast<const float*>(st + o_dd) + (gl >> 3) * 4 * ct + ch;
      const float2 dv = *reinterpret_cast<const float2*>(dd), mv = *reinterpret_cast<const float2*>(dd + 2 * ct);
      const float sc0 = (float)sb.x * dv.x, sc1 = (float)sb.y * dv.y;
      const float off0 = 8.f * sc0 - (float)mn.x * mv.x, off1 = 8.f * sc1 - (float)mn.y * mv.y;
      const unsigned char* xrow = st + o_xq + gid * ROW_STRIDE + gl * GROUP + tig * 8;
      const unsigned char* srow = st + o_sxs + (gl * T + tig * 2) * 8;
#pragma unroll
      for (int tile = 0; tile < TT; ++tile) {
        const uint2 xb = *reinterpret_cast<const uint2*>(xrow + tile * 8 * ROW_STRIDE);
        int d[4];
        mma::m16n8k32_s8(d, a0, a1, a2, a3, (int)xb.x, (int)xb.y, 0x4B400000);
        if (VARIANT == 1) {  // no epilogue math: just fold the results
          acc[tile][0] += __int_as_float(d[0]); acc[tile][1] += __int_as_float(d[1]);
          acc[tile][2] += __int_as_float(d[2]); acc[tile][3] += __int_as_float(d[3]);
        } else {
          float4 sv;
          if (VARIANT == 2) sv = make_float4(sc0, off0, sc1, off1);  // no sxs load
          else sv = *reinterpret_cast<const float4*>(srow + tile * 64);
          const float f0 = __int_as_float(d[0]) - MAGIC, f1 = __int_as_float(d[1]) - MAGIC;
          const float f2 = __int_as_float(d[2]) - MAGIC, f3 = __int_as_float(d[3]) - MAGIC;
          acc[tile][0] = __fmaf_rn(sv.y, off0, __fmaf_rn(__fmul_rn(f0, sv.x), sc0, acc[tile][0]));
          acc[tile][1] = __fmaf_rn(sv.w, off0, __fmaf_rn(__fmul_rn(f1, sv.z), sc0, acc[tile][1]));
          acc[tile][2] = __fmaf_rn(sv.y, off1, __fmaf_rn(__fmul_rn(f2, sv.x), sc1, acc[tile][2]));
          acc[tile][3] = __fmaf_rn(sv.w, off1, __fmaf_rn(__fmul_rn(f3, sv.z), sc1, acc[tile][3]));
        }
      }
    }
  }
  long long t1 = clock64();
  float s = 0;
  for (int t = 0; t < TT; ++t) s += acc[t][0] + acc[t][1] + acc[t][2] + acc[t][3];
  if (s == 1.2345f) sink[0] = s;
  if (tid == 0 && blockIdx.x == 0) cycles[0] = t1 - t0;
}
// All blocks that fit an SM (by registers and shared memory) run at once: one
// wave of 132 * resident blocks, and block 0's cycles are an SM's time for
// resident * reps * (ct / 8) * GC * TT units.
template <int TT, int V, int U = 1>
void run(int warps, int ct, float* sink, long long* cyc) {
  const int T = TT * 8;
  const int bytes = ct * ROW_STRIDE + T * ROW_STRIDE + 2 * GC * 2 * ct + 32 * ct + GC * T * 8;
  cudaFuncSetAttribute(inner<TT, V, U>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  int resident = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, inner<TT, V, U>, warps * 32, bytes);
  const int reps = 200;
  inner<TT, V, U><<<132 * resident, warps * 32, bytes>>>(reps, ct, sink, cyc);
  cudaDeviceSynchronize();
  long long h;
  cudaMemcpy(&h, cyc, 8, cudaMemcpyDeviceToHost);
  const double units = (double)resident * reps * (ct / 8) * GC * TT;
  printf("rows=%d variant=%d unroll=%d warps=%d pairs=%d resident blocks/SM=%d stage=%d B: "
         "%.2f cycles per (group, 8-row tile) per SM (err %d)\n",
         T, V, U, warps, ct, resident, bytes, h / units, (int)cudaGetLastError());
}

// variant 0: the kernel's loop; 1: the mma results folded without the f32
// epilogue; 2: without the (sx, xsum) loads.
int main() {
  float* sink;
  long long* cyc;
  cudaMalloc(&sink, 4);
  cudaMalloc(&cyc, 8);
  run<1, 0>(8, 64, sink, cyc);
  run<1, 0, 4>(8, 64, sink, cyc);
  run<1, 1>(8, 64, sink, cyc);
  run<1, 0>(8, 16, sink, cyc);
  run<2, 0>(8, 64, sink, cyc);
  run<4, 0>(8, 64, sink, cyc);
  run<4, 0>(16, 64, sink, cyc);
  run<8, 0>(8, 64, sink, cyc);
  run<8, 0>(16, 64, sink, cyc);
  run<8, 1>(8, 64, sink, cyc);
  run<8, 2>(8, 64, sink, cyc);
  return 0;
}
