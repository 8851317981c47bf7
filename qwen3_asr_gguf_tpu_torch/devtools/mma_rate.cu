// Throughput of the mma.sync tiles the kernels use (int8 m16n8k32, bf16
// m16n8k16, and fp8 m16n8k32 for comparison): eight independent accumulators
// per warp, cycles per tile per SM sub-partition at 1 to 8 warps each.
// Built and run by devtools/microbench.py.
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdint>
template <int KIND>
__global__ void bench(int iters, int* sink, long long* cycles) {
  int c[8][4]; float f[8][4];
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) { c[i][j] = threadIdx.x + i; f[i][j] = threadIdx.x + i; }
  int a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7, b0 = a0 * 11, b1 = a0 * 13;
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else if (KIND == 1)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(f[i][0]), "+f"(f[i][1]), "+f"(f[i][2]), "+f"(f[i][3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(f[i][0]), "+f"(f[i][1]), "+f"(f[i][2]), "+f"(f[i][3]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  long long t1 = clock64();
  int s = 0; float g = 0;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) { s += c[i][j]; g += f[i][j]; }
  if (s == 12345 && g == 1.5f) sink[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) cycles[0] = t1 - t0;
}
int main() {
  int* sink; long long* cyc; cudaMalloc(&sink, 4); cudaMalloc(&cyc, 8);
  const int iters = 2000;
  const char* names[3] = {"IMMA.16832.s8", "HMMA.16816.bf16", "QMMA.16832.e4m3"};
  for (int kind = 0; kind < 3; ++kind)
    for (int warps = 4; warps <= 32; warps *= 2) {
      long long h;
      if (kind == 0) bench<0><<<132, warps * 32>>>(iters, sink, cyc);
      else if (kind == 1) bench<1><<<132, warps * 32>>>(iters, sink, cyc);
      else bench<2><<<132, warps * 32>>>(iters, sink, cyc);
      cudaDeviceSynchronize();
      cudaMemcpy(&h, cyc, 8, cudaMemcpyDeviceToHost);
      // per sub-partition: warps/4 warps each issuing iters*8 mma
      printf("%s warps/SM=%d: %.2f cycles per mma per sub-partition (err %d)\n", names[kind], warps,
             (double)h / (iters * 8.0 * (warps / 4)), (int)cudaGetLastError());
    }
  return 0;
}
