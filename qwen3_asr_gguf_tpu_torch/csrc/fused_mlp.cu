// One token's int8 SwiGLU MLP, for Hopper (sm_90a): one persistent,
// cooperative launch.
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
// reciprocal) and round half to even; the dots are exact int32 (__dp4a), and
// |y_j| <= 127 * 127 * 512 < 2^24, so f32(y_j) is exact.
//
// Bound: 3*D*M weight bytes read once, 2 integer operations per byte: bound
// by device-memory bandwidth (6*D*M dp4a operations are ~1 us over the card,
// the bytes 11.3 us at (D, M) = (2048, 6144)). No tensor cores.
//
// Design: one cooperative launch of one block per SM (`blocks` and
// `slab_rows` from the wrapper's plan, `ops.mlp.fused_mlp_plan`): every block
// is resident, so blocks may wait for each other. Measured choices (PERF.md;
// `devtools/mlp_stamps.py` stamps each phase, `devtools/sweep_mlp.py`
// sweeps RING and PREFETCH_WD):
//   Prologue: x (and the block's sd) are loaded before anything else: a load
//     waits behind every byte the card has been asked for before it. x is
//     quantized into shared memory by the whole block.
//   Phase 1 (gate/up): the M rows are dealt round robin over the blocks
//     (block b takes b, b + G, b + 2G, ...); a warp keeps RING rows' 16-byte
//     pieces in flight in registers, takes both exact dots, and lane 0
//     writes act[m] to a global f32 buffer (it stays in L2). No fence per row:
//     a fence waits for the warp's loads in flight and empties the ring.
//   Slab: after its phase 1 each block copies its Wd slab (`slab_rows`
//     consecutive output rows across all M columns, 96 KB at (2048, 6144))
//     into shared memory with cp.async (every warp but warp 0, whose thread 0
//     runs the barrier: a fence would wait for its own copies). Copies issued
//     in the prologue, beside phase 1's loads, made the whole stream slower.
//   Grid barrier: thread 0 of each block publishes its rows (fence, then an
//     add to a row counter) and polls the counter until all M acts are out.
//   Phase 2a: warp w quantizes tiles w, w + WARPS, ... of the acts (read
//     around L1, which is not coherent with the other SMs' writes) into
//     shared memory with their scales s_j.
//   Phase 2b: once the slab has landed, warp w takes the 512-column steps w,
//     w + WARPS, ...: its act piece is read once and dotted with 16 slab rows
//     at a time, and the 16 rows' sums over the lanes are one transposed
//     reduction (16 shuffles). Each output row then adds f32(y_j) * s_j in
//     tile order and multiplies by sd once: the plain version's arithmetic.
//   The counters: each block takes a ticket past the barrier; the last sets
//     both counters back to 0, so back-to-back launches and a replayed CUDA
//     graph start from zero. The wrapper allocates them once per (device,
//     stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int RING = 1;         // phase-1 rows in flight per warp (a ring in registers)
constexpr int PREFETCH_WD = 0;  // the Wd slab's copies: 0 after the block's phase 1, 1 in the
                                // prologue, 2 after the grid barrier and the acts' quantization
constexpr int MAX_C = 4;        // 16-byte pieces of a row per lane: D <= 2048
constexpr int MAX_TILE = 512;   // 16 act values per lane
constexpr int X_PER = (MAX_C * 512 + THREADS - 1) / THREADS;  // x values per thread
constexpr int SMEM_BUDGET = 226 * 1024;  // dynamic shared memory asked for: 227 KB less the static
constexpr int POLL_NS = 128;            // a block's sleep between reads of the row counter
constexpr int ROWS_OUT = 0, TICKETS = 1; // the counters: rows whose act is out, blocks past the barrier

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) / 16 * 16; }

// Dynamic shared memory (ops.mlp.fused_mlp_plan repeats it): slab
// [slab_rows * m] int8 | aq [m] int8 | xq [d] int8 | s_act [n_tiles] f32 |
// ys [slab_rows * n_tiles] int32; each piece starts on 16 bytes.
struct Layout {
  size_t aq, xq, s_act, ys, bytes;
  __host__ __device__ Layout(int m, int d, int n_tiles, int slab_rows) {
    aq = up16(static_cast<size_t>(slab_rows) * m);
    xq = aq + up16(m);
    s_act = xq + up16(d);
    ys = s_act + up16(4 * static_cast<size_t>(n_tiles));
    bytes = ys + up16(4 * static_cast<size_t>(slab_rows) * n_tiles);
  }
};

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

__device__ __forceinline__ int quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));  // round half to even
  return min(max(q, -127), 127);
}

__device__ __forceinline__ int pack4(const float4& v, float s) {
  const unsigned b0 = quant(v.x, s) & 0xff, b1 = quant(v.y, s) & 0xff,
                 b2 = quant(v.z, s) & 0xff, b3 = quant(v.w, s) & 0xff;
  return static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

__device__ __forceinline__ int dot16(const int4& w, const int4& a, int acc) {
  acc = __dp4a(w.x, a.x, acc);
  acc = __dp4a(w.y, a.y, acc);
  acc = __dp4a(w.z, a.z, acc);
  return __dp4a(w.w, a.w, acc);
}

// A weight stream read once: not kept in L1.
__device__ __forceinline__ int4 ld_stream(const int8_t* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Loads issued where they stand (volatile: not moved behind the weight
// streams, whose queue they would then wait in).
__device__ __forceinline__ float load_f32_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float load_x_now(const void* x, int x_bf16, size_t i) {
  if (!x_bf16) return load_f32_now(reinterpret_cast<const float*>(x) + i);
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n"
               : "=h"(v)
               : "l"(reinterpret_cast<const unsigned short*>(x) + i));
  return __uint_as_float(static_cast<unsigned>(v) << 16);  // bf16 -> f32, exact
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One level of the transposed sum of 16 rows over 32 lanes: the lanes whose
// bit 2H is set keep rows H..2H-1 and take their partner's, the others keep
// rows 0..H-1; the row count halves (H is a constant, so p stays in registers).
template <int H>
__device__ __forceinline__ void halve(int (&p)[16], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int keep = up ? p[i + H] : p[i], send = up ? p[i] : p[i + H];
    p[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

// One phase-1 row in flight: this lane's 16-byte pieces of the gate and up
// rows, and their scales.
struct RowLoad {
  int4 g[MAX_C], u[MAX_C];
  float sg, su;
};

__device__ __forceinline__ void load_row(RowLoad& r, int row, int lane, int d,
                                         const int8_t* __restrict__ wg,
                                         const float* __restrict__ sg,
                                         const int8_t* __restrict__ wu,
                                         const float* __restrict__ su) {
  const size_t base = static_cast<size_t>(row < 0 ? 0 : row) * d;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    const int off = lane * 16 + c * 512;
    const bool live = row >= 0 && off < d;
    r.g[c] = live ? ld_stream(wg + base + off) : make_int4(0, 0, 0, 0);
    r.u[c] = live ? ld_stream(wu + base + off) : make_int4(0, 0, 0, 0);
  }
  r.sg = row >= 0 ? load_f32_now(sg + row) : 0.f;  // with the weights, not at first use
  r.su = row >= 0 ? load_f32_now(su + row) : 0.f;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_kernel(const void* __restrict__ x, int x_bf16, const int8_t* __restrict__ wg,
                 const float* __restrict__ sg, const int8_t* __restrict__ wu,
                 const float* __restrict__ su, const int8_t* __restrict__ wd,
                 const float* __restrict__ sd, float* act, unsigned* ctr,
                 void* __restrict__ out, int m, int d, int tile_m, int slab_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS];
  const int n_tiles = m / tile_m;
  const Layout L(m, d, n_tiles, slab_rows);
  int8_t* slab = reinterpret_cast<int8_t*>(smem);
  int8_t* aq = reinterpret_cast<int8_t*>(smem + L.aq);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + L.xq);
  float* s_act = reinterpret_cast<float*>(smem + L.s_act);
  int* ys = reinterpret_cast<int*>(smem + L.ys);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int blocks = gridDim.x, b = blockIdx.x;
  const int r0 = b * slab_rows;                         // this block's first output row
  const int rows = max(0, min(d - r0, slab_rows));      // and how many it has
  const int8_t* wd_slab = wd + static_cast<size_t>(r0) * m;
  // phase-1 rows of this warp: b + i * blocks for i = warp + WARPS * k, k = 0, 1, ...
  const int local_rows = b < m ? (m - b + blocks - 1) / blocks : 0;
  auto row_of = [&](int k) {
    const int i = warp + WARPS * k;
    return i < local_rows ? b + i * blocks : -1;
  };
  // 16-byte cp.async copies, one group, by every warp but warp 0: thread 0's
  // fences at the grid barrier would wait for copies of its own
  auto copy_slab = [&]() {
    if (warp == 0) return;
    const int4* src = reinterpret_cast<const int4*>(wd_slab);
    int4* dst = reinterpret_cast<int4*>(slab);
    const int n = rows * (m / 16);
    for (int i = tid - 32; i < n; i += THREADS - 32) mma::cp_async16(dst + i, src + i);
    mma::cp_async_commit();
  };

  // x and sd first, before any weight stream: a load queues behind every
  // byte the card has been asked for before it
  float xv[X_PER];
#pragma unroll
  for (int q = 0; q < X_PER; ++q) {
    const int i = tid + q * THREADS;
    xv[q] = i < d ? load_x_now(x, x_bf16, i) : 0.f;
  }
  const float sd_row = tid < rows ? load_f32_now(sd + r0 + tid) : 0.f;
  float amax = 0.f;
#pragma unroll
  for (int q = 0; q < X_PER; ++q) amax = fmaxf(amax, fabsf(xv[q]));
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (PREFETCH_WD == 1) copy_slab();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) amax = fmaxf(amax, red[w]);
  const float sx = quant_scale(amax);
#pragma unroll
  for (int q = 0; q < X_PER; ++q) {
    const int i = tid + q * THREADS;
    if (i < d) xq[i] = static_cast<int8_t>(quant(xv[q], sx));
  }
  __syncthreads();
  int4 xr[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    const int off = lane * 16 + c * 512;
    xr[c] = off < d ? *reinterpret_cast<const int4*>(xq + off) : make_int4(0, 0, 0, 0);
  }

  // phase 1: a ring of RING rows in registers; a row's slot is refilled
  // with the row RING places later as soon as its act is out
  RowLoad ring[RING];
#pragma unroll
  for (int r = 0; r < RING; ++r) load_row(ring[r], row_of(r), lane, d, wg, sg, wu, su);
  for (int k0 = 0; row_of(k0) >= 0; k0 += RING) {
#pragma unroll
    for (int r = 0; r < RING; ++r) {
      const int row = row_of(k0 + r);
      if (row < 0) break;  // uniform over the warp; rows only end
      int gacc = 0, uacc = 0;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        gacc = dot16(ring[r].g[c], xr[c], gacc);
        uacc = dot16(ring[r].u[c], xr[c], uacc);
      }
      gacc = warp_sum(gacc);
      uacc = warp_sum(uacc);
      if (lane == 0) {
        const float g = __fmul_rn(static_cast<float>(gacc), __fmul_rn(sx, ring[r].sg));
        const float u = __fmul_rn(static_cast<float>(uacc), __fmul_rn(sx, ring[r].su));
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
        act[row] = __fmul_rn(__fmul_rn(g, sig), u);
      }
      load_row(ring[r], row_of(k0 + r + RING), lane, d, wg, sg, wu, su);
    }
  }

  // every act of the grid out before any is read: one grid-wide barrier on
  // a row counter (a release per row would wait for the ring's loads and
  // empty it)
  __syncthreads();  // the block's acts are stored
  if (tid == 0) {
    __threadfence();
    atomicAdd(ctr + ROWS_OUT, static_cast<unsigned>(local_rows));
  }
  if (PREFETCH_WD == 0) copy_slab();  // streams while the other blocks finish
  if (tid == 0) {
    while (ld_relaxed(ctr + ROWS_OUT) < static_cast<unsigned>(m)) __nanosleep(POLL_NS);
    __threadfence();
  }
  __syncthreads();
  // past the barrier, a ticket; the last of the blocks' tickets sets the
  // counters back to 0 for the next launch (every block has then passed)
  unsigned ticket = 0;
  if (tid == 0) ticket = atomicAdd(ctr + TICKETS, 1u);

  // phase 2a: warp w quantizes tiles w, w + WARPS, ... into shared memory,
  // reading the acts around L1 (not coherent with the other SMs' writes)
  for (int j = warp; rows > 0 && j < n_tiles; j += WARPS) {
    const int off = lane * 16;  // this lane's 16 act values of the tile
    const bool live = off < tile_m;
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = live ? __ldcg(reinterpret_cast<const float4*>(act + static_cast<size_t>(j) * tile_m +
                                                           off) + q)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float am = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      am = fmaxf(am, fmaxf(fmaxf(fabsf(v[q].x), fabsf(v[q].y)), fmaxf(fabsf(v[q].z), fabsf(v[q].w))));
    const float s = quant_scale(warp_max(am));
    if (live)
      *reinterpret_cast<int4*>(aq + static_cast<size_t>(j) * tile_m + off) =
          make_int4(pack4(v[0], s), pack4(v[1], s), pack4(v[2], s), pack4(v[3], s));
    if (lane == 0) s_act[j] = s;
  }
  if (PREFETCH_WD == 2) copy_slab();
  mma::cp_async_wait_n<0>();  // this thread's part of the slab has landed
  __syncthreads();            // and every thread's

  // phase 2b: each slab row's int32 dot per tile into ys. A step is 512
  // columns, 16 per lane.
  const int4* aq4 = reinterpret_cast<const int4*>(aq);
  const int4* slab4 = reinterpret_cast<const int4*>(slab);
  if (tile_m == 512) {
    // a tile per step: warp w takes steps w, w + WARPS, ... over 16 rows at a
    // time, its act piece read once; the 16 rows' sums over the 32 lanes are
    // one transposed reduction (lane bits 4..1 pick the row) of 16 shuffles
    for (int st = warp; st < n_tiles; st += WARPS) {
      const int col = st * 512 + lane * 16;
      const int4 a = aq4[col >> 4];
      for (int g = 0; g < rows; g += 16) {
        int p[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          p[i] = g + i < rows ? dot16(slab4[((g + i) * static_cast<size_t>(m) + col) >> 4], a, 0) : 0;
        halve<8>(p, lane);
        halve<4>(p, lane);
        halve<2>(p, lane);
        halve<1>(p, lane);
        const int y = p[0] + __shfl_xor_sync(0xffffffffu, p[0], 1);
        const int row = g + (lane >> 1);
        if (!(lane & 1) && row < rows) ys[row * n_tiles + st] = y;
      }
    }
  } else {
    // several tiles per step: warp w takes rows w, w + WARPS, ..., each
    // tile's sum over its `seg` lanes
    const int tile_shift = __ffs(tile_m) - 1;
    const int seg = tile_m >> 4;
    for (int r = warp; r < rows; r += WARPS) {
      for (int c0 = 0; c0 < m; c0 += 512) {
        const int col = c0 + lane * 16;
        int y = col < m ? dot16(slab4[(r * static_cast<size_t>(m) + col) >> 4], aq4[col >> 4], 0) : 0;
        for (int o = seg >> 1; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
        if (col < m && (lane & (seg - 1)) == 0) ys[r * n_tiles + (col >> tile_shift)] = y;
      }
    }
  }
  __syncthreads();
  if (tid < rows) {  // the tiles in order in f32, sd once
    float acc = 0.f;
    for (int j = 0; j < n_tiles; ++j)
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(ys[tid * n_tiles + j]), s_act[j]));
    const float o = __fmul_rn(acc, sd_row);
    if (x_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[r0 + tid] = __float2bfloat16_rn(o);
    else
      reinterpret_cast<float*>(out)[r0 + tid] = o;
  }
  if (tid == 0 && ticket == static_cast<unsigned>(blocks - 1)) {
    ctr[ROWS_OUT] = 0u;
    ctr[TICKETS] = 0u;
  }
}

}  // namespace

// x [d] (f32 or bf16) -> out [d] in x's dtype; act is an f32 buffer of m
// values (left holding the acts); ctr holds 2 zeroed uint32 counters and is
// left zeroed. `blocks`, `slab_rows` and `smem` come from
// ops.mlp.fused_mlp_plan (d % 16 == 0 and d <= 2048, tile_m a power of two in
// [16, 512], m % tile_m == 0, slab_rows <= 512, blocks * slab_rows >= d;
// refused here as an invalid value otherwise). One cooperative launch: a grid
// the card cannot hold at once is refused (cudaErrorCooperativeLaunchTooLarge),
// not run.
extern "C" int fused_mlp_launch(const void* x, int x_bf16, const int8_t* wg, const float* sg,
                                const int8_t* wu, const float* su, const int8_t* wd,
                                const float* sd, float* act, unsigned* ctr, void* out, int m,
                                int d, int tile_m, int blocks, int slab_rows, int smem,
                                cudaStream_t stream) {
  if (m <= 0 || d <= 0 || tile_m < 16 || tile_m > MAX_TILE || (tile_m & (tile_m - 1)) ||
      d % 16 || m % tile_m || d > MAX_C * 512 || blocks <= 0 || slab_rows <= 0 ||
      slab_rows > THREADS || static_cast<long long>(blocks) * slab_rows < d ||
      smem > SMEM_BUDGET || static_cast<size_t>(smem) != Layout(m, d, m / tile_m, slab_rows).bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // above 48 KB of dynamic shared memory
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BUDGET);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fused_mlp_kernel, x, x_bf16, wg, sg, wu, su, wd,
                                           sd, act, ctr, out, m, d, tile_m, slab_rows);
  const cudaError_t last = cudaGetLastError();  // read, so a refusal is not left for the next launch
  return static_cast<int>(e != cudaSuccess ? e : last);
}
