// Fused int4 dequant + matmul over the planar Q4Weight layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` via `_q4_matmul_2d`
// (qwen3_asr_gguf_tpu/ops/pallas_qmm.py, pallas_call at :85; `q4_matmul`):
// every decode matvec of a precision="q4_k" engine, the rows step of a
// server on such an engine, and the int4 encoder's products on inputs of at
// most 64 rows. Layout (ops/qmm.py, Q4Weight as the port keeps it: planar,
// natural order, repacked once at load from the reference's rank-major
// columns):
//   packed u8 [N, K/2]: byte j holds element j of the first half of K in its
//     low nibble and element K/2 + j in its high nibble, so with g = K/64
//     the 32 bytes from 32*gi are group gi (low) and group g + gi (high);
//   scale, minv f32 [N, K/32], natural group order.
//   out[t, n] = sum_k x[t, k] * (q[n, k]*s - m), x taken as f32, f32 sums,
//   out in x's dtype; no activation quantization.
//
// Bound: every weight byte is read once, whatever T: N*K/2 packed bytes plus
// 8*N*K/32 bytes of scales and offsets (half as much again) over the memory
// rate. The tensor-core work (2*T8*N*K bf16 operations per x plane, T8 = T
// rounded up to 8) stays below it up to 64 rows.
//
// Design. The group is factored as the q4_k kernels factor it:
//   out[t, n] = sum_g s[n,g] * D[t,n,g] + (8 s[n,g] - m[n,g]) * xsum[t,g],
//   D = sum_{k in g} x[t,k] * (q[n,k] - 8),
// with D on the tensor cores: q - 8 is exact in bf16, a bf16 x is exact, and
// an f32 x is split by a small launch into two bf16 planes hi + lo (a
// relative 2^-17 of x is dropped; the bound on f32 outputs is 1e-4). A block
// owns 16*pw channels (pw = 1, 2, 4, 8) and ALL T rows, and walks its share
// of K (a thread block cluster of `ks` blocks splits K where N alone gives
// too few blocks to fill the card) in
// chunks of `gcm` group pairs (8 or 4: 512 or 256 of K) through a ring of
// shared-memory stages filled by cp.async (16-byte copies; indices are
// shifts and masks): the weight bytes, the two scale planes' rows of the
// block's channels and the chunk's live x rows of both halves of K. After a
// chunk lands the block sums xsum of its rows and groups from shared memory,
// then the 8 warps (pw channel tiles times 8/pw K slices) run, per group
// pair,
// m16n8k16 bf16 mma's with the weights as A (16 channels) and 8 rows of x as
// B. One 8-byte word of `packed` gives the lane, after two byte permutes and
// the 0x4300 | q trick (a bf16 128 + q, then an exact subtraction of 136),
// the A registers of both nibble planes for K slots that match x's natural
// pairs, with no shuffle; those registers serve all T/8 row tiles, so the
// weights are read once at any T. The f32 epilogue of a group (two fma per
// output) follows on the CUDA cores; the K slices are added through shared
// memory, in order, at the end, and then the cluster's blocks through
// distributed shared memory, in rank order (no atomics). One design for every shape: channels past N
// are clamped on load and masked on store, rows past T multiply as zeros.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "mma_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int STAGE_BUDGET = 110 * 1024;  // two blocks per SM where the stages allow it

constexpr int RED_STRIDE = 17;  // floats of a row of 16 channels in the final sums

// One stage: w[ch][ws] | s[ch][sp] f32 | m[ch][sp] f32 |
// x[planes][2 halves][t8][xs] bf16 | xsum[2*gcm][t8] f32.
struct Stage {
  int ws, xs, sp;  // byte strides of a weight row and an x row; floats of a scale row
  int w, s, m, x, xsum, bytes;
};

__host__ __device__ inline Stage stage_layout(int ch, int gcm, int t8, int planes) {
  Stage L;
  L.ws = gcm * 32 + 32;  // 8-byte loads of 16 lanes hit 32 banks
  L.xs = gcm * 64 + 64;  // 16-byte loads of 8 lanes hit 32 banks
  L.sp = 2 * gcm + 4;    // [half][group]; 8 channels' rows start in 8 different banks
  L.w = 0;
  L.s = L.w + ch * L.ws;
  L.m = L.s + ch * L.sp * 4;
  L.x = L.m + ch * L.sp * 4;
  L.xsum = L.x + planes * 2 * t8 * L.xs;
  L.bytes = L.xsum + 2 * gcm * t8 * 4;
  return L;
}

// f32 x -> two bf16 planes: hi = bf16(x), lo = bf16(x - hi).
__global__ void split_x_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ hi,
                               __nv_bfloat16* __restrict__ lo, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float v = x[i];
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi[i] = h;
  lo[i] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h)));
}

// Two packed bytes (in bytes 0 and 2 of `pair`) -> their low nibbles and
// their high nibbles as bf16 pairs of q - 8.
__device__ __forceinline__ void nibbles_bf16(uint32_t pair, uint32_t& lo, uint32_t& hi) {
  const uint32_t l = (pair & 0x000F000Fu) | 0x43004300u;         // bf16 128 + q
  const uint32_t h = ((pair >> 4) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 off = __float2bfloat162_rn(136.0f);
  const __nv_bfloat162 lv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), off);
  const __nv_bfloat162 hv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), off);
  lo = *reinterpret_cast<const uint32_t*>(&lv);
  hi = *reinterpret_cast<const uint32_t*>(&hv);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// NT = T8 / 8 row tiles, PL x planes (1: bf16 x, 2: the hi and lo of f32 x).
// gs = log2 of the group pairs per chunk (2 or 3), cs = log2 of the block's
// channels: every index below is a shift or a mask, never a division.
template <int NT, int PL>
__global__ void __launch_bounds__(THREADS, NT <= 2 ? 3 : 2)  // registers for 3 (or 2) blocks an SM
q4_matmul_kernel(const __nv_bfloat16* __restrict__ x0, const __nv_bfloat16* __restrict__ x1,
                 const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                 const float* __restrict__ minv, void* __restrict__ out, int out_bf16, int t,
                 int n, int k, int cs, int gs, int stages) {
  constexpr int T8 = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ch_count = 1 << cs, gcm = 1 << gs;
  const Stage L = stage_layout(ch_count, gcm, T8, PL);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ss = 7 - cs;  // log2 of the K slices: 8 warps over ch_count / 16 channel tiles
  const int k_slices = 1 << ss;
  const int pw = warp >> ss, kw = warp & (k_slices - 1);
  cg::cluster_group cluster = cg::this_cluster();  // spans grid.x: the blocks that split K
  const int rank = static_cast<int>(cluster.block_rank());
  const int ks = static_cast<int>(cluster.num_blocks());
  const int ch0 = blockIdx.y << cs;
  const int k2 = k / 2, g = k / 64;
  const int all_chunks = (g + gcm - 1) >> gs;
  const int per_block = (all_chunks + ks - 1) / ks;
  const int first_chunk = rank * per_block;  // this block's chunks of K
  const int n_chunks = max(0, min(all_chunks, first_chunk + per_block) - first_chunk);
  const bool vec_scales = (g & 3) == 0;  // a chunk's scales of a channel are whole 16 bytes

  auto load_chunk = [&](int local) {
    unsigned char* st = smem + (local % stages) * L.bytes;
    const int gi0 = (first_chunk + local) << gs;
    const int gcc = min(gcm, g - gi0);  // group pairs of this chunk
    for (int i = tid; i < ch_count << (gs + 1); i += THREADS) {  // 16-byte pieces of the weights
      const int r = i >> (gs + 1), s = i & (2 * gcm - 1);
      if (s >= 2 * gcc) continue;
      const int ch = min(ch0 + r, n - 1);
      mma::cp_async16(st + L.w + r * L.ws + s * 16,
                      packed + static_cast<size_t>(ch) * k2 + gi0 * 32 + s * 16);
    }
    float* s_s = reinterpret_cast<float*>(st + L.s);
    float* m_s = reinterpret_cast<float*>(st + L.m);
    if (vec_scales) {  // 4 groups per copy
      for (int i = tid; i < ch_count << (gs - 1); i += THREADS) {
        const int q4 = i & (gcm / 4 - 1), half = (i >> (gs - 2)) & 1, r = i >> (gs - 1);
        if (4 * q4 >= gcc) continue;
        const int ch = min(ch0 + r, n - 1);
        const size_t src = static_cast<size_t>(ch) * (2 * g) + half * g + gi0 + 4 * q4;
        const int dst = r * L.sp + half * gcm + 4 * q4;
        mma::cp_async16(s_s + dst, scale + src);
        mma::cp_async16(m_s + dst, minv + src);
      }
    } else {
      for (int i = tid; i < ch_count << (gs + 1); i += THREADS) {
        const int gl = i & (gcm - 1), half = (i >> gs) & 1, r = i >> (gs + 1);
        if (gl >= gcc) continue;
        const int ch = min(ch0 + r, n - 1);
        const size_t src = static_cast<size_t>(ch) * (2 * g) + half * g + gi0 + gl;
        const int dst = r * L.sp + half * gcm + gl;
        mma::cp_async4(s_s + dst, scale + src);
        mma::cp_async4(m_s + dst, minv + src);
      }
    }
#pragma unroll
    for (int ph = 0; ph < 2 * PL; ++ph) {  // (plane, half): 16-byte pieces of the live x rows
      const __nv_bfloat16* xp = (ph < 2 ? x0 : x1) + (ph & 1) * k2 + gi0 * 32;
      for (int i = tid; i < t << (gs + 2); i += THREADS) {
        const int row = i >> (gs + 2), s = i & (4 * gcm - 1);
        if (s >= 4 * gcc) continue;
        mma::cp_async16(st + L.x + (ph * T8 + row) * L.xs + s * 16,
                        xp + static_cast<size_t>(row) * k + s * 8);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int tile = 0; tile < NT; ++tile)
    acc[tile][0] = acc[tile][1] = acc[tile][2] = acc[tile][3] = 0.f;

  for (int c = 0; c < stages - 1; ++c) {
    if (c < n_chunks) load_chunk(c);
    mma::cp_async_commit();
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    mma::cp_async_wait(stages - 2);  // this chunk's group has landed
    __syncthreads();                 // for every thread; the slot refilled below is free
    if (chunk + stages - 1 < n_chunks) load_chunk(chunk + stages - 1);
    mma::cp_async_commit();

    const unsigned char* st = smem + (chunk % stages) * L.bytes;
    const int gcc = min(gcm, g - ((first_chunk + chunk) << gs));
    float* xsum_s = reinterpret_cast<float*>(const_cast<unsigned char*>(st) + L.xsum);
    // xsum[half][group][row] of the live rows (the others' products are never stored)
    if (NT <= 2) {
      // eight lanes per sum, four values each (plane 0's, then plane 1's), then
      // three butterfly steps
      const int tasks = t << (gs + 4);  // rows * 2 halves * gcm groups * 8 lanes
      for (int base = 0; base < tasks; base += THREADS) {
        const int i = base + tid;
        const int l8 = i & 7, gl = (i >> 3) & (gcm - 1), half = (i >> (gs + 3)) & 1;
        const int row = i >> (gs + 4);
        const bool live = i < tasks && gl < gcc;
        float sum = 0.f;
        if (live) {
#pragma unroll
          for (int pl = 0; pl < PL; ++pl) {
            const uint2 u = *reinterpret_cast<const uint2*>(
                st + L.x + ((pl * 2 + half) * T8 + row) * L.xs + gl * 64 + l8 * 8);
            sum = __fadd_rn(sum, bf16_lo(u.x));
            sum = __fadd_rn(sum, bf16_hi(u.x));
            sum = __fadd_rn(sum, bf16_lo(u.y));
            sum = __fadd_rn(sum, bf16_hi(u.y));
          }
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
        if (live && l8 == 0) xsum_s[(half * gcm + gl) * T8 + row] = sum;
      }
    } else {
      // one thread per sum: the 32 values of plane 0 in order, then plane 1's
      for (int i = tid; i < t << (gs + 1); i += THREADS) {
        const int gl = i & (gcm - 1), half = (i >> gs) & 1, row = i >> (gs + 1);
        if (gl >= gcc) continue;
        float sum = 0.f;
#pragma unroll
        for (int pl = 0; pl < PL; ++pl) {
          const uint4* xv = reinterpret_cast<const uint4*>(
              st + L.x + ((pl * 2 + half) * T8 + row) * L.xs + gl * 64);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const uint4 u = xv[v];
            const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sum = __fadd_rn(sum, bf16_lo(words[e]));
              sum = __fadd_rn(sum, bf16_hi(words[e]));
            }
          }
        }
        xsum_s[(half * gcm + gl) * T8 + row] = sum;
      }
    }
    __syncthreads();

    const float* s_s = reinterpret_cast<const float*>(st + L.s);
    const float* m_s = reinterpret_cast<const float*>(st + L.m);
    const int chl = pw * 16 + gid;  // the lane's first channel (its second: + 8), block-local
    for (int gl = kw; gl < gcc; gl += k_slices) {
      // the lane's 8 bytes of each channel: elements 8*tig.. of the group pair
      const unsigned char* wp = st + L.w + chl * L.ws + gl * 32 + tig * 8;
      const uint2 wa = *reinterpret_cast<const uint2*>(wp);
      const uint2 wb = *reinterpret_cast<const uint2*>(wp + 8 * L.ws);
      // a[half][mma][register]: mma 0 takes bytes 0..3, mma 1 bytes 4..7;
      // registers 0, 2 (channel gid) and 1, 3 (channel gid + 8) hold the
      // byte pairs (0, 1) and (2, 3)
      uint32_t a[2][2][4];
      nibbles_bf16(__byte_perm(wa.x, 0, 0x4140), a[0][0][0], a[1][0][0]);
      nibbles_bf16(__byte_perm(wb.x, 0, 0x4140), a[0][0][1], a[1][0][1]);
      nibbles_bf16(__byte_perm(wa.x, 0, 0x4342), a[0][0][2], a[1][0][2]);
      nibbles_bf16(__byte_perm(wb.x, 0, 0x4342), a[0][0][3], a[1][0][3]);
      nibbles_bf16(__byte_perm(wa.y, 0, 0x4140), a[0][1][0], a[1][1][0]);
      nibbles_bf16(__byte_perm(wb.y, 0, 0x4140), a[0][1][1], a[1][1][1]);
      nibbles_bf16(__byte_perm(wa.y, 0, 0x4342), a[0][1][2], a[1][1][2]);
      nibbles_bf16(__byte_perm(wb.y, 0, 0x4342), a[0][1][3], a[1][1][3]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int srow = chl * L.sp + half * gcm + gl;
        const float s0 = s_s[srow], s1 = s_s[srow + 8 * L.sp];
        const float o0 = __fmaf_rn(8.f, s0, -m_s[srow]);
        const float o1 = __fmaf_rn(8.f, s1, -m_s[srow + 8 * L.sp]);
        const float* xsum_row = xsum_s + (half * gcm + gl) * T8 + tig * 2;
#pragma unroll
        for (int tile = 0; tile < NT; ++tile) {
          float d[4];
#pragma unroll
          for (int pl = 0; pl < PL; ++pl) {
            uint4 xb = make_uint4(0, 0, 0, 0);  // rows past T multiply as zeros
            if (tile * 8 + gid < t)
              xb = *reinterpret_cast<const uint4*>(
                  st + L.x + ((pl * 2 + half) * T8 + tile * 8 + gid) * L.xs + gl * 64 + tig * 16);
            if (pl == 0)
              mma::m16n8k16_bf16_first(d, a[half][0][0], a[half][0][1], a[half][0][2],
                                       a[half][0][3], xb.x, xb.y);
            else
              mma::m16n8k16_bf16(d, a[half][0][0], a[half][0][1], a[half][0][2], a[half][0][3],
                                 xb.x, xb.y);
            mma::m16n8k16_bf16(d, a[half][1][0], a[half][1][1], a[half][1][2], a[half][1][3],
                               xb.z, xb.w);
          }
          const float2 xs = *reinterpret_cast<const float2*>(xsum_row + tile * 8);
          acc[tile][0] = __fmaf_rn(o0, xs.x, __fmaf_rn(s0, d[0], acc[tile][0]));
          acc[tile][1] = __fmaf_rn(o0, xs.y, __fmaf_rn(s0, d[1], acc[tile][1]));
          acc[tile][2] = __fmaf_rn(o1, xs.x, __fmaf_rn(s1, d[2], acc[tile][2]));
          acc[tile][3] = __fmaf_rn(o1, xs.y, __fmaf_rn(s1, d[3], acc[tile][3]));
        }
      }
    }
  }

  // add the K slices in order through shared memory: red[warp][row][16 channels]
  mma::cp_async_wait(0);
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  float* part = red + WARPS * T8 * RED_STRIDE;  // part[row][channel] of this block
#pragma unroll
  for (int tile = 0; tile < NT; ++tile)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(warp * T8 + tile * 8 + tig * 2 + (i & 1)) * RED_STRIDE + gid + 8 * (i >> 1)] =
          acc[tile][i];
  __syncthreads();
  auto block_sum = [&](int idx) {
    const int cl = idx & (ch_count - 1), row = idx >> cs;
    const float* src = red + (((cl >> 4) << ss) * T8 + row) * RED_STRIDE + (cl & 15);
    float v = src[0];
    for (int s = 1; s < k_slices; ++s) v = __fadd_rn(v, src[s * T8 * RED_STRIDE]);
    return v;
  };
  auto store = [&](int idx, float v) {
    const int cl = idx & (ch_count - 1), row = idx >> cs;
    if (row >= t || ch0 + cl >= n) return;
    const size_t at = static_cast<size_t>(row) * n + ch0 + cl;
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v);
    else
      reinterpret_cast<float*>(out)[at] = v;
  };
  if (ks == 1) {
    for (int idx = tid; idx < T8 << cs; idx += THREADS) store(idx, block_sum(idx));
    return;
  }
  for (int idx = tid; idx < T8 << cs; idx += THREADS) part[idx] = block_sum(idx);
  cluster.sync();
  // each block adds, in rank order, its share of the outputs
  const int share = ((T8 << cs) + ks - 1) / ks;
  const int last = min(T8 << cs, (rank + 1) * share);
  for (int idx = rank * share + tid; idx < last; idx += THREADS) {
    float v = cluster.map_shared_rank(part, 0)[idx];
    for (int r = 1; r < ks; ++r) v = __fadd_rn(v, cluster.map_shared_rank(part, r)[idx]);
    store(idx, v);
  }
  cluster.sync();  // no block's shared memory goes away while another reads it
}

template <int NT, int PL>
int launch(const __nv_bfloat16* x0, const __nv_bfloat16* x1, const uint8_t* packed,
           const float* scale, const float* minv, void* out, int out_bf16, int t, int n, int k,
           int pw, int gcm, int ks, cudaStream_t stream) {
  const int bytes = stage_layout(16 * pw, gcm, NT * 8, PL).bytes;
  int stages = STAGE_BUDGET / bytes;
  stages = stages < 2 ? 2 : (stages > MAX_STAGES ? MAX_STAGES : stages);
  const int smem = stages * bytes;  // also holds red and part at the end
  if (smem > SMEM_LIMIT || smem < (WARPS * RED_STRIDE + 16 * pw) * NT * 8 * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // above 48 KB dynamic shared memory needs opting in
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        q4_matmul_kernel<NT, PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, (n + 16 * pw - 1) / (16 * pw), 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int cs = pw == 1 ? 4 : (pw == 2 ? 5 : (pw == 4 ? 6 : 7));  // log2 of the channels
  const cudaError_t e = cudaLaunchKernelEx(&cfg, q4_matmul_kernel<NT, PL>, x0, x1, packed, scale,
                                           minv, out, out_bf16, t, n, k, cs, gcm == 8 ? 3 : 2,
                                           stages);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int PL>
int launch_rows(int nt, const __nv_bfloat16* x0, const __nv_bfloat16* x1, const uint8_t* packed,
                const float* scale, const float* minv, void* out, int out_bf16, int t, int n,
                int k, int pw, int gcm, int ks, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch<1, PL>(x0, x1, packed, scale, minv, out, out_bf16, t, n, k, pw, gcm, ks, stream);
    case 2: return launch<2, PL>(x0, x1, packed, scale, minv, out, out_bf16, t, n, k, pw, gcm, ks, stream);
    case 3: return launch<3, PL>(x0, x1, packed, scale, minv, out, out_bf16, t, n, k, pw, gcm, ks, stream);
    case 4: return launch<4, PL>(x0, x1, packed, scale, minv, out, out_bf16, t, n, k, pw, gcm, ks, stream);
    case 5: return launch<5, PL>(x0, x1, packed, scale, minv, out, out_bf16, t, n, k, pw, gcm, ks, stream);
    case 6: return launch<6, PL>(x0, x1, packed, scale, minv, out, out_bf16, t, n, k, pw, gcm, ks, stream);
    case 7: return launch<7, PL>(x0, x1, packed, scale, minv, out, out_bf16, t, n, k, pw, gcm, ks, stream);
    default: return launch<8, PL>(x0, x1, packed, scale, minv, out, out_bf16, t, n, k, pw, gcm, ks, stream);
  }
}

}  // namespace

// x [t, k] (f32 or bf16) -> out [t, n] in x's dtype. planes: scratch of
// 2*t*k bf16 for an f32 x (unused for bf16). pw channel tiles of 16 per
// block, gcm group pairs per chunk and ks blocks that split K come from
// ops/qmm.py (`tiling`).
// 1 <= t <= 64, k % 64 == 0 (checked by the wrapper; refused here as an
// invalid value).
extern "C" int q4_matmul_launch(const void* x, int x_bf16, void* planes, const uint8_t* packed,
                                const float* scale, const float* minv, void* out, int t, int n,
                                int k, int pw, int gcm, int ks, cudaStream_t stream) {
  if (t <= 0 || t > 64 || n <= 0 || k <= 0 || k % 64 || (pw != 1 && pw != 2 && pw != 4 && pw != 8) ||
      (gcm != 4 && gcm != 8) || WARPS / pw > gcm || ks < 1 || ks > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (t + 7) / 8;
  if (x_bf16)
    return launch_rows<1>(nt, reinterpret_cast<const __nv_bfloat16*>(x), nullptr, packed, scale,
                          minv, out, 1, t, n, k, pw, gcm, ks, stream);
  __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(planes);
  __nv_bfloat16* lo = hi + static_cast<size_t>(t) * k;
  const int count = t * k;
  split_x_kernel<<<(count + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      reinterpret_cast<const float*>(x), hi, lo, count);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_rows<2>(nt, hi, lo, packed, scale, minv, out, 0, t, n, k, pw, gcm, ks, stream);
}
