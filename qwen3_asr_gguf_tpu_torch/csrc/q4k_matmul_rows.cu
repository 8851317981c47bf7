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
// Bound: a batched decode step at T rows (T % 8 == 0, T <= 64) reads every
// weight byte once, whatever T: bytes over the memory rate at the layer
// shapes. At the LM head and T = 64 the f32 epilogue per (row, channel,
// group), four operations each, is as large as the byte time.
//
// Design. Pass A (a block per row and 1024 of K) quantizes the T rows into
// int8 and writes (sx, xsum) pairs as [group][row], the order pass B reads
// them in. Pass B: a block owns `ct` channel pairs (8, 16, 32 or 64: 16 to
// 128 channels) and ALL T rows, and walks its share of K (a thread block
// cluster of `ks` blocks splits K where N alone gives too few blocks to fill
// the card) in chunks of 512 through a ring of shared-memory stages filled
// with 16-byte cp.async copies: the block's weight rows, the T int8
// activation rows, the (sx, xsum) pairs, and the scale planes sub_t / min_t /
// dd_t of the block's channels, read along N where they are contiguous. The
// 8 warps are ct/8 channel tiles times 64/ct K slices. A 32-group is the K
// of one mma.sync.m16n8k32 (s8 x s8 -> s32): the A tile's 16 rows are the
// even channels of 8 pairs (low nibbles) and then their odd channels (high
// nibbles), so one 8-byte word of `packed` at (pair gid, k = 8*tig) gives
// the lane's four A registers after `split_nibbles`, with no shuffle; the 8
// activation rows of a row tile are the B tile. The A registers of a group
// serve T/8 mma's, so the weights are read once at any T. The accumulator
// starts at the bits of 1.5 * 2^23, so the int32 result read as a float is
// 12582912 + dot and one exact subtraction replaces the conversion. The f32
// epilogue of the group follows on the CUDA cores; the K slices are added
// through shared memory, in order, at the end, and then the cluster's blocks
// through distributed shared memory, in rank order (no atomics: the result
// does not depend on timing).
// Pass A stays a launch of its own.

#include <cooperative_groups.h>

#include "mma_common.cuh"
#include "q4k_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace q4k;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 512;                  // K per chunk: two q4_k superblocks
constexpr int GC = KC / GROUP;           // groups per chunk
constexpr int ROW_STRIDE = KC + 32;      // weight and xq rows: 8-byte loads of 16 lanes hit 32 banks
constexpr int DD_ROWS = KC / 128;        // d and dmin of each superblock of a chunk
constexpr int MAX_STAGES = 4;
constexpr int STAGE_BUDGET = 100 * 1024; // two blocks per SM where the stages allow it
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int MAGIC_BITS = 0x4B400000;   // 1.5 * 2^23 as a float
constexpr float MAGIC = 12582912.0f;
constexpr int RED_STRIDE = 17;           // floats of a row of 16 channels in the final sums
constexpr int QUANT_SPAN = 4 * THREADS;  // values of a row per block of pass A

// One stage: w[ct][ROW_STRIDE] | xq[t][ROW_STRIDE] | sub[GC][2ct] | min[GC][2ct]
// | dd[DD_ROWS][2ct] f32 | sxs[GC][t] float2; every part a multiple of 16 bytes.
struct Stage {
  int w, xq, sub, mn, dd, sxs, bytes;
};

__host__ __device__ inline Stage stage_layout(int ct, int t) {
  Stage s;
  s.w = 0;
  s.xq = s.w + ct * ROW_STRIDE;
  s.sub = s.xq + t * ROW_STRIDE;
  s.mn = s.sub + GC * 2 * ct;
  s.dd = s.mn + GC * 2 * ct;
  s.sxs = s.dd + DD_ROWS * 2 * ct * 4;
  s.bytes = s.sxs + GC * t * 8;
  return s;
}

// Pass A: quantize QUANT_SPAN values (blockIdx.y) of activation row blockIdx.x
// of x [t, k]. Eight lanes share a 32-group, four values each: the group's
// amax and sum come from three butterfly steps. xq is [t][k]; sxs is
// [k/32][t] pairs (sx, xsum).
__global__ void __launch_bounds__(THREADS)
quantize_rows_mma_kernel(const void* __restrict__ x, int x_bf16, int t, int k,
                         int8_t* __restrict__ xq, float2* __restrict__ sxs) {
  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * k;
  const int u = blockIdx.y * THREADS + threadIdx.x;  // k % 512 == 0: whole warps are in range
  if (u >= k / 4) return;
  float v[4];
  if (x_bf16) {
    const uint2 raw = reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(x) + off)[u];
    v[0] = __uint_as_float(raw.x << 16);
    v[1] = __uint_as_float(raw.x & 0xFFFF0000u);
    v[2] = __uint_as_float(raw.y << 16);
    v[3] = __uint_as_float(raw.y & 0xFFFF0000u);
  } else {
    const float4 raw = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + off)[u];
    v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
  }
  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
  float s = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]), v[3]);
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  const float sxg = fmaxf(amax, 1e-10f) * INV127;
  const float r = 1.0f / sxg;
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int q = __float2int_rn(v[e] * r);
    q = min(max(q, -127), 127);
    word |= static_cast<uint32_t>(q & 0xFF) << (8 * e);
  }
  reinterpret_cast<uint32_t*>(xq + off)[u] = word;
  if ((u & 7) == 0) sxs[static_cast<size_t>(u >> 3) * t + row] = make_float2(sxg, s);
}

// A 6-bit scale (0..63) as a float without an int-to-float conversion.
__device__ __forceinline__ float small_uint_f32(int v) {
  return __uint_as_float(0x4B000000u | static_cast<uint32_t>(v)) - 8388608.0f;
}

// Pass B. TT = T / 8 row tiles; 2^cts channel pairs per block; `stages` ring
// slots. Registers are held to two blocks per SM.
template <int TT>
__global__ void __launch_bounds__(THREADS, 2)
q4k_matmul_rows_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sxs,
                       const uint8_t* __restrict__ packed, const int8_t* __restrict__ sub_t,
                       const int8_t* __restrict__ min_t, const float* __restrict__ dd_t,
                       void* __restrict__ out, int out_bf16, int n, int k, int cts, int stages) {
  constexpr int T = TT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ct = 1 << cts;  // cts = log2 of the channel pairs: indices are shifts, not divisions
  const Stage L = stage_layout(ct, T);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ss = 6 - cts;                    // log2 of the warps that share a channel tile
  const int k_slices = 1 << ss;
  const int pw = warp >> ss, kw = warp & (k_slices - 1);
  const int groups_per_warp = GC >> ss;
  cg::cluster_group cluster = cg::this_cluster();  // spans grid.x: the blocks that split K
  const int rank = static_cast<int>(cluster.block_rank());
  const int ks = static_cast<int>(cluster.num_blocks());
  const int p0 = blockIdx.y * ct;            // first channel pair of the block
  const int c0 = 2 * p0;                     // first channel
  const int per_block = (k / KC + ks - 1) / ks;
  const int first_chunk = rank * per_block;  // this block's chunks of K
  const int n_chunks = max(0, min(k / KC, first_chunk + per_block) - first_chunk);

  auto load_chunk = [&](int local) {
    unsigned char* st = smem + (local % stages) * L.bytes;
    const int chunk = first_chunk + local;
    const int k0 = chunk * KC;
    for (int i = tid; i < ct * (KC / 16); i += THREADS) {
      const int r = i / (KC / 16), s = i % (KC / 16);
      mma::cp_async16(st + L.w + r * ROW_STRIDE + s * 16,
                      packed + static_cast<size_t>(p0 + r) * k + k0 + s * 16);
    }
    for (int i = tid; i < T * (KC / 16); i += THREADS) {
      const int r = i / (KC / 16), s = i % (KC / 16);
      mma::cp_async16(st + L.xq + r * ROW_STRIDE + s * 16,
                      xq + static_cast<size_t>(r) * k + k0 + s * 16);
    }
    const int nseg = ct / 8;  // 16-byte pieces of a group's 2*ct sub-scales
    for (int i = tid; i < GC * nseg; i += THREADS) {
      const int gl = i >> (cts - 3), s = i & (nseg - 1);
      const size_t src = static_cast<size_t>(chunk * GC + gl) * n + c0 + s * 16;
      mma::cp_async16(st + L.sub + gl * 2 * ct + s * 16, sub_t + src);
      mma::cp_async16(st + L.mn + gl * 2 * ct + s * 16, min_t + src);
    }
    const int dseg = ct / 2;  // 16-byte pieces of a row of 2*ct floats
    for (int i = tid; i < DD_ROWS * dseg; i += THREADS) {
      const int r = i >> (cts - 1), s = i & (dseg - 1);  // rows: d, dmin of each superblock
      mma::cp_async16(st + L.dd + (r * 2 * ct + s * 4) * 4,
                      dd_t + static_cast<size_t>(chunk * DD_ROWS + r) * n + c0 + s * 4);
    }
    const float* sxs_chunk = sxs + static_cast<size_t>(chunk) * GC * T * 2;
    for (int i = tid; i < GC * T / 2; i += THREADS)
      mma::cp_async16(st + L.sxs + i * 16, sxs_chunk + i * 4);
  };

  float acc[TT][4];
#pragma unroll
  for (int tile = 0; tile < TT; ++tile)
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
    const unsigned char* wrow = st + L.w + (pw * 8 + gid) * ROW_STRIDE + tig * 8;
    const int ch = pw * 16 + 2 * gid;  // the lane's even channel, local to the block
    for (int j = 0; j < groups_per_warp; ++j) {
      const int gl = kw * groups_per_warp + j;
      // K slots 4*tig.. of both halves carry k = 8*tig.. and 8*tig + 4..
      const uint2 wv = *reinterpret_cast<const uint2*>(wrow + gl * GROUP);
      int a0, a1, a2, a3;
      split_nibbles(wv.x, a0, a1);
      split_nibbles(wv.y, a2, a3);
      const char2 sb = *reinterpret_cast<const char2*>(st + L.sub + gl * 2 * ct + ch);
      const char2 mn = *reinterpret_cast<const char2*>(st + L.mn + gl * 2 * ct + ch);
      const float* dd = reinterpret_cast<const float*>(st + L.dd) + (gl >> 3) * 4 * ct + ch;
      const float2 dv = *reinterpret_cast<const float2*>(dd);
      const float2 mv = *reinterpret_cast<const float2*>(dd + 2 * ct);
      const float sc0 = __fmul_rn(small_uint_f32(sb.x), dv.x);
      const float sc1 = __fmul_rn(small_uint_f32(sb.y), dv.y);
      const float off0 = __fsub_rn(__fmul_rn(8.f, sc0), __fmul_rn(small_uint_f32(mn.x), mv.x));
      const float off1 = __fsub_rn(__fmul_rn(8.f, sc1), __fmul_rn(small_uint_f32(mn.y), mv.y));
      const unsigned char* xrow = st + L.xq + gid * ROW_STRIDE + gl * GROUP + tig * 8;
      const unsigned char* srow = st + L.sxs + (gl * T + tig * 2) * 8;
#pragma unroll
      for (int tile = 0; tile < TT; ++tile) {
        const uint2 xb = *reinterpret_cast<const uint2*>(xrow + tile * 8 * ROW_STRIDE);
        int d[4];
        mma::m16n8k32_s8(d, a0, a1, a2, a3, static_cast<int>(xb.x), static_cast<int>(xb.y),
                         MAGIC_BITS);
        // (sx, xsum) of rows 8*tile + 2*tig and + 1
        const float4 sv = *reinterpret_cast<const float4*>(srow + tile * 64);
        const float f0 = __fsub_rn(__int_as_float(d[0]), MAGIC);  // even channel, row 0
        const float f1 = __fsub_rn(__int_as_float(d[1]), MAGIC);  // even channel, row 1
        const float f2 = __fsub_rn(__int_as_float(d[2]), MAGIC);  // odd channel, row 0
        const float f3 = __fsub_rn(__int_as_float(d[3]), MAGIC);  // odd channel, row 1
        acc[tile][0] = __fmaf_rn(sv.y, off0, __fmaf_rn(__fmul_rn(f0, sv.x), sc0, acc[tile][0]));
        acc[tile][1] = __fmaf_rn(sv.w, off0, __fmaf_rn(__fmul_rn(f1, sv.z), sc0, acc[tile][1]));
        acc[tile][2] = __fmaf_rn(sv.y, off1, __fmaf_rn(__fmul_rn(f2, sv.x), sc1, acc[tile][2]));
        acc[tile][3] = __fmaf_rn(sv.w, off1, __fmaf_rn(__fmul_rn(f3, sv.z), sc1, acc[tile][3]));
      }
    }
  }

  // add the K slices in order through shared memory: red[warp][row][16 channels]
  mma::cp_async_wait(0);
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  float* part = red + WARPS * T * RED_STRIDE;  // part[row][channel] of this block
#pragma unroll
  for (int tile = 0; tile < TT; ++tile)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(warp * T + tile * 8 + tig * 2 + (i & 1)) * RED_STRIDE + 2 * gid + (i >> 1)] =
          acc[tile][i];
  __syncthreads();
  const int chs = cts + 1;  // log2 of the block's channels
  auto block_sum = [&](int idx) {
    const int cl = idx & (2 * ct - 1), t = idx >> chs;
    const float* src = red + (((cl >> 4) << ss) * T + t) * RED_STRIDE + (cl & 15);
    float v = src[0];
    for (int s = 1; s < k_slices; ++s) v = __fadd_rn(v, src[s * T * RED_STRIDE]);
    return v;
  };
  auto store = [&](int idx, float v) {
    const size_t at = static_cast<size_t>(idx >> chs) * n + c0 + (idx & (2 * ct - 1));
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v);
    else
      reinterpret_cast<float*>(out)[at] = v;
  };
  if (ks == 1) {
    for (int idx = tid; idx < T << chs; idx += THREADS) store(idx, block_sum(idx));
    return;
  }
  for (int idx = tid; idx < T << chs; idx += THREADS) part[idx] = block_sum(idx);
  cluster.sync();
  // each block adds, in rank order, its share of the outputs
  const int share = ((T << chs) + ks - 1) / ks;
  const int last = min(T << chs, (rank + 1) * share);
  for (int idx = rank * share + tid; idx < last; idx += THREADS) {
    float v = cluster.map_shared_rank(part, 0)[idx];
    for (int r = 1; r < ks; ++r) v = __fadd_rn(v, cluster.map_shared_rank(part, r)[idx]);
    store(idx, v);
  }
  cluster.sync();  // no block's shared memory goes away while another reads it
}

template <int TT>
int launch_rows(const int8_t* xq, const float* sxs, const uint8_t* packed, const int8_t* sub_t,
                const int8_t* min_t, const float* dd_t, void* out, int out_bf16, int n, int k,
                int ct, int ks, cudaStream_t stream) {
  const int bytes = stage_layout(ct, TT * 8).bytes;
  int stages = STAGE_BUDGET / bytes;
  stages = stages < 2 ? 2 : (stages > MAX_STAGES ? MAX_STAGES : stages);
  const int smem = stages * bytes;  // also holds red and part at the end
  if (smem > SMEM_LIMIT || smem < (WARPS * RED_STRIDE + 2 * ct) * TT * 8 * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // above 48 KB dynamic shared memory needs opting in
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        q4k_matmul_rows_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, n / 2 / ct, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;  // the ks blocks of a channel tile form a cluster
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int cts = ct == 8 ? 3 : (ct == 16 ? 4 : (ct == 32 ? 5 : 6));
  const cudaError_t e = cudaLaunchKernelEx(&cfg, q4k_matmul_rows_kernel<TT>, xq, sxs, packed, sub_t,
                                           min_t, dd_t, out, out_bf16, n, k, cts, stages);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// x [t, k] (f32 or bf16) -> out [t, n]; scratch xq [t, k] int8 and sxs
// [k/32, t, 2] f32. ct is the block's channel pairs and ks the blocks that
// split K's chunks (ops/q4k.py, rows_tiling). t % 8 == 0, t <= 64,
// n % 512 == 0, k % 512 == 0, k <= 12288 (checked by the wrapper; refused
// here as an invalid value).
extern "C" int q4k_matmul_rows_launch(const void* x, int x_bf16, int8_t* xq, float* sxs,
                                      const uint8_t* packed, const int8_t* sub_t,
                                      const int8_t* min_t, const float* dd_t, void* out,
                                      int out_bf16, int t, int n, int k, int ct, int ks,
                                      cudaStream_t stream) {
  if (t <= 0 || t % 8 || t > 64 || n % 512 || k % 512 || k > MAX_K ||
      (ct != 8 && ct != 16 && ct != 32 && ct != 64) || (n / 2) % ct || ks < 1 || ks > 8 ||
      ks > k / KC)
    return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_mma_kernel<<<dim3(t, (k + QUANT_SPAN - 1) / QUANT_SPAN), THREADS, 0, stream>>>(
      x, x_bf16, t, k, xq, reinterpret_cast<float2*>(sxs));
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  switch (t / 8) {
    case 1: return launch_rows<1>(xq, sxs, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, ct, ks, stream);
    case 2: return launch_rows<2>(xq, sxs, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, ct, ks, stream);
    case 3: return launch_rows<3>(xq, sxs, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, ct, ks, stream);
    case 4: return launch_rows<4>(xq, sxs, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, ct, ks, stream);
    case 5: return launch_rows<5>(xq, sxs, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, ct, ks, stream);
    case 6: return launch_rows<6>(xq, sxs, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, ct, ks, stream);
    case 7: return launch_rows<7>(xq, sxs, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, ct, ks, stream);
    default: return launch_rows<8>(xq, sxs, packed, sub_t, min_t, dd_t, out, out_bf16, n, k, ct, ks, stream);
  }
}
