// Single-token GQA decode attention over a bf16 or f32 KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` via `_attn_call`
// (qwen3_asr_gguf_tpu/ops/pallas_attn.py, pallas_call at :94; the
// `gqa_decode_attention` of the single-stream decode step). Same function as
// its plain version `gqa_decode_attention_ref` (ops/attn.py):
//   q [Hq, d] already in the cache's dtype; k, v [S, Hkv, d]; the query
//   attends to the first `win` slots, slot <= pos
//   score = (q . k) summed in f32, then * scale; masked slots -1e30; f32
//   online softmax over 256-slot tiles; probs rounded to V's dtype before the
//   PV dot; out = acc / max(l, 1e-30), written in the caller's dtype.
// The cache is read in place (no [:win] copy, no mask tensor, no f32 copy).
//
// The TPU kernel scores all (query head, kv head) pairs in one matrix-unit
// product and masks with a one-hot head selection, because its compiler has
// no batched product; here each block simply reads its own kv head.
//
// Bound: the live part of the K/V window, read once: 2 * (pos + 1) * Hkv * d
// elements, at ~2 flops per byte, so device-memory bandwidth bounds it.
// Design: a thread block cluster per kv head, so the g = Hq/Hkv query heads
// of a kv head share every K/V byte. The live 256-slot tiles (those up to the
// tile holding `pos`; later tiles have weights of exactly 0) are dealt round
// robin to the cluster's blocks, at most 8 of them, where the TPU walks them
// on a sequential grid axis. Per tile, all threads copy the tile's K and V
// rows into shared memory with 16-byte asynchronous copies (cp.async), all in
// flight at once; thread t then scores slot t from shared memory (K rows
// padded by 16 bytes, so the 8 threads of a load phase hit distinct banks),
// the block reduces each head's tile max and sum, and each thread owns (head,
// dim) outputs and walks the tile's V column in shared memory. An f32 cache
// stages V into the K buffer after the scores (two f32 tiles do not fit in
// shared memory together). Each block leaves its running (max, sum, acc) in
// its shared memory; after a cluster barrier block 0 reads the others' through
// distributed shared memory and merges them by the same online-softmax rule,
// so one launch does the whole window with no scratch in device memory.
// Known weakness, for a later change: at most 8 * Hkv blocks (64 at the 1.7B
// shape) on 132 SMs, and a tile's copy does not overlap another tile's math
// within a block.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TS = 256;  // slots per tile, = threads per block
constexpr int WARPS = TS / 32;
constexpr int MAX_G = 8;  // query heads per kv head
constexpr int MAX_D = 128;
constexpr int MAX_E = MAX_G * MAX_D / TS;  // (head, dim) outputs per thread
constexpr int KPAD = 16;  // bytes of padding after each staged K row
constexpr int MAX_CLUSTER = 8;  // blocks of one kv head (the portable cluster size)
constexpr float MASKED = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);  // a value in T, as f32
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Block-wide max (is_max) or sum of one value per head; every thread gets
// the results. `red` holds MAX_G * WARPS floats.
__device__ __forceinline__ void block_reduce(float (&val)[MAX_G], int g, bool is_max,
                                             float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int hh = 0; hh < MAX_G; ++hh) {
    if (hh >= g) break;
    float x = val[hh];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = is_max ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) red[hh * WARPS + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < MAX_G; ++hh) {
    if (hh >= g) break;
    float x = red[hh * WARPS];
    for (int w = 1; w < WARPS; ++w) x = is_max ? fmaxf(x, red[hh * WARPS + w]) : x + red[hh * WARPS + w];
    val[hh] = x;
  }
  __syncthreads();  // `red` is reused by the next reduction
}

// An f32 cache stages V where K was; a bf16 cache holds both tiles at once.
template <typename T>
constexpr bool SHARES_TILE = sizeof(T) > 2;

// Dynamic shared memory of one block: K tile (rows padded), V tile (unless it
// shares K's), q, p, and the reduction scratch.
template <typename T>
__host__ __device__ constexpr size_t decode_smem_bytes(int g, int d) {
  return static_cast<size_t>(TS) * (d * sizeof(T) + KPAD) +
         (SHARES_TILE<T> ? 0 : static_cast<size_t>(TS) * d * sizeof(T)) +
         sizeof(float) * (static_cast<size_t>(g) * d + static_cast<size_t>(g) * TS + MAX_G * WARPS);
}

// Start the asynchronous copy of `n_slots` rows of `row_bytes` each (a
// multiple of 16) from the cache (rows `src_stride` bytes apart) into shared
// memory (rows `dst_stride` apart), as one committed cp.async group.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_stride,
                                           const unsigned char* src, size_t src_stride,
                                           int n_slots, int row_bytes) {
  const int chunks = row_bytes / 16;
  for (int i = threadIdx.x; i < n_slots * chunks; i += TS) {
    const int sl = i / chunks, c = (i % chunks) * 16;
    __pipeline_memcpy_async(dst + sl * dst_stride + c, src + sl * src_stride + c, 16);
  }
  __pipeline_commit();
}

template <typename T, typename OT>
__global__ void __launch_bounds__(TS)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   OT* __restrict__ out, int hq, int hkv, int d, int pos, int win,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // the cluster spans grid.x
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int tid = threadIdx.x;
  const int gd = g * d;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int krow = row_bytes + KPAD;  // bytes per staged K row
  unsigned char* k_t = smem;
  unsigned char* v_t = SHARES_TILE<T> ? k_t : k_t + static_cast<size_t>(TS) * krow;
  const int vrow = SHARES_TILE<T> ? krow : row_bytes;
  float* q_s = reinterpret_cast<float*>(
      smem + static_cast<size_t>(TS) * krow +
      (SHARES_TILE<T> ? 0 : static_cast<size_t>(TS) * row_bytes));
  float* p_s = q_s + gd;  // p in V's dtype: [g][TS]; at the end this block's (m, l, acc)
  float* red = p_s + g * TS;

  const T* qrow = q + static_cast<size_t>(h) * gd;
  for (int e = tid; e < gd; e += TS) q_s[e] = to_f<T>(qrow[e]);

  const int last_slot = pos < win - 1 ? pos : win - 1;
  const int n_tiles = last_slot / TS + 1;
  const size_t slot_stride = static_cast<size_t>(hkv) * row_bytes;  // bytes between slots
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k) + static_cast<size_t>(h) * row_bytes;
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) + static_cast<size_t>(h) * row_bytes;
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte piece

  float m[MAX_G], l[MAX_G], acc[MAX_E];
#pragma unroll
  for (int hh = 0; hh < MAX_G; ++hh) {
    m[hh] = MASKED;
    l[hh] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < MAX_E; ++i) acc[i] = 0.f;

  for (int tile = rank; tile < n_tiles; tile += n_blocks) {
    const int base = tile * TS;
    const int n_slots = last_slot - base + 1 < TS ? last_slot - base + 1 : TS;
    // stage the tile's rows (slots past last_slot are never read)
    stage_rows(k_t, krow, kb + base * slot_stride, slot_stride, n_slots, row_bytes);
    if (!SHARES_TILE<T>) {
      stage_rows(v_t, vrow, vb + base * slot_stride, slot_stride, n_slots, row_bytes);
      __pipeline_wait_prior(1);  // K has landed; V may still be in flight
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    // scores: thread tid owns slot base + tid
    const bool keep = tid < n_slots;
    float s_own[MAX_G], t_red[MAX_G];
#pragma unroll
    for (int hh = 0; hh < MAX_G; ++hh) s_own[hh] = 0.f;
    if (keep) {
      const unsigned char* kr = k_t + tid * krow;
      for (int c = 0; c < d; c += PER) {
        const uint4 w = *reinterpret_cast<const uint4*>(kr + c * sizeof(T));
        const T* kv = reinterpret_cast<const T*>(&w);
        float kf[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e) kf[e] = to_f<T>(kv[e]);
#pragma unroll
        for (int hh = 0; hh < MAX_G; ++hh) {
          if (hh >= g) break;
          const float* qh = q_s + hh * d + c;
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < PER; ++e) part += qh[e] * kf[e];
          s_own[hh] += part;
        }
      }
#pragma unroll
      for (int hh = 0; hh < MAX_G; ++hh) s_own[hh] *= scale;
    }
#pragma unroll
    for (int hh = 0; hh < MAX_G; ++hh) {
      if (!keep || hh >= g) s_own[hh] = MASKED;
      t_red[hh] = s_own[hh];
    }

    // online softmax over this tile
    block_reduce(t_red, g, true, red);  // ends in a barrier: K is consumed
    if (SHARES_TILE<T>) stage_rows(v_t, vrow, vb + base * slot_stride, slot_stride, n_slots, row_bytes);
    float alpha[MAX_G];
#pragma unroll
    for (int hh = 0; hh < MAX_G; ++hh) {
      const float m_new = fmaxf(m[hh], t_red[hh]);
      alpha[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
      s_own[hh] = keep ? expf(s_own[hh] - m_new) : 0.f;  // p
      t_red[hh] = s_own[hh];
    }
    block_reduce(t_red, g, false, red);
#pragma unroll
    for (int hh = 0; hh < MAX_G; ++hh) {
      if (hh >= g) break;
      l[hh] = l[hh] * alpha[hh] + t_red[hh];
      p_s[hh * TS + tid] = round_to<T>(s_own[hh]);
    }
    __pipeline_wait_prior(0);  // V has landed
    __syncthreads();

    // PV: thread owns outputs e = tid + i*TS, (head, dim) = (e / d, e % d)
#pragma unroll
    for (int i = 0; i < MAX_E; ++i) {
      const int e = tid + i * TS;
      if (e >= gd) break;
      const int hh = e / d, j = e % d;
      const float* pf = p_s + hh * TS;
      const unsigned char* vcol = v_t + j * sizeof(T);
      float pv = 0.f;
#pragma unroll 8
      for (int t = 0; t < n_slots; ++t)
        pv += pf[t] * to_f<T>(*reinterpret_cast<const T*>(vcol + t * vrow));
      acc[i] = acc[i] * alpha[hh] + pv;
    }
    __syncthreads();  // the tiles and p_s are rewritten next
  }

  // this block's running state, where the cluster can read it: m[g], l[g], acc[g*d]
  // (every block has at least one tile with a live slot, so its m is a real score)
  float* part = p_s;
#pragma unroll
  for (int hh = 0; hh < MAX_G; ++hh) {
    if (hh < g && tid == hh) {
      part[hh] = m[hh];
      part[g + hh] = l[hh];
    }
  }
#pragma unroll
  for (int i = 0; i < MAX_E; ++i) {
    const int e = tid + i * TS;
    if (e >= gd) break;
    part[2 * g + e] = acc[i];
  }
  cluster.sync();
  if (rank == 0) {
    OT* orow = out + static_cast<size_t>(h) * gd;
#pragma unroll
    for (int i = 0; i < MAX_E; ++i) {
      const int e = tid + i * TS;
      if (e >= gd) break;
      const int hh = e / d;
      float m_all = MASKED;
      for (int r = 0; r < n_blocks; ++r)
        m_all = fmaxf(m_all, cluster.map_shared_rank(part, r)[hh]);
      float l_all = 0.f, o_all = 0.f;
      for (int r = 0; r < n_blocks; ++r) {
        const float* theirs = cluster.map_shared_rank(part, r);
        const float w = expf(theirs[hh] - m_all);
        l_all += theirs[g + hh] * w;
        o_all += theirs[2 * g + e] * w;
      }
      orow[e] = from_f<OT>(o_all / fmaxf(l_all, 1e-30f));
    }
  }
  cluster.sync();  // no block's shared memory goes away while block 0 reads it
}

template <typename T, typename OT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int hq, int hkv,
                   int d, int pos, int win, float scale, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB dynamic shared memory needs opting in
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(decode_smem_bytes<T>(MAX_G, MAX_D)));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  // one cluster per kv head, one block per live tile up to the portable cluster size
  const int n_tiles = (pos < win - 1 ? pos : win - 1) / TS + 1;
  const unsigned n_blocks = n_tiles < MAX_CLUSTER ? n_tiles : MAX_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks, hkv, 1);
  cfg.blockDim = dim3(TS, 1, 1);
  cfg.dynamicSmemBytes = decode_smem_bytes<T>(hq / hkv, d);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attn_kernel<T, OT>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<OT*>(out), hq, hkv, d, pos, win, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// q [hq, d] in the cache's dtype (kv_bf16 says which: bf16 or f32); k, v
// [s_max, hkv, d]; out [hq, d] bf16 or f32 (out_bf16). 0 <= pos; win % 256 ==
// 0, win <= s_max, d % 8 == 0, d <= 128, hq / hkv <= 8 (checked by the
// wrapper; refused here as an invalid value).
extern "C" int gqa_decode_attention_launch(const void* q, const void* k, const void* v,
                                           int kv_bf16, void* out, int out_bf16, int hq,
                                           int hkv, int d, int s_max, int pos, int win,
                                           float scale, cudaStream_t stream) {
  if (hkv <= 0 || hq % hkv || hq / hkv > MAX_G || d % 8 || d <= 0 || d > MAX_D || pos < 0 ||
      win % TS || win < TS || win > s_max)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (kv_bf16)
    e = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, hq, hkv, d, pos, win, scale, stream)
                 : launch<__nv_bfloat16, float>(q, k, v, out, hq, hkv, d, pos, win, scale, stream);
  else
    e = out_bf16 ? launch<float, __nv_bfloat16>(q, k, v, out, hq, hkv, d, pos, win, scale, stream)
                 : launch<float, float>(q, k, v, out, hq, hkv, d, pos, win, scale, stream);
  return static_cast<int>(e);
}
