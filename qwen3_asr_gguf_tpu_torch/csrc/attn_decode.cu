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
//   online softmax; probs rounded to V's dtype before the PV dot;
//   out = acc / max(l, 1e-30), written in the caller's dtype.
// The cache is read in place (no [:win] copy, no mask tensor, no f32 copy).
// `pos` is read from a 1-element int32 tensor on the device, as the TPU
// kernel reads its scalar-prefetch `pos_ref`: the grid and the cluster
// depend on `win` and the heads alone, so one launch configuration (and a
// captured CUDA graph) serves every position of a window.
//
// Bound: the live part of the K/V window, read once: 2 * (pos + 1) * Hkv * d
// elements, at ~2 flops per byte, so device-memory bandwidth bounds it; at
// the decode shapes (at most 8 MB) the time is latency: how soon every SM
// has its bytes in flight, and how short each warp's chain of dependent
// steps is.
// Design: a thread block cluster of CLUSTER = 8 blocks (ops/attn.py
// `DECODE_CLUSTER`) per kv head, so the g = Hq/Hkv query heads of a kv head
// share every K/V byte and 8 * Hkv blocks work on any window. Block `rank`
// owns slots [rank * win / CLUSTER, ...); its 16 warps (8 for an f32 cache)
// take that range's 8-slot sub-tiles round robin. Each warp streams its own
// sub-tiles (K and V rows) through a 2-deep ring of cp.async groups in
// shared memory (both issued before the first is scored) and keeps its own
// online-softmax state (m, l, acc), so no block barrier stands between
// sub-tiles. Scores: 8 lanes per slot (4 slots per
// step), each lane dotting its 16-byte pieces of the K row with q (f32, from
// shared memory), three xor shuffles for the sum. PV: lanes along d (at d =
// 128 lane l owns elements 4l .. 4l + 3, one vector load per V row; at other
// d elements l, l + 32, ...), the sub-tile's probabilities from the warp's
// shared row. The kernel is instantiated per group size g (1, 2, 4, 8), so a
// thread holds only its g heads' state. Sub-tiles wholly past `pos` are not
// read; a block or warp with none leaves the empty state (m = -1e30, l = 0,
// acc = 0), which every merge weighs by exp(-1e30 - m) = 0 (slot 0 is always
// live, so the final max is a real score). At the end the warps' states are
// merged in warp order in shared memory; then every block of the cluster
// merges its share of the outputs over the blocks' states in rank order,
// reading them through distributed shared memory (all ranks' values loaded
// before the sums): one launch, no scratch in device memory, no atomics, a
// result that does not depend on timing.
// `gqa_decode_attention_kernel_order` (ops/attn.py) repeats the split, the
// per-warp online softmax and the ordered merges with tensor ops.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SUB = 8;      // slots per warp sub-tile: two score steps of 4 slots
constexpr int MAX_G = 8;    // query heads per kv head
constexpr int CLUSTER = 8;   // blocks per kv head (a portable cluster size)
constexpr int MAX_D = 128;
constexpr int MAX_EL = MAX_D / 32;  // outputs per lane and head in the PV (d elements lane + 32 e)
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// A 16-byte piece of a cache row as f32 values (8 bf16 or 4 f32).
__device__ __forceinline__ void unpack(const uint4 w, float (&f)[8], __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4 w, float (&f)[4], float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

// Warps of a block (16 for a bf16 cache, 8 for f32) and the cp.async ring
// depth of each warp: WARPS x STAGES x 8 slots of K and V rows fill 128 KB
// of shared memory at d = 128 in either dtype.
template <typename T>
constexpr int WARPS = sizeof(T) > 2 ? 8 : 16;
constexpr int STAGES = 2;

// The d element that lane `lane` holds in its e-th PV output: 4 neighbours
// at d = 128 (a vector load), else lane + 32 e.
__device__ __forceinline__ int pv_elem(int lane, int e, int d) {
  return d == MAX_D ? 4 * lane + e : lane + 32 * e;
}

// Four neighbouring elements of a V row in shared memory as f32.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[MAX_EL]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(w.x << 16);
  f[1] = __uint_as_float(w.x & 0xFFFF0000u);
  f[2] = __uint_as_float(w.y << 16);
  f[3] = __uint_as_float(w.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&f)[MAX_EL]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  f[0] = w.x, f[1] = w.y, f[2] = w.z, f[3] = w.w;
}

// Dynamic shared memory of one block: the warps' rings (reused for the warp
// states after the loop), q as f32, the warps' probability rows, and the
// block's merged state (read by the cluster through distributed shared
// memory).
template <typename T>
__host__ __device__ constexpr size_t ring_bytes(int d) {
  return static_cast<size_t>(WARPS<T>) * STAGES * SUB * 2 * d * sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t decode_smem_bytes(int g, int d) {
  return ring_bytes<T>(d) +
         sizeof(float) * (2 * static_cast<size_t>(g) * d + WARPS<T> * SUB * MAX_G + 2 * g);
}

template <typename T, typename OT, int G>
__global__ void __launch_bounds__(32 * WARPS<T>)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ pos_ptr, OT* __restrict__ out, int hkv, int d,
                   int win, float scale) {
  constexpr int P = 16 / sizeof(T);  // elements of a 16-byte piece
  constexpr int NS = STAGES;
  constexpr int W = WARPS<T>;
  constexpr int THREADS = 32 * W;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // the cluster spans grid.x
  const int h = blockIdx.y;
  const int gd = G * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int chunks = row_bytes / 16;  // 16-byte pieces of a row
  const int stage_bytes = SUB * 2 * row_bytes;  // K rows, then V rows
  unsigned char* ring = smem + static_cast<size_t>(warp) * NS * stage_bytes;
  float* q_s = reinterpret_cast<float*>(smem + ring_bytes<T>(d));
  float* p_s = q_s + gd + warp * SUB * MAX_G;  // this warp's probabilities [SUB][MAX_G]
  float* part = q_s + gd + W * SUB * MAX_G;  // the block's m[G] | l[G] | acc[G*d]

  const T* qrow = q + static_cast<size_t>(h) * gd;
  for (int e = tid; e < gd; e += THREADS) q_s[e] = to_f<T>(qrow[e]);

  const int last = min(*pos_ptr, win - 1);  // the last live slot
  const int per_block = win / CLUSTER;
  const int b0 = rank * per_block;
  const int n_live = max(0, min(per_block, last - b0 + 1));
  const int n_sub = (n_live + SUB - 1) / SUB;  // the block's live sub-tiles
  const int my_subs = warp < n_sub ? (n_sub - warp + W - 1) / W : 0;

  const size_t slot_stride = static_cast<size_t>(hkv) * row_bytes;  // bytes between slots
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k) + static_cast<size_t>(h) * row_bytes;
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) + static_cast<size_t>(h) * row_bytes;

  // the warp's i-th sub-tile (its live rows only) into stage i % NS, as one
  // committed group (an empty one past the warp's last sub-tile)
  auto issue = [&](int i) {
    if (i < my_subs) {
      const int s0 = b0 + (warp + i * W) * SUB;
      const int rows = min(SUB, last - s0 + 1);
      unsigned char* st = ring + (i % NS) * stage_bytes;
      for (int c = lane; c < rows * chunks; c += 32) {
        const int r = c / chunks, off = (c - r * chunks) * 16;
        const size_t src = static_cast<size_t>(s0 + r) * slot_stride + off;
        mma::cp_async16(st + r * row_bytes + off, kb + src);
        mma::cp_async16(st + (SUB + r) * row_bytes + off, vb + src);
      }
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS; ++i) issue(i);
  __syncthreads();  // q_s

  const int sg = lane >> 3, pl = lane & 7;  // slot of a score step, lane within the slot
  float m[G], l[G], acc[G][MAX_EL];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    m[hh] = MASKED;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < MAX_EL; ++e) acc[hh][e] = 0.f;
  }

  for (int i = 0; i < my_subs; ++i) {
    mma::cp_async_wait_n<NS - 1>();  // sub-tile i has landed for this lane
    __syncwarp();                    // ... for every lane
    const unsigned char* st = ring + (i % NS) * stage_bytes;
    const int s0 = b0 + (warp + i * W) * SUB;

    // scores of slots s0 + sg (step 0) and s0 + 4 + sg (step 1)
    float s[2][G];
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      const unsigned char* krow = st + (step * 4 + sg) * row_bytes;
      float dot[G];
#pragma unroll
      for (int hh = 0; hh < G; ++hh) dot[hh] = 0.f;
      for (int pc = pl; pc < chunks; pc += 8) {
        float kf[P];
        unpack(*reinterpret_cast<const uint4*>(krow + pc * 16), kf, T());
#pragma unroll
        for (int hh = 0; hh < G; ++hh) {
          const float4* qh = reinterpret_cast<const float4*>(q_s + hh * d + pc * P);
          float part_dot = 0.f;
#pragma unroll
          for (int e4 = 0; e4 < P / 4; ++e4) {
            const float4 qv = qh[e4];
            part_dot = fmaf(qv.x, kf[4 * e4], part_dot);
            part_dot = fmaf(qv.y, kf[4 * e4 + 1], part_dot);
            part_dot = fmaf(qv.z, kf[4 * e4 + 2], part_dot);
            part_dot = fmaf(qv.w, kf[4 * e4 + 3], part_dot);
          }
          dot[hh] += part_dot;
        }
      }
      const bool keep = s0 + step * 4 + sg <= last;
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        float x = dot[hh];
        x += __shfl_xor_sync(FULL, x, 1);
        x += __shfl_xor_sync(FULL, x, 2);
        x += __shfl_xor_sync(FULL, x, 4);
        s[step][hh] = keep ? x * scale : MASKED;
      }
    }

    // online softmax over the sub-tile (the sub-tile's first slot is live)
    const bool keep0 = s0 + sg <= last, keep1 = s0 + 4 + sg <= last;
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      float mx = fmaxf(s[0][hh], s[1][hh]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = expf(m[hh] - m_new);
      m[hh] = m_new;
      const float p0 = keep0 ? expf(s[0][hh] - m_new) : 0.f;
      const float p1 = keep1 ? expf(s[1][hh] - m_new) : 0.f;
      float ts = p0 + p1;
      ts += __shfl_xor_sync(FULL, ts, 8);
      ts += __shfl_xor_sync(FULL, ts, 16);
      l[hh] = l[hh] * alpha + ts;
#pragma unroll
      for (int e = 0; e < MAX_EL; ++e) acc[hh][e] *= alpha;
      if (pl == 0) {
        p_s[sg * MAX_G + hh] = round_to<T>(p0);
        p_s[(4 + sg) * MAX_G + hh] = round_to<T>(p1);
      }
    }
    __syncwarp();

    // PV over the sub-tile's live rows: lane owns d elements lane + 32 e
    const int rows = min(SUB, last - s0 + 1);
    const T* vt = reinterpret_cast<const T*>(st + SUB * row_bytes);
#pragma unroll
    for (int r = 0; r < SUB; ++r) {
      if (r < rows) {
        float vf[MAX_EL];
        if (d == MAX_D) {  // 4 neighbouring elements: one 8- or 16-byte load
          load4(vt + r * d + 4 * lane, vf);
        } else {
#pragma unroll
          for (int e = 0; e < MAX_EL; ++e)
            vf[e] = lane + 32 * e < d ? to_f<T>(vt[r * d + lane + 32 * e]) : 0.f;
        }
#pragma unroll
        for (int hh = 0; hh < G; ++hh) {
          const float p = p_s[r * MAX_G + hh];
#pragma unroll
          for (int e = 0; e < MAX_EL; ++e) acc[hh][e] = fmaf(p, vf[e], acc[hh][e]);
        }
      }
    }
    __syncwarp();  // the stage and p_s are rewritten next
    issue(i + NS);
  }

  // the warps' states, in the ring's place: [warp][m MAX_G | l MAX_G | acc G*d]
  mma::cp_async_wait_n<0>();
  __syncthreads();
  const int st_stride = 2 * MAX_G + gd;
  float* st_w = reinterpret_cast<float*>(smem) + warp * st_stride;
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    if (lane == 0) {
      st_w[hh] = m[hh];
      st_w[MAX_G + hh] = l[hh];
    }
#pragma unroll
    for (int e = 0; e < MAX_EL; ++e)
      if (lane + 32 * e < d) st_w[2 * MAX_G + hh * d + pv_elem(lane, e, d)] = acc[hh][e];
  }
  __syncthreads();
  // the block's state: the warps merged in warp order
  const float* st0 = reinterpret_cast<const float*>(smem);
  for (int e = tid; e < gd; e += THREADS) {
    const int hh = e / d;
    float mb = MASKED;
#pragma unroll
    for (int w = 0; w < W; ++w) mb = fmaxf(mb, st0[w * st_stride + hh]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* sw = st0 + w * st_stride;
      const float wt = expf(sw[hh] - mb);
      lb = __fmaf_rn(sw[MAX_G + hh], wt, lb);
      ab = __fmaf_rn(sw[2 * MAX_G + e], wt, ab);
    }
    part[2 * G + e] = ab;
    if (e - hh * d == 0) {
      part[hh] = mb;
      part[G + hh] = lb;
    }
  }
  cluster.sync();
  // each block merges its share of the outputs over the blocks, in rank order
  const int share = (gd + CLUSTER - 1) / CLUSTER;
  const int end = min(gd, (rank + 1) * share);
  OT* orow = out + static_cast<size_t>(h) * gd;
  for (int e = rank * share + tid; e < end; e += THREADS) {
    const int hh = e / d;
    float mr[CLUSTER], lr[CLUSTER], ar[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const float* theirs = cluster.map_shared_rank(part, r);
      mr[r] = theirs[hh];
      lr[r] = theirs[G + hh];
      ar[r] = theirs[2 * G + e];
    }
    float m_all = MASKED;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) m_all = fmaxf(m_all, mr[r]);
    float l_all = 0.f, o_all = 0.f;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const float wt = expf(mr[r] - m_all);
      l_all = __fmaf_rn(lr[r], wt, l_all);
      o_all = __fmaf_rn(ar[r], wt, o_all);
    }
    orow[e] = from_f<OT>(o_all / fmaxf(l_all, 1e-30f));
  }
  cluster.sync();  // no block's shared memory goes away while another reads it
}

template <typename T, typename OT, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, void* out,
                   int hkv, int d, int win, float scale, cudaStream_t stream) {
  static bool attrs_set = false;  // above 48 KB of dynamic shared memory
  if (!attrs_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T, OT, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(decode_smem_bytes<T>(MAX_G, MAX_D)));
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, hkv, 1);  // one cluster per kv head
  cfg.blockDim = dim3(32 * WARPS<T>, 1, 1);
  cfg.dynamicSmemBytes = decode_smem_bytes<T>(G, d);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attn_kernel<T, OT, G>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<OT*>(out), hkv, d, win, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, typename OT>
cudaError_t launch_g(int g, const void* q, const void* k, const void* v, const int* pos,
                     void* out, int hkv, int d, int win, float scale, cudaStream_t stream) {
  switch (g) {
    case 1: return launch<T, OT, 1>(q, k, v, pos, out, hkv, d, win, scale, stream);
    case 2: return launch<T, OT, 2>(q, k, v, pos, out, hkv, d, win, scale, stream);
    case 4: return launch<T, OT, 4>(q, k, v, pos, out, hkv, d, win, scale, stream);
    case 8: return launch<T, OT, 8>(q, k, v, pos, out, hkv, d, win, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [hq, d] in the cache's dtype (kv_bf16 says which: bf16 or f32); k, v
// [s_max, hkv, d]; pos a 1-element int32 device tensor (the last valid
// slot); out [hq, d] bf16 or f32 (out_bf16). win % 256 == 0, win <= s_max,
// d % 8 == 0, d <= 128, hq / hkv in {1, 2, 4, 8} (checked by the wrapper;
// refused here as an invalid value).
extern "C" int gqa_decode_attention_launch(const void* q, const void* k, const void* v,
                                           int kv_bf16, const int* pos, void* out,
                                           int out_bf16, int hq, int hkv, int d, int s_max,
                                           int win, float scale, cudaStream_t stream) {
  if (hkv <= 0 || hq % hkv || d % 8 || d <= 0 || d > MAX_D || win % 256 || win < 256 ||
      win > s_max)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = hq / hkv;
  cudaError_t e;
  if (kv_bf16)
    e = out_bf16 ? launch_g<__nv_bfloat16, __nv_bfloat16>(g, q, k, v, pos, out, hkv, d, win, scale, stream)
                 : launch_g<__nv_bfloat16, float>(g, q, k, v, pos, out, hkv, d, win, scale, stream);
  else
    e = out_bf16 ? launch_g<float, __nv_bfloat16>(g, q, k, v, pos, out, hkv, d, win, scale, stream)
                 : launch_g<float, float>(g, q, k, v, pos, out, hkv, d, win, scale, stream);
  return static_cast<int>(e);
}
