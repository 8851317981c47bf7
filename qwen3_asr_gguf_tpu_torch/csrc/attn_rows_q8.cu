// Batched-rows GQA decode attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rows_kernel` via `_rows_attn_call`
// (qwen3_asr_gguf_tpu/ops/pallas_attn.py, pallas_call at :215; the
// `gqa_rows_q8_attention` of the serving decode step). Same function as its
// plain version `decoder._gqa_attention_rows_q8` (ops/attn.py):
//   q [B, Hq, d] (bf16 or f32); k, v int8 [B, S, Hkv, d] with f32 scales
//   ks, vs [B, S, Hkv]; row i attends to its first `win` slots, slot <= poss[i]
//   score = (q . k_int8) * (ks * scale) with f32 products (the int8 -> q
//   dtype cast is exact), masked slots -1e30, f32 online softmax, PV with
//   p * vs rounded to q's dtype first, out = acc / max(l, 1e-30) in q's dtype.
// The cache is read in place with its strides (no [:, :win] copy), and
// `poss` is read on the device: the grid depends on B, Hkv and nothing else,
// so one launch configuration (and a captured CUDA graph) serves every
// position of a window.
//
// Bound: each row's live slots (slot <= poss[i]) read once: (poss[i] + 1) *
// Hkv * (2 d + 8) bytes per row and layer at ~4 flops per byte, so
// device-memory bandwidth bounds it; at the serving shapes (at most 34 MB)
// the time is a fixed part (cluster launch, barriers, merges) and then the
// instructions of the per-slot math: with the math taken out the copies
// alone stream at ~2.9 TB/s (`devtools/sweep_rows_cluster`, PERF.md).
// Design (kernel 4's, `attn_decode.cu`, with per-row positions and int8
// rows with per-slot scales): a thread block cluster of CLUSTER blocks
// (ops/attn.py `ROWS_CLUSTER`; 4 by a sweep of 2, 4 and 8 on the card) per
// (row, kv head), so the g = Hq/Hkv query heads of a kv head share every K/V
// byte and B * Hkv * CLUSTER blocks work on any window. The row's live slots are cut into SUB-slot sub-tiles and
// the sub-tiles split evenly over the cluster (block r takes
// [r * n / CLUSTER, (r + 1) * n / CLUSTER) of the n live ones), so a short
// row costs its blocks little; a block's WARPS warps take its sub-tiles
// round robin. Each warp streams its own sub-tiles (K and V rows, 16-byte
// copies, and their ks / vs scales, 4-byte copies) through a STAGES-deep
// ring of cp.async groups in shared memory and keeps its own online-softmax
// state (m, l, acc), so no block barrier stands between sub-tiles. Scores:
// 8 lanes per slot (4 slots per step), each lane dotting its 16-byte pieces
// of the int8 K row with q (f32 in shared memory, each 16-value piece padded
// by 4 floats so the 8 lanes of a slot hit distinct banks), three xor
// shuffles for the sum, then * (ks * scale). PV: lanes along d (lane l owns
// d / 32 neighbouring elements: one 4- or 8-byte load per V row), the
// sub-tile's p * vs, rounded to q's dtype, from the warp's shared row. The
// kernel is instantiated per group size g (1 .. 8) and head dim (128, 256),
// so a thread holds only its g heads' state. A block or warp with no live
// sub-tile leaves the empty state (m = -1e30, l = 0, acc = 0), which every
// merge weighs by exp(-1e30 - m) = 0 (slot 0 is live). At the end the warps'
// states are merged in warp order in shared memory; then every block of the
// cluster merges its share of the outputs over the blocks' states in rank
// order, reading them through distributed shared memory: one launch, no
// scratch in device memory, no atomics, a result that does not depend on
// timing. `gqa_rows_q8_attention_kernel_order` (ops/attn.py) repeats the
// split, the per-warp online softmax and the ordered merges with tensor ops.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TS = 256;      // windows are whole 256-slot tiles
constexpr int CLUSTER = 4;   // blocks per (row, kv head): ops/attn.py ROWS_CLUSTER
constexpr int WARPS = 8;     // warps of a block: ops/attn.py ROWS_WARPS
constexpr int SUB = 8;       // slots of a warp's sub-tile (two score steps of 4 slots)
constexpr int STAGES = 2;    // cp.async ring depth of each warp
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_G = 8;     // query heads per kv head
constexpr int QPAD = 4;      // floats after each 16-value piece of q in shared memory
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename QT>
__device__ __forceinline__ float to_f(QT v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename QT>
__device__ __forceinline__ float round_to(float v);  // a value in q's dtype, as f32
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename QT>
__device__ __forceinline__ QT from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four signed bytes of a word as f32, exactly, without the int-to-float
// conversion unit (an eighth of the FMA rate; all 256 values of a K and V
// row pass here): byte b + 128 is placed in the mantissa of 2^23 by one byte
// permute, then 2^23 + 128 is subtracted.
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // each byte b + 128, 0 .. 255
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)), 8388736.0f);
}

// One stage of a warp's ring: K rows [SUB][D] i8 | V rows [SUB][D] i8 |
// ks [SUB] f32 | vs [SUB] f32.
template <int D>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * SUB * D + 2 * SUB * 4;
}

// The rings, or (after the loop, in their place) the warps' states
// [warp][m MAX_G | l MAX_G | acc G*D].
template <int G, int D>
__host__ __device__ constexpr size_t front_bytes() {
  const size_t ring = static_cast<size_t>(WARPS) * STAGES * stage_bytes<D>();
  const size_t states = sizeof(float) * WARPS * (2 * MAX_G + G * D);
  return ring > states ? ring : states;
}

// Dynamic shared memory of one block: the front, q as padded f32, the warps'
// probability rows [SUB][MAX_G], and the block's merged state m[G] | l[G] |
// acc[G*D] (read by the cluster through distributed shared memory).
template <int G, int D>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  return front_bytes<G, D>() +
         sizeof(float) * (static_cast<size_t>(G) * (D / 16) * (16 + QPAD) + WARPS * SUB * MAX_G +
                          2 * G + G * D);
}

template <typename QT, int G, int D>
__global__ void __launch_bounds__(THREADS)
rows_q8_attn_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k,
                    const float* __restrict__ ks, const int8_t* __restrict__ v,
                    const float* __restrict__ vs, const int64_t* __restrict__ poss,
                    QT* __restrict__ out, int hkv, int s_max, int win, float scale) {
  constexpr int CH = D / 16;              // 16-byte pieces of a K or V row
  constexpr int EL = D / 32;              // PV outputs per lane and head
  constexpr int QROW = CH * (16 + QPAD);  // floats of one head's padded q
  constexpr int SB = stage_bytes<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // the cluster spans grid.x
  const int b = blockIdx.y / hkv, h = blockIdx.y - b * hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* ring = smem + static_cast<size_t>(warp) * STAGES * SB;
  float* q_s = reinterpret_cast<float*>(smem + front_bytes<G, D>());
  float* p_s = q_s + G * QROW + warp * SUB * MAX_G;  // this warp's p * vs [SUB][MAX_G]
  float* part = q_s + G * QROW + WARPS * SUB * MAX_G;  // the block's m[G] | l[G] | acc[G*D]

  // the block's share of the row's live sub-tiles
  const int64_t pos = poss[b];
  const int last = static_cast<int>(pos < win - 1 ? pos : win - 1);  // the last live slot
  const int n_sub = last >= 0 ? last / SUB + 1 : 0;
  const int sub0 = rank * n_sub / CLUSTER, sub1 = (rank + 1) * n_sub / CLUSTER;
  const int my_subs = warp < sub1 - sub0 ? (sub1 - sub0 - warp + WARPS - 1) / WARPS : 0;

  const size_t slot_stride = static_cast<size_t>(hkv) * D;  // bytes between slots
  const size_t row0 = static_cast<size_t>(b) * s_max;
  const int8_t* kb = k + row0 * slot_stride + static_cast<size_t>(h) * D;
  const int8_t* vb = v + row0 * slot_stride + static_cast<size_t>(h) * D;
  const float* ksb = ks + row0 * hkv + h;
  const float* vsb = vs + row0 * hkv + h;

  // the warp's i-th sub-tile (its live rows only) into stage i % STAGES, as
  // one committed group (an empty one past the warp's last sub-tile)
  auto issue = [&](int i) {
    if (i < my_subs) {
      const int s0 = (sub0 + warp + i * WARPS) * SUB;
      const int rows = min(SUB, last - s0 + 1);
      unsigned char* st = ring + (i % STAGES) * SB;
      for (int c = lane; c < rows * CH; c += 32) {
        const int r = c / CH, off = (c - r * CH) * 16;
        const size_t src = static_cast<size_t>(s0 + r) * slot_stride + off;
        mma::cp_async16(st + r * D + off, kb + src);
        mma::cp_async16(st + (SUB + r) * D + off, vb + src);
      }
      float* sc = reinterpret_cast<float*>(st + 2 * SUB * D);  // ks [SUB] | vs [SUB]
      if (lane < rows)
        mma::cp_async4(sc + lane, ksb + static_cast<size_t>(s0 + lane) * hkv);
      else if (lane >= SUB && lane - SUB < rows)
        mma::cp_async4(sc + lane, vsb + static_cast<size_t>(s0 + lane - SUB) * hkv);
    }
    mma::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES; ++i) issue(i);

  const int hq = hkv * G;
  const QT* qrow = q + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * G) * D;
  for (int e = tid; e < G * D; e += THREADS) {
    const int hh = e / D, j = e - hh * D;
    q_s[hh * QROW + (j >> 4) * (16 + QPAD) + (j & 15)] = to_f<QT>(qrow[e]);
  }
  __syncthreads();  // q_s

  const int sg = lane >> 3, pl = lane & 7;  // slot of a score step, lane within the slot
  float m[G], l[G], acc[G][EL];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    m[hh] = MASKED;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[hh][e] = 0.f;
  }

  for (int i = 0; i < my_subs; ++i) {
    mma::cp_async_wait_n<STAGES - 1>();  // sub-tile i has landed for this lane
    __syncwarp();                        // ... for every lane
    const unsigned char* st = ring + (i % STAGES) * SB;
    const float* sc = reinterpret_cast<const float*>(st + 2 * SUB * D);
    const int s0 = (sub0 + warp + i * WARPS) * SUB;
    const bool keep0 = s0 + sg <= last, keep1 = s0 + 4 + sg <= last;

    // scores of slots s0 + sg (step 0) and s0 + 4 + sg (step 1)
    float s[2][G];
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      const int r = step * 4 + sg;
      const int8_t* krow = reinterpret_cast<const int8_t*>(st) + r * D;
      float dot[G];
#pragma unroll
      for (int hh = 0; hh < G; ++hh) dot[hh] = 0.f;
#pragma unroll
      for (int pc = pl; pc < CH; pc += 8) {
        const uint4 w = *reinterpret_cast<const uint4*>(krow + pc * 16);
        float kf[16];
        i8x4(w.x, kf);
        i8x4(w.y, kf + 4);
        i8x4(w.z, kf + 8);
        i8x4(w.w, kf + 12);
#pragma unroll
        for (int hh = 0; hh < G; ++hh) {
          const float4* qh = reinterpret_cast<const float4*>(q_s + hh * QROW + pc * (16 + QPAD));
          float part_dot = 0.f;
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const float4 qv = qh[e4];
            part_dot = fmaf(qv.x, kf[4 * e4], part_dot);
            part_dot = fmaf(qv.y, kf[4 * e4 + 1], part_dot);
            part_dot = fmaf(qv.z, kf[4 * e4 + 2], part_dot);
            part_dot = fmaf(qv.w, kf[4 * e4 + 3], part_dot);
          }
          dot[hh] += part_dot;
        }
      }
      const bool keep = step ? keep1 : keep0;
      const float kscale = keep ? __fmul_rn(sc[r], scale) : 0.f;  // a dead slot's scale is not copied
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        float x = dot[hh];
        x += __shfl_xor_sync(FULL, x, 1);
        x += __shfl_xor_sync(FULL, x, 2);
        x += __shfl_xor_sync(FULL, x, 4);
        s[step][hh] = keep ? __fmul_rn(x, kscale) : MASKED;
      }
    }

    // online softmax over the sub-tile (its first slot is live)
    const float vs0 = keep0 ? sc[SUB + sg] : 0.f, vs1 = keep1 ? sc[SUB + 4 + sg] : 0.f;
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
      float ts = __fadd_rn(p0, p1);
      ts = __fadd_rn(ts, __shfl_xor_sync(FULL, ts, 8));
      ts = __fadd_rn(ts, __shfl_xor_sync(FULL, ts, 16));
      l[hh] = __fmaf_rn(l[hh], alpha, ts);
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[hh][e] = __fmul_rn(acc[hh][e], alpha);
      if (pl == 0) {
        p_s[sg * MAX_G + hh] = round_to<QT>(__fmul_rn(p0, vs0));
        p_s[(4 + sg) * MAX_G + hh] = round_to<QT>(__fmul_rn(p1, vs1));
      }
    }
    __syncwarp();

    // PV over the sub-tile's live rows: lane owns d elements EL * lane ..
    const int rows = min(SUB, last - s0 + 1);
    const int8_t* vt = reinterpret_cast<const int8_t*>(st) + SUB * D;
#pragma unroll
    for (int r = 0; r < SUB; ++r) {
      if (r < rows) {
        float vf[EL];
        if constexpr (EL == 4) {
          i8x4(*reinterpret_cast<const uint32_t*>(vt + r * D + 4 * lane), vf);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(vt + r * D + EL * lane);
          i8x4(w.x, vf);
          i8x4(w.y, vf + 4);
        }
#pragma unroll
        for (int hh = 0; hh < G; ++hh) {
          const float p = p_s[r * MAX_G + hh];
#pragma unroll
          for (int e = 0; e < EL; ++e) acc[hh][e] = __fmaf_rn(p, vf[e], acc[hh][e]);
        }
      }
    }
    __syncwarp();  // the stage and p_s are rewritten next
    issue(i + STAGES);
  }

  // the warps' states, in the ring's place: [warp][m MAX_G | l MAX_G | acc G*D]
  mma::cp_async_wait_n<0>();
  __syncthreads();
  constexpr int ST = 2 * MAX_G + G * D;
  float* st_w = reinterpret_cast<float*>(smem) + warp * ST;
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    if (lane == 0) {
      st_w[hh] = m[hh];
      st_w[MAX_G + hh] = l[hh];
    }
#pragma unroll
    for (int e = 0; e < EL; ++e) st_w[2 * MAX_G + hh * D + EL * lane + e] = acc[hh][e];
  }
  __syncthreads();
  // the block's state: the warps merged in warp order
  const float* st0 = reinterpret_cast<const float*>(smem);
  for (int e = tid; e < G * D; e += THREADS) {
    const int hh = e / D;
    float mb = MASKED;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, st0[w * ST + hh]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* sw = st0 + w * ST;
      const float wt = expf(sw[hh] - mb);
      lb = __fmaf_rn(sw[MAX_G + hh], wt, lb);
      ab = __fmaf_rn(sw[2 * MAX_G + e], wt, ab);
    }
    part[2 * G + e] = ab;
    if (e - hh * D == 0) {
      part[hh] = mb;
      part[G + hh] = lb;
    }
  }
  cluster.sync();
  // each block merges its share of the outputs over the blocks, in rank order
  constexpr int SHARE = (G * D + CLUSTER - 1) / CLUSTER;
  const int end = min(G * D, (rank + 1) * SHARE);
  QT* orow = out + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * G) * D;
  for (int e = rank * SHARE + tid; e < end; e += THREADS) {
    const int hh = e / D;
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
    orow[e] = from_f<QT>(o_all / fmaxf(l_all, 1e-30f));
  }
  cluster.sync();  // no block's shared memory goes away while another reads it
}

template <typename QT, int G, int D>
cudaError_t launch(const void* q, const int8_t* k, const float* ks, const int8_t* v,
                   const float* vs, const int64_t* poss, void* out, int b, int hkv, int s_max,
                   int win, float scale, cudaStream_t stream) {
  constexpr size_t smem = rows_smem_bytes<G, D>();
  static bool attrs_set = false;  // above 48 KB of dynamic shared memory
  if (!attrs_set) {
    const cudaError_t e = cudaFuncSetAttribute(rows_q8_attn_kernel<QT, G, D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attrs_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, b * hkv, 1);  // one cluster per (row, kv head)
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, rows_q8_attn_kernel<QT, G, D>, static_cast<const QT*>(q), k, ks, v, vs, poss,
      static_cast<QT*>(out), hkv, s_max, win, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename QT, int D>
cudaError_t launch_g(int g, const void* q, const int8_t* k, const float* ks, const int8_t* v,
                     const float* vs, const int64_t* poss, void* out, int b, int hkv, int s_max,
                     int win, float scale, cudaStream_t stream) {
#define Q3A_ROWS_G(G) \
  case G: return launch<QT, G, D>(q, k, ks, v, vs, poss, out, b, hkv, s_max, win, scale, stream);
  switch (g) {
    Q3A_ROWS_G(1) Q3A_ROWS_G(2) Q3A_ROWS_G(3) Q3A_ROWS_G(4)
    Q3A_ROWS_G(5) Q3A_ROWS_G(6) Q3A_ROWS_G(7) Q3A_ROWS_G(8)
    default: return cudaErrorInvalidValue;
  }
#undef Q3A_ROWS_G
}

template <typename QT>
cudaError_t launch_d(int d, int g, const void* q, const int8_t* k, const float* ks,
                     const int8_t* v, const float* vs, const int64_t* poss, void* out, int b,
                     int hkv, int s_max, int win, float scale, cudaStream_t stream) {
  if (d == 128)
    return launch_g<QT, 128>(g, q, k, ks, v, vs, poss, out, b, hkv, s_max, win, scale, stream);
  return launch_g<QT, 256>(g, q, k, ks, v, vs, poss, out, b, hkv, s_max, win, scale, stream);
}

}  // namespace

// q [b, hq, d] (bf16 or f32, q_bf16 says which) -> out [b, hq, d] in q's
// dtype; k, v int8 [b, s_max, hkv, d] (16-byte aligned), ks, vs f32
// [b, s_max, hkv], poss int64 [b] on the device. win % 256 == 0,
// win <= s_max, d in {128, 256}, hq / hkv <= 8 (checked by the wrapper;
// refused here as an invalid value).
extern "C" int gqa_rows_q8_attention_launch(const void* q, int q_bf16, const int8_t* k,
                                            const float* ks, const int8_t* v,
                                            const float* vs, const int64_t* poss, void* out,
                                            int b, int hq, int hkv, int d, int s_max, int win,
                                            float scale, cudaStream_t stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv || hq / hkv > MAX_G || (d != 128 && d != 256) ||
      win % TS || win < TS || win > s_max)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = hq / hkv;
  const cudaError_t e =
      q_bf16 ? launch_d<__nv_bfloat16>(d, g, q, k, ks, v, vs, poss, out, b, hkv, s_max, win,
                                       scale, stream)
             : launch_d<float>(d, g, q, k, ks, v, vs, poss, out, b, hkv, s_max, win, scale,
                               stream);
  return static_cast<int>(e);
}
