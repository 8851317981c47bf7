// Batched-rows GQA decode attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rows_kernel` via `_rows_attn_call`
// (qwen3_asr_gguf_tpu/ops/pallas_attn.py, pallas_call at :215; the
// `gqa_rows_q8_attention` of the serving decode step). Same function as its
// plain version `decoder._gqa_attention_rows_q8` (ops/attn.py):
//   q [B, Hq, d] (bf16 or f32); k, v int8 [B, S, Hkv, d] with f32 scales
//   ks, vs [B, S, Hkv]; row i attends to its first `win` slots, slot <= poss[i]
//   score = (q . k_int8) * (ks * scale), masked slots -1e30, f32 online
//   softmax over 256-slot tiles, PV with p * vs rounded to q's dtype first,
//   out = acc / max(l, 1e-30) in q's dtype.
// The cache is read in place with its strides (no [:, :win] copy).
//
// Bound: the KV window, read once: B * win * Hkv * (2 d + 8) bytes per layer
// at ~4 flops per byte, so device-memory bandwidth bounds it. Design: one
// block per (row, kv head), so the g = Hq/Hkv query heads of a kv head share
// every K/V byte; a loop over the 256-slot tiles replaces the TPU's
// sequential grid axis and stops at the tile holding poss[i] (later tiles
// have weights of exactly 0). Per tile, all threads first copy the tile's
// K and V rows into shared memory with 16-byte loads (8 threads on each
// 128-byte row, every load in flight at once); thread t then scores slot t
// from shared memory (K rows padded by 16 bytes, so the 8 threads of a
// load phase hit distinct banks), the block reduces each head's tile max
// and sum, and each thread owns (head, dim) outputs and walks the tile's V
// column in shared memory.
// Known weakness, for a later change: B * Hkv blocks (64 at the 1.7B
// serving shape) leave half the SMs idle, and a tile's copy does not
// overlap the previous tile's math; splitting the window over blocks
// (flash-decoding) with a combining pass, and cp.async double buffering,
// would fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 256;  // slots per tile, = threads per block
constexpr int WARPS = TS / 32;
constexpr int MAX_G = 8;  // query heads per kv head
constexpr int MAX_D = 256;
constexpr int MAX_E = MAX_G * MAX_D / TS;  // (head, dim) outputs per thread
constexpr int KPAD = 16;  // bytes of padding after each staged K row
constexpr float MASKED = -1e30f;

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

// Dynamic shared memory of one block: K tile (rows padded), V tile, q, p,
// and the reduction scratch.
__host__ __device__ constexpr size_t attn_smem_bytes(int g, int d) {
  return static_cast<size_t>(TS) * (d + KPAD) + static_cast<size_t>(TS) * d +
         sizeof(float) * (static_cast<size_t>(g) * d + static_cast<size_t>(g) * TS + MAX_G * WARPS);
}

template <typename QT>
__global__ void __launch_bounds__(TS)
rows_q8_attn_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k,
                    const float* __restrict__ ks, const int8_t* __restrict__ v,
                    const float* __restrict__ vs, const int64_t* __restrict__ poss,
                    QT* __restrict__ out, int hq, int hkv, int d, int s_max, int win,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int g = hq / hkv;
  const int tid = threadIdx.x;
  const int gd = g * d;
  const int krow = d + KPAD;  // bytes per staged K row
  int8_t* k_t = reinterpret_cast<int8_t*>(smem);
  int8_t* v_t = k_t + static_cast<size_t>(TS) * krow;
  float* q_s = reinterpret_cast<float*>(v_t + static_cast<size_t>(TS) * d);
  float* p_s = q_s + gd;  // scores, then p * vs in q's dtype: [g][TS]
  float* red = p_s + g * TS;

  const QT* qrow = q + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g) * d;
  for (int e = tid; e < gd; e += TS) q_s[e] = to_f<QT>(qrow[e]);

  const int64_t pos = poss[b];
  const int64_t last_slot = pos < win - 1 ? pos : win - 1;
  const int n_tiles = static_cast<int>(last_slot / TS) + 1;
  const size_t slot_stride = static_cast<size_t>(hkv) * d;  // bytes between slots
  const int8_t* kb = k + static_cast<size_t>(b) * s_max * slot_stride + static_cast<size_t>(h) * d;
  const int8_t* vb = v + static_cast<size_t>(b) * s_max * slot_stride + static_cast<size_t>(h) * d;
  const float* ksb = ks + static_cast<size_t>(b) * s_max * hkv + h;
  const float* vsb = vs + static_cast<size_t>(b) * s_max * hkv + h;
  const int chunks = d / 16;  // 16-byte pieces of a row

  float m[MAX_G], l[MAX_G], acc[MAX_E];
#pragma unroll
  for (int hh = 0; hh < MAX_G; ++hh) {
    m[hh] = MASKED;
    l[hh] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < MAX_E; ++i) acc[i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int base = tile * TS;
    const int n_slots = static_cast<int>(last_slot - base + 1) < TS
                            ? static_cast<int>(last_slot - base + 1) : TS;
    // stage the tile's K and V rows (slots past last_slot are never read)
    for (int i = tid; i < n_slots * chunks; i += TS) {
      const int sl = i / chunks, c = (i % chunks) * 16;
      const size_t src = static_cast<size_t>(base + sl) * slot_stride + c;
      *reinterpret_cast<uint4*>(k_t + sl * krow + c) = __ldg(reinterpret_cast<const uint4*>(kb + src));
      *reinterpret_cast<uint4*>(v_t + sl * d + c) = __ldg(reinterpret_cast<const uint4*>(vb + src));
    }
    __syncthreads();

    // scores: thread tid owns slot base + tid
    const bool keep = tid < n_slots;
    float s_own[MAX_G], t_red[MAX_G];
#pragma unroll
    for (int hh = 0; hh < MAX_G; ++hh) s_own[hh] = 0.f;
    if (keep) {
      const int8_t* kr = k_t + tid * krow;
      for (int c = 0; c < d; c += 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(kr + c);
        const int8_t* kv = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int hh = 0; hh < MAX_G; ++hh) {
          if (hh >= g) break;
          const float* qh = q_s + hh * d + c;
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < 16; ++e) part += qh[e] * static_cast<float>(kv[e]);
          s_own[hh] += part;
        }
      }
      const float kscale = ksb[static_cast<size_t>(base + tid) * hkv] * scale;
#pragma unroll
      for (int hh = 0; hh < MAX_G; ++hh) s_own[hh] *= kscale;
    }
#pragma unroll
    for (int hh = 0; hh < MAX_G; ++hh) {
      if (!keep || hh >= g) s_own[hh] = MASKED;
      t_red[hh] = s_own[hh];
    }

    // online softmax over this tile
    block_reduce(t_red, g, true, red);
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
    const float vscale = keep ? vsb[static_cast<size_t>(base + tid) * hkv] : 0.f;
#pragma unroll
    for (int hh = 0; hh < MAX_G; ++hh) {
      if (hh >= g) break;
      l[hh] = l[hh] * alpha[hh] + t_red[hh];
      p_s[hh * TS + tid] = round_to<QT>(s_own[hh] * vscale);
    }
    __syncthreads();

    // PV: thread owns outputs e = tid + i*TS, (head, dim) = (e / d, e % d)
#pragma unroll
    for (int i = 0; i < MAX_E; ++i) {
      const int e = tid + i * TS;
      if (e >= gd) break;
      const int hh = e / d, j = e % d;
      const float* pf = p_s + hh * TS;
      const int8_t* vcol = v_t + j;
      float pv = 0.f;
#pragma unroll 8
      for (int t = 0; t < n_slots; ++t) pv += pf[t] * static_cast<float>(vcol[t * d]);
      acc[i] = acc[i] * alpha[hh] + pv;
    }
    __syncthreads();  // the tiles and p_s are rewritten next
  }

  QT* orow = out + (static_cast<size_t>(b) * hq + static_cast<size_t>(h) * g) * d;
#pragma unroll
  for (int i = 0; i < MAX_E; ++i) {
    const int e = tid + i * TS;
    if (e >= gd) break;
    orow[e] = from_f<QT>(acc[i] / fmaxf(l[e / d], 1e-30f));
  }
}

}  // namespace

// q [b, hq, d] (bf16 or f32, q_bf16 says which) -> out [b, hq, d] in q's
// dtype; k, v int8 [b, s_max, hkv, d], ks, vs f32 [b, s_max, hkv], poss int64
// [b]. win % 256 == 0, win <= s_max, d % 128 == 0, d <= 256, hq / hkv <= 8
// (checked by the wrapper; refused here as an invalid value).
extern "C" int gqa_rows_q8_attention_launch(const void* q, int q_bf16, const int8_t* k,
                                            const float* ks, const int8_t* v,
                                            const float* vs, const int64_t* poss, void* out,
                                            int b, int hq, int hkv, int d, int s_max, int win,
                                            float scale, cudaStream_t stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv || hq / hkv > MAX_G || d % 128 || d > MAX_D ||
      win % TS || win < TS || win > s_max)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;  // above 48 KB dynamic shared memory needs opting in
  if (!smem_set) {
    const int most = static_cast<int>(attn_smem_bytes(MAX_G, MAX_D));
    cudaError_t e = cudaFuncSetAttribute(rows_q8_attn_kernel<__nv_bfloat16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rows_q8_attn_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int grid = b * hkv;
  const size_t smem = attn_smem_bytes(hq / hkv, d);
  if (q_bf16)
    rows_q8_attn_kernel<__nv_bfloat16><<<grid, TS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), k, ks, v, vs, poss,
        static_cast<__nv_bfloat16*>(out), hq, hkv, d, s_max, win, scale);
  else
    rows_q8_attn_kernel<float><<<grid, TS, smem, stream>>>(
        static_cast<const float*>(q), k, ks, v, vs, poss, static_cast<float*>(out), hq, hkv,
        d, s_max, win, scale);
  return static_cast<int>(cudaGetLastError());
}
