"""Batched-rows int8-KV decode attention (counterpart of the rows section of
`qwen3_asr_gguf_tpu/ops/pallas_attn.py`): the wrapper of the CUDA kernel in
`csrc/attn_rows_q8.cu`, its gate and its plain PyTorch version.

The serving decode step (`decoder.forward_step_rows`) attends every row's
query over its own int8 cache row, with the f32 per-(slot, head) scales
folded into the dots. The kernel reads the FULL caches with their strides
and stops at each row's last valid slot; the plain version is
`decoder._gqa_attention_rows_q8` on the `[:, :win]` window.

A wrapper runs its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

TS = 256  # KV slots per tile; windows are 256-slot buckets
MAX_GROUP = 8  # query heads per kv head the kernel takes
MAX_HEAD_DIM = 256


def rows_q8_supported(q_shape: tuple[int, ...], hkv: int, win: int) -> bool:
    """[B, Hq, d] queries, a TS-aligned window, a lane-exact head_dim (the
    conditions of pallas_attn.rows_q8_supported)."""
    if len(q_shape) != 3:
        return False
    b, hq, d = q_shape
    return win % TS == 0 and win >= TS and d % 128 == 0 and hq % hkv == 0 and b >= 1


def gqa_rows_q8_attention_ref(q, k_full, ks_full, v_full, vs_full, poss, scale: float,
                              win: int) -> torch.Tensor:
    """Plain version of `gqa_rows_q8_attention`: the decoder's int8 rows
    attention on the first `win` slots, slot <= poss[i]."""
    from ..models.decoder import _gqa_attention_rows_q8

    mask = torch.arange(win, device=q.device)[None, :] <= poss[:, None]
    return _gqa_attention_rows_q8(q, k_full[:, :win], ks_full[:, :win], v_full[:, :win],
                                  vs_full[:, :win], mask, scale)


def _check_cuda_args(q, k_full, ks_full, v_full, vs_full, poss, win: int) -> None:
    what = "gqa_rows_q8_attention"
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: q must be bf16 or f32, got {q.dtype}")
    if q.ndim != 3 or k_full.ndim != 4:
        raise ValueError(f"{what}: q must be [B, Hq, d] and k [B, S, Hkv, d]")
    b, hq, d = q.shape
    _, s_max, hkv, _ = k_full.shape
    if not rows_q8_supported(tuple(q.shape), hkv, win) or win > s_max \
            or hq // hkv > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, "
                         f"cache {tuple(k_full.shape)}, win {win}")
    for name, t, dt, shape in (
        ("k", k_full, torch.int8, (b, s_max, hkv, d)),
        ("v", v_full, torch.int8, (b, s_max, hkv, d)),
        ("k_s", ks_full, torch.float32, (b, s_max, hkv)),
        ("v_s", vs_full, torch.float32, (b, s_max, hkv)),
        ("poss", poss, torch.int64, (b,)),
    ):
        if t.device != q.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dt} {shape} on {q.device}")
    if not q.is_contiguous():
        raise ValueError(f"{what}: q must be contiguous")


def gqa_rows_q8_attention(q, k_full, ks_full, v_full, vs_full, poss, scale: float,
                          win: int) -> torch.Tensor:
    """q [B, Hq, d]; k/v the FULL int8 caches [B, S, Hkv, d] with f32 scales
    [B, S, Hkv]; poss [B] int64, each row's last valid slot; win (<= S,
    TS-aligned) -> [B, Hq, d] in q's dtype."""
    if not q.is_cuda:
        return gqa_rows_q8_attention_ref(q, k_full, ks_full, v_full, vs_full, poss, scale, win)
    _check_cuda_args(q, k_full, ks_full, v_full, vs_full, poss, win)
    b, hq, d = q.shape
    _, s_max, hkv, _ = k_full.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().gqa_rows_q8_attention_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_full.data_ptr(), ks_full.data_ptr(),
        v_full.data_ptr(), vs_full.data_ptr(), poss.data_ptr(), out.data_ptr(),
        b, hq, hkv, d, s_max, int(win), float(scale), stream,
    )
    _build.check(rc, "gqa_rows_q8_attention")
    _build.count_launch(gqa_rows_q8_attention)
    return out


gqa_rows_q8_attention.launches = 0
