"""Decode attention kernels (counterpart of
`qwen3_asr_gguf_tpu/ops/pallas_attn.py`): the wrappers of the CUDA kernels in
`csrc/attn_decode.cu` and `csrc/attn_rows_q8.cu`, their gates and their plain
PyTorch versions.

The single-stream decode step (`decoder.forward_step_layers`) attends one
token's query over a bf16 or f32 cache through `gqa_decode_attention`: the
kernel reads the FULL per-layer cache and stops at `pos`; the plain version
is `decoder._gqa_attention` on the `[:win]` window.

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
DECODE_MAX_HEAD_DIM = 128  # the single-token kernel holds a K and a V tile in shared memory
_KV_DTYPES = (torch.bfloat16, torch.float32)


def gqa_decode_attention_ref(q, k_full, v_full, pos: int, scale: float, win: int) -> torch.Tensor:
    """Plain version of `gqa_decode_attention`: the decoder's attention on
    the first `win` slots, slot <= pos, with q cast to the cache's dtype."""
    from ..models.decoder import _gqa_attention

    valid = (torch.arange(win, device=q.device) <= pos)[None, :]
    out = _gqa_attention(q.to(k_full.dtype), k_full[:win], v_full[:win], valid, scale)
    return out.to(q.dtype)


def _check_decode_args(q, k_full, v_full, pos: int, win: int) -> None:
    what = "gqa_decode_attention"
    if q.dtype not in _KV_DTYPES or k_full.dtype not in _KV_DTYPES:
        raise TypeError(f"{what}: q and the cache must be bf16 or f32, got {q.dtype}, "
                        f"{k_full.dtype}")
    if q.ndim != 3 or q.shape[0] != 1 or k_full.ndim != 3:
        raise ValueError(f"{what}: q must be [1, Hq, d] and k [S, Hkv, d]")
    _, hq, d = q.shape
    s_max, hkv, _ = k_full.shape
    if win % TS or win < TS or win > s_max or hq % hkv or hq // hkv > MAX_GROUP \
            or d % 8 or d > DECODE_MAX_HEAD_DIM or not 0 <= pos:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, "
                         f"cache {tuple(k_full.shape)}, pos {pos}, win {win}")
    for name, t in (("k", k_full), ("v", v_full)):
        if t.device != q.device or t.dtype != k_full.dtype \
                or tuple(t.shape) != (s_max, hkv, d) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {k_full.dtype} "
                             f"{(s_max, hkv, d)} on {q.device}")


def gqa_decode_attention(q, k_full, v_full, pos: int, scale: float, win: int) -> torch.Tensor:
    """q [1, Hq, d]; k/v the FULL cache [S, Hkv, d] (bf16 or f32); pos the
    last valid slot; win (<= S, TS-aligned) -> [1, Hq, d] in q's dtype.
    Equals `decoder._gqa_attention(q, k[:win], v[:win], slot <= pos)`."""
    if not q.is_cuda:
        return gqa_decode_attention_ref(q, k_full, v_full, pos, scale, win)
    _check_decode_args(q, k_full, v_full, pos, win)
    _, hq, d = q.shape
    s_max, hkv, _ = k_full.shape
    qc = q.to(k_full.dtype).contiguous()  # no copy where q already has the cache's dtype
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().gqa_decode_attention_launch(
        qc.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
        int(k_full.dtype == torch.bfloat16), out.data_ptr(), int(q.dtype == torch.bfloat16),
        hq, hkv, d, s_max, int(pos), int(win), float(scale), stream,
    )
    _build.check(rc, "gqa_decode_attention")
    _build.count_launch(gqa_decode_attention)
    return out


gqa_decode_attention.launches = 0


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
