"""Decode attention kernels (counterpart of
`qwen3_asr_gguf_tpu/ops/pallas_attn.py`): the wrappers of the CUDA kernels in
`csrc/attn_decode.cu` and `csrc/attn_rows_q8.cu`, their gates and their plain
PyTorch versions.

The single-stream decode step (`decoder.forward_step_layers`) attends one
token's query over a bf16 or f32 cache through `gqa_decode_attention`: the
kernel reads the FULL per-layer cache and stops at `pos`, which it reads
from a 1-element int32 device tensor that the step makes once for all
layers; the plain version is `decoder._gqa_attention` on the `[:win]`
window.

The serving decode step (`decoder.forward_step_rows`) attends every row's
query over its own int8 cache row, with the f32 per-(slot, head) scales
folded into the dots. The kernel reads the FULL caches with their strides
and each row's last valid slot from the int64 `poss` on the device, and
splits the row's live slots over a cluster of `ROWS_CLUSTER` blocks; the
plain version is `decoder._gqa_attention_rows_q8` on the `[:, :win]`
window.

A wrapper runs its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

TS = 256  # KV slots per tile; windows are 256-slot buckets
MAX_GROUP = 8  # query heads per kv head the kernel takes
MAX_HEAD_DIM = 256
DECODE_MAX_HEAD_DIM = 128  # the single-token kernel: lanes along d, up to 4 outputs per lane
DECODE_SUB = 8  # slots of a warp's sub-tile in the single-token kernel
DECODE_WARPS = {torch.bfloat16: 16, torch.float32: 8}  # warps of a block, by cache dtype
DECODE_CLUSTER = 8  # blocks per kv head (a thread block cluster), at every window and `pos`
ROWS_CLUSTER = 4  # the rows kernel: blocks per (row, kv head), at every window and `poss`
ROWS_WARPS = 8  # warps of a block of the rows kernel
ROWS_SUB = 8  # slots of a warp's sub-tile in the rows kernel (two score steps of 4)
_KV_DTYPES = (torch.bfloat16, torch.float32)
MASKED = -1e30


def decode_pos(pos, device) -> torch.Tensor:
    """`pos` as the kernel reads it: a 1-element int32 tensor on the device
    (a tensor is passed through; an int is copied there, synchronously)."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.tensor([int(pos)], dtype=torch.int32, device=device)


def gqa_decode_attention_ref(q, k_full, v_full, pos, scale: float, win: int) -> torch.Tensor:
    """Plain version of `gqa_decode_attention`: the decoder's attention on
    the first `win` slots, slot <= pos, with q cast to the cache's dtype.
    `pos` is an int or a 1-element tensor on q's device."""
    from ..models.decoder import _gqa_attention

    valid = (torch.arange(win, device=q.device) <= pos)[None, :]
    out = _gqa_attention(q.to(k_full.dtype), k_full[:win], v_full[:win], valid, scale)
    return out.to(q.dtype)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _merge(states: list) -> tuple:
    """(m, l, acc) of ordered (m, l, acc) states, as the kernel merges them:
    the max first, then l and acc weighted by exp(m_i - m) in order."""
    m = states[0][0]
    for s in states[1:]:
        m = torch.maximum(m, s[0])
    l, acc = torch.zeros_like(m), torch.zeros_like(states[0][2])
    for mi, li, ai in states:
        wt = torch.exp(mi - m)
        l, acc = _fma(li, wt, l), _fma(ai, wt[..., None], acc)
    return m, l, acc


def gqa_decode_attention_kernel_order(q, k_full, v_full, pos, scale: float,
                                      win: int) -> torch.Tensor:
    """`gqa_decode_attention` as the CUDA kernel splits and orders it: the
    window cut into `DECODE_CLUSTER` blocks, each block's 8-slot sub-tiles
    dealt round robin to its warps (16, or 8 for an f32 cache), each warp's
    own online softmax (tile
    sum ((p0+p4) + (p1+p5)) + ((p2+p6) + (p3+p7)), acc scaled by alpha, then
    the probabilities, rounded to V's dtype, times V added slot by slot), the
    warps merged in order, then the blocks in rank order. The q.k dots are torch's f32 sums (the kernel's 8
    lanes per slot sum in another order). Differs from the plain version by
    the f32 sum order only."""
    _, hq, d = q.shape
    _, hkv, _ = k_full.shape
    g = hq // hkv
    last = min(int(pos), win - 1)
    per_block = win // DECODE_CLUSTER
    qf = q.to(k_full.dtype).float().reshape(hkv, g, d)
    empty = (torch.full((hkv, g), MASKED), torch.zeros(hkv, g), torch.zeros(hkv, g, d))
    blocks = []
    for rank in range(DECODE_CLUSTER):
        b0 = rank * per_block
        n_sub = -(-max(0, min(per_block, last - b0 + 1)) // DECODE_SUB)
        warps = []
        for w in range(DECODE_WARPS[k_full.dtype]):
            m, l, acc = empty
            for i in range(w, n_sub, DECODE_WARPS[k_full.dtype]):
                s0 = b0 + i * DECODE_SUB
                kt = k_full[s0:s0 + DECODE_SUB].float()  # [SUB, Hkv, d]
                vt = v_full[s0:s0 + DECODE_SUB].float()
                keep = torch.arange(s0, s0 + DECODE_SUB) <= last
                s = torch.where(keep, torch.einsum("hgd,shd->hgs", qf, kt) * scale, MASKED)
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(keep, torch.exp(s - m_new[..., None]), 0.0)
                t = p[..., :4] + p[..., 4:]
                l = _fma(l, alpha, (t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3]))
                pr = p.to(v_full.dtype).float()
                acc = acc * alpha[..., None]
                for r in range(min(DECODE_SUB, last - s0 + 1)):
                    acc = _fma(pr[..., r, None], vt[r][:, None, :], acc)
                m = m_new
            warps.append((m, l, acc))
        blocks.append(_merge(warps))
    _, l_all, o_all = _merge(blocks)
    out = o_all / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(1, hq, d).to(q.dtype)


def _check_decode_args(q, k_full, v_full, pos, win: int) -> None:
    what = "gqa_decode_attention"
    if q.dtype not in _KV_DTYPES or k_full.dtype not in _KV_DTYPES:
        raise TypeError(f"{what}: q and the cache must be bf16 or f32, got {q.dtype}, "
                        f"{k_full.dtype}")
    if q.ndim != 3 or q.shape[0] != 1 or k_full.ndim != 3:
        raise ValueError(f"{what}: q must be [1, Hq, d] and k [S, Hkv, d]")
    _, hq, d = q.shape
    s_max, hkv, _ = k_full.shape
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or tuple(pos.shape) != (1,) or pos.device != q.device:
            raise ValueError(f"{what}: pos must be a 1-element int32 tensor on {q.device}, "
                             f"got {pos.dtype} {tuple(pos.shape)} on {pos.device}")
    elif not 0 <= pos:
        raise ValueError(f"{what}: pos {pos} is negative")
    if win % TS or win < TS or win > s_max or hq % hkv or hq // hkv > MAX_GROUP \
            or d % 8 or d > DECODE_MAX_HEAD_DIM:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, "
                         f"cache {tuple(k_full.shape)}, win {win}")
    for name, t in (("k", k_full), ("v", v_full)):
        if t.device != q.device or t.dtype != k_full.dtype \
                or tuple(t.shape) != (s_max, hkv, d) or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous, 16-byte aligned "
                             f"{k_full.dtype} {(s_max, hkv, d)} on {q.device}")


def gqa_decode_attention(q, k_full, v_full, pos, scale: float, win: int) -> torch.Tensor:
    """q [1, Hq, d]; k/v the FULL cache [S, Hkv, d] (bf16 or f32); pos the
    last valid slot, an int or a 1-element int32 tensor on q's device (the
    kernel reads it there, so a captured graph replays at any position of
    the window); win (<= S, TS-aligned) -> [1, Hq, d] in q's dtype.
    Equals `decoder._gqa_attention(q, k[:win], v[:win], slot <= pos)`."""
    if not q.is_cuda:
        return gqa_decode_attention_ref(q, k_full, v_full, pos, scale, win)
    _check_decode_args(q, k_full, v_full, pos, win)
    _, hq, d = q.shape
    s_max, hkv, _ = k_full.shape
    pos_t = decode_pos(pos, q.device)
    qc = q.to(k_full.dtype).contiguous()  # no copy where q already has the cache's dtype
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _build.lib().gqa_decode_attention_launch(
        qc.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
        int(k_full.dtype == torch.bfloat16), pos_t.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), hq, hkv, d, s_max, int(win), float(scale), stream,
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


def gqa_rows_q8_attention_kernel_order(q, k_full, ks_full, v_full, vs_full, poss,
                                       scale: float, win: int) -> torch.Tensor:
    """`gqa_rows_q8_attention` as the CUDA kernel splits and orders it: row
    i's live slots (slot <= min(poss[i], win - 1)) cut into `ROWS_SUB`-slot
    sub-tiles, the n sub-tiles split over `ROWS_CLUSTER` blocks (block r takes
    [r n / C, (r + 1) n / C)), each block's sub-tiles dealt round robin to its
    `ROWS_WARPS` warps, each warp's own online softmax (score = dot *
    (ks * scale), tile sum ((p0+p4) + (p1+p5)) + ((p2+p6) + (p3+p7)),
    l = fma(l, alpha, sum), acc scaled by alpha, then p * vs rounded to q's
    dtype times V added slot by slot), the warps merged in order, then the
    blocks in rank order. The q.k dots are torch's f32 sums (the kernel's 8
    lanes per slot sum in another order). Differs from the plain version by
    the f32 sum order and where p * vs is rounded only."""
    b, hq, d = q.shape
    hkv = k_full.shape[2]
    g = hq // hkv
    sub, n_warps = ROWS_SUB, ROWS_WARPS
    scale_f = torch.tensor(scale, dtype=torch.float32)  # the kernel's f32 scale
    empty = (torch.full((hkv, g), MASKED), torch.zeros(hkv, g), torch.zeros(hkv, g, d))
    outs = []
    for i in range(b):
        last = min(int(poss[i]), win - 1)
        n_sub = last // sub + 1 if last >= 0 else 0
        qf = q[i].float().reshape(hkv, g, d)
        blocks = []
        for rank in range(ROWS_CLUSTER):
            sub0, sub1 = rank * n_sub // ROWS_CLUSTER, (rank + 1) * n_sub // ROWS_CLUSTER
            warps = []
            for w in range(n_warps):
                m, l, acc = empty
                for j in range(sub0 + w, sub1, n_warps):
                    s0 = j * sub
                    keep = torch.arange(s0, s0 + sub) <= last
                    kt = k_full[i, s0:s0 + sub].float()  # [SUB, Hkv, d], exact
                    kscale = ks_full[i, s0:s0 + sub].T * scale_f
                    dots = torch.einsum("hgd,shd->hgs", qf, kt)
                    s = torch.where(keep, dots * kscale[:, None, :], MASKED)
                    m_new = torch.maximum(m, s.amax(dim=-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(keep, torch.exp(s - m_new[..., None]), 0.0)
                    t = p[..., :4] + p[..., 4:]
                    l = _fma(l, alpha, (t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3]))
                    vsc = torch.where(keep, vs_full[i, s0:s0 + sub].T, 0.0)  # [Hkv, SUB]
                    pr = (p * vsc[:, None, :]).to(q.dtype).float()
                    acc = acc * alpha[..., None]
                    vt = v_full[i, s0:s0 + sub].float()
                    for r in range(min(sub, last - s0 + 1)):
                        acc = _fma(pr[..., r, None], vt[r][:, None, :], acc)
                    m = m_new
                warps.append((m, l, acc))
            blocks.append(_merge(warps))
        _, l_all, o_all = _merge(blocks)
        outs.append((o_all / torch.clamp(l_all, min=1e-30)[..., None]).reshape(hq, d))
    return torch.stack(outs).to(q.dtype)


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
    if k_full.data_ptr() % 16 or v_full.data_ptr() % 16:
        raise ValueError(f"{what}: k and v must be 16-byte aligned (16-byte copies)")
    if not q.is_contiguous():
        raise ValueError(f"{what}: q must be contiguous")


def gqa_rows_q8_attention(q, k_full, ks_full, v_full, vs_full, poss, scale: float,
                          win: int) -> torch.Tensor:
    """q [B, Hq, d]; k/v the FULL int8 caches [B, S, Hkv, d] with f32 scales
    [B, S, Hkv]; poss [B] int64, each row's last valid slot (the kernel reads
    it on the device, so a captured graph replays at any positions of the
    window); win (<= S, TS-aligned) -> [B, Hq, d] in q's dtype. One launch,
    no scratch."""
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
