"""Sparse-expert products: the router, the decode step's routed-expert int4
matvec (kernel 8, `csrc/moe_matvec.cu`) and the prefill's grouped products.

Expert weights (`ExpertWeights`) are ggml q4_0 as a checkpoint stores them,
split on the device into two planes per projection (`from_q4_0`):

    qs : uint8 [E, N, K//2]   per 32-block 16 bytes: byte j holds element j
                              of the block in its low nibble, j + 16 in its
                              high nibble
    d  : f16   [E, N, K//32]  the block's scale; a weight is (q - 8) * d

with the projections gate and up [E, M, D] and down [E, D, M]. The shared
experts' one SwiGLU of width n_shared * M is held as `n_shared` more
experts of width M after the routed ones (rows of gate and up, columns of
down: the sum of the halves is the whole, up to the order of summation),
each of weight 1, so a token's product runs `slots` = top_k + n_shared
experts.

`expert_matvec(x, w, ids, wts)` = sum_s wts[s] * down[ids[s]] @
(silu(gate[ids[s]] @ x) * (up[ids[s]] @ x)) for one row x [D], with x and
the SwiGLU's output entering the products as int8, 32 to a scale, as in
kernels 1-3: `ids` (int32) and `wts` (f32) [slots] are device tensors that
no host value precedes, so the step stays inside a captured CUDA graph. On
a CUDA tensor it launches kernel 8 or raises; on the CPU it runs its plain
version.

`DenseExperts` is the prefill's bf16 copy ([E, 2M, D] gate|up and
[E, D, M] down). `grouped_experts` sorts a prefill's (token, slot) rows by
expert and runs one grouped product per projection with the group offsets
on the device (`torch._grouped_mm` on the card; a loop over the experts is
its plain version on the CPU), then sums each token's slots in slot order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build

QK = 32  # weights to a q4_0 block
BLOCK_BYTES = 18
MAX_SLOTS = 16
SMEM_BYTES = 200 * 1024  # a block's dynamic shared memory that kernel 8 asks for at most


@dataclass
class ExpertWeights:
    gate_qs: torch.Tensor  # uint8 [E, M, D//2]
    gate_d: torch.Tensor  # f16 [E, M, D//32]
    up_qs: torch.Tensor
    up_d: torch.Tensor
    down_qs: torch.Tensor  # uint8 [E, D, M//2]
    down_d: torch.Tensor  # f16 [E, D, M//32]

    @property
    def shape(self) -> tuple[int, int, int]:
        """(experts, M, D)."""
        e, m, d2 = self.gate_qs.shape
        return e, m, 2 * d2

    def dense(self, dtype=torch.bfloat16) -> "DenseExperts":
        """The prefill's dense copy, one projection and one expert at a time
        in f32 on the device."""
        e, m, d = self.shape
        dev = self.gate_qs.device
        gateup = torch.empty(e, 2 * m, d, dtype=dtype, device=dev)
        down = torch.empty(e, d, m, dtype=dtype, device=dev)
        for i in range(e):
            gateup[i, :m] = dequant(self.gate_qs[i], self.gate_d[i]).to(dtype)
            gateup[i, m:] = dequant(self.up_qs[i], self.up_d[i]).to(dtype)
            down[i] = dequant(self.down_qs[i], self.down_d[i]).to(dtype)
        return DenseExperts(gateup=gateup, down=down)


@dataclass
class DenseExperts:
    gateup: torch.Tensor  # [E, 2M, D]: gate rows, then up rows
    down: torch.Tensor  # [E, D, M]


def split_q4_0(raw: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q4_0 bytes [..., K//32 * 18] (on any device) -> (qs uint8 [..., K//2],
    d f16 [..., K//32]), on that device."""
    lead = raw.shape[:-1]
    blk = raw.reshape(*lead, k // QK, BLOCK_BYTES)
    d = blk[..., :2].contiguous().view(torch.float16).reshape(*lead, k // QK)
    qs = blk[..., 2:].contiguous().reshape(*lead, k // 2)
    return qs, d


def dequant(qs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """f32 [..., K] from the planes."""
    lead, k2 = qs.shape[:-1], qs.shape[-1]
    b = qs.reshape(*lead, k2 // 16, 16)
    q = torch.cat([b & 0x0F, b >> 4], dim=-1).float() - 8.0
    return (q * d.float()[..., None]).reshape(*lead, 2 * k2)


def from_q4_0(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, m: int, d: int,
              shared: tuple | None = None) -> ExpertWeights:
    """The routed experts' q4_0 bytes (gate, up [E, M, D//32*18], down
    [E, D, M//32*18], each on its device) and `shared` = (gate, up
    [S*M, D//32*18], down [D, S*M//32*18]) of the shared SwiGLU, held as S
    experts of width M after the routed ones."""
    parts = [split_q4_0(gate, d), split_q4_0(up, d), split_q4_0(down, m)]
    if shared is not None:
        sg, su, sd = shared
        s = sg.shape[0] // m
        extra = [split_q4_0(sg.reshape(s, m, -1), d), split_q4_0(su.reshape(s, m, -1), d)]
        qs, dd = split_q4_0(sd, s * m)  # [D, S*M//2], [D, S*M//32]
        extra.append((qs.reshape(d, s, m // 2).transpose(0, 1).contiguous(),
                      dd.reshape(d, s, m // QK).transpose(0, 1).contiguous()))
        parts = [(torch.cat([q, eq]), torch.cat([s_, es])) for (q, s_), (eq, es) in zip(parts, extra)]
    (gq, gd), (uq, ud), (dq, ddn) = parts
    return ExpertWeights(gq, gd, uq, ud, dq, ddn)


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, top_k: int,
          scale: float, norm: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] -> (experts [T, top_k] int64, weights [T, top_k] f32): f32
    logits, sigmoid scores, the top_k of scores + bias, weighted by their
    unbiased scores (renormalised with `norm`) times `scale`."""
    scores = torch.sigmoid(x.float() @ router.float().t())
    idx = torch.topk(scores + bias.float(), top_k, dim=-1, sorted=True).indices
    w = scores.gather(-1, idx)
    if norm:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scale


def with_shared(idx: torch.Tensor, w: torch.Tensor, n_routed: int, n_shared: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's routed (experts, weights) followed by the shared experts
    n_routed .. n_routed + n_shared - 1 at weight 1."""
    t = idx.shape[0]
    sid = torch.arange(n_routed, n_routed + n_shared, device=idx.device).expand(t, n_shared)
    return torch.cat([idx, sid], 1), torch.cat([w, w.new_ones(t, n_shared)], 1)


# --------------------------------------------------------------------------
# decode: kernel 8 and its plain version
# --------------------------------------------------------------------------


def quantize_groups(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v f32 [..., K] -> (q [..., K//32, 32], sx [..., K//32]), as kernel 8
    quantizes its activations: q = round-half-even(v * (127 / amax)) per
    32-group (0 where amax is 0), sx = amax / 127; q is integer-valued f32."""
    g = v.float().reshape(*v.shape[:-1], -1, QK)
    amax = g.abs().amax(-1)
    inv = torch.where(amax > 0, 127.0 / torch.where(amax > 0, amax, torch.ones_like(amax)),
                      torch.zeros_like(amax))
    return torch.round(g * inv[..., None]).clamp(-127, 127), amax / 127.0


def _int_dot(qs: torch.Tensor, d: torch.Tensor, q: torch.Tensor, sx: torch.Tensor
             ) -> torch.Tensor:
    """Rows of q4_0 planes [S, N, K//2], [S, N, K//32] against int8 groups
    q [S or 1, K//32, 32] with scales sx [S or 1, K//32] -> [S, N] f32: each
    block's integer dot (exact in f32) times d * sx, summed over the blocks."""
    s, n, k2 = qs.shape
    b = qs.reshape(s, n, k2 // 16, 16)
    w = torch.cat([b & 0x0F, b >> 4], dim=-1).float() - 8.0  # [S, N, K//32, 32]
    blocks = torch.einsum("snbj,sbj->snb", w, q.expand(s, -1, -1))
    return (blocks * d.float() * sx.expand(s, -1)[:, None, :]).sum(-1)


def expert_matvec_ref(x: torch.Tensor, w: ExpertWeights, ids: torch.Tensor,
                      wts: torch.Tensor) -> torch.Tensor:
    """Plain version of `expert_matvec`: x and then silu(gate) * up quantized
    to int8 per 32-group (`quantize_groups`), each block's integer dot times
    its scales in f32, the blocks and the slots summed in f32; the result in
    x's dtype."""
    e, m, d = w.shape
    ids = ids.reshape(-1).long()
    q, sx = quantize_groups(x.reshape(1, d))
    g = _int_dot(w.gate_qs[ids], w.gate_d[ids], q, sx)
    u = _int_dot(w.up_qs[ids], w.up_d[ids], q, sx)
    qa, sa = quantize_groups(F.silu(g) * u)  # [S, M//32, 32]
    out = _int_dot(w.down_qs[ids], w.down_d[ids], qa, sa)  # [S, D]
    return (wts.reshape(-1, 1).float() * out).sum(0).to(x.dtype).reshape(*x.shape[:-1], d)


def supported(x_shape: tuple[int, ...], w: ExpertWeights, slots: int) -> bool:
    """Shapes kernel 8 takes: one row, whole 32-blocks along D and M, at
    most MAX_SLOTS experts, and every slot's int8 activations (with a scale
    and a sum per 32) within one block's shared memory."""
    e, m, d = w.shape
    rows = 1
    for s in x_shape[:-1]:
        rows *= int(s)
    return (rows == 1 and x_shape[-1] == d and d % QK == 0 and m % QK == 0
            and 0 < slots <= MAX_SLOTS and slots * m * 5 // 4 <= SMEM_BYTES
            and d * 5 // 4 <= SMEM_BYTES)


def _check_cuda_args(x, w: ExpertWeights, ids, wts) -> None:
    slots = ids.numel()
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expert_matvec: x must be f32 or bf16, got {x.dtype}")
    if not supported(tuple(x.shape), w, slots) or not x.is_contiguous():
        raise ValueError(f"expert_matvec: unsupported x {tuple(x.shape)} for experts "
                         f"{w.shape} and {slots} slots")
    if ids.dtype != torch.int32 or wts.dtype != torch.float32 or wts.numel() != slots:
        raise ValueError("expert_matvec: ids must be int32 and wts f32, one per slot")
    for name, t, dt in (("gate_qs", w.gate_qs, torch.uint8), ("gate_d", w.gate_d, torch.float16),
                        ("up_qs", w.up_qs, torch.uint8), ("up_d", w.up_d, torch.float16),
                        ("down_qs", w.down_qs, torch.uint8), ("down_d", w.down_d, torch.float16),
                        ("ids", ids, torch.int32), ("wts", wts, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"expert_matvec: {name} must be contiguous {dt} on {x.device}")
    if any(p.data_ptr() % 16 for p in (w.gate_qs, w.up_qs, w.down_qs)):
        raise ValueError("expert_matvec: the nibble planes must be 16-byte aligned")


def expert_matvec(x: torch.Tensor, w: ExpertWeights, ids: torch.Tensor,
                  wts: torch.Tensor) -> torch.Tensor:
    """x [..., D] (one row) -> [..., D] in x's dtype: the weighted sum of the
    experts `ids` (int32 [slots] on the device) at weights `wts` (f32
    [slots]). Two launches: gate and up of every slot into a scratch of
    silu(gate) * up as int8 groups, then down of every slot summed."""
    if not x.is_cuda:
        return expert_matvec_ref(x, w, ids, wts)
    ids, wts = ids.reshape(-1), wts.reshape(-1)
    _check_cuda_args(x, w, ids, wts)
    e, m, d = w.shape
    slots = ids.numel()
    # the SwiGLU's output as int8, then a scale and a sum of q per 32
    scratch = torch.empty(slots * m * 5 // 4, dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().moe_matvec_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ids.data_ptr(), wts.data_ptr(),
        w.gate_qs.data_ptr(), w.gate_d.data_ptr(), w.up_qs.data_ptr(), w.up_d.data_ptr(),
        w.down_qs.data_ptr(), w.down_d.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        slots, m, d, stream)
    _build.check(rc, "expert_matvec")
    _build.count_launch(expert_matvec)
    return out


expert_matvec.launches = 0


# --------------------------------------------------------------------------
# prefill: grouped products
# --------------------------------------------------------------------------


def _grouped(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor, counts: torch.Tensor
             ) -> torch.Tensor:
    """Rows of `a` [R, K] grouped by expert (group g = rows offs[g-1] ..
    offs[g]) times b[g] [N, K]^T -> [R, N]."""
    if a.is_cuda:
        return torch._grouped_mm(a, b.transpose(1, 2), offs=offs)
    out = a.new_zeros(a.shape[0], b.shape[1])
    start = 0
    for g, n in enumerate(counts.tolist()):
        if n:
            out[start:start + n] = (a[start:start + n].float() @ b[g].float().t()).to(a.dtype)
        start += n
    return out


def grouped_experts(x: torch.Tensor, w: DenseExperts, ids: torch.Tensor, wts: torch.Tensor,
                    hist: list | None = None, n_routed: int | None = None,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """x [T, D] with each row's experts `ids` [T, S] and weights `wts`
    [T, S] (f32) -> sum_s wts * expert(x) [T, D] in x's dtype. The T*S rows
    are sorted by expert (stable) with the counts and offsets on the
    device; `hist` gets the rows of each routed expert (the first
    `n_routed`) among the rows `valid` (bool [T]; all by default; a
    prompt's padding rows are computed but not counted), an int32 device
    tensor."""
    t, s = ids.shape
    e = w.gateup.shape[0]
    m = w.down.shape[2]
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))  # no host read, as bincount's size would need
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xs = x.index_select(0, order // s)
    gu = _grouped(xs, w.gateup, offs, counts)
    act = (F.silu(gu[:, :m].float()) * gu[:, m:].float()).to(x.dtype)
    y = _grouped(act, w.down, offs, counts).float() * wts.reshape(-1)[order, None]
    out = torch.empty_like(y).index_copy_(0, order, y)
    if hist is not None:
        if valid is not None:
            counts = torch.zeros_like(counts).scatter_add_(
                0, flat, valid[:, None].expand(t, s).reshape(-1).to(torch.int64))
        hist.append(counts[:n_routed].to(torch.int32))
    return out.reshape(t, s, -1).sum(1).to(x.dtype)
