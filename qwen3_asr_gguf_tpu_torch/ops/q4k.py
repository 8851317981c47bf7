"""q4_k int4-stream matvec and multi-row matmul: weight container, host
packing, plain versions and the wrappers of the CUDA kernels in
`csrc/q4k_matvec.cu` and `csrc/q4k_matmul_rows.cu`.

Counterpart of `qwen3_asr_gguf_tpu/ops/pallas_q4k.py`, with its weight
layout (so weights carry across unchanged):

    packed : uint8 [N//2, K]  signed nibbles (q-8), channel PAIRS per byte:
             byte [r, k] holds channel 2r in its low nibble, 2r+1 in its high
    sub_t  : int8 [K//32, N]  6-bit q4_k sub-scale per 32-group
    min_t  : int8 [K//32, N]  6-bit q4_k sub-min
    dd_t   : f32 [2*S, N]     S superblocks: row 2s = d_s, row 2s+1 = dmin_s

scale[g] = sub[g] * d[g//8], minv[g] = min[g] * dmin[g//8], and a weight is
q*scale + (8*scale - minv). The matvec quantizes the activation row to int8
per 32-group (x * reciprocal(sx), round half to even), takes exact int32
group dots and applies the scales per group, as the TPU kernel does. The
multi-row matmul (serving's batched decode step) does the same for each of
T rows (T % 8 == 0, T <= 64) on the tensor cores, streaming each weight once
for all rows.

A wrapper runs its plain PyTorch version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats import quants as q

from . import _build
from ._order import fma, sum_in_order

GROUP = 32  # q4_k quant group along K
BN = 512  # channel tile of the TPU kernel; `supported` keeps its conditions
T_TILE = 8  # activation rows of one tensor-core tile of the multi-row matmul
MAX_ROWS = 64  # activation rows the multi-row matmul takes at most
ROWS_CHUNK_GROUPS = 16  # 32-groups per K chunk of the multi-row kernel (512 of K)
ROWS_WARPS = 8  # warps of a block: channel tiles of 8 pairs times K slices
ROWS_MIN_BLOCKS = 64  # blocks along N below which a block narrows
ROWS_FILL_BLOCKS = 96  # blocks in all that a split of K makes up to
MAX_K = 12288  # the kernels stage a quantized activation row in shared memory
NORMED_MAX_K = 2048  # the fused-norm matvec holds the whole row in registers


def pick_subk(k: int) -> int | None:
    """The TPU kernel's K step (pallas_q4k.pick_subk); the port keeps it as
    the applicability rule: K must be a multiple of 512."""
    for subk in (2048, 1024, 512):
        if k % subk == 0:
            return subk
    return None


@dataclass
class Q4KWeight:
    """q4_k weight in the matvec layout (see module docstring)."""

    packed: torch.Tensor
    sub_t: torch.Tensor
    min_t: torch.Tensor
    dd_t: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        n2, k = self.packed.shape[-2:]
        return (n2 * 2, k)

    def to(self, device) -> "Q4KWeight":
        return Q4KWeight(*(t.to(device) for t in (self.packed, self.sub_t, self.min_t, self.dd_t)))

    @classmethod
    def from_numpy(cls, packed, sub_t, min_t, dd_t, device="cpu") -> "Q4KWeight":
        arrs = (
            np.ascontiguousarray(packed, np.uint8),
            np.ascontiguousarray(sub_t).astype(np.int8, copy=False),
            np.ascontiguousarray(min_t).astype(np.int8, copy=False),
            np.ascontiguousarray(dd_t, np.float32),
        )
        return cls(*(torch.from_numpy(a).to(device) for a in arrs))


# --------------------------------------------------------------------------
# host packing (numpy; copies of pallas_q4k.pack_q4k_mxu / pad_rows)
# --------------------------------------------------------------------------


def pack_q4k_mxu(p: "q.PackedQ4") -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """PackedQ4 -> (packed, sub_t, min_t, dd_t) numpy arrays. Sources without
    native q4_k structure are factorized through 6-bit supers."""
    n, k = p.shape
    packed = p.packed
    if q.is_rank_major(p):
        packed = packed[:, q.rank_major_inverse(k // 2)]

    ints = np.concatenate([packed & 0x0F, packed >> 4], axis=-1).astype(np.int8)  # [N, K] 0..15
    ints -= 8  # signed
    nib = (ints & 0xF).astype(np.uint8)
    rows = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)  # [N//2, K]

    if p.sc6 is not None:
        sc6, mn6, d, dmin = p.sc6, p.mn6, p.d, p.dmin
    else:
        sc6, mn6, d, dmin = q.factorize_q4k_scales(p.scale, p.minv)
    sub_t = np.ascontiguousarray(sc6.T).astype(np.int8)  # [G, N], 0..63
    min_t = np.ascontiguousarray(mn6.T).astype(np.int8)
    dd = np.stack([d.T, dmin.T], axis=1).reshape(2 * d.shape[1], n)  # [2S, N]
    return rows, sub_t, min_t, np.ascontiguousarray(dd).astype(np.float32)


def pad_rows(
    rows: np.ndarray, sub_t: np.ndarray, min_t: np.ndarray, dd_t: np.ndarray,
    multiple: int = BN,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad the channel dimension to a multiple (zero rows dequantize to 0;
    lm_logits slices them away)."""
    n = rows.shape[0] * 2
    pad = (-n) % multiple
    if not pad:
        return rows, sub_t, min_t, dd_t
    rows = np.concatenate([rows, np.zeros((pad // 2, rows.shape[1]), np.uint8)])
    sub_t = np.concatenate([sub_t, np.zeros((sub_t.shape[0], pad), sub_t.dtype)], axis=1)
    min_t = np.concatenate([min_t, np.zeros((min_t.shape[0], pad), min_t.dtype)], axis=1)
    dd_t = np.concatenate([dd_t, np.zeros((dd_t.shape[0], pad), dd_t.dtype)], axis=1)
    return rows, sub_t, min_t, dd_t


def from_packed_q4(p: "q.PackedQ4", pad: bool = True, device="cpu") -> Q4KWeight:
    parts = pack_q4k_mxu(p)
    if pad:
        parts = pad_rows(*parts)
    return Q4KWeight.from_numpy(*parts, device=device)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _expand_scales(w: Q4KWeight) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, minv) f32 [N, G] from the factored planes."""
    g = w.sub_t.shape[-2]
    d = torch.repeat_interleave(w.dd_t[0::2], 8, dim=0)[:g]
    dm = torch.repeat_interleave(w.dd_t[1::2], 8, dim=0)[:g]
    scale = w.sub_t.float() * d
    minv = w.min_t.float() * dm
    return scale.T, minv.T


def _signed_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """packed u8 [N/2, K] -> int8 values [N, K] in -8..7 (rows interleaved)."""
    lo = ((packed & 0x0F).to(torch.int8) ^ 8) - 8
    hi = ((packed >> 4).to(torch.int8) ^ 8) - 8
    return torch.stack([lo, hi], dim=1).reshape(packed.shape[0] * 2, packed.shape[1])


def dequant_mxu(w: Q4KWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [N, K] reconstruction (prefill and fallback path); bit-exact
    q4_k dequant for GGUF-sourced weights."""
    n, k = w.shape
    g = w.sub_t.shape[-2]
    ints = _signed_nibbles(w.packed).float()
    scale, minv = _expand_scales(w)  # [N, G]
    offs = 8.0 * scale - minv
    dense = ints.reshape(n, g, k // g) * scale[..., None] + offs[..., None]
    return dense.reshape(n, k).to(dtype)


def quantize_act_ref(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 [..., K] -> (xq int8 [..., K], sx f32 [..., G], xsum f32 [..., G]):
    per-32-group int8 quantization with x * reciprocal(sx), round half to
    even."""
    lead = xf.shape[:-1]
    xg = xf.reshape(-1, GROUP)
    amax = xg.abs().amax(dim=1)
    sx = torch.clamp(amax, min=1e-10) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(xg * torch.reciprocal(sx)[:, None]), -127, 127)
    return (xq.to(torch.int8).reshape(*lead, -1), sx.reshape(*lead, -1),
            xg.sum(dim=1).reshape(*lead, -1))


def _matvec_f32(xf: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """f32 [K] row (already in its final f32 form) -> f32 [N]."""
    n, k = w.shape
    g = k // GROUP
    xq, sx, xsum = quantize_act_ref(xf)
    ints = _signed_nibbles(w.packed).float().reshape(n, g, GROUP)
    # integer group dots: every partial sum is an integer below 2**24, so
    # the f32 products and sums are exact in any order
    acc = torch.einsum("ngk,gk->ng", ints, xq.float().reshape(g, GROUP))
    scale, minv = _expand_scales(w)
    offs = 8.0 * scale - minv
    contrib = acc * scale * sx[None, :] + xsum[None, :] * offs
    return contrib.sum(dim=1)


def q4k_matvec_ref(x: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """Plain version of `q4k_matvec`."""
    n, k = w.shape
    out = _matvec_f32(x.reshape(k).float(), w)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


def q4k_matvec_kernel_order(x: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """`q4k_matvec` step by step as the CUDA kernel computes it: the row
    quantized as `quantize_act_kernel_order` does (int8s and sx as the plain
    version's, xsum in the kernel's order), exact integer group dots, lane
    `l` of a warp adding groups l, l + 32, ... in order with
    acc = fma(xsum, offs, fma(dot*sx, scale, acc)), then a butterfly over
    the 32 lanes (xor 16, 8, 4, 2, 1). Which block takes which channels
    does not change the order. Differs from `q4k_matvec_ref` by the f32 sum order only."""
    n, k = w.shape
    g = k // GROUP
    xq, sx, xsum = quantize_act_kernel_order(x.reshape(1, k).float())
    ints = _signed_nibbles(w.packed).float().reshape(n, g, GROUP)
    dots = torch.einsum("ngk,gk->gn", ints, xq.float().reshape(g, GROUP))  # exact
    scale, minv = _expand_scales(w)
    scale, offs = scale.T, (8.0 * scale - minv).T  # [G, N]
    lanes = torch.zeros(32, n)
    for c in range(-(-g // 32)):
        gi = torch.arange(32) + 32 * c
        live = gi < g
        gl = gi[live]
        acc = fma(dots[gl] * sx[0, gl, None], scale[gl], lanes[live])
        lanes[live] = fma(xsum[0, gl, None], offs[gl], acc)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ o]
    return lanes[0].reshape(*x.shape[:-1], n).to(x.dtype)


def _matmul_rows_f32(xf: torch.Tensor, w: Q4KWeight, chunk: int = 16384) -> torch.Tensor:
    """f32 [T, K] rows -> f32 [T, N]: each row exactly as `_matvec_f32`,
    in channel chunks to bound the f32 unpack of the weight."""
    n, k = w.shape
    g = k // GROUP
    t = xf.shape[0]
    xq, sx, xsum = quantize_act_ref(xf)
    xqg = xq.float().reshape(t, g, GROUP)
    scale, minv = _expand_scales(w)
    offs = 8.0 * scale - minv
    out = []
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        ints = _signed_nibbles(w.packed[c0 // 2: c1 // 2]).float().reshape(c1 - c0, g, GROUP)
        acc = torch.einsum("ngk,tgk->tng", ints, xqg)  # exact integer group dots
        contrib = acc * scale[None, c0:c1] * sx[:, None, :] + xsum[:, None, :] * offs[None, c0:c1]
        out.append(contrib.sum(dim=2))
    return torch.cat(out, dim=1)


def q4k_matmul_rows_ref(x: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """Plain version of `q4k_matmul_rows`: x [T, K] -> [T, N] in x's dtype."""
    return _matmul_rows_f32(x.float(), w).to(x.dtype)


def rows_tiling(n: int, k: int) -> tuple[int, int]:
    """(channel pairs per block, blocks that split K) of the multi-row
    kernel. A block's 8 warps are pairs/8 channel tiles times 64/pairs K
    slices; a cluster of up to 8 blocks splits K's chunks of 512 evenly. The
    widest block of 64, 32, 16, 8 pairs that still leaves `ROWS_MIN_BLOCKS`
    blocks is taken (a wide block reads the activation rows once for more
    channels), with the smallest split that reaches `ROWS_FILL_BLOCKS`; a
    weight too small for that takes the largest split first, then the widest
    block."""
    chunks = k // (ROWS_CHUNK_GROUPS * GROUP)
    splits = [d for d in range(1, 9) if chunks % d == 0]
    widths = (64, 32, 16, 8)
    for ct in widths:
        blocks = (n // 2) // ct
        if blocks >= ROWS_MIN_BLOCKS:
            fit = [d for d in splits if blocks * d >= ROWS_FILL_BLOCKS]
            return ct, (fit[0] if fit else splits[-1])
    for ct in widths:
        if (n // 2) // ct * splits[-1] >= ROWS_MIN_BLOCKS:
            return ct, splits[-1]
    return 8, splits[-1]


def quantize_act_kernel_order(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`quantize_act_ref` with the group sum taken as pass A of the multi-row
    kernel and the matvec kernel's prologue take it: eight lanes of four
    values, ((v0+v1)+v2)+v3 in each, then three butterfly steps."""
    xq, sx, _ = quantize_act_ref(xf)
    lanes = xf.reshape(-1, 8, 4)
    s = ((lanes[..., 0] + lanes[..., 1]) + lanes[..., 2]) + lanes[..., 3]  # [groups, 8]
    for _ in range(3):
        s = s[:, 0::2] + s[:, 1::2]
    return xq, sx, s.reshape(sx.shape)


def q4k_matmul_rows_kernel_order(x: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """`q4k_matmul_rows` step by step as the CUDA kernel computes it: the
    same quantization and exact integer group dots as the plain version, the
    groups of each K slice of each block (`rows_tiling`) added in order with
    acc = fma(xsum, offs, fma(dot*sx, scale, acc)), then the slices in
    order, then the blocks that split K in order. Differs from
    `q4k_matmul_rows_ref` by the f32 sum order only."""
    n, k = w.shape
    g = k // GROUP
    t = x.shape[0]
    xq, sx, xsum = quantize_act_kernel_order(x.float())
    ct, ks = rows_tiling(n, k)
    k_slices = ROWS_WARPS // (ct // 8)
    per_slice = ROWS_CHUNK_GROUPS // k_slices
    per_block = g // ROWS_CHUNK_GROUPS // ks  # chunks of one block of the cluster
    ints = _signed_nibbles(w.packed).float().reshape(n, g, GROUP)
    dots = torch.einsum("ngk,tgk->tng", ints, xq.float().reshape(t, g, GROUP))  # exact
    scale, minv = _expand_scales(w)
    offs = 8.0 * scale - minv
    parts = [[torch.zeros(t, n) for _ in range(k_slices)] for _ in range(ks)]
    for gi in range(g):
        mine = parts[gi // ROWS_CHUNK_GROUPS // per_block]
        s = (gi % ROWS_CHUNK_GROUPS) // per_slice
        acc = fma(dots[:, :, gi] * sx[:, gi, None], scale[None, :, gi], mine[s])
        mine[s] = fma(xsum[:, gi, None], offs[None, :, gi], acc)
    return sum_in_order([sum_in_order(mine) for mine in parts]).to(x.dtype)


def normed_row_kernel_order(x: torch.Tensor, norm_w: torch.Tensor, eps: float) -> torch.Tensor:
    """rms_norm(x) * norm_w rounded to bf16, as the prologue of
    `q4k_matvec_normed` builds it: lane l of warp w (8 warps) holds the four
    values 4l .. 4l + 3 of each 128-value piece w, w + 8, ... and adds their
    squares in that order (x*x, then +, each rounded once to f32); the lanes
    are summed by a butterfly (xor 16, 8, 4, 2, 1), the warps in warp order;
    rstd = 1 / sqrt(ss / K + eps), each step rounded once (ss / K is exact:
    K is a power of two wherever `supported_normed` holds); then
    bf16((x * rstd) * norm_w). Returns the bf16 row in x's shape."""
    k = x.shape[-1]
    piece = 4 * 32
    pieces = -(-k // (piece * 8))  # per warp
    xp = torch.zeros(pieces * 8 * piece)
    xp[:k] = x.reshape(k).float()
    v = xp.reshape(pieces, 8, 32, 4)  # [piece of the warp, warp, lane, value]
    ss = torch.zeros(8, 32)
    for c in range(pieces):
        for e in range(4):
            ss = ss + v[c, :, :, e] * v[c, :, :, e]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[:, idx ^ o]
    total = sum_in_order(list(ss[:, 0]))
    rstd = torch.reciprocal(torch.sqrt(total / k + torch.tensor(eps, dtype=torch.float32)))
    xn = (x.reshape(k).float() * rstd) * norm_w.reshape(k).float()
    return xn.to(torch.bfloat16).reshape(x.shape)


def q4k_matvec_normed_kernel_order(x: torch.Tensor, w: Q4KWeight, norm_w: torch.Tensor,
                                   eps: float) -> torch.Tensor:
    """`q4k_matvec_normed` step by step as the CUDA kernel computes it: the
    normed row of `normed_row_kernel_order`, then `q4k_matvec_kernel_order`
    on it. Differs from `q4k_matvec_normed_ref` by the f32 sum orders only."""
    return q4k_matvec_kernel_order(normed_row_kernel_order(x, norm_w, eps).to(x.dtype), w)


def q4k_matvec_normed_ref(x: torch.Tensor, w: Q4KWeight, norm_w: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """Plain version of `q4k_matvec_normed`: rms_norm(x)*norm_w in f32, the
    bf16 round-trip of the unfused path, then the matvec."""
    n, k = w.shape
    xf = x.reshape(1, k).float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps) * norm_w.reshape(1, k).float()
    xn = xn.to(torch.bfloat16).float()
    out = _matvec_f32(xn.reshape(k), w)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


# --------------------------------------------------------------------------
# applicability (same conditions as pallas_q4k.supported / supported_normed)
# --------------------------------------------------------------------------


def supported(x_shape: tuple[int, ...], w: Q4KWeight) -> bool:
    n, k = w.shape
    t = int(np.prod(x_shape[:-1])) if len(x_shape) > 1 else 1
    return t == 1 and pick_subk(k) is not None and n % BN == 0 and w.packed.ndim == 2


def supported_rows(x_shape: tuple[int, ...], w: Q4KWeight) -> bool:
    """Multi-row matmul: 2-D [T, K] with T a T_TILE multiple up to MAX_ROWS
    (pallas_q4k.supported_rows)."""
    if len(x_shape) != 2:
        return False
    t = x_shape[0]
    n, k = w.shape
    return (t > 1 and t % T_TILE == 0 and t <= MAX_ROWS and pick_subk(k) is not None
            and n % BN == 0 and w.packed.ndim == 2)


def supported_normed(x_shape: tuple[int, ...], w: Q4KWeight) -> bool:
    """Norm fusion needs the whole row in one K step (K in {512,1024,2048})."""
    n, k = w.shape
    return supported(x_shape, w) and pick_subk(k) == k


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_cuda_args(x: torch.Tensor, w: Q4KWeight, what: str, rows: int = 1) -> None:
    n, k = w.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x must be f32 or bf16, got {x.dtype}")
    if x.numel() != rows * k or not x.is_contiguous():
        raise ValueError(f"{what}: x must be {rows} contiguous row(s) of {k}, "
                         f"got {tuple(x.shape)}")
    if n % BN or k % 512 or k > MAX_K:
        raise ValueError(f"{what}: unsupported weight shape {(n, k)}")
    for name, t, dt in (("packed", w.packed, torch.uint8), ("sub_t", w.sub_t, torch.int8),
                        ("min_t", w.min_t, torch.int8), ("dd_t", w.dd_t, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dt} on {x.device}")
    if w.packed.data_ptr() % 16 or w.dd_t.data_ptr() % 8 or w.sub_t.data_ptr() % 2 \
            or w.min_t.data_ptr() % 2:
        raise ValueError(f"{what}: weight planes are not aligned for vector loads")


def q4k_matvec(x: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """x [..., K] (one row) @ dequant(w).T -> [..., N] in x's dtype: one
    launch that quantizes the row in every block's prologue; no scratch."""
    if not x.is_cuda:
        return q4k_matvec_ref(x, w)
    _check_cuda_args(x, w, "q4k_matvec")
    if any(p.data_ptr() % 16 for p in (x, w.sub_t, w.min_t, w.dd_t)):
        raise ValueError("q4k_matvec: x and the scale planes must be 16-byte aligned")
    n, k = w.shape
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().q4k_matvec_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.packed.data_ptr(), w.sub_t.data_ptr(),
        w.min_t.data_ptr(), w.dd_t.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16),
        n, k, stream,
    )
    _build.check(rc, "q4k_matvec")
    _build.count_launch(q4k_matvec)
    return out


def q4k_matvec_normed(x: torch.Tensor, w: Q4KWeight, norm_w: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """rms_norm(x, norm_w, eps) @ dequant(w).T in one launch that builds the
    normed bf16 row in every block's prologue; no scratch. Equal to
    `q4k_matvec(normed_row_kernel_order(x, norm_w, eps), w)` bit for bit."""
    if not x.is_cuda:
        return q4k_matvec_normed_ref(x, w, norm_w, eps)
    _check_cuda_args(x, w, "q4k_matvec_normed")
    n, k = w.shape
    if k > NORMED_MAX_K:
        raise ValueError(f"q4k_matvec_normed: K={k} exceeds one {NORMED_MAX_K}-wide step")
    norm_w = norm_w.reshape(k)
    if norm_w.dtype != torch.float32 or norm_w.device != x.device or not norm_w.is_contiguous():
        raise ValueError("q4k_matvec_normed: norm_w must be contiguous f32 on x's device")
    if any(p.data_ptr() % 16 for p in (x, norm_w, w.sub_t, w.min_t, w.dd_t)):
        raise ValueError("q4k_matvec_normed: x, norm_w and the scale planes must be 16-byte "
                         "aligned")
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().q4k_matvec_normed_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), norm_w.data_ptr(), float(eps),
        w.packed.data_ptr(), w.sub_t.data_ptr(), w.min_t.data_ptr(), w.dd_t.data_ptr(),
        out.data_ptr(), int(out.dtype == torch.bfloat16), n, k, stream,
    )
    _build.check(rc, "q4k_matvec_normed")
    _build.count_launch(q4k_matvec_normed)
    return out


def q4k_matmul_rows(x: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """x [T, K] @ dequant(w).T -> [T, N] in x's dtype (T % 8 == 0, T <= 64):
    each row as `q4k_matvec` computes it (the f32 sums over the groups in
    another order), one weight stream for all rows."""
    if not x.is_cuda:
        return q4k_matmul_rows_ref(x, w)
    if not supported_rows(tuple(x.shape), w):
        raise ValueError(f"q4k_matmul_rows: unsupported x {tuple(x.shape)} for weight {w.shape}")
    t = x.shape[0]
    _check_cuda_args(x, w, "q4k_matmul_rows", rows=t)
    if any(p.data_ptr() % 16 for p in (x, w.sub_t, w.min_t, w.dd_t)):
        raise ValueError("q4k_matmul_rows: x and the scale planes must be 16-byte aligned")
    n, k = w.shape
    xq = torch.empty(t * k, dtype=torch.int8, device=x.device)
    sxs = torch.empty((k // GROUP) * t * 2, dtype=torch.float32, device=x.device)
    out = torch.empty(t, n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().q4k_matmul_rows_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(), sxs.data_ptr(),
        w.packed.data_ptr(), w.sub_t.data_ptr(), w.min_t.data_ptr(), w.dd_t.data_ptr(),
        out.data_ptr(), int(out.dtype == torch.bfloat16), t, n, k, *rows_tiling(n, k), stream,
    )
    _build.check(rc, "q4k_matmul_rows")
    _build.count_launch(q4k_matmul_rows)
    return out


q4k_matvec.launches = 0
q4k_matvec_normed.launches = 0
q4k_matmul_rows.launches = 0
