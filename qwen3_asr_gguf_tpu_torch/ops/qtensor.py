"""Quantized weight containers and matmul dispatch (counterpart of
`qwen3_asr_gguf_tpu/ops/qtensor.py`).

Convention: weights are [out_features, in_features] (GGUF row order) and
``matmul(x, w) == x @ dequant(w).T``. A `Q4KWeight` takes one row through the
q4_k matvec kernel where `supported`, and 8 to 64 rows (a multiple of 8)
through the multi-row kernel where `supported_rows`; a `Q4Weight` takes at
most 64 rows through the fused dequant + matmul kernel (`ops.qmm.q4_matmul`)
when x is on the card, as the JAX package does on the TPU, and dequant + dense
otherwise; an `Int8Weight` takes the int8 x int8 product with per-row
activation quantization (`int8_matmul`, plain PyTorch as in the JAX package,
which computes it outside any Pallas kernel); everything else is a dequant
followed by a dense matmul that accumulates in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.quants import GROUP_Q4, PackedQ4, rank_major_inverse

from . import q4k, qmm


@dataclass
class Q4Weight:
    """Planar int4 (`formats.quants.PackedQ4` on the device) in NATURAL column
    order: byte j of `packed` holds element j of the first half of K in its
    low nibble and element K//2 + j in its high nibble. The reference packs
    group-32 weights rank-major (column r*G + g holds element g*32 + r);
    `from_reference` undoes that once, on the host, so that a 32-group is 32
    contiguous bytes for the kernel. Scales and offsets are untouched and the
    dequantized values are bit-equal."""

    packed: torch.Tensor  # uint8 [N, K//2]
    scale: torch.Tensor  # f32 [N, K//32]
    minv: torch.Tensor  # f32 [N, K//32]

    @property
    def shape(self) -> tuple[int, int]:
        n, k2 = self.packed.shape
        return (n, k2 * 2)

    @classmethod
    def from_reference(cls, packed, scale, minv, device="cpu") -> "Q4Weight":
        """The reference's planes (numpy; `packed` rank-major where the group
        is 32 and each half of K holds whole groups, as `is_rank_major`
        says) as a port weight."""
        packed = np.asarray(packed)
        k2 = packed.shape[-1]
        if 2 * k2 // np.asarray(scale).shape[-1] == GROUP_Q4 and k2 % GROUP_Q4 == 0:
            packed = packed[..., rank_major_inverse(k2)]
        return cls(
            packed=torch.from_numpy(np.ascontiguousarray(packed, np.uint8)).to(device),
            scale=torch.from_numpy(np.ascontiguousarray(scale, np.float32)).to(device),
            minv=torch.from_numpy(np.ascontiguousarray(minv, np.float32)).to(device),
        )

    @classmethod
    def from_packed(cls, p: PackedQ4, device="cpu") -> "Q4Weight":
        return cls.from_reference(p.packed, p.scale, p.minv, device=device)


def dequant_q4(w: Q4Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [N, K] from the planar layout: q*scale - minv in f32, then
    `dtype`."""
    n, k = w.shape
    group = k // w.scale.shape[1]
    qv = torch.cat([w.packed & 0x0F, w.packed >> 4], dim=-1)  # [first half | second half]
    qf = qv.reshape(n, -1, group).float()
    dense = qf * w.scale[..., None] - w.minv[..., None]
    return dense.reshape(n, k).to(dtype)


@dataclass
class Int8Weight:
    """Per-output-channel symmetric int8 weight: activations are quantized
    per row at the call and both scales apply after the integer product."""

    q: torch.Tensor  # int8 [N, K]
    scale: torch.Tensor  # f32 [N]

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.q.shape[-2:])  # type: ignore[return-value]


def dequant_int8(w: Int8Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [N, K]: q * scale in f32, then `dtype`."""
    return (w.q.float() * w.scale[..., None]).to(dtype)


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] -> (int8 values, f32 scale [..., 1]), one scale per row. The
    int8s come from a DIVISION by the scale (the q4_k kernels multiply by its
    reciprocal; the two differ at .5 boundaries)."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-10)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


INT_MM_MIN_ROWS = 32  # torch._int_mm wants more than 16 rows; pad to whole 8-row tiles


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [..., K] x int8 [N, K] -> the exact integer sums, as f32
    [..., N] (rounded as the reference's int32 -> f32 cast rounds).

    On the CPU the products are summed in f64: every partial sum is an
    integer below 127 * 127 * K < 2**53, so the sum is exact at any K (f32
    holds integers only up to 2**24, which K = 2048 can pass). On the card
    that route converts the whole weight to f64 at every call (17 bytes moved
    per weight element), so there the product is one `torch._int_mm` (int8 x
    int8 -> int32 on the tensor cores, exact below 2**31, i.e. K < 133,000):
    it needs more than 16 rows and K and N multiples of 8, so the rows are
    zero-padded to at least 32 and other shapes keep the f64 route. Held bit
    for bit to the f64 route on an H100 up to the 1.7B LM head (N = 151,936;
    `tests/test_torch_cuda.py`)."""
    n, k = wq.shape
    if xq.is_cuda and k % 8 == 0 and n % 8 == 0 and 127 * 127 * k < 2 ** 31:
        rows = xq.reshape(-1, k)
        t = rows.shape[0]
        padded = max(INT_MM_MIN_ROWS, (t + 7) // 8 * 8)
        if padded != t:
            rows = torch.cat([rows, rows.new_zeros(padded - t, k)])
        y = torch._int_mm(rows.contiguous(), wq.contiguous().T)[:t]
        return y.float().reshape(*xq.shape[:-1], n)
    return torch.matmul(xq.double(), wq.double().T).float()


def int8_matmul(x: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """x [..., K] @ dequant(w).T with dynamic per-row activation quantization."""
    xq, sx = quantize_rows_int8(x)
    return (int8_dot(xq, w.q) * sx * w.scale).to(x.dtype)


def to_int8(w) -> Int8Weight:
    """A `Q4Weight` or a dense [N, K] tensor as per-channel int8."""
    dense = dequant_q4(w, dtype=torch.float32) if isinstance(w, Q4Weight) else w.float()
    scale = torch.clamp(dense.abs().amax(dim=-1) / 127.0, min=1e-10)
    q = torch.clamp(torch.round(dense / scale[:, None]), -127, 127).to(torch.int8)
    return Int8Weight(q=q, scale=scale)


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w[N, K].T with an f32 accumulate, result in x's dtype.
    On the card a same-dtype product is one cuBLAS call (it accumulates in
    f32); elsewhere the operands are widened to f32 first."""
    if x.is_cuda and x.dtype == w.dtype:
        return torch.matmul(x, w.T)
    return torch.matmul(x.float(), w.float().T).to(x.dtype)


def _q4_kernel_route(x: torch.Tensor) -> bool:
    """Whether a `Q4Weight` product of at most `qmm.MAX_ROWS` rows goes to
    the fused kernel: on the card it does, as on the TPU in the JAX package;
    on the CPU both packages take dequant + dense (the committed goldens come
    from that side). Tests replace this to put the kernel's plain version
    into the dispatch."""
    return x.is_cuda


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w.T -> [..., N]; w is Q4KWeight, Int8Weight, Q4Weight or
    dense [N, K]. The kernels read x as dense rows: a strided x (the
    encoder's conv features are a view) is copied first."""
    if isinstance(w, q4k.Q4KWeight):
        if q4k.supported(tuple(x.shape), w):
            return q4k.q4k_matvec(x.contiguous(), w)  # decode matvec: int4 stream, exact q4_k
        if q4k.supported_rows(tuple(x.shape), w):
            return q4k.q4k_matmul_rows(x.contiguous(), w)  # batched decode rows (serving)
        return dense_matmul(x, q4k.dequant_mxu(w, dtype=x.dtype))
    if isinstance(w, Int8Weight):
        return int8_matmul(x, w)
    if isinstance(w, Q4Weight):
        shape = tuple(x.shape)
        if (_q4_kernel_route(x) and qmm.supported(shape, w)
                and x.numel() // shape[-1] <= qmm.MAX_ROWS):
            return qmm.q4_matmul(x.contiguous(), w)  # decode matvecs, short encoder inputs
        return dense_matmul(x, dequant_q4(w, dtype=x.dtype))  # compute-bound: dequant once
    return dense_matmul(x, w)


def kernel_rows(w, rows: int) -> int:
    """Activation rows at which a product of `w` with `rows` rows runs on
    the card's kernel: a `Q4KWeight` takes whole `q4k.T_TILE`-row tiles up
    to `q4k.MAX_ROWS` (`q4k.supported_rows`), so `rows` rounds up to a
    tile; a `Q4Weight` takes at most `qmm.MAX_ROWS`. Raises ValueError
    above the limit, where `matmul` would dequantize the weight per call.
    Other weights take any count."""
    if isinstance(w, q4k.Q4KWeight):
        limit, t = q4k.MAX_ROWS, -(-rows // q4k.T_TILE) * q4k.T_TILE
    elif isinstance(w, Q4Weight):
        limit, t = qmm.MAX_ROWS, rows
    else:
        return rows
    if t > limit:
        raise ValueError(f"{rows} rows exceed {limit}, the most rows the "
                         f"{type(w).__name__} kernel takes")
    return t


def matmul_normed(x: torch.Tensor, w, norm_w: torch.Tensor, eps: float) -> torch.Tensor:
    """rms_norm(x, norm_w, eps) @ w.T, with the norm fused into the q4_k
    matvec kernel where it applies; otherwise norm then `matmul`."""
    from ..models.decoder import rms_norm

    if isinstance(w, q4k.Q4KWeight) and q4k.supported_normed(tuple(x.shape), w):
        return q4k.q4k_matvec_normed(x, w, norm_w, eps)
    return matmul(rms_norm(x, norm_w, eps), w)


def dequant_q6k_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """ggml Q6_K block dequant on the device (blocks [nb, 210] uint8 ->
    f32 [nb, 256]); counterpart of qtensor._dequant_q6k_blocks."""
    nb = blocks.shape[0]
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].contiguous().view(torch.int8).float()
    d = blocks[:, 208:210].contiguous().view(torch.float16).float()  # [nb, 1]

    qlg = ql.reshape(nb, 2, 1, 64)
    lo = torch.cat([qlg & 0x0F, qlg >> 4], dim=2).reshape(nb, 256)
    qhg = qh.reshape(nb, 2, 1, 32)
    hi = torch.cat([(qhg >> s) & 0x03 for s in (0, 2, 4, 6)], dim=2).reshape(nb, 256)
    qv = (lo | (hi << 4)).to(torch.int32) - 32
    w = (d * sc).reshape(nb, 16, 1) * qv.reshape(nb, 16, 16).float()
    return w.reshape(nb, 256)


def dequant_q6k(blocks_u8: np.ndarray, shape: tuple[int, ...], dtype=torch.bfloat16,
                device="cpu") -> torch.Tensor:
    # a writable host copy: the blocks are usually a read-only mmap of the GGUF
    blocks = torch.from_numpy(np.array(blocks_u8, np.uint8).reshape(-1, 210)).to(device)
    return dequant_q6k_blocks(blocks).reshape(shape).to(dtype)
