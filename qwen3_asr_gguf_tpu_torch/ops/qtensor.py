"""Quantized weight containers and matmul dispatch (counterpart of
`qwen3_asr_gguf_tpu/ops/qtensor.py`).

Convention: weights are [out_features, in_features] (GGUF row order) and
``matmul(x, w) == x @ dequant(w).T``. A `Q4KWeight` takes one row through the
q4_k matvec kernel where `supported`, and 8 to 64 rows (a multiple of 8)
through the multi-row kernel where `supported_rows`; an `Int8Weight` takes the
int8 x int8 product with per-row activation quantization (`int8_matmul`,
plain PyTorch as in the JAX package, which computes it outside any Pallas
kernel); everything else is a dequant followed by a dense matmul that
accumulates in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.quants import PackedQ4

from . import q4k


@dataclass
class Q4Weight:
    """Planar rank-major int4 (`formats.quants.PackedQ4` on the device)."""

    packed: torch.Tensor  # uint8 [N, K//2]
    scale: torch.Tensor  # f32 [N, K//32]
    minv: torch.Tensor  # f32 [N, K//32]

    @property
    def shape(self) -> tuple[int, int]:
        n, k2 = self.packed.shape
        return (n, k2 * 2)

    @classmethod
    def from_packed(cls, p: PackedQ4, device="cpu") -> "Q4Weight":
        return cls(
            packed=torch.from_numpy(np.ascontiguousarray(p.packed)).to(device),
            scale=torch.from_numpy(np.ascontiguousarray(p.scale, np.float32)).to(device),
            minv=torch.from_numpy(np.ascontiguousarray(p.minv, np.float32)).to(device),
        )


def dequant_q4(w: Q4Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [N, K] from the planar layout, undoing the rank-major permute."""
    n, k = w.shape
    group = k // w.scale.shape[1]
    low = w.packed & 0x0F
    high = w.packed >> 4
    if group == 32 and (k // 2) % 32 == 0:
        g_half = k // 64

        def unperm(h):
            return h.reshape(n, 32, g_half).transpose(1, 2).reshape(n, k // 2)

        low, high = unperm(low), unperm(high)
    qv = torch.cat([low, high], dim=-1)  # planar: [first half | second half]
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


def int8_matmul(x: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """x [..., K] @ dequant(w).T with dynamic per-row activation quantization."""
    xq, sx = quantize_rows_int8(x)
    # the int8 x int8 products are summed in f64: every partial sum is an
    # integer below 127 * 127 * K < 2**53, so the sum is exact at any K
    # (f32 holds integers only up to 2**24, which K = 2048 can pass), and it
    # rounds to f32 as the reference's int32 sum does. int32 matmul itself
    # has no CUDA kernel in PyTorch.
    y = torch.matmul(xq.double(), w.q.double().T).float()
    return (y * sx * w.scale).to(x.dtype)


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


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w.T -> [..., N]; w is Q4KWeight, Int8Weight, Q4Weight or
    dense [N, K]."""
    if isinstance(w, q4k.Q4KWeight):
        if q4k.supported(tuple(x.shape), w):
            return q4k.q4k_matvec(x, w)  # decode matvec: int4 stream, exact q4_k
        if q4k.supported_rows(tuple(x.shape), w):
            return q4k.q4k_matmul_rows(x, w)  # batched decode rows (serving)
        return dense_matmul(x, q4k.dequant_mxu(w, dtype=x.dtype))
    if isinstance(w, Int8Weight):
        return int8_matmul(x, w)
    if isinstance(w, Q4Weight):
        return dense_matmul(x, dequant_q4(w, dtype=x.dtype))
    return dense_matmul(x, w)


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
