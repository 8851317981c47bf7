"""ggml's q4_0 block format in plain PyTorch, on any device: 32 weights to a
block, an f16 scale d and 16 bytes of nibbles (18 bytes; byte j holds
element j in its low nibble and element j + 16 in its high nibble; a weight
is (q - 8) * d). The sparse-expert checkpoints keep their experts in it.

Importing this module adds the type to `gguf.BLOCK`, so that the
benchmark's GGUF writer and reader size q4_0 tensors.
"""

from __future__ import annotations

import torch

from . import gguf

Q4_0 = 2
QK = 32
BLOCK_BYTES = 18

gguf.BLOCK.setdefault(Q4_0, (QK, BLOCK_BYTES))


def encode_q4_0(x: torch.Tensor) -> torch.Tensor:
    """[..., K] f32 (K % 32 == 0) -> uint8 [..., K // 32 * 18], as ggml's
    reference quantizer: d = v / -8 for the value v of largest magnitude,
    q = min(15, trunc(x / d + 8.5))."""
    lead, k = x.shape[:-1], x.shape[-1]
    b = x.float().reshape(-1, QK)
    vmax = b.gather(1, b.abs().argmax(1, keepdim=True))[:, 0]
    d = vmax / -8.0
    inv = torch.where(d != 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                      torch.zeros_like(d))
    q = torch.clamp((b * inv[:, None] + 8.5).to(torch.int8), max=15).to(torch.uint8)
    qs = q[:, :16] | (q[:, 16:] << 4)
    out = torch.cat([d.to(torch.float16).view(torch.uint8).reshape(-1, 2), qs], dim=1)
    return out.reshape(*lead, k // QK * BLOCK_BYTES)


def decode_q4_0(blocks: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 [..., K // 32 * 18] -> f32 [..., K]."""
    lead = blocks.shape[:-1]
    blk = blocks.reshape(-1, BLOCK_BYTES)
    d = blk[:, :2].contiguous().view(torch.float16).float()
    qs = blk[:, 2:]
    q = torch.cat([qs & 0x0F, qs >> 4], dim=1).float() - 8.0
    return (q * d).reshape(*lead, k)
