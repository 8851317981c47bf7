"""ggml's q4_0 block format: 32 weights to a block, an f16 scale `d` and
16 bytes of nibbles, 18 bytes in all (4.5 bits a weight, the int4 byte
budget). Byte j of a block holds element j in its low nibble and element
j + 16 in its high nibble; a weight is (q - 8) * d.

The sparse-expert decoders keep their expert matrices in it: an expert's
width (1,408 in Moonlight-16B-A3B) is a whole number of 32-blocks but not
of q4_k's 256-superblocks. `formats/quants.py` is a verbatim copy of the
JAX package's, which has no q4_0, so importing this module adds the type to
that module's tables (the GGUF reader then sizes q4_0 tensors); the codec
is here.
"""

from __future__ import annotations

import numpy as np

from . import quants

GGML_Q4_0 = 2
QK4_0 = 32
BLOCK_BYTES = 18

quants.QUANT_SIZES.setdefault(GGML_Q4_0, (QK4_0, BLOCK_BYTES))
quants.TYPE_NAMES.setdefault(GGML_Q4_0, "q4_0")
quants.NAME_TO_TYPE.setdefault("q4_0", GGML_Q4_0)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    """[..., K] f32 (K % 32 == 0) -> uint8 [..., K // 32 * 18], as ggml's
    reference quantizer: d = v / -8 for the value v of largest magnitude,
    q = min(15, trunc(x / d + 8.5))."""
    x = np.asarray(x, dtype=np.float32)
    lead, k = x.shape[:-1], x.shape[-1]
    b = x.reshape(-1, QK4_0)
    idx = np.abs(b).argmax(axis=1)
    vmax = b[np.arange(len(b)), idx]
    d = vmax / -8.0
    inv = np.divide(1.0, d, out=np.zeros_like(d), where=d != 0)
    q = np.minimum(15, (b * inv[:, None] + 8.5).astype(np.int8)).astype(np.uint8)
    qs = q[:, :16] | (q[:, 16:] << 4)
    out = np.concatenate([d.astype(np.float16).view(np.uint8).reshape(-1, 2), qs], axis=1)
    return out.reshape(*lead, k // QK4_0 * BLOCK_BYTES)


def dequantize_q4_0(data: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """uint8 q4_0 blocks -> f32 of `shape`."""
    blk = np.asarray(data, dtype=np.uint8).reshape(-1, BLOCK_BYTES)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blk[:, 2:]
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).astype(np.float32) - 8.0
    return (q * d).reshape(shape)
