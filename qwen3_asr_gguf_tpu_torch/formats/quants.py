"""ggml block-quantization formats, implemented from the format spec in NumPy.

Formats supported (enough to read/write the checkpoints the reference
pipeline produces — q4_k decoder GGUFs where 1-D tensors stay f32 and
token_embd/output may be q6_k):

==========  =========  ==========  ========================================
type        block      bytes/blk   layout
==========  =========  ==========  ========================================
F32/F16/BF16   1       4/2/2       raw
Q8_0           32      34          fp16 d | 32x int8
Q4_K           256     144         fp16 d | fp16 dmin | 12B 6-bit sc/min
                                   (8 sub-blocks of 32) | 128B packed 4-bit
Q6_K           256     210         128B ql | 64B qh | 16x int8 scales | fp16 d
==========  =========  ==========  ========================================

Semantics per sub-block g (Q4_K):   w = (d*sc[g]) * q - (dmin*m[g]),  q in [0,15]
Semantics per 16-group g (Q6_K):    w = d * sc[g] * (q - 32),         q in [0,63]

(Format reference: ggml-quants.c / the reference's NumPy oracle at
qwen_asr_gguf/export/gguf/quants.py:475-571 — used as a *test oracle*, the
implementation here is written independently from the byte-layout spec.)

Also defines the TPU-side repacking: `repack_q4k_for_tpu` converts the
interleaved superblock format into three dense planes (packed int4 values +
per-32-group effective scale/min), the layout the Pallas dequant-matmul
kernels consume directly from HBM.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

QK_K = 256  # superblock width
QK8_0 = 32

# GGML tensor-type ids (subset; matches the GGUF on-disk enum)
GGML_F32 = 0
GGML_F16 = 1
GGML_Q8_0 = 8
GGML_Q4_K = 12
GGML_Q6_K = 14
GGML_BF16 = 30

#: ggml type id -> (block_size, type_size_bytes)
QUANT_SIZES: dict[int, tuple[int, int]] = {
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_Q8_0: (32, 34),
    GGML_Q4_K: (256, 144),
    GGML_Q6_K: (256, 210),
    GGML_BF16: (1, 2),
}

TYPE_NAMES = {
    GGML_F32: "f32",
    GGML_F16: "f16",
    GGML_Q8_0: "q8_0",
    GGML_Q4_K: "q4_k",
    GGML_Q6_K: "q6_k",
    GGML_BF16: "bf16",
}
NAME_TO_TYPE = {v: k for k, v in TYPE_NAMES.items()}


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """Round half away from zero (ggml roundf semantics, not banker's)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


# --------------------------------------------------------------------------
# BF16
# --------------------------------------------------------------------------


def f32_to_bf16_bytes(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.float32).view(np.uint32)
    # round-to-nearest-even on the truncated mantissa
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return rounded.astype(np.uint16)


def bf16_bytes_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


# --------------------------------------------------------------------------
# Q8_0
# --------------------------------------------------------------------------


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """[..., K] f32 -> uint8 bytes [..., K//32 * 34]."""
    rows = x.reshape(-1, x.shape[-1]).astype(np.float32)
    n, k = rows.shape
    assert k % QK8_0 == 0, f"row size {k} not divisible by {QK8_0}"
    b = rows.reshape(n, k // QK8_0, QK8_0)
    amax = np.abs(b).max(axis=-1, keepdims=True)
    d = amax / 127.0
    inv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))
    q = _round_half_away(b * inv).astype(np.int8)
    d16 = d.astype(np.float16).view(np.uint8).reshape(n, -1, 2)
    out = np.concatenate([d16, q.view(np.uint8)], axis=-1)
    return out.reshape(*x.shape[:-1], -1)


def dequantize_q8_0(data: np.ndarray, out_shape: tuple[int, ...]) -> np.ndarray:
    from .. import native

    if native.available():
        return native.dequant_q8_0(np.asarray(data).view(np.uint8), out_shape)
    blocks = data.reshape(-1, 34)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    q = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (d * q).reshape(out_shape)


# --------------------------------------------------------------------------
# Q4_K
# --------------------------------------------------------------------------


def _pack_6bit_scales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Pack 8 6-bit scales + 8 6-bit mins per superblock into 12 bytes.

    Byte layout (j = sub-block index):
      bytes 0..3  : sc[j]&0x3F         | (sc[j+4]>>4)<<6
      bytes 4..7  : mn[j]&0x3F         | (mn[j+4]>>4)<<6
      bytes 8..11 : (sc[j+4]&0xF)      | (mn[j+4]&0xF)<<4
    """
    n = sc.shape[0]
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.zeros((n, 12), dtype=np.uint8)
    out[:, 0:4] = (sc[:, 0:4] & 0x3F) | ((sc[:, 4:8] >> 4) << 6)
    out[:, 4:8] = (mn[:, 0:4] & 0x3F) | ((mn[:, 4:8] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:8] & 0x0F) | ((mn[:, 4:8] & 0x0F) << 4)
    return out


def _unpack_6bit_scales(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of `_pack_6bit_scales`. packed: [n, 12] uint8 -> (sc, mn) [n, 8]."""
    p = packed.astype(np.uint8)
    d = p[:, 0:4]
    m = p[:, 4:8]
    md = p[:, 8:12]
    sc = np.concatenate([d & 0x3F, (md & 0x0F) | ((d >> 2) & 0x30)], axis=-1)
    mn = np.concatenate([m & 0x3F, (md >> 4) | ((m >> 2) & 0x30)], axis=-1)
    return sc, mn


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    """[..., K] f32 -> uint8 bytes [..., K//256 * 144].

    Uses the simple min/max fit per 32-wide sub-block followed by 6-bit
    quantization of the per-sub-block scales/mins against superblock-level
    fp16 super-scales (the llama.cpp reference additionally runs an iterative
    weighted search; this variant is format-identical and within ~1e-2
    relative RMSE of it).
    """
    from .. import native

    if x.shape[-1] % QK_K == 0 and native.available():
        return native.quantize_q4k(np.asarray(x, dtype=np.float32))
    rows = x.reshape(-1, x.shape[-1]).astype(np.float32)
    n, k = rows.shape
    assert k % QK_K == 0, f"row size {k} not divisible by {QK_K}"
    nb = n * (k // QK_K)
    sb = rows.reshape(nb, 8, 32)  # superblocks x sub-blocks x elems

    xmin = np.minimum(sb.min(axis=-1), 0.0)  # mins stored as positive offsets
    xmax = np.maximum(sb.max(axis=-1), 0.0)
    scales = (xmax - xmin) / 15.0  # [nb, 8]
    mins = -xmin  # >= 0

    # superblock super-scales, quantized to fp16
    d = scales.max(axis=-1, keepdims=True) / 63.0
    dmin = mins.max(axis=-1, keepdims=True) / 63.0
    d16 = d.astype(np.float16)
    dmin16 = dmin.astype(np.float16)
    d_eff = d16.astype(np.float32)
    dmin_eff = dmin16.astype(np.float32)

    inv_d = np.where(d_eff > 0, 1.0 / np.where(d_eff == 0, 1.0, d_eff), 0.0)
    inv_dmin = np.where(dmin_eff > 0, 1.0 / np.where(dmin_eff == 0, 1.0, dmin_eff), 0.0)
    sc6 = np.clip(np.rint(scales * inv_d), 0, 63).astype(np.uint8)
    mn6 = np.clip(np.rint(mins * inv_dmin), 0, 63).astype(np.uint8)

    sc_eff = d_eff * sc6  # [nb, 8]
    mn_eff = dmin_eff * mn6
    inv_sc = np.where(sc_eff > 0, 1.0 / np.where(sc_eff == 0, 1.0, sc_eff), 0.0)
    q = np.clip(np.rint((sb + mn_eff[..., None]) * inv_sc[..., None]), 0, 15).astype(np.uint8)

    # nibble packing: per 64-elem pair of sub-blocks, 32 bytes:
    # byte i = q[2j*32 + i] | q[(2j+1)*32 + i] << 4
    qp = q.reshape(nb, 4, 2, 32)
    packed = (qp[:, :, 0, :] | (qp[:, :, 1, :] << 4)).reshape(nb, 128)

    blocks = np.concatenate(
        [
            d16.view(np.uint8).reshape(nb, 2),
            dmin16.view(np.uint8).reshape(nb, 2),
            _pack_6bit_scales(sc6, mn6),
            packed,
        ],
        axis=-1,
    )
    return blocks.reshape(*x.shape[:-1], -1)


def dequantize_q4_k(data: np.ndarray, out_shape: tuple[int, ...]) -> np.ndarray:
    from .. import native

    if native.available():
        return native.dequant_q4k(np.asarray(data).view(np.uint8), out_shape)
    blocks = np.ascontiguousarray(data.reshape(-1, 144))
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)  # [nb,1]
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _unpack_6bit_scales(blocks[:, 4:16])
    qs = blocks[:, 16:144]

    low = qs & 0x0F
    high = qs >> 4
    # element order per 32-byte group: 32 low nibbles then 32 high nibbles
    q = np.stack([low.reshape(nb, 4, 32), high.reshape(nb, 4, 32)], axis=2)
    q = q.reshape(nb, 8, 32).astype(np.float32)

    w = (d * sc.astype(np.float32))[..., None] * q - (dmin * mn.astype(np.float32))[..., None]
    return w.reshape(out_shape)


# --------------------------------------------------------------------------
# Q6_K
# --------------------------------------------------------------------------


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    """[..., K] f32 -> uint8 bytes [..., K//256 * 210]."""
    rows = x.reshape(-1, x.shape[-1]).astype(np.float32)
    n, k = rows.shape
    assert k % QK_K == 0
    nb = n * (k // QK_K)
    sb = rows.reshape(nb, 16, 16)  # 16 groups of 16

    amax = np.abs(sb).max(axis=-1)  # [nb,16]
    gscale = amax / 31.0  # q-32 in [-32,31]; use 31 to keep symmetric headroom
    d = gscale.max(axis=-1, keepdims=True) / 127.0
    d16 = d.astype(np.float16)
    d_eff = d16.astype(np.float32)
    inv_d = np.where(d_eff > 0, 1.0 / np.where(d_eff == 0, 1.0, d_eff), 0.0)
    sc8 = np.clip(np.rint(gscale * inv_d), -128, 127).astype(np.int8)

    eff = d_eff * sc8.astype(np.float32)  # [nb,16]
    inv_eff = np.where(eff != 0, 1.0 / np.where(eff == 0, 1.0, eff), 0.0)
    q = np.clip(_round_half_away(sb * inv_eff[..., None]) + 32, 0, 63).astype(np.uint8)
    q = q.reshape(nb, QK_K)

    # split 6-bit values: low 4 bits -> ql (128B), high 2 bits -> qh (64B)
    ql4 = q & 0x0F
    qh2 = q >> 4
    # ql: per 64-byte group covers 128 elements (low nibbles = elems 0..63)
    e = ql4.reshape(nb, 2, 2, 64)
    ql = (e[:, :, 0, :] | (e[:, :, 1, :] << 4)).reshape(nb, 128)
    # qh: per 32-byte group covers 128 elements, 2 bits each at shifts 0/2/4/6
    h = qh2.reshape(nb, 2, 4, 32)
    qh = (h[:, :, 0, :] | (h[:, :, 1, :] << 2) | (h[:, :, 2, :] << 4) | (h[:, :, 3, :] << 6)).reshape(nb, 64)

    blocks = np.concatenate(
        [ql, qh, sc8.view(np.uint8), d16.view(np.uint8).reshape(nb, 2)], axis=-1
    )
    return blocks.reshape(*x.shape[:-1], -1)


def dequantize_q6_k(data: np.ndarray, out_shape: tuple[int, ...]) -> np.ndarray:
    from .. import native

    if native.available():
        return native.dequant_q6k(np.asarray(data).view(np.uint8), out_shape)
    blocks = np.ascontiguousarray(data.reshape(-1, 210))
    nb = blocks.shape[0]
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)

    qlg = ql.reshape(nb, 2, 64)  # [superblock, 128-elem group, byte]
    lo = np.stack([qlg & 0x0F, qlg >> 4], axis=2).reshape(nb, QK_K)
    qhg = qh.reshape(nb, 2, 32)
    hi = np.stack([(qhg >> s) & 0x03 for s in (0, 2, 4, 6)], axis=2)  # [sb, g, shift, byte]
    hi = hi.reshape(nb, QK_K)
    q = (lo | (hi << 4)).astype(np.int8) - np.int8(32)

    w = (d * sc).reshape(nb, 16, 1) * q.reshape(nb, 16, 16).astype(np.float32)
    return w.reshape(out_shape)


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------


def quantize(x: np.ndarray, ggml_type: int) -> np.ndarray:
    if ggml_type == GGML_F32:
        return x.astype(np.float32)
    if ggml_type == GGML_F16:
        return x.astype(np.float16)
    if ggml_type == GGML_BF16:
        return f32_to_bf16_bytes(x)
    if ggml_type == GGML_Q8_0:
        return quantize_q8_0(x)
    if ggml_type == GGML_Q4_K:
        return quantize_q4_k(x)
    if ggml_type == GGML_Q6_K:
        return quantize_q6_k(x)
    raise ValueError(f"unsupported ggml type {ggml_type}")


def dequantize(data: np.ndarray, ggml_type: int, out_shape: tuple[int, ...]) -> np.ndarray:
    if ggml_type == GGML_F32:
        return np.frombuffer(data.tobytes(), dtype=np.float32).reshape(out_shape).copy()
    if ggml_type == GGML_F16:
        return (
            np.frombuffer(data.tobytes(), dtype=np.float16).astype(np.float32).reshape(out_shape)
        )
    if ggml_type == GGML_BF16:
        return bf16_bytes_to_f32(np.frombuffer(data.tobytes(), dtype=np.uint16)).reshape(out_shape)
    if ggml_type == GGML_Q8_0:
        return dequantize_q8_0(np.asarray(data).view(np.uint8), out_shape)
    if ggml_type == GGML_Q4_K:
        return dequantize_q4_k(np.asarray(data).view(np.uint8), out_shape)
    if ggml_type == GGML_Q6_K:
        return dequantize_q6_k(np.asarray(data).view(np.uint8), out_shape)
    raise ValueError(f"unsupported ggml type {ggml_type}")


def byte_width(ggml_type: int, row_elems: int) -> int:
    block, size = QUANT_SIZES[ggml_type]
    if row_elems % block:
        raise ValueError(f"row of {row_elems} not divisible by block {block}")
    return row_elems // block * size


# --------------------------------------------------------------------------
# TPU repacking
# --------------------------------------------------------------------------


GROUP_Q4 = 32


def rank_major_perm(k_half: int) -> np.ndarray:
    """Column permutation applied per K-half at pack time.

    Natural order: element e = g*32 + rank (g = quant group, G groups per
    half). Rank-major order: position p = rank*G + g. Then the per-column
    scale pattern is [s0..s_{G-1}] tiled 32x — exactly what `pltpu.repeat`
    produces — so the Pallas kernel expands group scales with one cheap VPU
    repeat instead of one-hot matmuls. Returns perm with
    perm[p] = source element index of position p.
    """
    g = k_half // GROUP_Q4
    p = np.arange(k_half)
    return (p % g) * GROUP_Q4 + p // g


def rank_major_inverse(k_half: int) -> np.ndarray:
    """inv[e] = packed position of natural element e."""
    g = k_half // GROUP_Q4
    e = np.arange(k_half)
    return (e % GROUP_Q4) * g + e // GROUP_Q4


@dataclass
class PackedQ4:
    """TPU-friendly weight-only int4 layout (planar nibbles, rank-major).

    packed : uint8 [N, K//2]  — byte j of a row holds PERMUTED value j in
             its LOW nibble and permuted value j + K//2 in its HIGH nibble.
             Within each K-half, columns are rank-major permuted
             (see `rank_major_perm`): position p holds natural element
             (p % G)*32 + p//G  where G = K//64 groups per half.
    scale  : f32 [N, K//32]   — effective per-32-group scale (d * sc),
             NATURAL group order (first half's groups then second half's)
    minv   : f32 [N, K//32]   — effective per-32-group offset (dmin * m)

    Dequant of position p in half h: q * scale[n, h*G + p%G] - minv[...].
    """

    packed: np.ndarray
    scale: np.ndarray
    minv: np.ndarray
    shape: tuple[int, int]
    # Native q4_k factorization of scale/minv when the source had one
    # (scale = d * sc6, minv = dmin * mn6, 8 groups per superblock):
    # sc6/mn6 u8 [N, K//32], d/dmin f32 [N, K//256]. The Pallas matvec
    # layout streams THESE (2.5 B/group) instead of the expanded f32
    # planes (8 B/group) — see ops.pallas_q4k.pack_q4k_mxu.
    sc6: np.ndarray | None = None
    mn6: np.ndarray | None = None
    d: np.ndarray | None = None
    dmin: np.ndarray | None = None

    @property
    def nbytes(self) -> int:
        return self.packed.nbytes + self.scale.nbytes + self.minv.nbytes


def factorize_q4k_scales(
    scale: np.ndarray, minv: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fit expanded per-32-group planes to the q4_k 6-bit/superblock form:
    scale ~= d * sc6 with d = max(scale over 8 groups)/63 (exactly the
    ggml fit, quants spec above). Used for weights quantized directly from
    f32 (no native q4_k structure); adds <= d/2 scale error, the same
    rounding q4_k itself carries. Group count pads up to a superblock."""
    n, g = scale.shape
    s = -(-g // 8)
    pad = s * 8 - g
    if pad:
        scale = np.concatenate([scale, np.zeros((n, pad), scale.dtype)], axis=1)
        minv = np.concatenate([minv, np.zeros((n, pad), minv.dtype)], axis=1)
    sc_r = scale.reshape(n, s, 8).astype(np.float32)
    mn_r = minv.reshape(n, s, 8).astype(np.float32)
    d = sc_r.max(axis=-1) / 63.0
    dmin = mn_r.max(axis=-1) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1.0, dmin), 0.0)
    sc6 = np.clip(np.rint(sc_r * inv_d[..., None]), 0, 63).astype(np.uint8)
    mn6 = np.clip(np.rint(mn_r * inv_m[..., None]), 0, 63).astype(np.uint8)
    return sc6.reshape(n, s * 8)[:, :g], mn6.reshape(n, s * 8)[:, :g], d, dmin


def _q4k_raw_scales(
    q4k_bytes: np.ndarray, n: int, k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(sc6, mn6, d, dmin) straight out of the superblock bytes."""
    blocks = np.ascontiguousarray(q4k_bytes.reshape(-1, 144))
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(n, k // 256)
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(n, k // 256)
    sc, mn = _unpack_6bit_scales(blocks[:, 4:16])
    return sc.reshape(n, k // 32), mn.reshape(n, k // 32), d, dmin


def repack_q4_k(q4k_bytes: np.ndarray, shape: tuple[int, int]) -> PackedQ4:
    """Repack ggml Q4_K superblocks into dense TPU planes (no dequant loss)."""
    n, k = shape
    perm = rank_major_perm(k // 2)
    from .. import native

    if native.available() and k <= native.MAX_NATIVE_K:
        packed, scale, minv = native.repack_q4k(np.asarray(q4k_bytes).view(np.uint8), n, k)
        sc6, mn6, d, dmin = _q4k_raw_scales(np.asarray(q4k_bytes).view(np.uint8), n, k)
        return PackedQ4(
            packed=packed[:, perm], scale=scale, minv=minv, shape=(n, k),
            sc6=sc6, mn6=mn6, d=d, dmin=dmin,
        )
    blocks = np.ascontiguousarray(q4k_bytes.reshape(-1, 144))
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _unpack_6bit_scales(blocks[:, 4:16])
    qs = blocks[:, 16:144]

    scale = (d * sc.astype(np.float32)).reshape(n, k // 32)
    minv = (dmin * mn.astype(np.float32)).reshape(n, k // 32)

    low = qs & 0x0F
    high = qs >> 4
    q = np.stack([low.reshape(nb, 4, 32), high.reshape(nb, 4, 32)], axis=2)
    q = q.reshape(nb, 256).reshape(n, k)  # unpacked nibble values, natural order

    half = k // 2
    packed = (q[:, :half] | (q[:, half:] << 4)).astype(np.uint8)
    return PackedQ4(
        packed=packed[:, perm], scale=scale, minv=minv, shape=(n, k),
        sc6=sc.reshape(n, k // 32), mn6=mn.reshape(n, k // 32),
        d=d.reshape(n, k // 256), dmin=dmin.reshape(n, k // 256),
    )


def pack_q4_direct(w: np.ndarray, group: int = 32) -> PackedQ4:
    """Quantize f32 [N, K] directly into the TPU PackedQ4 layout.

    Equivalent fidelity path for weights that never existed as ggml Q4_K
    (e.g. int4 encoder weights, reference 04-Quantize-ASR-Encoder.py
    MatMulNBits block 128 — here group defaults to 32 to match q4_k).
    """
    n, k = w.shape
    perm = rank_major_perm(k // 2) if group == GROUP_Q4 and (k // 2) % GROUP_Q4 == 0 else None
    from .. import native

    if group == 32 and k % 64 == 0 and native.available() and k <= native.MAX_NATIVE_K:
        packed, scale, minv = native.pack_q4_direct(np.asarray(w, dtype=np.float32))
        if perm is not None:
            packed = packed[:, perm]
        sc6, mn6, d, dmin = factorize_q4k_scales(scale, minv)
        return PackedQ4(
            packed=packed, scale=scale, minv=minv, shape=(n, k),
            sc6=sc6, mn6=mn6, d=d, dmin=dmin,
        )
    if k % group != 0:
        raise ValueError(
            f"int4 packing needs the K dim divisible by {group} (got {w.shape});"
            " use precision=int8 or q4_k for this model shape"
        )
    g = w.reshape(n, k // group, group).astype(np.float32)
    gmin = np.minimum(g.min(axis=-1), 0.0)
    gmax = np.maximum(g.max(axis=-1), 0.0)
    scale = (gmax - gmin) / 15.0
    inv = np.where(scale > 0, 1.0 / np.where(scale == 0, 1.0, scale), 0.0)
    q = np.clip(np.rint((g - gmin[..., None]) * inv[..., None]), 0, 15).astype(np.uint8)
    q = q.reshape(n, k)
    half = k // 2
    packed = (q[:, :half] | (q[:, half:] << 4)).astype(np.uint8)
    if perm is not None:
        packed = packed[:, perm]
    sc6, mn6, d, dmin = factorize_q4k_scales(scale, -gmin)
    return PackedQ4(
        packed=packed, scale=scale, minv=-gmin, shape=(n, k),
        sc6=sc6, mn6=mn6, d=d, dmin=dmin,
    )


def is_rank_major(p: PackedQ4) -> bool:
    """True when the packed columns carry the rank-major permutation
    (always the case for GROUP_Q4-grouped weights on the kernel grid)."""
    n, k = p.shape
    return k // p.scale.shape[1] == GROUP_Q4 and (k // 2) % GROUP_Q4 == 0


def unpack_q4(p: PackedQ4) -> np.ndarray:
    """Reference dequant of PackedQ4 (oracle for the Pallas kernel)."""
    n, k = p.shape
    packed = p.packed
    if is_rank_major(p):
        packed = packed[:, rank_major_inverse(k // 2)]
    q = np.concatenate([packed & 0x0F, packed >> 4], axis=-1)
    group = k // p.scale.shape[1]
    qf = q.reshape(n, -1, group).astype(np.float32)
    w = qf * p.scale[..., None] - p.minv[..., None]
    return w.reshape(n, k)
