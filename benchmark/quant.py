"""Weight codecs in plain PyTorch, on any device: the ggml q4_k and q6_k
block formats (encode, for the checkpoint writer; decode, for the
reference), and the port's int4 weight semantics that the reference works
out again from the checkpoint's values:

- `int4_group32`: group-32 asymmetric int4 with f32 scale and offset per
  group (the quantized encoder at "int4");
- `int4_factored`: the same integers with each group's scale and offset
  fitted to 6 bits against a per-256 f32 super-scale, as q4_k stores them
  (a non-q4_k matrix, the q6_k head, on the "int4" decoder).

The bit layouts follow the ggml spec; encodes use the simple min/max fit.
"""

from __future__ import annotations

import torch

QK = 256


def _f16_bytes(x: torch.Tensor) -> torch.Tensor:
    """[n, 1] f32 -> [n, 2] uint8 of its f16 rounding."""
    return x.to(torch.float16).contiguous().view(torch.uint8)


def _f16_from(b: torch.Tensor) -> torch.Tensor:
    """[n, 2] uint8 -> [n, 1] f32."""
    return b.contiguous().view(torch.float16).float()


def _inv(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, 1.0 / torch.where(x == 0, torch.ones_like(x), x),
                       torch.zeros_like(x))


def encode_q4_k(x: torch.Tensor) -> torch.Tensor:
    """[N, K] f32 (K % 256 == 0) -> uint8 [N, K // 256 * 144]."""
    n, k = x.shape
    sb = x.float().reshape(-1, 8, 32)
    xmin = torch.clamp(sb.amin(-1), max=0.0)
    xmax = torch.clamp(sb.amax(-1), min=0.0)
    scales, mins = (xmax - xmin) / 15.0, -xmin
    d = (scales.amax(-1, keepdim=True) / 63.0).to(torch.float16)
    dmin = (mins.amax(-1, keepdim=True) / 63.0).to(torch.float16)
    sc6 = torch.clamp(torch.round(scales * _inv(d.float())), 0, 63)
    mn6 = torch.clamp(torch.round(mins * _inv(dmin.float())), 0, 63)
    inv_sc = _inv(d.float() * sc6)
    q = torch.clamp(torch.round((sb + (dmin.float() * mn6)[..., None]) * inv_sc[..., None]),
                    0, 15).to(torch.uint8)
    qp = q.reshape(-1, 4, 2, 32)
    packed = (qp[:, :, 0] | (qp[:, :, 1] << 4)).reshape(-1, 128)
    sc, mn = sc6.to(torch.uint8), mn6.to(torch.uint8)
    scale_bytes = torch.cat([
        (sc[:, :4] & 0x3F) | ((sc[:, 4:] >> 4) << 6),
        (mn[:, :4] & 0x3F) | ((mn[:, 4:] >> 4) << 6),
        (sc[:, 4:] & 0x0F) | ((mn[:, 4:] & 0x0F) << 4),
    ], dim=-1)
    blocks = torch.cat([_f16_bytes(d.float()), _f16_bytes(dmin.float()), scale_bytes, packed], -1)
    return blocks.reshape(n, -1)


def decode_q4_k(b: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 [N, K // 256 * 144] -> f32 [N, K]."""
    n = b.shape[0]
    blk = b.reshape(-1, 144)
    d, dmin = _f16_from(blk[:, 0:2]), _f16_from(blk[:, 2:4])
    p = blk[:, 4:16]
    lo, mo, md = p[:, 0:4], p[:, 4:8], p[:, 8:12]
    sc = torch.cat([lo & 0x3F, (md & 0x0F) | ((lo >> 2) & 0x30)], -1).float()
    mn = torch.cat([mo & 0x3F, (md >> 4) | ((mo >> 2) & 0x30)], -1).float()
    qs = blk[:, 16:].reshape(-1, 4, 32)
    q = torch.stack([qs & 0x0F, qs >> 4], dim=2).reshape(-1, 8, 32).float()
    w = (d * sc)[..., None] * q - (dmin * mn)[..., None]
    return w.reshape(n, k)


def encode_q6_k(x: torch.Tensor) -> torch.Tensor:
    """[N, K] f32 (K % 256 == 0) -> uint8 [N, K // 256 * 210]."""
    n, k = x.shape
    sb = x.float().reshape(-1, 16, 16)
    gscale = sb.abs().amax(-1) / 31.0
    d = (gscale.amax(-1, keepdim=True) / 127.0).to(torch.float16)
    sc8 = torch.clamp(torch.round(gscale * _inv(d.float())), -128, 127)
    eff = d.float() * sc8
    inv_eff = torch.where(eff != 0, 1.0 / torch.where(eff == 0, torch.ones_like(eff), eff),
                          torch.zeros_like(eff))
    v = sb * inv_eff[..., None]
    v = torch.sign(v) * torch.floor(v.abs() + 0.5)  # ggml roundf: half away from zero
    q = torch.clamp(v + 32, 0, 63).to(torch.uint8).reshape(-1, QK)
    e = (q & 0x0F).reshape(-1, 2, 2, 64)
    ql = (e[:, :, 0] | (e[:, :, 1] << 4)).reshape(-1, 128)
    h = (q >> 4).reshape(-1, 2, 4, 32)
    qh = (h[:, :, 0] | (h[:, :, 1] << 2) | (h[:, :, 2] << 4) | (h[:, :, 3] << 6)).reshape(-1, 64)
    blocks = torch.cat([ql, qh, sc8.to(torch.int8).view(torch.uint8), _f16_bytes(d.float())], -1)
    return blocks.reshape(n, -1)


def decode_q6_k(b: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 [N, K // 256 * 210] -> f32 [N, K]."""
    n = b.shape[0]
    blk = b.reshape(-1, 210)
    qlg = blk[:, 0:128].reshape(-1, 2, 64)
    lo = torch.stack([qlg & 0x0F, qlg >> 4], dim=2).reshape(-1, QK)
    qhg = blk[:, 128:192].reshape(-1, 2, 32)
    hi = torch.stack([(qhg >> s) & 0x03 for s in (0, 2, 4, 6)], dim=2).reshape(-1, QK)
    q = (lo | (hi << 4)).float() - 32.0
    sc = blk[:, 192:208].contiguous().view(torch.int8).float()
    d = _f16_from(blk[:, 208:210])
    w = (d * sc)[..., None] * q.reshape(-1, 16, 16)
    return w.reshape(n, k)


def _group32_ints(w: torch.Tensor):
    """(q [N, G, 32], scale [N, G], offset [N, G]) of the group-32 fit:
    min and max clamped through 0, 16 levels."""
    n, k = w.shape
    g = w.float().reshape(n, k // 32, 32)
    gmin = torch.clamp(g.amin(-1), max=0.0)
    gmax = torch.clamp(g.amax(-1), min=0.0)
    scale = (gmax - gmin) / 15.0
    q = torch.clamp(torch.round((g - gmin[..., None]) * _inv(scale)[..., None]), 0, 15)
    return q, scale, -gmin


def int4_group32(w: torch.Tensor) -> torch.Tensor:
    """The values of a group-32 int4 weight with f32 scales: q * scale - offset."""
    q, scale, off = _group32_ints(w)
    return (q * scale[..., None] - off[..., None]).reshape(w.shape)


def int4_factored(w: torch.Tensor) -> torch.Tensor:
    """Group-32 int4 whose scales and offsets are then fitted to 6 bits
    against a per-256 super-scale (d = max / 63, round to nearest)."""
    q, scale, off = _group32_ints(w)
    n, g = scale.shape
    pad = (-g) % 8

    def fit(s):
        s = torch.nn.functional.pad(s, (0, pad)).reshape(n, -1, 8)
        sup = s.amax(-1, keepdim=True) / 63.0
        return (torch.clamp(torch.round(s * _inv(sup)), 0, 63) * sup).reshape(n, -1)[:, :g]

    return (q * fit(scale)[..., None] - fit(off)[..., None]).reshape(w.shape)

