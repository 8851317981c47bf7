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
T rows (T % 8 == 0, T <= 64), streaming each weight once per 8 rows.

A wrapper runs its plain PyTorch version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats import quants as q

from . import _build

GROUP = 32  # q4_k quant group along K
BN = 512  # channel tile of the TPU kernel; `supported` keeps its conditions
T_TILE = 8  # activation rows per weight pass of the multi-row matmul
MAX_K = 12288  # the kernels stage a quantized activation row in shared memory


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
    """Multi-row matmul: 2-D [T, K] with T a T_TILE multiple up to 64
    (pallas_q4k.supported_rows)."""
    if len(x_shape) != 2:
        return False
    t = x_shape[0]
    n, k = w.shape
    return (t > 1 and t % T_TILE == 0 and t <= 64 and pick_subk(k) is not None
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


def _scratch(x: torch.Tensor, k: int, rows: int = 1):
    g = k // GROUP
    return (torch.empty(rows * k, dtype=torch.int8, device=x.device),
            torch.empty(rows * g, dtype=torch.float32, device=x.device),
            torch.empty(rows * g, dtype=torch.float32, device=x.device))


def q4k_matvec(x: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """x [..., K] (one row) @ dequant(w).T -> [..., N] in x's dtype."""
    if not x.is_cuda:
        return q4k_matvec_ref(x, w)
    _check_cuda_args(x, w, "q4k_matvec")
    n, k = w.shape
    xq, sx, xsum = _scratch(x, k)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().q4k_matvec_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(), sx.data_ptr(),
        xsum.data_ptr(), w.packed.data_ptr(), w.sub_t.data_ptr(), w.min_t.data_ptr(),
        w.dd_t.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16), n, k, stream,
    )
    _build.check(rc, "q4k_matvec")
    _build.count_launch(q4k_matvec)
    return out


def q4k_matvec_normed(x: torch.Tensor, w: Q4KWeight, norm_w: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """rms_norm(x, norm_w, eps) @ dequant(w).T in one kernel pair; equal to
    `q4k_matvec(rms_norm(x, norm_w, eps), w)` for bf16 x."""
    if not x.is_cuda:
        return q4k_matvec_normed_ref(x, w, norm_w, eps)
    _check_cuda_args(x, w, "q4k_matvec_normed")
    n, k = w.shape
    if k > 2048:
        raise ValueError(f"q4k_matvec_normed: K={k} exceeds one 2048-wide step")
    norm_w = norm_w.reshape(k)
    if norm_w.dtype != torch.float32 or norm_w.device != x.device or not norm_w.is_contiguous():
        raise ValueError("q4k_matvec_normed: norm_w must be contiguous f32 on x's device")
    xq, sx, xsum = _scratch(x, k)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().q4k_matvec_normed_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), norm_w.data_ptr(), float(eps),
        xq.data_ptr(), sx.data_ptr(), xsum.data_ptr(), w.packed.data_ptr(),
        w.sub_t.data_ptr(), w.min_t.data_ptr(), w.dd_t.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.bfloat16), n, k, stream,
    )
    _build.check(rc, "q4k_matvec_normed")
    _build.count_launch(q4k_matvec_normed)
    return out


def q4k_matmul_rows(x: torch.Tensor, w: Q4KWeight) -> torch.Tensor:
    """x [T, K] @ dequant(w).T -> [T, N] in x's dtype (T % 8 == 0, T <= 64):
    each row as `q4k_matvec` computes it, one weight stream per 8 rows."""
    if not x.is_cuda:
        return q4k_matmul_rows_ref(x, w)
    if not supported_rows(tuple(x.shape), w):
        raise ValueError(f"q4k_matmul_rows: unsupported x {tuple(x.shape)} for weight {w.shape}")
    t = x.shape[0]
    _check_cuda_args(x, w, "q4k_matmul_rows", rows=t)
    n, k = w.shape
    xq, sx, xsum = _scratch(x, k, rows=t)
    out = torch.empty(t, n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().q4k_matmul_rows_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(), sx.data_ptr(),
        xsum.data_ptr(), w.packed.data_ptr(), w.sub_t.data_ptr(), w.min_t.data_ptr(),
        w.dd_t.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16), t, n, k, stream,
    )
    _build.check(rc, "q4k_matmul_rows")
    _build.count_launch(q4k_matmul_rows)
    return out


q4k_matvec.launches = 0
q4k_matvec_normed.launches = 0
q4k_matmul_rows.launches = 0
