"""Fused int4 dequant + matmul over the planar `Q4Weight` layout: the plain
version and the wrapper of the CUDA kernel in `csrc/q4_matmul.cu`.

Counterpart of `qwen3_asr_gguf_tpu/ops/pallas_qmm.py`. The weight keeps the
reference's layout (`ops.qtensor.Q4Weight`, so weights carry across
unchanged):

    packed : uint8 [N, K//2]  unsigned nibbles, planar and rank-major: with
             g = K//64 groups per half, column c = r*g + gi holds natural
             index gi*32 + r of the FIRST half of K in its low nibble and of
             the SECOND half in its high nibble
    scale  : f32 [N, K//32]   per 32-group scale; column c dequantizes with
             scale[n, c % g] (low) and scale[n, g + c % g] (high)
    minv   : f32 [N, K//32]   per 32-group offset

and ``q4_matmul(x, w) == x @ (q*scale - minv).T``: the weight is dequantized
in f32, x is cast to f32, the sum is f32 and the result takes x's dtype. No
activation quantization. It serves at most `MAX_ROWS` activation rows (a
decode step's matvecs, a short encoder input); `ops.qtensor.matmul` keeps
dequant + dense above that, as the reference does.

The wrapper runs its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

GROUP = 32  # quantization group along K
MAX_ROWS = 64  # above this the product is compute-bound: dequant once + dense
_REF_CHUNK = 16384  # channels per step of the plain version (bounds its f32 unpack)


def _rows(x_shape: tuple[int, ...]) -> int:
    t = 1
    for s in x_shape[:-1]:
        t *= int(s)
    return t


def supported(x_shape: tuple[int, ...], w) -> bool:
    """Shapes the kernel takes: 2-D planes, groups of 32 and K a multiple of
    64 (whole groups in each half, which is also what the rank-major packing
    needs). Any N and any row count; `ops.qtensor.matmul` adds the row
    limit."""
    if w.packed.ndim != 2 or w.scale.ndim != 2:
        return False
    n, k = w.shape
    return (len(x_shape) >= 1 and x_shape[-1] == k and k % 64 == 0
            and w.scale.shape[1] * GROUP == k)


def _perm(xh: torch.Tensor, g: int) -> torch.Tensor:
    """natural -> rank-major columns of one half of x: [T, g*32] -> [T, 32*g]."""
    t = xh.shape[0]
    return xh.reshape(t, g, GROUP).transpose(1, 2).reshape(t, g * GROUP)


def q4_matmul_ref(x: torch.Tensor, w) -> torch.Tensor:
    """Plain version of `q4_matmul`, step by step as the kernel computes:
    x's halves permuted to the packed column order, each nibble plane
    dequantized as q*s - m in f32 with the scale row tiled across the ranks,
    two f32 products added."""
    n, k = w.shape
    if not supported(tuple(x.shape), w):
        raise ValueError(f"q4_matmul: unsupported x {tuple(x.shape)} for weight {(n, k)}")
    g = k // 64
    xf = x.reshape(-1, k).float()
    xlo, xhi = _perm(xf[:, : k // 2], g), _perm(xf[:, k // 2:], g)
    out = []
    for c0 in range(0, n, _REF_CHUNK):
        rows = slice(c0, min(n, c0 + _REF_CHUNK))
        packed = w.packed[rows]
        scale, minv = w.scale[rows], w.minv[rows]
        lo_w = (packed & 0x0F).float() * scale[:, :g].repeat(1, GROUP) - minv[:, :g].repeat(1, GROUP)
        hi_w = (packed >> 4).float() * scale[:, g:].repeat(1, GROUP) - minv[:, g:].repeat(1, GROUP)
        out.append(torch.matmul(xlo, lo_w.T) + torch.matmul(xhi, hi_w.T))
    return torch.cat(out, dim=1).reshape(*x.shape[:-1], n).to(x.dtype)


def _check_cuda_args(x: torch.Tensor, w) -> None:
    n, k = w.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q4_matmul: x must be f32 or bf16, got {x.dtype}")
    if not supported(tuple(x.shape), w):
        raise ValueError(f"q4_matmul: unsupported x {tuple(x.shape)} for weight {(n, k)}")
    if _rows(tuple(x.shape)) > MAX_ROWS:
        raise ValueError(f"q4_matmul: {_rows(tuple(x.shape))} rows, the kernel takes at most "
                         f"{MAX_ROWS}")
    if not x.is_contiguous():
        raise ValueError("q4_matmul: x must be contiguous")
    for name, t, dt in (("packed", w.packed, torch.uint8), ("scale", w.scale, torch.float32),
                        ("minv", w.minv, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"q4_matmul: {name} must be contiguous {dt} on {x.device}")
    if w.packed.data_ptr() % 4 or w.scale.data_ptr() % 16 or w.minv.data_ptr() % 16:
        raise ValueError("q4_matmul: weight planes are not aligned for vector loads")
    if w.minv.shape != w.scale.shape or w.scale.shape[0] != n:
        raise ValueError("q4_matmul: scale and minv must both be [N, K//32]")


def q4_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] (at most `MAX_ROWS` rows in all) @ dequant(w).T -> [..., N]
    in x's dtype."""
    if not x.is_cuda:
        return q4_matmul_ref(x, w)
    _check_cuda_args(x, w)
    n, k = w.shape
    t = _rows(tuple(x.shape))
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().q4_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.packed.data_ptr(), w.scale.data_ptr(),
        w.minv.data_ptr(), out.data_ptr(), t, n, k, stream,
    )
    _build.check(rc, "q4_matmul")
    _build.count_launch(q4_matmul)
    return out


q4_matmul.launches = 0
