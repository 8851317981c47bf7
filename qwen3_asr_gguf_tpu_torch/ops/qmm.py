"""Fused int4 dequant + matmul over the planar `Q4Weight` layout: the plain
versions and the wrapper of the CUDA kernel in `csrc/q4_matmul.cu`.

Counterpart of `qwen3_asr_gguf_tpu/ops/pallas_qmm.py`. The port keeps the
weight planar in NATURAL column order (`ops.qtensor.Q4Weight` undoes the
reference's rank-major column permutation once, when the weight is built, so
that a 32-group is 32 contiguous bytes; the dequantized values are bit-equal):

    packed : uint8 [N, K//2]  unsigned nibbles, planar: byte j holds element
             j of the FIRST half of K in its low nibble and element K//2 + j
             of the SECOND half in its high nibble; with g = K//64 groups per
             half, bytes 32*gi .. 32*gi + 31 are group gi (low nibbles) and
             group g + gi (high nibbles)
    scale  : f32 [N, K//32]   per 32-group scale, natural group order
    minv   : f32 [N, K//32]   per 32-group offset

and ``q4_matmul(x, w) == x @ (q*scale - minv).T``: the weight is dequantized
in f32, x is cast to f32, the sum is f32 and the result takes x's dtype. No
activation quantization. It serves at most `MAX_ROWS` activation rows (a
decode step's matvecs, a server's rows step, a short encoder input);
`ops.qtensor.matmul` keeps dequant + dense above that, as the reference does.

The kernel factors each group, sum_k x*(q - 8) on the tensor cores in bf16
(an f32 x as two bf16 planes) and the scale and offset per group in f32;
`q4_matmul_kernel_order` repeats that arithmetic step by step.

The wrapper runs its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from ._order import fma, sum_in_order

GROUP = 32  # quantization group along K
MAX_ROWS = 64  # above this the product is compute-bound: dequant once + dense
_REF_CHUNK = 16384  # channels per step of the plain version (bounds its f32 unpack)
WARPS = 8  # warps of a block: channel tiles of 16 times K slices
MIN_BLOCKS = 64  # blocks along N below which a block narrows
FILL_BLOCKS = 96  # blocks in all that a split of K makes up to


def _rows(x_shape: tuple[int, ...]) -> int:
    t = 1
    for s in x_shape[:-1]:
        t *= int(s)
    return t


def supported(x_shape: tuple[int, ...], w) -> bool:
    """Shapes the kernel takes: 2-D planes, groups of 32 and K a multiple of
    64 (whole groups in each half). Any N and any row count;
    `ops.qtensor.matmul` adds the row limit."""
    if w.packed.ndim != 2 or w.scale.ndim != 2:
        return False
    n, k = w.shape
    return (len(x_shape) >= 1 and x_shape[-1] == k and k % 64 == 0
            and w.scale.shape[1] * GROUP == k)


def q4_matmul_ref(x: torch.Tensor, w) -> torch.Tensor:
    """Plain version of `q4_matmul`: each nibble plane dequantized as
    q*s - m in f32 with the group's scale spread over its 32 columns, two
    f32 products (one per half of K) added."""
    n, k = w.shape
    if not supported(tuple(x.shape), w):
        raise ValueError(f"q4_matmul: unsupported x {tuple(x.shape)} for weight {(n, k)}")
    g = k // 64
    xf = x.reshape(-1, k).float()
    xlo, xhi = xf[:, : k // 2], xf[:, k // 2:]
    out = []
    for c0 in range(0, n, _REF_CHUNK):
        rows = slice(c0, min(n, c0 + _REF_CHUNK))
        packed = w.packed[rows]
        scale = w.scale[rows].repeat_interleave(GROUP, dim=1)
        minv = w.minv[rows].repeat_interleave(GROUP, dim=1)
        lo_w = (packed & 0x0F).float() * scale[:, : k // 2] - minv[:, : k // 2]
        hi_w = (packed >> 4).float() * scale[:, k // 2:] - minv[:, k // 2:]
        out.append(torch.matmul(xlo, lo_w.T) + torch.matmul(xhi, hi_w.T))
    return torch.cat(out, dim=1).reshape(*x.shape[:-1], n).to(x.dtype)


def tiling(t: int, n: int, k: int, planes: int = 1) -> tuple[int, int, int]:
    """(channel tiles of 16 per block, group pairs per K chunk, blocks that
    split K) of the kernel: 8 pairs per chunk (512 of K) while the chunk's x
    rows are at most 32 (bf16) or 16 (f32, two planes), else 4: x's chunk is
    part of a shared-memory stage. A cluster of up to 8 blocks splits the
    chunks. With 8 pairs a block is 4, 2 or 1 tiles wide (8 tiles would leave
    one block per SM), with 4 pairs 8, 4 or 2 (x's rows are read once for
    more channels; two planes of more than 32 rows fit 4). The widest block
    that still leaves `MIN_BLOCKS` blocks is taken, with the smallest split
    that reaches `FILL_BLOCKS`; a weight too small for that takes the
    largest split first, then the widest block."""
    t8 = -(-t // 8) * 8
    gcm = 8 if planes * t8 <= 32 else 4
    chunks = -(-(k // 64) // gcm)
    if gcm == 8:
        widths = (4, 2, 1)
    else:
        widths = (4, 2) if planes == 2 and t > 32 else (8, 4, 2)
    top = min(8, chunks)
    for pw in widths:
        blocks = -(-n // (16 * pw))
        if blocks >= MIN_BLOCKS:
            return pw, gcm, min(top, -(-FILL_BLOCKS // blocks))
    for pw in widths:
        if -(-n // (16 * pw)) * top >= MIN_BLOCKS:
            return pw, gcm, top
    return widths[-1], gcm, top


def split_planes(x: torch.Tensor) -> list[torch.Tensor]:
    """x as the f32 values of the bf16 planes the kernel multiplies: a bf16
    x itself; an f32 x as hi = bf16(x) and lo = bf16(x - hi)."""
    if x.dtype == torch.bfloat16:
        return [x.float()]
    xf = x.float()
    hi = xf.to(torch.bfloat16).float()
    return [hi, (xf - hi).to(torch.bfloat16).float()]


def q4_matmul_kernel_order(x: torch.Tensor, w) -> torch.Tensor:
    """`q4_matmul` step by step as the CUDA kernel computes it: per 32-group
    D = sum_k x*(q - 8) over x's bf16 planes (f32 sums; the tensor cores'
    order inside a group is not repeated), xsum the f32 sum of the group's
    plane values in the kernel's order, then per K slice of each block
    (`tiling`), over the chunks' group pairs in order, low half then high
    half, acc = fma(8s - m, xsum, fma(s, D, acc)); the slices added in order,
    then the blocks that split K in order."""
    n, k = w.shape
    if not supported(tuple(x.shape), w):
        raise ValueError(f"q4_matmul: unsupported x {tuple(x.shape)} for weight {(n, k)}")
    g = k // 64
    planes = [p.reshape(-1, k) for p in split_planes(x)]
    t = planes[0].shape[0]
    pw, gcm, ks = tiling(t, n, k, len(planes))
    k_slices = WARPS // pw
    per_block = -(-(-(-g // gcm)) // ks)  # chunks of a block of the cluster (the last may get fewer)
    q = torch.cat([w.packed & 0x0F, w.packed >> 4], dim=1).float() - 8.0  # [N, K] natural
    qg = q.reshape(n, 2 * g, GROUP)
    dots = torch.zeros(t, n, 2 * g)
    xsum = torch.zeros(t, 2 * g)
    for p in planes:
        dots = dots + torch.einsum("ngk,tgk->tng", qg, p.reshape(t, 2 * g, GROUP))
    if t <= 16:  # eight lanes of four values (plane after plane), then three butterfly steps
        lanes = torch.zeros(t, 2 * g, 8)
        for p in planes:
            for e in range(4):
                lanes = lanes + p.reshape(t, 2 * g, 8, 4)[..., e]
        for _ in range(3):
            lanes = lanes[..., 0::2] + lanes[..., 1::2]
        xsum = lanes[..., 0]
    else:  # one thread per sum: the group's values of plane after plane, in order
        for p in planes:
            for e in range(GROUP):
                xsum = xsum + p.reshape(t, 2 * g, GROUP)[:, :, e]
    offs = fma(torch.full_like(w.scale, 8.0), w.scale, -w.minv)  # [N, 2g]
    parts = [[torch.zeros(t, n) for _ in range(k_slices)] for _ in range(ks)]
    for gi in range(g):
        mine = parts[gi // gcm // per_block]
        s = (gi % gcm) % k_slices
        for grp in (gi, g + gi):
            acc = fma(w.scale[None, :, grp], dots[:, :, grp], mine[s])
            mine[s] = fma(offs[None, :, grp], xsum[:, grp, None], acc)
    out = sum_in_order([sum_in_order(mine) for mine in parts])
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


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
    if w.packed.data_ptr() % 16 or w.scale.data_ptr() % 16 or w.minv.data_ptr() % 16:
        raise ValueError("q4_matmul: weight planes are not aligned for 16-byte copies")
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
    if x.data_ptr() % 16:  # a view at an odd offset: the kernel copies 16 bytes at a time
        x = x.clone()
    bf16 = x.dtype == torch.bfloat16
    # an f32 x goes through the tensor cores as two bf16 planes
    planes = None if bf16 else torch.empty(2 * t * k, dtype=torch.bfloat16, device=x.device)
    pw, gcm, ks = tiling(t, n, k, 1 if bf16 else 2)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().q4_matmul_launch(
        x.data_ptr(), int(bf16), None if bf16 else planes.data_ptr(), w.packed.data_ptr(),
        w.scale.data_ptr(), w.minv.data_ptr(), out.data_ptr(), t, n, k, pw, gcm, ks, stream,
    )
    _build.check(rc, "q4_matmul")
    _build.count_launch(q4_matmul)
    return out


q4_matmul.launches = 0
