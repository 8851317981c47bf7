"""Fused int8 SwiGLU MLP for one token: the plain version and the wrapper of
the CUDA kernel in `csrc/fused_mlp.cu`.

Counterpart of `qwen3_asr_gguf_tpu/ops/pallas_mlp.py`:
``y = (silu(x @ Wg.T) * (x @ Wu.T)) @ Wd.T`` with int8 weights, Wg/Wu
[M, D] with per-row scales sg/su [M] and Wd [D, M] with sd [D] (GGUF row
order). x is quantized per row as `ops.qtensor.int8_matmul` does (a DIVISION
by the scale, round half to even); the intermediate activation is quantized
again per tile of `tile_m` consecutive M rows, the tiles' down products are
scaled by their own s_act and added in tile order in f32, and sd multiplies
once at the end.

The wrapper runs its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .qtensor import int8_dot, quantize_rows_int8

TILE_M = 512
MAX_DIM = 32768  # the kernel stages D and M int8 values in shared memory


def quantize_act_tiles(act: torch.Tensor, tile_m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """act f32 [R, M] -> (int8 [R, M], s_act f32 [R, M // tile_m]): one scale
    per (row, tile of `tile_m` consecutive values)."""
    r, m = act.shape
    tiles = act.reshape(r, m // tile_m, tile_m)
    s_act = torch.clamp(tiles.abs().amax(dim=-1) / 127.0, min=1e-10)
    aq = torch.clamp(torch.round(tiles / s_act[..., None]), -127, 127).to(torch.int8)
    return aq.reshape(r, m), s_act


def mlp_act_ref(x, wg_q, sg, wu_q, su) -> torch.Tensor:
    """The first half of the plain version: act = silu(g) * u, f32 [R, M]."""
    xq, sx = quantize_rows_int8(x)
    g = int8_dot(xq, wg_q) * (sx * sg[None, :])
    u = int8_dot(xq, wu_q) * (sx * su[None, :])
    return (g * torch.sigmoid(g)) * u


def fused_mlp_matvec_ref(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m: int = TILE_M) -> torch.Tensor:
    """Plain version of `fused_mlp_matvec`: x [R, D] -> [R, D] in x's dtype."""
    m, d = wg_q.shape
    if m % tile_m:
        raise ValueError(f"fused_mlp_matvec: M={m} is not a multiple of tile_m={tile_m}")
    aq, s_act = quantize_act_tiles(mlp_act_ref(x, wg_q, sg, wu_q, su), tile_m)
    acc = torch.zeros(x.shape[0], d, dtype=torch.float32, device=x.device)
    for j in range(m // tile_m):  # tile order is part of the result
        cols = slice(j * tile_m, (j + 1) * tile_m)
        acc = acc + int8_dot(aq[:, cols], wd_q[:, cols]) * s_act[:, j: j + 1]
    return (acc * sd[None, :]).to(x.dtype)


def _check_cuda_args(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m: int) -> None:
    m, d = wg_q.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_mlp_matvec: x must be f32 or bf16, got {x.dtype}")
    if x.numel() != d or not x.is_contiguous():
        raise ValueError(f"fused_mlp_matvec: x must be one contiguous row of {d}, "
                         f"got {tuple(x.shape)}")
    if tuple(wu_q.shape) != (m, d) or tuple(wd_q.shape) != (d, m):
        raise ValueError(f"fused_mlp_matvec: weights must be [M, D], [M, D], [D, M]; got "
                         f"{tuple(wg_q.shape)}, {tuple(wu_q.shape)}, {tuple(wd_q.shape)}")
    if d % 16 or tile_m <= 0 or tile_m % 16 or m % tile_m or d > MAX_DIM or m > MAX_DIM:
        raise ValueError(f"fused_mlp_matvec: unsupported shape M={m}, D={d}, tile_m={tile_m}")
    for name, t, dt, numel in (("wg_q", wg_q, torch.int8, m * d), ("wu_q", wu_q, torch.int8, m * d),
                               ("wd_q", wd_q, torch.int8, m * d), ("sg", sg, torch.float32, m),
                               ("su", su, torch.float32, m), ("sd", sd, torch.float32, d)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous() or t.numel() != numel:
            raise ValueError(f"fused_mlp_matvec: {name} must be {numel} contiguous {dt} values "
                             f"on {x.device}")
    if wg_q.data_ptr() % 16 or wu_q.data_ptr() % 16 or wd_q.data_ptr() % 16:
        raise ValueError("fused_mlp_matvec: weights are not aligned for 16-byte loads")


def _launch(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, the kernel's f32 act scratch [M]) for a CUDA x."""
    _check_cuda_args(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m)
    m, d = wg_q.shape
    act = torch.empty(m, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.lib().fused_mlp_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wg_q.data_ptr(), sg.data_ptr(),
        wu_q.data_ptr(), su.data_ptr(), wd_q.data_ptr(), sd.data_ptr(), act.data_ptr(),
        out.data_ptr(), m, d, tile_m, stream,
    )
    _build.check(rc, "fused_mlp_matvec")
    _build.count_launch(fused_mlp_matvec)
    return out, act


def fused_mlp_matvec(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m: int = TILE_M) -> torch.Tensor:
    """x [1, D] -> [1, D] in x's dtype: the whole int8 MLP of one token, each
    weight read once."""
    if not x.is_cuda:
        return fused_mlp_matvec_ref(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m)
    return _launch(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m)[0]


fused_mlp_matvec.launches = 0
