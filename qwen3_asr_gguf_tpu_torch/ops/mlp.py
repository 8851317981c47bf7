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

from dataclasses import dataclass

import torch

from . import _build
from .qtensor import int8_dot, quantize_rows_int8

TILE_M = 512
# What csrc/fused_mlp.cu compiles in: each lane keeps x's int8s and its
# rows' 16-byte pieces in registers (at most 4 x 16 bytes of a row, so
# D <= 2048) and 16 act values of a tile (tile_m a power of two, at most
# 512); one thread per slab row reads its sd (at most 512 rows); a block
# asks for at most SMEM_BUDGET bytes of dynamic shared memory; the wrapper's
# counter buffer holds COUNTERS uint32 (rows out, blocks past the barrier).
MAX_D = 2048
MAX_TILE = 512
MAX_SLAB_ROWS = 512
SMEM_BUDGET = 226 * 1024
COUNTERS = 2


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _layout_bytes(m: int, d: int, n_tiles: int, slab_rows: int) -> int:
    """Dynamic shared memory of a block (`Layout` in csrc/fused_mlp.cu): the
    Wd slab, the quantized acts, the quantized x, the tiles' scales, the
    slab rows' per-tile int32 dots."""
    return (_up16(slab_rows * m) + _up16(m) + _up16(d) + _up16(4 * n_tiles)
            + _up16(4 * slab_rows * n_tiles))


@dataclass(frozen=True)
class MlpPlan:
    """The launch of `fused_mlp_matvec` at one shape: `blocks` blocks (one
    per SM), each holding a Wd slab of `slab_rows` consecutive output rows in
    `smem_bytes` of dynamic shared memory. Every block waits until all M acts
    are out (a grid-wide row counter reaches M) before it reads one."""

    m: int
    d: int
    tile_m: int
    blocks: int
    slab_rows: int
    smem_bytes: int

    def act_rows(self, block: int) -> range:
        """Phase 1: the gate/up rows of `block`, in the order it takes them
        (dealt round robin, so every block starts on tile 0)."""
        return range(block, self.m, self.blocks)

    def slab(self, block: int) -> range:
        """Phase 2: the output rows of `block` (its Wd slab); empty for the
        blocks past D."""
        return range(min(block * self.slab_rows, self.d),
                     min((block + 1) * self.slab_rows, self.d))


def fused_mlp_plan(m: int, d: int, tile_m: int, blocks: int) -> MlpPlan:
    """The plan of one launch on a card that holds `blocks` blocks at once
    (its SMs), or ValueError for a shape the kernel does not take."""
    if d <= 0 or d % 16 or tile_m <= 0 or m <= 0 or m % tile_m or blocks <= 0:
        raise ValueError(f"fused_mlp_matvec: unsupported shape M={m}, D={d}, tile_m={tile_m}")
    slab_rows = -(-d // blocks)
    if (d > MAX_D or tile_m < 16 or tile_m > MAX_TILE or tile_m & (tile_m - 1)
            or slab_rows > MAX_SLAB_ROWS):
        raise ValueError(f"fused_mlp_matvec: M={m}, D={d}, tile_m={tile_m} on {blocks} blocks is "
                         f"beyond the kernel (D <= {MAX_D}, tile_m a power of two in "
                         f"[16, {MAX_TILE}], at most {MAX_SLAB_ROWS} Wd rows per block)")
    smem = _layout_bytes(m, d, m // tile_m, slab_rows)
    if smem > SMEM_BUDGET:
        raise ValueError(f"fused_mlp_matvec: M={m}, D={d} on {blocks} blocks needs {smem} bytes "
                         f"of shared memory per block ({slab_rows} Wd rows of {m}), more than "
                         f"{SMEM_BUDGET}")
    return MlpPlan(m, d, tile_m, blocks, slab_rows, smem)


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
    for name, t, dt, numel in (("wg_q", wg_q, torch.int8, m * d), ("wu_q", wu_q, torch.int8, m * d),
                               ("wd_q", wd_q, torch.int8, m * d), ("sg", sg, torch.float32, m),
                               ("su", su, torch.float32, m), ("sd", sd, torch.float32, d)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous() or t.numel() != numel:
            raise ValueError(f"fused_mlp_matvec: {name} must be {numel} contiguous {dt} values "
                             f"on {x.device}")
    if wg_q.data_ptr() % 16 or wu_q.data_ptr() % 16 or wd_q.data_ptr() % 16:
        raise ValueError("fused_mlp_matvec: weights are not aligned for 16-byte loads")


_sms: dict[int, int] = {}
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _blocks(device: torch.device) -> int:
    """One block per SM of the card."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device.index]


def _counters_for(device: torch.device, stream) -> torch.Tensor:
    """The kernel's two counters (rows out, blocks past the grid barrier) for
    launches on `stream`: allocated zeroed once per (device, stream) and left
    zeroed by every launch, so back-to-back calls and a replayed CUDA graph
    start from zero. (During a graph capture the first call on the capture
    stream allocates from the graph's pool, and its zeroing becomes a node of
    that graph.)"""
    key = (device.index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None:
        buf = _counters[key] = torch.zeros(COUNTERS, dtype=torch.int32, device=device)
    return buf


def _launch(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, the f32 acts [M] the kernel left in global memory) for a CUDA x."""
    _check_cuda_args(x, wg_q, sg, wu_q, su, wd_q, sd, tile_m)
    m, d = wg_q.shape
    plan = fused_mlp_plan(m, d, tile_m, _blocks(x.device))
    act = torch.empty(m, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device)
    ctr = _counters_for(x.device, stream)
    rc = _build.lib().fused_mlp_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wg_q.data_ptr(), sg.data_ptr(),
        wu_q.data_ptr(), su.data_ptr(), wd_q.data_ptr(), sd.data_ptr(), act.data_ptr(),
        ctr.data_ptr(), out.data_ptr(), m, d, tile_m, plan.blocks, plan.slab_rows,
        plan.smem_bytes, stream.cuda_stream,
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
