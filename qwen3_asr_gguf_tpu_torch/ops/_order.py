"""Two helpers of the kernel-order plain versions (`ops.q4k`, `ops.qmm`):
the f32 arithmetic of the CUDA kernels repeated with tensor ops."""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once to f32 (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def sum_in_order(parts: list) -> torch.Tensor:
    """((p0 + p1) + p2) + ...: the order the kernels add partial sums in."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out
