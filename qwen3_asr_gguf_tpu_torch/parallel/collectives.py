"""The collectives of tensor parallelism, written out (the JAX package needs
none: XLA inserts them under its shardings).

- `copy_to_tp` (Megatron's *f*): identity forward, all-reduce of the
  gradient backward; at the input of a column-parallel block, whose local
  output tiles each see the whole replicated input.
- `reduce_from_tp` (Megatron's *g*): all-reduce forward, identity backward;
  after a row-parallel product, whose partial sums add up to the replicated
  output. (`torch.distributed.nn.functional.all_reduce` is not *g*: its
  backward all-reduces the replicated gradient again, a factor of tp.)
- `gather_from_tp`: all-gather of local tiles along an axis (the vocab-split
  logits, the column-split encoder input); backward keeps the rank's own
  slice of the replicated gradient.

With `group=None` each is the identity, so the single-process path runs the
same code. Every collective goes through `torch.distributed.all_reduce` /
`all_gather` (a test wraps them to count). Gloo takes CUDA tensors directly
(torch 2.11 on an H100), so a test world of several ranks on one card needs
no staging through host memory.
"""

from __future__ import annotations

import torch
import torch.distributed as dist



def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of `t` over `group`, in place; returns `t`."""
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' tiles of `t` concatenated along `dim`, in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, rank * ctx.size, ctx.size).contiguous(), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    if group is None:
        return x
    return _GatherFromTP.apply(x, group, dim % x.ndim)


def broadcast_object(obj):
    """Rank 0's `obj` on every rank of the default group; the identity
    without a process group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
