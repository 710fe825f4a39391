"""The collectives of the sharded step, as autograd functions.

Megatron's pair over an axis whose ranks all compute the same loss:

- :func:`sum_grad` (f): the identity forward, the gradient summed over the
  group backward; where a replicated activation enters a split region (a
  column-parallel projection, the local keys of a sequence shard), each
  rank's gradient is a part of the whole;
- :func:`all_sum` (g): the sum over the group forward, the identity
  backward; where a split region's partial outputs are added (a
  row-parallel projection, the softmax partials of the key shards), each
  rank's downstream gradient is already the whole.

:func:`gather_rows` gathers a batch-sharded tensor for a consumer that
every rank computes alike (the loss of the global batch): backward, a rank
keeps its own rows' gradient. A ``group`` of None (an axis of size 1) makes
each of them the identity, so a one-device mesh launches no collective.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group: Group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` in place (no autograd)."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise maximum over ``group``, without a gradient."""
    return all_reduce_(x.detach().clone(), group, dist.ReduceOp.MAX)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_grad(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Identity forward, gradient summed over ``group`` backward (f)."""
    return x if group is None else _SumGrad.apply(x, group)


def all_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over ``group`` forward, identity backward (g)."""
    return x if group is None else _AllSum.apply(x, group)


def _gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        start = dist.get_rank(ctx.group) * ctx.rows
        return g[start:start + ctx.rows], None


def gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' blocks of ``x`` along dim 0, in rank order. Under autograd
    a rank's gradient is its own rows' (the consumer is the same on every
    rank, so each already holds the whole gradient)."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, group)
    return _gather(x, group)


def sum_grads_(tensors: Iterable[torch.Tensor], group: Group) -> None:
    """Sum the tensors over ``group`` in place, one flat buffer a dtype."""
    if group is None:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))
