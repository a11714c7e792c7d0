"""Tensor-parallel linear layers over the ``tp`` dimension of a mesh.

The counterpart of ``__graft_entry__.py::_param_shardings``, which shards
the PPO actor-critic's first hidden Dense over its output columns
(``P(None, "tp")``, bias ``P("tp")``) and the second over its input rows
(``P("tp", None)``); there XLA inserts the activation collectives, here
two autograd functions on the tp group do:

* :class:`ColumnParallelLinear` keeps its rank's ``out / tp`` columns and
  their bias; its input passes through :func:`copy_to_tp` (the identity
  forward, an ``all_reduce`` of the input's gradient backward);
* :class:`RowParallelLinear` keeps its rank's ``in / tp`` rows; its partial
  products pass through :func:`reduce_from_tp` (an ``all_reduce`` forward,
  the identity backward) and the full bias is added once, after it.

Both are slices of a full ``rl/_nn.py::dense`` layer, so a tp model drawn
from the same generator as the unsharded one holds exactly its numbers.
The products are plain ``F.linear``: the JAX package computes them outside
any Pallas kernel.  Each ``all_reduce`` is counted in
:data:`~.sharding.COLLECTIVES` and :data:`~.sharding.TP_COLLECTIVES`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import sharding


def all_reduce_sum_tp_(t: torch.Tensor, group) -> torch.Tensor:
    """Overwrite ``t`` with the sum of every tp rank's ``t`` (counted)."""
    sharding.count_collective(tp=True)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_tp_(grad.clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum_tp_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; backward, its gradient summed over the tp group
    (each rank's columns contributed a part of it)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every tp rank's ``x``; backward, the gradient unchanged."""
    return _ReduceFromTP.apply(x, group)


def _shard(n: int, tp: int, rank: int) -> slice:
    if n % tp:
        raise ValueError("a width of %d does not split evenly over tp=%d" % (n, tp))
    k = n // tp
    return slice(rank * k, (rank + 1) * k)


class ColumnParallelLinear(nn.Module):
    """Rows ``rank * out / tp ...`` of a full layer's ``weight [out, in]``
    and its bias: this rank's share of the output features."""

    def __init__(self, full: nn.Linear, tp: int, rank: int, group):
        super().__init__()
        cols = _shard(full.out_features, tp, rank)
        self.weight = nn.Parameter(full.weight.detach()[cols].clone())
        self.bias = nn.Parameter(full.bias.detach()[cols].clone())
        self.group = group

    def forward(self, x):
        return F.linear(copy_to_tp(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """Columns ``rank * in / tp ...`` of a full layer's ``weight [out, in]``
    and the whole bias: it takes this rank's share of the input features
    and returns the full output on every tp rank."""

    def __init__(self, full: nn.Linear, tp: int, rank: int, group):
        super().__init__()
        rows = _shard(full.in_features, tp, rank)
        self.weight = nn.Parameter(full.weight.detach()[:, rows].clone())
        self.bias = nn.Parameter(full.bias.detach().clone())
        self.group = group

    def forward(self, x):
        return reduce_from_tp(F.linear(x, self.weight), self.group) + self.bias
