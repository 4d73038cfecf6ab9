"""Tensor and expert parallelism over the mesh's "model" axis.

The reference lets XLA derive the model axis's collectives from the
parameters' shardings; the port writes them out. A :class:`TPContext`
holds the "model" group of a mesh, this rank's index in it and its size,
and, for each parameter of the port's tree, the dimension that the rules
split over "model" (None: replicated), read from ``build_shardings``'
specs. Each rank holds a contiguous ``1/size`` of a split dimension.

The two conjugate operators of the Megatron layout, as autograd functions:

* :func:`enter`: identity forward, all-reduce (sum) backward. It goes
  where a tensor that is the same on every model rank is consumed by a
  computation local to the rank (a column-parallel product, this rank's
  experts, a slice of a replicated weight): each rank's gradient of it is
  a partial sum.
* :func:`leave`: all-reduce (sum) forward, identity backward. It goes
  after a row-parallel product, or any sum of per-rank partials: every
  rank then holds the same tensor, and differentiates its own replica of
  the loss.

A product of an input split over the group with a weight split on its
input dimension (the recurrent blocks' ``("ffn", None)`` weights) is a
partial sum of a whole tensor, of which the per-channel or per-head work
downstream wants only this rank's part. :meth:`TPContext.own` takes it:
the sum (:func:`leave`), then :func:`enter`, then the slice. ``leave``
then the slice alone would be wrong in the backward: each rank would hand
its partial product only its own part's gradient. :meth:`TPContext.part`
is this rank's part of a tensor that is whole on every rank (``enter``,
then the slice), and :meth:`TPContext.take` the slice alone, for a tensor
whose gradient is already summed upstream. Each takes its part as
``groups`` contiguous blocks where a dimension stacks several fields (the
``(z, i, f, o)`` gates of the sLSTM).

Serving runs the same layout under ``torch.inference_mode()``, where the
autograd functions run their forward alone; :meth:`TPContext.gather` is
the one collective serving adds: every rank's part of a split dimension
concatenated (the query heads of the sequence-sharded decode, the vocab
ranges of the logits).

The residual stream, the norms and every replicated weight's gradient are
then the same on every model rank. The models take the context as a
``tp=`` keyword (None: a model axis of one rank, today's ops in today's
order) and read which dimensions are split from their parameters' local
shapes.

:func:`batch_mean` is the same pair over a data-parallel step's batch
group: the reference computes the MoE's load-balance loss over the global
batch, so the MoE averages its routing statistics over that group. A
:class:`BatchShare` says what a rank's part of a global microbatch weighs
in such a statistic, and in the cross entropy, where the parts are uneven
(a rank's part padded to the shard's rows, or no real row at all).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_map
from repro_torch.sharding.rules import axis_sizes


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce (sum) over ``group`` backward."""
    return _Enter.apply(x, group)


def leave(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward, identity backward."""
    return _Leave.apply(x, group)


def batch_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``, differentiable: every rank's loss
    holds the global mean, and each rank's gradient of it is summed over
    the group, so the data-parallel mean of the gradients is the gradient
    of the global statistic."""
    return enter(leave(x, group), group) / dist.get_world_size(group)


@dataclasses.dataclass(frozen=True)
class BatchShare:
    """This data-parallel rank's part of one global microbatch, for the
    statistics the reference takes over the whole of it. ``group``: the
    batch group. The first ``rows`` of the rank's ``padded`` rows are
    real, the rest pad its part to the shard's rows
    (``data.tokens.shard_rows``). ``even``: the microbatch's rows over the
    group's size (every rank's part, were the layout even); ``tokens``:
    its scored tokens (labels not masked, at least one) over the group's
    size. On an even layout each rank's terms are its local means."""

    group: Any
    rows: int
    padded: int
    even: torch.Tensor
    tokens: torch.Tensor

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the global microbatch of ``x``'s dimensions 0 and
        1 (dimension 0: this rank's padded rows, each as an equal count of
        groups), on every rank, differentiable (:func:`batch_mean` of each
        rank's real rows' sum over ``even`` rows' worth)."""
        per_row = x.shape[0] // self.padded
        local = x[:per_row * self.rows].sum(dim=(0, 1)) / (per_row * x.shape[1] * self.even)
        return batch_mean(local, self.group)


def split_dim(spec: tuple) -> Optional[int]:
    """The dimension a spec splits over "model" (None: none)."""
    for i, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return i
    return None


@dataclasses.dataclass(frozen=True)
class TPContext:
    """The "model" group (``size`` > 1 ranks, this one ``rank``) and
    ``dims``: per parameter of the port's tree, the local dimension split
    over it."""

    group: Any
    rank: int
    size: int
    dims: Any

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return enter(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return leave(x, self.group)

    def take(self, x: torch.Tensor, dim: int = -1, groups: int = 1) -> torch.Tensor:
        """This rank's ``1/size`` of each of ``groups`` equal contiguous
        blocks of ``x``'s ``dim``, concatenated (a slice: no collective)."""
        n = x.shape[dim] // (groups * self.size)
        if groups == 1:
            return x.narrow(dim, self.offset(n), n)
        blocks = x.unflatten(dim, (groups, x.shape[dim] // groups))
        d = dim % x.dim() + 1
        return blocks.narrow(d, self.offset(n), n).flatten(d - 1, d)

    def part(self, x: torch.Tensor, dim: int = -1, groups: int = 1) -> torch.Tensor:
        """This rank's part (:meth:`take`) of ``x``, whole on every rank:
        its gradient, this rank's part of the whole one, summed over the
        group."""
        return self.take(self.enter(x), dim, groups)

    def own(self, partial: torch.Tensor, dim: int = -1, groups: int = 1) -> torch.Tensor:
        """This rank's part (:meth:`take`) of the sum over the group of
        ``partial``; the gradient of ``partial`` is the whole sum's."""
        return self.part(self.leave(partial), dim, groups)

    def offset(self, local: int) -> int:
        """The first global index of this rank's ``local`` entries of a
        split dimension."""
        return self.rank * local

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated on ``dim`` in rank order: the
        whole of a dimension split over the group (no gradient)."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The element-wise maximum over the group (no gradient)."""
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x


def tp_context(mesh, port_dims) -> Optional[TPContext]:
    """The context of ``mesh``'s "model" axis (``port_dims``: per parameter
    of the port's tree, the dimension split over "model"); None where that
    axis has one rank or there is no mesh."""
    size = axis_sizes(mesh).get("model", 1)
    if size == 1:
        return None
    return TPContext(mesh.get_group("model"), mesh.get_local_rank("model"), size, port_dims)


def shard_params(tree, tp: Optional[TPContext]):
    """This rank's shards of a full tree of the port's layout (fresh
    tensors); the tree itself when ``tp`` is None. Leaves that are None (a
    layer that a ZeRO rank does not own) stay None."""
    if tp is None:
        return tree

    def one(t, d):
        if t is None or d is None:
            return t
        n = t.shape[d] // tp.size
        return t.narrow(d, tp.rank * n, n).clone()

    return tree_map(one, tree, tp.dims)


def gather_params(tree, tp: Optional[TPContext]):
    """The full tree from every model rank's shards (a collective over the
    group: every rank takes part); the tree itself when ``tp`` is None."""
    if tp is None:
        return tree

    def one(t, d):
        return t if t is None or d is None else tp.gather(t, d)

    return tree_map(one, tree, tp.dims)
