"""Tensor primitives of the torch-ops engines (port of
``repro.engine.jax_ops``).

State operands are batched ``(n, d)`` tensors (column j = query j); per-edge
operands (``w``, masks) stay 1-D and broadcast across the batch dimension.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.semirings import delta_cols


def _bcast_edge(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Lift a per-edge 1-D tensor to broadcast against (e, d) messages."""
    if like.ndim == a.ndim + 1:
        return a[..., None]
    return a


def edge_op(kind: str, x_src: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    w = _bcast_edge(w, x_src)
    if kind == "mul":
        return x_src * w
    if kind == "add":
        return x_src + w
    if kind == "min":
        return torch.minimum(x_src, w)
    raise ValueError(kind)


_SEGMENT_REDUCE = {"sum": "sum", "min": "min", "max": "max"}


def segment_reduce_sorted(
    kind: str, msgs: torch.Tensor, lengths: torch.Tensor, identity: float
) -> torch.Tensor:
    """``out[v] = REDUCE`` of the ``lengths[v]`` messages of vertex v, over
    messages grouped by destination; empty segments at ``identity``. Each
    segment is reduced in message order, so a sum is the same on every run,
    on the card too (a scatter that adds with atomics sums in a varying
    order, and PageRank's largest states then move by an ulp, more than
    eps, every round).

    Callers build ``lengths`` by counting (non-negative, summing to
    ``len(msgs)``). On the card the op's own check of that reads the
    lengths back to the host, a synchronisation per call, so it is skipped
    there (``unsafe``); on the CPU it stays, and the CPU tests check every
    caller's lengths."""
    if kind not in _SEGMENT_REDUCE:
        raise ValueError(kind)
    return torch.segment_reduce(msgs, _SEGMENT_REDUCE[kind], lengths=lengths, axis=0,
                                initial=identity, unsafe=msgs.is_cuda)


def combine(
    kind: str, agg: torch.Tensor, c: torch.Tensor, x_old: torch.Tensor,
    fixed: torch.Tensor, x0: torch.Tensor,
) -> torch.Tensor:
    if kind == "replace":
        x_new = c + agg
    elif kind == "min_old":
        x_new = torch.minimum(x_old, torch.minimum(c, agg))
    elif kind == "max_old":
        x_new = torch.maximum(x_old, torch.maximum(c, agg))
    else:
        raise ValueError(kind)
    return torch.where(fixed, x0, x_new)


def residual_cols(kind: str, x_new: torch.Tensor, x_old: torch.Tensor) -> torch.Tensor:
    """Per-column residual f32[d] for (n, d) states — the shared metric
    definition (`kernels.semirings.delta_cols`)."""
    return delta_cols(kind, x_new, x_old)
