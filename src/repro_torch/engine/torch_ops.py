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


_SCATTER_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def segment_reduce(
    kind: str, msgs: torch.Tensor, dst: torch.Tensor, n: int, identity: float
) -> torch.Tensor:
    """``out[v] = REDUCE_{e: dst[e] == v} msgs[e]``, empty segments at
    ``identity``."""
    if kind not in _SCATTER_REDUCE:
        raise ValueError(kind)
    out = torch.full((n,) + tuple(msgs.shape[1:]), identity, dtype=msgs.dtype,
                     device=msgs.device)
    index = dst.view(-1, *([1] * (msgs.ndim - 1))).expand_as(msgs)
    return out.scatter_reduce_(0, index, msgs, reduce=_SCATTER_REDUCE[kind],
                               include_self=True)


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
