"""int8 gradient compression for the data-parallel all-reduce.

Per-tensor symmetric int8 quantization with a scale shared by every rank
(the absmax all-reduced with MAX over each data axis in turn), so the
integer sum is exact in int32 and dequantizes alike everywhere, plus
*error feedback*: each rank's quantization residual ``g32 - q * scale`` is
carried into the next step's gradient. The rounding is ``torch.round``,
half to even as ``jnp.round``; the values are clipped to +-127.

The reference runs this inside a ``shard_map`` manual over the data axes;
here each axis name is the process group ``mesh.get_group(name)`` of a
``DeviceMesh`` and the collectives are explicit. ``mesh=None`` is a world
of one rank (no collective).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_map


def _groups(mesh, axis_names) -> list:
    return [] if mesh is None else [mesh.get_group(ax) for ax in axis_names]


def compressed_psum(g, axis_names, err, mesh=None):
    """Quantized sum of one tensor over the ranks. Returns (sum, new_err)."""
    g32 = g.to(torch.float32) + err
    absmax = torch.max(torch.abs(g32))
    groups = _groups(mesh, axis_names)
    for grp in groups:
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=grp)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.to(torch.float32) * scale
    qsum = q.to(torch.int32)
    for grp in groups:
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=grp)
    total = qsum.to(torch.float32) * scale
    return total, new_err


def compressed_psum_tree(grads, axis_names, err_tree, n_ranks: int, mesh=None):
    """Tree version (one scale per tensor; None: an empty subtree); returns
    (mean grads, new error-feedback tree)."""
    out = tree_map(lambda g, e: None if g is None else compressed_psum(g, axis_names, e, mesh),
                   grads, err_tree)

    def pick(tree, i):
        if tree is None or isinstance(tree, tuple):
            return None if tree is None else tree[i]
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return [pick(v, i) for v in tree]

    means = tree_map(lambda t: None if t is None else t / n_ranks, pick(out, 0))
    return means, pick(out, 1)


def init_error_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
