"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

Models annotate parameters with *logical* axes ("vocab", "heads", "ffn",
"expert", ...). This module maps them onto the mesh with a divisibility
guard: a dimension that cannot be split evenly over its mesh axis (gemma3's
4 KV heads over a 16-way model axis) is replicated and the fallback is
recorded, in the reference's words.

A spec is a tuple with one entry per dimension: a mesh axis name, a tuple
of axis names, or None (the reference's ``PartitionSpec`` entries). The
functions read only the mesh's axis names and sizes (:func:`axis_sizes`),
so they take a ``torch.distributed.device_mesh.DeviceMesh``, the shape
that ``launch.mesh.make_production_mesh`` returns, or any object with an
``axis_names`` tuple and a ``shape`` mapping of name to size (a JAX mesh's
surface); no device is needed. ``mesh=None`` is one rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class ShardingRules:
    """Mapping from logical axis name -> mesh axis (str, tuple, or None)."""

    rules: dict
    fallbacks: list = dataclasses.field(default_factory=list)

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        return self.rules.get(logical)


ONE_RANK = {"data": 1, "model": 1}


def axis_names(mesh) -> tuple:
    """The mesh's axis names (``mesh=None``: one rank, ("data", "model"))."""
    if mesh is None:
        return tuple(ONE_RANK)
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}: a DeviceMesh's ``mesh_dim_names`` against its
    ``shape`` tuple, else the mesh's own ``shape`` mapping (``mesh=None``:
    one rank, every axis of size 1)."""
    if mesh is None:
        return dict(ONE_RANK)
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def batch_axes_for_mesh(mesh) -> tuple:
    """DP axes: ("pod", "data") on the multi-pod mesh, ("data",) otherwise."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def default_rules(mesh, *, seq_shard: bool = False) -> ShardingRules:
    ba = batch_axes_for_mesh(mesh)
    return ShardingRules(rules={
        "batch": ba,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "heads_flat": "model",
        "ffn": "model",
        "expert": "model",
        "embed": None,
        "embed_out": None,
        "head_dim": None,
        "seq": "model" if seq_shard else None,
        "kv_seq": "model",      # sequence-sharded KV caches (split-KV decode)
        "layers": None,
    })


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def spec_for_axes(mesh, rules: ShardingRules, logical_axes, shape=None,
                  name: str = "?") -> tuple:
    """The spec of one array from its logical axes.

    ``logical_axes`` has one entry per dim (string or None). When ``shape``
    is given, divisibility is checked per dim; a failure replicates that
    dim and is appended to ``rules.fallbacks``. A mesh axis used by an
    earlier dim is dropped from a later one (replicated there).
    """
    entries = []
    for i, lax_ in enumerate(logical_axes):
        mesh_axes = rules.mesh_axes(lax_)
        if mesh_axes is None:
            entries.append(None)
            continue
        size = _axis_size(mesh, mesh_axes)
        if shape is not None and shape[i] % size != 0:
            rules.fallbacks.append(
                f"{name}: dim {i} ({lax_}={shape[i]}) not divisible by "
                f"{mesh_axes}({size}) -> replicated"
            )
            entries.append(None)
            continue
        entries.append(mesh_axes)
    seen: set = set()
    cleaned = []
    for e in entries:
        flat = (e,) if isinstance(e, str) else (e or ())
        if any(a in seen for a in flat):
            cleaned.append(None)
            continue
        seen.update(flat)
        cleaned.append(e)
    return tuple(cleaned)


def build_param_specs(mesh, rules: ShardingRules, shapes, logical_specs):
    """A tree of shaped leaves (tensors, meta tensors, anything with
    ``shape``; None for an empty subtree) and the matching tree of
    logical-axes tuples -> the tree of specs. Leaves are visited in JAX's
    order (dict keys sorted), so ``rules.fallbacks`` lists them as the
    reference does."""
    if shapes is None:
        return None
    if isinstance(shapes, dict):  # keys in sorted order, as JAX visits them
        return {k: build_param_specs(mesh, rules, shapes[k], logical_specs[k])
                for k in sorted(shapes)}
    if isinstance(shapes, (list, tuple)) and not hasattr(shapes, "shape"):
        return [build_param_specs(mesh, rules, v, s) for v, s in zip(shapes, logical_specs)]
    return spec_for_axes(mesh, rules, tuple(logical_specs), tuple(shapes.shape))


def spec_axes(spec: tuple) -> set:
    """Every mesh axis a spec uses."""
    return {a for e in spec for a in ((e,) if isinstance(e, str) else (e or ()))}

