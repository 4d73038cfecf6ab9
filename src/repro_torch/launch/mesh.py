"""Meshes for training and the sequence-sharded decode.

Functions, not module constants: importing this module touches no
process group.

Production geometry (pods of 256 accelerators), the reference's:
  single-pod: (16, 16)            axes (data, model)
  multi-pod:  (2, 16, 16)         axes (pod, data, model)

The "model" axis carries tensor, expert and sequence sharding; "data" and
"pod" carry data parallelism. :func:`make_production_mesh` returns only
that shape and its axis names (no process group spans 256 cards here), which
is all ``sharding.rules`` reads. :func:`make_debug_mesh` builds a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is up: one NCCL rank on the card, gloo ranks in the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_debug_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cuda"):
    """A ("data", "model") DeviceMesh of ``n_data x n_model`` over the
    default process group's ranks (``n_data`` defaults to world / n_model),
    on ``device_type`` devices ("cuda" unless the caller asks for "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_debug_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group first (one rank: world_size=1)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' was asked for but no CUDA device is "
                           "available; pass device_type='cpu'")
    world = dist.get_world_size()
    n_data = n_data or world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} does not cover the {world} ranks "
                         "of the process group")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))
