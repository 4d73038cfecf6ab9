"""The single source of truth for kernel-semiring constants (port of
``repro.kernels.semirings``).

ACC_IDENTITY[s]  — the value a reduction accumulator starts from.
TILE_FILL[s]     — the value absent edges *inside* a nonzero tile carry.
DELTA_METRIC[s]  — the per-sweep convergence metric the sweep kernel
                   accumulates when the caller pins none: "linf" for the
                   plus semiring, "changed" (count of moved entries) for the
                   lattice semirings — the `residual` kinds
                   `engine.algorithms` assigns.
"""
from __future__ import annotations

import torch

from repro_torch.engine.algorithms import BIG

ACC_IDENTITY: dict[str, float] = {
    "plus_times": 0.0,
    "min_plus": float(BIG),
    "max_min": float(-BIG),
    "max_times": float(-BIG),
}

TILE_FILL: dict[str, float] = {
    "plus_times": 0.0,
    "min_plus": float(BIG),
    "max_min": float(-BIG),
    "max_times": 0.0,
}

DELTA_METRIC: dict[str, str] = {
    "plus_times": "linf",
    "min_plus": "changed",
    "max_min": "changed",
    "max_times": "changed",
}

# integer codes the CUDA libraries take for the semirings (the SR_* enums of
# csrc/*.cu) and for the residual kinds
SEMIRING_CODE: dict[str, int] = {
    "plus_times": 0, "min_plus": 1, "max_min": 2, "max_times": 3,
}
RES_KIND_CODE: dict[str, int] = {"linf": 0, "l1": 1, "changed": 2}


def pending_cols(semiring: str, p: torch.Tensor, r: torch.Tensor,
                 keepdim: bool = False) -> torch.Tensor:
    """Per-column pending-work metric of a push-engine ``(p, r)`` state —
    THE definition for the port: the push round driver and its torch round.

    Sum semiring: the per-column max-|r| (the linf quantity the sweep
    engines hold to eps). Lattice semirings: the per-column count of rows
    whose pending candidate beats ``p`` under the combine."""
    if semiring == "plus_times":
        return torch.amax(torch.abs(r), dim=0, keepdim=keepdim)
    if semiring == "min_plus":
        moved = torch.minimum(p, r) != p
    elif semiring in ("max_min", "max_times"):
        moved = torch.maximum(p, r) != p
    else:
        raise ValueError(semiring)
    return torch.sum(moved.to(torch.float32), dim=0, keepdim=keepdim)


def delta_cols(res_kind: str, new: torch.Tensor, old: torch.Tensor,
               keepdim: bool = False) -> torch.Tensor:
    """Per-column convergence metric over the row axis — THE definition for
    the port: the round drivers (`engine.torch_ops.residual_cols`), the
    kernel's plain version and the kernel itself compute this."""
    if res_kind == "linf":
        return torch.amax(torch.abs(new - old), dim=0, keepdim=keepdim)
    if res_kind == "l1":
        return torch.sum(torch.abs(new - old), dim=0, keepdim=keepdim)
    if res_kind == "changed":
        return torch.sum((new != old).to(torch.float32), dim=0, keepdim=keepdim)
    raise ValueError(res_kind)
