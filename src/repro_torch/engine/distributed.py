"""Distributed engine: vertex blocks sharded across ranks (port of
``repro.engine.distributed`` onto ``torch.distributed``).

Execution model: *synchronous across shards, Gauss–Seidel within a shard*.
Each rank owns a contiguous range of blocks of the processing order. Per
superstep every rank sweeps its own blocks in order against a rank-local
copy of the full state matrix (so its own earlier blocks contribute
this-round values, while other ranks' rows keep their start-of-superstep
values), then the shards are re-assembled: one all-gather of the state
matrix per superstep, identical on every rank.

GoGraph's partition-locality objective minimizes cross-shard edges, which
is what keeps this hybrid close to fully asynchronous Gauss–Seidel in
rounds. States are batched ``f32[N, d]`` like every other engine, with
per-column convergence freezing in the shared round driver; every rank
reads its convergence from the same gathered bits, so the ranks agree
without a further collective. The per-superstep collective volume is
|V|·d·4 bytes.

The mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` holds ``axis`` (PyTorch's counterpart of the JAX mesh
and axis name); the collective runs on the process group the mesh gives for
that axis, with the backend the caller chose (NCCL on one card per rank;
gloo stages CUDA tensors through the host). ``mesh=None`` takes the default
process group's world when ``torch.distributed`` is initialized, else a
world of one rank on ``device`` with no collective.

:class:`DistContext` packs one algorithm *structure* (edges, block layout,
mesh) into device operands plus the superstep driver. `run_distributed`
builds a throwaway context per call; `engine.async_block.AsyncBlockSession`
(``backend="distributed"``) keeps one alive as the resident backing of a
serving family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.engine.algorithms import AlgoInstance
from repro_torch.engine.convergence import RunResult
from repro_torch.engine import harness
from repro_torch.engine import torch_ops as T
from repro_torch.graphs.blocked import BlockedInEdges


def _pad_blocks(arr: np.ndarray, nb_target: int, fill) -> np.ndarray:
    nb = arr.shape[0]
    if nb == nb_target:
        return arr
    pad = np.full((nb_target - nb,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


@dataclasses.dataclass(frozen=True)
class _World:
    """Where a superstep's shards live: this process's rank among
    ``size`` ranks of ``group`` (None: the default group). ``collective``
    is False for the world of one rank that no process group backs."""

    group: Any
    rank: int
    size: int
    collective: bool


def check_mesh(mesh, axis: str, device) -> None:
    """Reject a mesh the engine cannot run on ``device``: not a 1-D
    ``DeviceMesh``, no dimension named ``axis``, or a device type other than
    ``device``'s (the engine never moves the state to another device)."""
    from repro_torch.engine.api import EngineOptionsError

    names = getattr(mesh, "mesh_dim_names", None)
    dev_type = getattr(mesh, "device_type", None)
    if names is None or dev_type is None:
        raise EngineOptionsError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh with "
            f"mesh_dim_names, got {type(mesh).__name__}"
        )
    if mesh.ndim != 1 or axis not in names:
        raise EngineOptionsError(
            f"mesh must be 1-D with its dimension named {axis!r}, got "
            f"mesh_dim_names={names}"
        )
    if dev_type != torch.device(device).type:
        raise EngineOptionsError(
            f"mesh is on {dev_type!r} devices but the solve runs on "
            f"{str(device)!r}; pass device={dev_type!r} or a mesh of "
            f"{torch.device(device).type!r} devices"
        )


def _world(mesh, axis: str) -> _World:
    if mesh is not None:
        return _World(mesh.get_group(axis), mesh.get_local_rank(axis),
                      mesh.size(0), True)
    if dist.is_available() and dist.is_initialized():
        return _World(None, dist.get_rank(), dist.get_world_size(), True)
    return _World(None, 0, 1, False)


def make_superstep(
    mesh, axis: str, nb: int, bs: int,
    sem_reduce: str, sem_edge: str, comb: str,
    identity: float, inner: int = 1,
) -> tuple[Callable, int]:
    """Build the one-superstep function over ``(N, d)`` states.

    Returns ``(superstep, nb_local)``. ``superstep(x_full, rows, c_blk,
    fixed_blk, x0_blk)`` takes the replicated start-of-superstep state,
    this rank's blocks' in-edge segments ``rows`` (`harness.block_segments`
    of blocks ``[rank*nb_local, (rank+1)*nb_local)``) and the ``(nb, bs,
    d)`` operand blocks, and returns the new replicated state."""
    w = _world(mesh, axis)
    if nb % w.size:
        raise ValueError(f"nb={nb} is not a multiple of the {w.size} ranks")
    nb_local = nb // w.size
    lo = w.rank * nb_local * bs
    hi = lo + nb_local * bs

    def superstep(x_full, rows, c_blk, fixed_blk, x0_blk):
        x = x_full.clone()
        for j in range(nb_local):
            gi = w.rank * nb_local + j  # global block id
            srcs, lengths, wts = rows[j]
            sl = slice(gi * bs, (gi + 1) * bs)
            for _ in range(inner):
                msgs = T.edge_op(sem_edge, x[srcs], wts)
                agg = T.segment_reduce_sorted(sem_reduce, msgs, lengths, identity)
                x[sl] = T.combine(comb, agg, c_blk[gi], x[sl], fixed_blk[gi], x0_blk[gi])
        if not w.collective:
            return x
        # each rank contributes its own refreshed slice
        mine = x[lo:hi]
        parts = [torch.empty_like(mine) for _ in range(w.size)]
        dist.all_gather(parts, mine, group=w.group)
        return torch.cat(parts)

    return superstep, nb_local


class DistContext:
    """Packed operands + superstep driver for one structure.

    Owns what is constant across runs of one algorithm family: the rank's
    place in the mesh, its blocks' in-edge segments on ``device`` (blocks
    padded to a whole number per rank with empty blocks), and the padded
    ``(npad2, d)`` host operand templates ``x0`` / ``c`` / ``fixed``.
    :meth:`run` then converges any ``(npad2, d)`` state against any
    same-shape operand columns, which lets a serving session mutate operand
    columns on the device between batches.
    """

    def __init__(self, algo: AlgoInstance, bs: int, mesh=None,
                 axis: str = "data", inner: int = 1, device: str = "cuda"):
        self.device = torch.device(device)
        if mesh is not None:
            check_mesh(mesh, axis, self.device)
        self.mesh, self.axis, self.bs = mesh, axis, bs
        world = _world(mesh, axis)
        be, x0, c, fixed, _ = harness.pack(algo, bs)
        self.nb = -(-be.nb // world.size) * world.size
        self.npad2 = self.nb * bs

        def padm(a, fill):
            out = np.full((self.npad2,) + a.shape[1:], fill, dtype=a.dtype)
            out[: a.shape[0]] = a
            return out

        # host templates; callers stage them on the device (sessions keep
        # them there)
        self.x0 = padm(x0, np.asarray(algo.semiring.identity, x0.dtype))
        self.c = padm(c, np.asarray(algo.c_pad_fill, c.dtype))
        self.fixed = padm(fixed, True)
        self._real_mask = torch.arange(self.npad2, device=self.device) < algo.n

        self._superstep, nb_local = make_superstep(
            mesh, axis, self.nb, bs,
            algo.semiring.reduce, algo.semiring.edge_op, algo.combine,
            algo.semiring.identity, inner=inner,
        )
        lo = world.rank * nb_local
        local = BlockedInEdges(
            bs=bs, n=algo.n,
            esrc=_pad_blocks(be.esrc, self.nb, 0)[lo:lo + nb_local],
            edst=_pad_blocks(be.edst, self.nb, 0)[lo:lo + nb_local],
            ew=_pad_blocks(be.ew, self.nb, 0.0)[lo:lo + nb_local],
            emask=_pad_blocks(be.emask, self.nb, False)[lo:lo + nb_local],
        )
        self._rows = harness.block_segments(local, self.device)
        self._res_kind, self._eps = algo.residual, algo.eps

    def _on_device(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            return harness.to_device(np.asarray(a), self.device)
        if a.device.type != self.device.type:
            raise ValueError(
                f"operand on {a.device}, the context runs on {self.device}"
            )
        return a

    def run(self, x_start, x0, c, fixed, *, max_iters: int,
            extrapolate_every: int = 0):
        """Drive supersteps to convergence; the `harness.loop` tuple."""
        x_start, x0, c, fixed = (self._on_device(a) for a in (x_start, x0, c, fixed))
        d = x_start.shape[1]
        c_blk = c.view(self.nb, self.bs, d)
        fixed_blk = fixed.view(self.nb, self.bs, d)
        x0_blk = x0.view(self.nb, self.bs, d)  # pins stay x0 when warm-started

        def round_fn(x):
            return self._superstep(x, self._rows, c_blk, fixed_blk, x0_blk)

        return harness.loop(
            round_fn, x_start, res_kind=self._res_kind, eps=self._eps,
            max_iters=max_iters, real_mask=self._real_mask,
            extrapolate_every=extrapolate_every,
        )


def _solve(algo: AlgoInstance, o) -> RunResult:
    """Engine body behind ``solve(algo, engine="distributed", ...)``;
    options are already validated (`engine.api.validate_options`)."""
    ctx = DistContext(algo, o.bs, mesh=o.mesh, axis=o.axis, inner=o.inner,
                      device=o.device)
    x_start = harness.init_state(ctx.x0, o.x_init, algo.n)
    out = ctx.run(
        x_start, ctx.x0, ctx.c, ctx.fixed,
        max_iters=o.max_iters, extrapolate_every=o.extrapolate_every,
    )
    return harness.finalize(algo, *out)


def run_distributed(
    algo: AlgoInstance,
    mesh=None,
    axis: str = "data",
    bs: int = 256,
    max_iters: int = 2000,
    inner: int = 1,
    x_init: Optional[np.ndarray] = None,
    extrapolate_every: int = 0,
    device: str = "cuda",
) -> RunResult:
    """Thin shim over ``solve(algo, engine="distributed")`` — the legacy
    keyword spelling of the reference.

    ``x_init`` warm-starts from a prior state (incremental serving);
    ``extrapolate_every`` enables Aitken acceleration for linear systems
    (see `harness.loop`)."""
    from repro_torch.engine.api import EngineOptions, solve

    return solve(algo, engine="distributed", options=EngineOptions(
        x_init=x_init, extrapolate_every=extrapolate_every, bs=bs,
        inner=inner, max_iters=max_iters, mesh=mesh, axis=axis, device=device,
    ))
