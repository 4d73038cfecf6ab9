"""Synchronous (Jacobi) engine — paper Eq. 1 (port of ``repro.engine.sync``).

Every round recomputes all vertices from the *previous* round's states:
one full segment-reduce over the edge set inside the shared round loop
(`engine.harness.loop`). This is the paper's "Sync" baseline mode.

States are batched ``f32[n, d]`` (column j = independent query j); a
converged column freezes and reports its own round count. ``d = 1`` is the
scalar mode. ``x_init`` warm-starts the loop from a prior state while ``x0``
keeps pinning fixed vertices; ``extrapolate_every`` turns on the shared
loop's Aitken acceleration (linear sum-semiring systems only).

There is no kernel backend: like the reference's sync engine, this one runs
on torch ops only (``backend="kernel"`` raises in `engine.api`). The edges
are grouped by destination once, in their original order within each
destination, and every round reduces each vertex's messages in that order
(`torch_ops.segment_reduce_sorted`): the sum is the same on every run.
With a scatter that adds by atomics, as ``scatter_reduce_`` does on the
card, PageRank's largest states move by an ulp (more than eps) every round
and the run never converges.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.algorithms import AlgoInstance
from repro_torch.engine.convergence import RunResult
from repro_torch.engine import harness
from repro_torch.engine import torch_ops as T
from repro_torch.obs.trace import tspan


def _run(
    src, lengths, w, x_start, x0, c, fixed, *,
    sem_reduce: str, sem_edge: str, comb: str, res_kind: str,
    eps: float, max_iters: int, identity: float, extrapolate_every: int,
):
    """Edges ``(src, w)`` grouped by destination, ``lengths[v]`` of them
    for vertex v."""
    def round_fn(x):
        msgs = T.edge_op(sem_edge, x[src], w)
        agg = T.segment_reduce_sorted(sem_reduce, msgs, lengths, identity)
        return T.combine(comb, agg, c, x, fixed, x0)

    return harness.loop(
        round_fn, x_start, res_kind=res_kind, eps=eps, max_iters=max_iters,
        extrapolate_every=extrapolate_every,
    )


def _solve(algo: AlgoInstance, o) -> RunResult:
    """Engine body behind ``solve(algo, engine="sync", ...)``; options are
    already validated (`engine.api.validate_options`)."""
    device = torch.device(o.device)

    def dev(a):
        return harness.to_device(a, device)

    with tspan(o.trace, "pack", algo=algo.name, n=algo.n, d=algo.d):
        by_dst = np.argsort(algo.dst, kind="stable")
        src = dev(np.asarray(algo.src, np.int64)[by_dst])
        w = dev(np.asarray(algo.w, np.float32)[by_dst])
        lengths = dev(np.bincount(algo.dst, minlength=algo.n).astype(np.int64))
        x0 = np.asarray(algo.x0, np.float32)
        x_start = harness.init_state(x0, o.x_init, algo.n)
    out = _run(
        src, lengths, w, dev(x_start), dev(x0),
        dev(np.asarray(algo.c, np.float32)), dev(np.asarray(algo.fixed, bool)),
        sem_reduce=algo.semiring.reduce,
        sem_edge=algo.semiring.edge_op,
        comb=algo.combine,
        res_kind=algo.residual,
        eps=algo.eps,
        max_iters=o.max_iters,
        identity=algo.semiring.identity,
        extrapolate_every=o.extrapolate_every,
    )
    return harness.finalize(algo, *out)


def run_sync(
    algo: AlgoInstance, max_iters: int = 2000,
    x_init: np.ndarray | None = None, extrapolate_every: int = 0,
    device: str = "cuda",
) -> RunResult:
    """Thin shim over ``solve(algo, engine="sync")`` — the reference's
    legacy keyword spelling, plus ``device``."""
    from repro_torch.engine.api import EngineOptions, solve

    return solve(algo, engine="sync", options=EngineOptions(
        max_iters=max_iters, x_init=x_init,
        extrapolate_every=extrapolate_every, device=device,
    ))
