"""Incremental serving engine for evolving graphs (delta-based warm-start);
port of ``repro.engine.incremental``.

Production serving re-answers the same queries on graphs that change under
them; recomputing from ``x0`` after every edge batch throws away exactly the
rounds the GoGraph ordering saved. This engine absorbs a
:class:`~repro_torch.graphs.delta.GraphDelta` into an already-converged
:class:`RunResult` instead, iterating only on what the delta perturbed. Two
regimes, chosen by the algorithm's semiring:

**Sum semirings** (pagerank / katz / ppr / adsorption / php) are linear:
``x* = c + W x*``. After a mutation (W, c) -> (W', c'), the correction
``delta* = x'* - x_warm`` solves the *same* linear system with the dense
residual ``r = c' + W' x_warm - x_warm`` as its constant term (Maiter's
delta-based accumulative iteration). We build that delta instance and drive
it through the ordinary engines — the shared round driver `harness.loop` —
from ``delta = 0``. Because the delta system is linear with an arbitrary
sign pattern (deletions make ``r`` signed), the paper's monotone-semiring
restrictions don't bind it, and the driver's Aitken extrapolation
(``extrapolate_every``) legally accelerates it: the iteration matrix W' is
entrywise nonnegative, so the dominant (Perron) mode is real and the
geometric-tail jump ``step * rho / (1 - rho)`` is well conditioned.

**Min/max semirings** (sssp / bfs / cc / sswp) are lattice fixpoints.
*Tightening* deltas — insertions, plus reweights that move edges in the
reduce direction — can only move the fixpoint further along the monotone
direction, so the converged state is a valid bound and the engines'
``min_old`` / ``max_old`` combine re-lowers (re-raises) it directly via
``x_init``. *Loosening* deltas (deletions; reweights against the reduce
direction) can invalidate converged values, and a min-fixpoint can never be
raised by iteration — so the affected *region* (everything reachable from
the loosened edges' destinations in the mutated graph) is masked back to
``x0`` and recomputed, while the untouched remainder keeps serving its warm
values. Every warm value outside the region is witnessed by a surviving
path, so the masked state stays a valid bound and the iteration converges to
the exact new fixpoint (bitwise — the per-edge relaxations are the same f32
programs a cold run executes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np

from repro_torch.engine.algorithms import AlgoInstance
from repro_torch.engine.convergence import RunResult
from repro_torch.engine.harness import permute_state
from repro_torch.graphs.delta import out_closure
from repro_torch.graphs.graph import Graph

__all__ = [
    "EdgeDiff", "instance_edge_diff", "warm_state", "dense_residual",
    "affected_region", "run_incremental", "permute_state",
]

# Aitken period for the linear delta systems: frequent enough to matter on
# short warm runs, spaced enough that modes re-mix between jumps.
DEFAULT_EXTRAPOLATE_EVERY = 4


@dataclasses.dataclass(frozen=True)
class EdgeDiff:
    """Instance-level edge diff (on the *transformed* weights, so implicit
    reweights like PageRank's out-degree renormalization are included)."""

    added_dst: np.ndarray      # int32 — dsts of edges only in the new instance
    removed_dst: np.ndarray    # int32 — dsts of edges only in the old instance
    tightened_dst: np.ndarray  # int32 — surviving edges moved along the reduce dir
    loosened_dst: np.ndarray   # int32 — surviving edges moved against it

    @property
    def loosening(self) -> bool:
        """True when the delta can move the fixpoint *against* the monotone
        direction (requires the masked regional recompute for min/max)."""
        return len(self.removed_dst) > 0 or len(self.loosened_dst) > 0


def instance_edge_diff(old: AlgoInstance, new: AlgoInstance) -> EdgeDiff:
    """Diff two min/max-semiring instances of the same algorithm over
    (possibly) different graphs. Parallel edges are collapsed to their
    effective weight under the instance's reduce (min for min-semirings,
    max for max). Sum semirings never need a diff — their incremental path
    works off the dense residual — and tighter/looser has no meaning for
    them, so they are rejected."""
    if new.semiring.reduce not in ("min", "max"):
        raise ValueError(
            f"edge diffs classify tightening/loosening for min/max "
            f"semirings only, not reduce={new.semiring.reduce!r}"
        )
    n = max(old.n, new.n)

    def eff(algo: AlgoInstance) -> tuple[np.ndarray, np.ndarray]:
        key = algo.src.astype(np.int64) * n + algo.dst
        uniq, inv = np.unique(key, return_inverse=True)
        if algo.semiring.reduce == "min":
            w = np.full(len(uniq), np.inf)
            np.minimum.at(w, inv, algo.w.astype(np.float64))
        else:
            w = np.full(len(uniq), -np.inf)
            np.maximum.at(w, inv, algo.w.astype(np.float64))
        return uniq, w

    ko, wo = eff(old)
    kn, wn = eff(new)
    added = np.setdiff1d(kn, ko, assume_unique=True)
    removed = np.setdiff1d(ko, kn, assume_unique=True)
    common, io_, in_ = np.intersect1d(ko, kn, assume_unique=True,
                                      return_indices=True)
    dw = wn[in_] - wo[io_]
    # "tighter" moves the fixpoint along the monotone direction: lower
    # weights for min-reduce (shorter paths), higher for max-reduce (wider).
    if new.semiring.reduce == "min":
        tightened, loosened = common[dw < 0], common[dw > 0]
    else:
        tightened, loosened = common[dw > 0], common[dw < 0]

    def dsts(keys: np.ndarray) -> np.ndarray:
        return (keys % n).astype(np.int32)

    return EdgeDiff(dsts(added), dsts(removed), dsts(tightened), dsts(loosened))


def warm_state(algo_new: AlgoInstance, algo_old: AlgoInstance,
               prior: Union[RunResult, np.ndarray]) -> np.ndarray:
    """Overlay a prior converged state onto the new instance's ``x0``:
    surviving vertices keep their values, appended vertices start cold."""
    x_prior = np.asarray(getattr(prior, "x", prior), np.float32)
    x_prior = x_prior.reshape(algo_old.n, -1)
    if x_prior.shape[1] != algo_new.d:
        raise ValueError(
            f"prior state has {x_prior.shape[1]} query columns, "
            f"new instance has {algo_new.d}"
        )
    x = algo_new.x0.astype(np.float32).copy()
    x[: algo_old.n] = x_prior
    # pinned vertices always serve their pin value, not a stale prior
    x = np.where(algo_new.fixed, algo_new.x0, x)
    return x


def dense_residual(algo: AlgoInstance, x: np.ndarray) -> np.ndarray:
    """``F(x) - x`` for a sum-semiring instance (f64 accumulate, f32 out);
    zero at pinned vertices."""
    assert algo.combine == "replace" and algo.semiring.reduce == "sum"
    assert algo.semiring.edge_op == "mul", algo.semiring
    x = np.asarray(x, np.float64).reshape(algo.n, -1)
    msgs = x[algo.src] * algo.w.astype(np.float64)[:, None]
    agg = np.zeros_like(x)
    np.add.at(agg, algo.dst, msgs)
    r = algo.c.astype(np.float64) + agg - x
    return np.where(algo.fixed, 0.0, r).astype(np.float32)


def affected_region(algo: AlgoInstance, seeds: np.ndarray) -> np.ndarray:
    """bool[n] — vertices reachable from ``seeds`` along the instance's
    out-edges. Anything whose converged value could have depended on a
    loosened edge lies downstream of that edge's destination; paths through
    *other* removed edges are covered because their destinations seed too."""
    n = algo.n
    reach = np.zeros(n, bool)
    seeds = np.unique(np.asarray(seeds, np.int64))
    if len(seeds) == 0:
        return reach
    indptr, nbrs, _ = Graph(n, algo.src, algo.dst, algo.w).csr()
    reach[seeds] = True
    frontier = seeds
    while len(frontier):
        counts = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            break
        starts = np.repeat(indptr[frontier], counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        nxt = np.unique(nbrs[starts + offs])
        nxt = nxt[~reach[nxt]]
        reach[nxt] = True
        frontier = nxt
    return reach


def _dispatch(engine: str, algo: AlgoInstance, *,
              x_init: Optional[np.ndarray] = None,
              extrapolate_every: int = 0, **kw: Any) -> RunResult:
    # the engine string table IS solve()'s dispatch now: one validation
    # pass, one set of error messages, for direct and incremental runs alike
    from repro_torch.engine.api import solve

    return solve(algo, engine=engine, x_init=x_init,
                 extrapolate_every=extrapolate_every, **kw)


def run_incremental(
    algo_new: AlgoInstance,
    algo_old: AlgoInstance,
    prior: Union[RunResult, np.ndarray],
    *,
    engine: str = "async_block",
    extrapolate_every: Optional[int] = None,
    rank: Optional[np.ndarray] = None,
    **engine_kw: Any,
) -> RunResult:
    """Converge ``algo_new`` warm-started from ``prior`` (converged on
    ``algo_old``); both instances must come from the same constructor in the
    same id space with old ids a prefix of the new (see
    :func:`repro_torch.engine.algorithms.remake`).

    ``rank`` optionally supplies a processing order (e.g. from
    `core.gograph.extend_rank`); the iteration runs relabeled but the
    returned state is always in the instances' id space, so serving code
    never sees the ordering.

    Extra ``engine_kw`` are forwarded to the engine, so
    ``engine="async_block", backend="kernel"`` serves the warm re-run through
    the flat-BSR sweep kernel (`kernels.gs_sweep`): the sum path's delta system packs
    like any other "replace" instance (its residual constant rides the ``c``
    operand), and the min/max paths' warm states enter the kernel through
    ``x_init`` — including the max-semiring workloads (sswp/reachability) the
    kernels now implement. Adding ``sweeps_per_call=R`` batches R sweeps per
    persistent kernel launch, and this function then also seeds the
    kernel's active frontier with exactly the delta-touched blocks: for sum
    semirings the rows where the dense residual is nonzero (everything else
    solves the delta system at its 0 start bitwise), for min/max the
    destinations of mutated edges, the masked recompute region, and the
    appended vertices (every other block's warm value stays self-consistent
    under the monotone combine, so skipping it until a neighbor moves is a
    bitwise no-op). An explicit ``frontier=`` in ``engine_kw`` overrides the
    seeding.

    Returns an ordinary :class:`RunResult` whose ``x`` is the new fixpoint
    and whose ``rounds`` / traces are those of the *incremental* run only —
    for sum semirings they describe the delta system, whose per-round changes
    equal the full system's by linearity.
    """
    if algo_old.name != algo_new.name or algo_old.d != algo_new.d:
        raise ValueError(
            f"instance mismatch: {algo_old.name}/d={algo_old.d} vs "
            f"{algo_new.name}/d={algo_new.d}"
        )
    x_warm = warm_state(algo_new, algo_old, prior)

    # seed the sweep kernel's active frontier from the delta-touched blocks
    # when the caller asked for sweep batching and didn't pin one themselves
    seed_frontier = (
        engine == "async_block"
        and engine_kw.get("backend") == "kernel"
        and int(engine_kw.get("sweeps_per_call", 1)) > 1
        and "frontier" not in engine_kw
    )

    def _run_relabeled(
        algo: AlgoInstance, x_init: Optional[np.ndarray]
    ) -> RunResult:
        """Run `algo` under `rank` (or directly), returning id-space x.

        All the relabel mechanics — permuting x_init/frontier in and the
        result back out — live in ``solve(rank=...)`` now; this wrapper only
        threads the order through."""
        return _dispatch(engine, algo, x_init=x_init, rank=rank, **run_kw)

    if algo_new.semiring.reduce == "sum":
        if extrapolate_every is None:
            # Aitken needs per-sweep host control; the sweep-batched driver
            # only syncs per batch, so it runs unaccelerated — and the push
            # engine is itself the sparse acceleration ("auto" drops the
            # period in solve() if and when it routes to push)
            extrapolate_every = (
                0 if (engine == "push"
                      or int(engine_kw.get("sweeps_per_call", 1)) > 1)
                else DEFAULT_EXTRAPOLATE_EVERY
            )
        run_kw = dict(engine_kw, extrapolate_every=extrapolate_every)
        r = dense_residual(algo_new, x_warm)
        if seed_frontier:
            # the delta system starts at 0: any block with an all-zero
            # residual already satisfies its equation bitwise at that start
            run_kw["frontier"] = np.any(r != 0, axis=1)
        delta_algo = dataclasses.replace(
            algo_new,
            x0=np.zeros_like(x_warm),
            c=r,
            fixed=algo_new.fixed.copy(),
            exact_fn=None,
        )
        res = _run_relabeled(delta_algo, None)
        delta = np.asarray(res.x, np.float32).reshape(x_warm.shape)
        x_full = x_warm + delta
        if algo_new.d == 1:
            x_full = x_full[:, 0]
        return dataclasses.replace(res, x=x_full)

    # min/max semirings: monotone re-lowering / re-raising, with a masked
    # regional recompute when the delta loosens the fixpoint. An explicit
    # extrapolation request is an error here, same as at the engines.
    from repro_torch.engine.harness import check_extrapolation

    check_extrapolation(algo_new, extrapolate_every or 0)
    run_kw = dict(engine_kw, extrapolate_every=0)
    diff = instance_edge_diff(algo_old, algo_new)
    region = None
    if diff.loosening:
        seeds = np.concatenate([diff.removed_dst, diff.loosened_dst])
        region = affected_region(algo_new, seeds)
        x_warm = np.where(region[:, None], algo_new.x0, x_warm)
    if seed_frontier:
        # every warm block outside this set is the old fixpoint fed unchanged
        # in-edges, so its recompute is a bitwise no-op until a neighbor moves
        verts = out_closure(
            algo_new.src, algo_new.dst,
            np.concatenate([diff.added_dst, diff.removed_dst,
                            diff.tightened_dst, diff.loosened_dst]),
            algo_new.n, depth=0,
        )
        verts[algo_old.n:] = True  # appended vertices start at x0
        if region is not None:
            verts |= region
        run_kw["frontier"] = verts
    return _run_relabeled(algo_new, x_warm)
