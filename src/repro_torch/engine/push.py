"""Vertex-granular residual push engine — the ultra-sparse regime (port of
``repro.engine.push``).

The block engines sweep whole ``bs``-blocks, so a delta or a personalized
query touching a few vertices still pays whole blocks per round. This engine
does work proportional to the touched neighborhood: it keeps a ``(p, r)``
pair per query column — ``p`` the settled estimate, ``r`` the pending
residual — and each round *pushes* only the vertices whose residual exceeds
their threshold, scattering one semiring message per out-edge onto the
neighbors' residual rows.

**Sum semirings** (``plus_times`` / ``replace``) keep ``r = c + W p - p``;
``p`` converges to the sweep engines' fixpoint within eps (the stopping rule
``|r| <= eps`` is the sweeps' linf test). The per-vertex threshold is
``eps * outdeg**(1 - beta)`` (``beta = 1``, the default, is uniform eps).

**Lattice semirings** (min/max) hold in ``r`` the best pending candidate; a
vertex is pending while ``combine(p, r)`` beats ``p``. Every scatter is one
of the f32 relaxations a sweep executes, so the resolved state equals
``run_async_block``'s bitwise.

Initialization. Sum: ``p0 = x_init or x0``, ``r0 = dense_residual(algo,
p0)``. Lattice: cold starts ``p0 = identity`` with ``r0 = combine(x0, c)``;
warm starts (``x_init``) add one full aggregate so exactly the rows whose
equation the delta violated become pending. Pinned vertices carry ``x0`` as
their only candidate and are re-clamped every round.

Two backends behind ``EngineOptions.backend``:

* ``"torch"`` — one Jacobi-style push round as torch ops: all active
  vertices push at once through masked edge messages, summed per
  destination in a fixed order (`torch_ops.segment_reduce_sorted`) or
  reduced with ``scatter_reduce_`` (min/max, where order does not matter).
  Frozen columns are masked out of the push, so converged queries stay put
  bitwise.
* ``"kernel"`` — the bucketed scatter kernel (`kernels.push_scatter`): the
  host bins the round's active vertices into ``EngineOptions.buckets``
  priority buckets (best first — smallest tentative distance for min_plus,
  largest residual for sum), and the kernel walks the slots in order, so a
  vertex sees every earlier scatter of its round (Gauss–Seidel freshness).
  As in the reference's Pallas round, columns are not masked. Bucket caps
  round up to a power of two, so the slot order is the reference's.

The router (`estimate_frontier_fraction` + ``solve(engine="auto")``)
estimates the initial pending fraction from the same initialization rule
and routes to push below ``EngineOptions.push_threshold``.

Every device-to-host readout per round (pending counts, per-column metric,
active mask, state sum, priority keys) is audited
(`harness.audited_sync`), so ``transfer_guard="disallow"`` holds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.engine.algorithms import AlgoInstance
from repro_torch.engine.api import EngineOptions
from repro_torch.engine.convergence import RunResult, converge_step
from repro_torch.engine.harness import audited_sync, to_device
from repro_torch.engine import torch_ops as T
from repro_torch.graphs.graph import Graph
from repro_torch.kernels.ops import _KERNEL_SEMIRING
from repro_torch.kernels.semirings import ACC_IDENTITY, pending_cols

# the combine each kernel semiring pairs with; any other pair must fail
# loudly before any state is built
_COMBINES = {"plus_times": "replace", "min_plus": "min_old",
             "max_min": "max_old", "max_times": "max_old"}


def _kernel_semiring(algo: AlgoInstance) -> str:
    key = (algo.semiring.reduce, algo.semiring.edge_op)
    ks = _KERNEL_SEMIRING.get(key)
    if ks is None or algo.combine != _COMBINES[ks]:
        raise NotImplementedError(
            f"push engine: unsupported semiring/combine "
            f"({key}, {algo.combine!r}); supported: "
            f"{sorted((k, _COMBINES[v]) for k, v in _KERNEL_SEMIRING.items())}"
        )
    return ks


def _overlay_x_init(algo: AlgoInstance, x_init: Optional[np.ndarray]) -> np.ndarray:
    """(n, d) f32 start state: algo.x0 with x_init overlaid, pinned rows
    clamped to their pin."""
    x = np.asarray(algo.x0, np.float32).reshape(algo.n, algo.d).copy()
    if x_init is not None:
        xi = np.asarray(x_init, np.float32)
        if xi.ndim == 1:
            xi = xi[:, None]
        if xi.shape != (algo.n, algo.d):
            raise ValueError(
                f"x_init shape {xi.shape} != (n, d) = {(algo.n, algo.d)}"
            )
        x = xi.copy()
    return np.where(algo.fixed, algo.x0, x).astype(np.float32)


def _lattice_residual(
    algo: AlgoInstance, ks: str, p0: np.ndarray, aggregate: bool
) -> np.ndarray:
    """Initial pending-candidate matrix r0 for a lattice start at ``p0``:
    the constant candidates combine(x0, c), plus (``aggregate``, for warm
    starts) one full pass of edge candidates ``edge_op(p0[src], w)``. All
    f32, so candidates are the kernels' exact values. Pinned rows carry x0
    as their only candidate."""
    n, d = algo.n, algo.d
    x0 = np.asarray(algo.x0, np.float32).reshape(n, d)
    c = np.asarray(algo.c, np.float32).reshape(n, d)
    lat_min = ks == "min_plus"
    pair = np.minimum if lat_min else np.maximum
    r0 = pair(x0, c).astype(np.float32)
    if aggregate and len(algo.src):
        w = np.asarray(algo.w, np.float32)[:, None]
        ps = p0[algo.src]
        with np.errstate(over="ignore"):
            if ks == "min_plus":
                msgs = ps + w
            elif ks == "max_min":
                msgs = np.minimum(ps, w)
            else:  # max_times
                msgs = ps * w
        agg = np.full((n, d), ACC_IDENTITY[ks], np.float32)
        if lat_min:
            np.minimum.at(agg, algo.dst, msgs.astype(np.float32))
        else:
            np.maximum.at(agg, algo.dst, msgs.astype(np.float32))
        r0 = pair(r0, agg).astype(np.float32)
    return np.where(algo.fixed, x0, r0).astype(np.float32)


def _init_state(
    algo: AlgoInstance, ks: str, x_init: Optional[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """The uniform (p0, r0) initialization rule (module docstring)."""
    if ks == "plus_times":
        from repro_torch.engine.incremental import dense_residual

        p0 = _overlay_x_init(algo, x_init)
        return p0, dense_residual(algo, p0)
    if x_init is None:
        p0 = np.full((algo.n, algo.d), ACC_IDENTITY[ks], np.float32)
        return p0, _lattice_residual(algo, ks, p0, aggregate=False)
    p0 = _overlay_x_init(algo, x_init)
    return p0, _lattice_residual(algo, ks, p0, aggregate=True)


def estimate_frontier_fraction(
    algo: AlgoInstance, x_init: Optional[np.ndarray] = None
) -> float:
    """Fraction of vertices the push engine would start active — the router
    signal behind ``solve(engine="auto")``. Derived from the engine's own
    initialization rule, so the estimate *is* the round-0 frontier; one
    vectorized O(m) host pass, no iteration."""
    ks = _kernel_semiring(algo)
    p0, r0 = _init_state(algo, ks, x_init)
    if ks == "plus_times":
        pend = np.any(np.abs(r0) > algo.eps, axis=1)
    elif ks == "min_plus":
        pend = np.any(np.minimum(p0, r0) != p0, axis=1)
    else:
        pend = np.any(np.maximum(p0, r0) != p0, axis=1)
    return float(pend.mean()) if algo.n else 0.0


def _eps_vec(algo: AlgoInstance, beta: float) -> np.ndarray:
    """Per-vertex push threshold ``eps * outdeg**(1 - beta)`` (sum only)."""
    if beta == 1.0:
        return np.full(algo.n, algo.eps, np.float32)
    deg = Graph(algo.n, algo.src, algo.dst, algo.w).out_degrees()
    return (algo.eps * np.maximum(deg, 1).astype(np.float64)
            ** (1.0 - beta)).astype(np.float32)


def _prep(ks: str, p: torch.Tensor, r: torch.Tensor, eps_v: torch.Tensor,
          col_live: torch.Tensor):
    """Per-round prep on the device: active-vertex mask, per-column pending
    counts and metric, the bucketing priority key and the state sum."""
    lat_min = ks == "min_plus"
    if ks == "plus_times":
        pend = torch.abs(r) > eps_v[:, None]
        metric = torch.amax(torch.abs(r), dim=0)
    else:
        newp = torch.minimum(p, r) if lat_min else torch.maximum(p, r)
        pend = newp != p
        metric = pending_cols(ks, p, r)
    res_col = torch.sum(pend.to(torch.float32), dim=0)
    live = pend & col_live[None, :]
    active_v = torch.any(live, dim=1)
    if ks == "plus_times":
        key = -torch.amax(torch.where(live, torch.abs(r), 0.0), dim=1)
    else:
        best = torch.amin(newp, dim=1) if lat_min else -torch.amax(newp, dim=1)
        key = torch.where(active_v, best, float("inf"))
    ssum = torch.sum(torch.where(torch.abs(p) < 1e30, p, 0.0))
    return active_v, res_col, metric, key, ssum


class _TorchRound:
    """The vectorized (Jacobi-style) push round as torch ops: every active
    vertex of every live column pushes at once. Converged columns are masked
    out of the push, so they freeze bitwise."""

    def __init__(self, algo: AlgoInstance, ks: str, device: torch.device) -> None:
        self.ks = ks
        order = np.arange(algo.m)
        if ks == "plus_times":
            # edges grouped by destination once (stable within one): each
            # vertex's incoming pushes are summed in that order, the same
            # sum on every run (an index_add_ adds with atomics on the card)
            order = np.argsort(algo.dst, kind="stable")
            self.lengths = to_device(
                np.bincount(algo.dst, minlength=algo.n).astype(np.int64), device)
        self.src = to_device(algo.src.astype(np.int64)[order], device)
        self.dst = to_device(algo.dst.astype(np.int64)[order], device)
        self.w = to_device(np.asarray(algo.w, np.float32)[order, None], device)
        self.fixed = to_device(algo.fixed, device)
        self.x0 = to_device(np.asarray(algo.x0, np.float32).reshape(algo.n, algo.d),
                            device)
        self.ident = ACC_IDENTITY[ks]

    def __call__(self, p, r, active_v, col_live):
        mask = active_v[:, None] & col_live[None, :]
        if self.ks == "plus_times":
            push = torch.where(mask, r, 0.0)
            p2 = p + push
            agg = T.segment_reduce_sorted("sum", self.w * push[self.src], self.lengths, 0.0)
            return p2, torch.where(self.fixed, 0.0, r - push + agg)
        lat_min = self.ks == "min_plus"
        newp = torch.minimum(p, r) if lat_min else torch.maximum(p, r)
        p2 = torch.where(mask, newp, p)
        r2 = torch.where(mask, self.ident, r)
        ps = p2[self.src]
        if self.ks == "min_plus":
            msgs = ps + self.w
        elif self.ks == "max_min":
            msgs = torch.minimum(ps, self.w)
        else:
            msgs = ps * self.w
        msgs = torch.where(mask[self.src], msgs, self.ident)
        agg = torch.full_like(p, self.ident).scatter_reduce_(
            0, self.dst[:, None].expand_as(msgs), msgs,
            reduce="amin" if lat_min else "amax", include_self=True,
        )
        r2 = torch.minimum(r2, agg) if lat_min else torch.maximum(r2, agg)
        return torch.where(self.fixed, self.x0, p2), torch.where(self.fixed, self.x0, r2)


def _pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


class _KernelRound:
    """Host-side bucketing + kernel dispatch for one push round (the
    reference's ``_PallasRound``)."""

    def __init__(self, algo: AlgoInstance, ks: str, buckets: int,
                 device: torch.device) -> None:
        indptr, nbrs, eid = Graph(algo.n, algo.src, algo.dst, algo.w).csr()
        self.indptr = indptr.astype(np.int64)
        self.ks = ks
        self.buckets = buckets
        self.device = device
        self.nbrs = to_device(nbrs.astype(np.int32), device)
        self.ew = to_device(np.asarray(algo.w, np.float32)[eid], device)
        self.fixed = to_device(algo.fixed, device)
        self.x0 = to_device(np.asarray(algo.x0, np.float32).reshape(algo.n, algo.d),
                            device)
        # pinned rows: clamp the state, drop incoming messages; sum discards
        # pinned residual
        self.r_pin = 0.0 if ks == "plus_times" else ACC_IDENTITY[ks]

    def slots(self, ids: np.ndarray, key: np.ndarray):
        """The slot list of one round: ``(vid, seg_start, seg_len, buckets,
        cap)`` as host arrays, best priority first."""
        order = np.argsort(key[ids], kind="stable")
        ids = ids[order].astype(np.int64)
        buckets = min(self.buckets, max(1, len(ids)))
        cap = _pow2(-(-len(ids) // buckets))  # pow2 caps, as in the reference
        vid = np.full(buckets * cap, -1, np.int32)
        vid[: len(ids)] = ids
        seg_s = np.zeros(buckets * cap, np.int32)
        seg_l = np.zeros(buckets * cap, np.int32)
        seg_s[: len(ids)] = self.indptr[ids]
        seg_l[: len(ids)] = self.indptr[ids + 1] - self.indptr[ids]
        return vid, seg_s, seg_l, buckets, cap

    def __call__(self, p, r, ids: np.ndarray, key: np.ndarray):
        from repro_torch.kernels.push_scatter import push_scatter

        vid, seg_s, seg_l, buckets, cap = self.slots(ids, key)
        p, r, _, _ = push_scatter(
            to_device(vid, self.device), to_device(seg_s, self.device),
            to_device(seg_l, self.device), self.nbrs, self.ew, p, r,
            semiring=self.ks, buckets=buckets, cap=cap,
        )
        return (torch.where(self.fixed, self.x0, p),
                torch.where(self.fixed, self.r_pin, r))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _solve(algo: AlgoInstance, o: EngineOptions) -> RunResult:
    """solve()'s dispatch target for ``engine="push"``.

    Keeps the reference's per-round bookkeeping: the legacy ``residuals``
    buffer over working rounds and one convergence-trace entry per counted
    round (empty-frontier accounting rounds included) whose residual is the
    post-round pending metric read at the next round's prep.
    """
    from repro_torch.obs.telemetry import trace_from_push_counts
    from repro_torch.obs.trace import tspan

    ks = _kernel_semiring(algo)
    n, d = algo.n, algo.d
    device = torch.device(o.device)
    with tspan(o.trace, "pack", algo=algo.name, n=n, d=d, engine="push",
               backend=o.backend):
        p0, r0 = _init_state(algo, ks, o.x_init)
        eps_v = (
            _eps_vec(algo, o.beta) if ks == "plus_times"
            else np.zeros(n, np.float32)
        )
        outdeg = np.bincount(algo.src, minlength=n).astype(np.int64)
        p = to_device(p0, device)
        r = to_device(r0, device)
        eps_dev = to_device(eps_v, device)
        round_torch = _TorchRound(algo, ks, device) if o.backend == "torch" else None
        round_kernel = (
            _KernelRound(algo, ks, o.buckets, device) if o.backend == "kernel" else None
        )

    col_done = np.zeros(d, bool)
    col_rounds = np.zeros(d, np.int32)
    res_buf: list[float] = []
    sum_buf: list[float] = []
    trace_res: list[float] = []     # post-round metric per counted round
    trace_pushed: list[float] = []  # vertices settled per counted round
    open_cols: Optional[np.ndarray] = None  # last round's active columns
    touched = np.zeros(n, bool)
    pushed_total = 0
    edges_total = 0
    k = 0
    while k < o.max_iters:
        col_live = to_device(~col_done, device)
        active_v, res_col, metric, key, ssum = _prep(ks, p, r, eps_dev, col_live)
        with audited_sync():  # per-round pending counts drive the host loop
            res_col_h, metric_h = _host(res_col), _host(metric)
        if open_cols is not None:
            # close the previous round's trace entry with its post-round
            # residual — the value this prep just measured
            trace_res.append(float(np.max(np.where(open_cols, metric_h, 0.0))))
            open_cols = None
        _, active_cols, col_done, col_rounds = converge_step(
            res_col_h, 0.0, col_done, col_rounds
        )
        if bool(col_done.all()):
            break
        with audited_sync():  # frontier ids select this round's scatter set
            mask_h = _host(active_v)
        ids = np.nonzero(mask_h)[0]
        if len(ids) == 0:
            # live columns with zero pending rows are done too: loop once
            # more to fold the accounting, no work to dispatch
            trace_res.append(0.0)
            trace_pushed.append(0.0)
            k += 1
            continue
        res_buf.append(float(np.max(metric_h[active_cols])))
        with audited_sync():  # per-round state-sum trace sample
            sum_buf.append(float(ssum))
        touched[ids] = True
        pushed_total += int(len(ids))
        edges_total += int(outdeg[ids].sum())
        trace_pushed.append(float(len(ids)))
        open_cols = active_cols.copy()
        if round_kernel is not None:
            with audited_sync():  # priority keys drive host-side bucketing
                key_h = _host(key)
            p, r = round_kernel(p, r, ids, key_h)
        else:
            assert round_torch is not None
            p, r = round_torch(p, r, active_v, col_live)
        k += 1

    if open_cols is not None:
        # budget exhausted mid-frontier: one extra prep supplies the final
        # round's post-push metric (unconverged exits only)
        _, _, metric, _, _ = _prep(ks, p, r, eps_dev, to_device(~col_done, device))
        with audited_sync():  # final trace entry on a budget-exhausted exit
            metric_h = _host(metric)
        trace_res.append(float(np.max(np.where(open_cols, metric_h, 0.0))))

    converged = bool(col_done.all())
    with audited_sync():  # end-of-run RunResult readout
        x = _host(p).astype(np.float32)
    if d == 1:
        x = x[:, 0]
    res = RunResult(
        x=x,
        rounds=k,
        converged=converged,
        residuals=np.asarray(res_buf, np.float32),
        state_sums=np.asarray(sum_buf, np.float32),
        col_rounds=col_rounds.copy(),
        col_converged=col_done.copy(),
        convergence_trace=trace_from_push_counts(trace_res, trace_pushed, n=n),
    )
    res.push_stats = {
        "pushed": pushed_total,
        "edges": edges_total,
        "touched": int(touched.sum()),
        "touched_fraction": float(touched.mean()) if n else 0.0,
        "rounds": k,
    }
    return res


def run_push(
    algo: AlgoInstance,
    *,
    x_init: Optional[np.ndarray] = None,
    backend: str = "torch",
    beta: float = 1.0,
    buckets: int = 4,
    max_iters: int = 2000,
    device: str = "cuda",
) -> RunResult:
    """Thin shim: ``solve(algo, engine="push", ...)`` with the legacy
    keyword style of the other ``run_*`` entry points."""
    from repro_torch.engine.api import solve

    o = EngineOptions(x_init=x_init, backend=backend, beta=beta,
                      buckets=buckets, max_iters=max_iters, device=device)
    return solve(algo, engine="push", options=o)
