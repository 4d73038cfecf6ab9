"""Block Gauss–Seidel engine (port of ``repro.engine.async_block``).

The processing order is cut into contiguous blocks; blocks run in order
inside one sweep and each block update gathers the *current* state, so
blocks earlier in the order contribute this-round values (the paper's Eq. 2
at block granularity). States are batched ``f32[n, d]`` with per-column
convergence freezing in `engine.harness.loop`. The instance must already be
relabeled with the processing order.

``backend="torch"`` runs each block update as torch ops over the block's
in-edge list (``inner > 1`` re-runs a block update against its own fresh
state).
``backend="kernel"`` runs sweeps through the hand-written kernel
(`kernels.gs_sweep`) over the ragged flat-BSR tiles: with
``sweeps_per_call=1`` one launch per sweep under `harness.loop`; with
``sweeps_per_call=R > 1`` up to R frontier-gated sweeps per launch under
`harness.sweep_batched_loop`.

:class:`AsyncBlockSession` keeps one packed instance and its state resident
on the device across many short batches, with columns swapped in between
them: the engine side of the serving layer's continuous batching.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.engine.algorithms import AlgoInstance
from repro_torch.engine.convergence import RunResult
from repro_torch.engine import harness
from repro_torch.engine import torch_ops as T
from repro_torch.obs.trace import NULL_SPAN, tspan


def _run(
    rows, x_start, x0, c, fixed, *,
    bs: int, nb: int, n_real: int,
    sem_reduce: str, sem_edge: str, comb: str, res_kind: str,
    eps: float, max_iters: int, identity: float, inner: int,
    extrapolate_every: int,
):
    """Torch-ops block sweep driven by `harness.loop`. Block i's in-edges
    are ``rows[i] = (src, lengths, w)`` (`harness.block_segments`: the real
    slots of the padded lists, grouped by destination; padding slots only
    reduce the identity in, so they are dropped), and each destination's
    messages are reduced in slot order, the same sum on every run."""
    d = x0.shape[1]
    c_blk = c.view(nb, bs, d)
    fixed_blk = fixed.view(nb, bs, d)
    x0_blk = x0.view(nb, bs, d)  # pin source stays x0 even when warm-started
    real_mask = torch.arange(nb * bs, device=x0.device) < n_real

    def sweep(x):
        x = x.clone()
        for i in range(nb):
            srcs, lengths, w = rows[i]
            sl = slice(i * bs, (i + 1) * bs)
            for _ in range(inner):
                msgs = T.edge_op(sem_edge, x[srcs], w)
                agg = T.segment_reduce_sorted(sem_reduce, msgs, lengths, identity)
                x[sl] = T.combine(comb, agg, c_blk[i], x[sl], fixed_blk[i], x0_blk[i])
        return x

    return harness.loop(
        sweep, x_start, res_kind=res_kind, eps=eps, max_iters=max_iters,
        real_mask=real_mask, extrapolate_every=extrapolate_every,
    )


def _solve(algo: AlgoInstance, o) -> RunResult:
    """Engine body behind ``solve(algo, engine="async_block", ...)``;
    options are already validated (`engine.api.validate_options`)."""
    device = torch.device(o.device)
    if o.backend == "kernel":
        return _run_async_block_kernel(
            algo, o.bs, o.max_iters, o.x_init,
            extrapolate_every=o.extrapolate_every,
            sweeps_per_call=o.sweeps_per_call, frontier=o.frontier,
            tracer=o.trace, device=device,
        )
    with tspan(o.trace, "pack", algo=algo.name, n=algo.n, d=algo.d, bs=o.bs):
        be, x0, c, fixed, npad = harness.pack(algo, o.bs)

        def dev(a):
            return harness.to_device(a, device)

        rows = harness.block_segments(be, device)
    x_start = harness.init_state(x0, o.x_init, algo.n)
    out = _run(
        rows, dev(x_start), dev(x0), dev(c), dev(fixed),
        bs=o.bs, nb=be.nb, n_real=algo.n,
        sem_reduce=algo.semiring.reduce,
        sem_edge=algo.semiring.edge_op,
        comb=algo.combine,
        res_kind=algo.residual,
        eps=algo.eps,
        max_iters=o.max_iters,
        identity=algo.semiring.identity,
        inner=o.inner,
        extrapolate_every=o.extrapolate_every,
    )
    return harness.finalize(algo, *out)


def run_async_block(
    algo: AlgoInstance, bs: int = 256, max_iters: int = 2000, inner: int = 1,
    x_init: np.ndarray | None = None, backend: str = "torch",
    extrapolate_every: int = 0, sweeps_per_call: int = 1,
    frontier: np.ndarray | None = None, device: str = "cuda",
) -> RunResult:
    """Thin shim over ``solve(algo, engine="async_block")`` — the legacy
    keyword spelling of the reference."""
    from repro_torch.engine.api import EngineOptions, solve

    return solve(algo, engine="async_block", options=EngineOptions(
        x_init=x_init, extrapolate_every=extrapolate_every, backend=backend,
        bs=bs, inner=inner, sweeps_per_call=sweeps_per_call,
        frontier=frontier, max_iters=max_iters, device=device,
    ))


def _run_async_block_kernel(
    algo, bs, max_iters, x_init, extrapolate_every=0, sweeps_per_call=1,
    frontier=None, tracer=None, device=torch.device("cuda"),
) -> RunResult:
    """Counterpart of the reference's ``_run_async_block_pallas``."""
    from repro_torch.graphs.blocked import frontier_blocks
    from repro_torch.kernels.gs_sweep import gs_multisweep, gs_sweep
    from repro_torch.kernels.ops import pack_algorithm

    with tspan(tracer, "pack", algo=algo.name, n=algo.n, d=algo.d, bs=bs):
        ops = pack_algorithm(algo, bs, device=device)
    # the state is its own buffer, never x0: the kernel updates it in place
    x_start = harness.to_device(
        harness.init_state(ops["x0_host"], x_init, algo.n), device)
    nb = int(ops["rowptr"].shape[0]) - 1
    real_mask = torch.arange(x_start.shape[0], device=device) < algo.n
    if sweeps_per_call == 1 and frontier is None:
        def sweep(x):
            # loop() keeps the pre-sweep state for freezing: sweep a copy
            return gs_sweep(
                ops["rowptr"], ops["tilecols"], ops["tiles"], ops["c"],
                ops["x0"], ops["fixed"], x.clone(),
                semiring=ops["semiring"], combine=ops["combine"], bs=bs,
            )

        out = harness.loop(
            sweep, x_start, res_kind=algo.residual, eps=algo.eps,
            max_iters=max_iters, real_mask=real_mask,
            extrapolate_every=extrapolate_every,
        )
        return harness.finalize(algo, *out)

    dirty0 = harness.to_device(frontier_blocks(frontier, algo.n, bs), device)

    def batch_fn(x, dirty):
        return gs_multisweep(
            ops["rowptr"], ops["tilecols"], ops["revptr"], ops["revrows"],
            dirty, ops["tiles"], ops["c"], ops["x0"], ops["fixed"], x,
            semiring=ops["semiring"], combine=ops["combine"],
            res_kind=algo.residual, bs=bs, sweeps=sweeps_per_call,
            eps=float(algo.eps),
        )

    out = harness.sweep_batched_loop(
        batch_fn, x_start, dirty0,
        eps=algo.eps, max_iters=max_iters, sweeps=sweeps_per_call, nb=nb,
        real_mask=real_mask,
    )
    res = harness.finalize(algo, *out[:6])
    res.active_block_fraction = out[6]
    from repro_torch.obs.telemetry import trace_from_block_activity

    res.convergence_trace = trace_from_block_activity(
        res.residuals, out[6], rounds=res.rounds, nb=nb, bs=bs, d=algo.d,
    )
    return res


@dataclasses.dataclass
class BatchReport:
    """Outcome of one bounded-round session batch (host-side, per column)."""

    rounds: int                # rounds the batch actually executed
    col_done: np.ndarray       # bool[d]  — converged within THIS batch
    col_rounds: np.ndarray     # int32[d] — rounds each column was active


class AsyncBlockSession:
    """Pre-packed block-GS runner for repeated bounded-round batches over a
    resident ``f32[npad, d]`` state — the engine side of continuous batching
    (port of the reference's ``AsyncBlockSession``).

    The session packs the family's edge structure **once**; each
    :meth:`run_batch` drives up to ``max_iters`` rounds through the shared
    round driver, and :meth:`swap_in` re-initialises one column between
    batches (`harness.swap_in_column_device`: the newcomer's ``x0 / c /
    fixed`` written into the operand columns, the state column reset to
    the newcomer's start). The session owns the *cumulative* per-column
    accounting (``col_done`` / ``col_rounds``, folded from every batch's
    report); :meth:`swap_in` resets it for exactly the swapped column, so
    ``col_rounds[j]`` always reads the rounds the slot's current query has
    consumed since its swap-in.

    Everything stays on ``device``: the state, the operands, the dirty-block
    frontier and the accounting. Host transfers are the newcomer's vectors
    at a swap, the frontier bits it adds, and one readout per batch, each
    audited (`harness.audited_sync`).

    Backends: ``"torch"`` (torch-ops block sweep) and ``"kernel"`` (the
    sweep kernel: `kernels.gs_sweep.gs_sweep` under `harness.loop` with
    ``sweeps_per_call=1``; `kernels.gs_sweep.gs_multisweep` under
    `harness.sweep_batched_loop` with ``sweeps_per_call > 1``, the dirty
    bitmap carried from batch to batch and across swaps: a swapped-in column
    ORs the depth-1 out-closure of its support into it). The kernel updates
    the state in place, so :attr:`x` is always the state the last launch
    returned. ``"distributed"`` backs the family with the superstep of
    `engine.distributed.DistContext` (``mesh`` / ``axis`` select the ranks;
    the state has the context's ``npad2`` rows).

    A column's trajectory from swap-in to convergence is what a solo
    `run_async_block` of that query produces: min/max columns bitwise, sum
    columns within the stopping tolerance under ``sweeps_per_call > 1``
    (no freezing mid-batch).
    """

    def __init__(
        self, algo: AlgoInstance, bs: int = 256, inner: int = 1,
        backend: str = "torch", sweeps_per_call: int = 1,
        mesh=None, axis: str = "data",
        trace=None, trace_attrs: dict | None = None, device: str = "cuda",
    ):
        from repro_torch.engine.api import EngineOptions, validate_options

        engine = "distributed" if backend == "distributed" else "async_block"
        validate_options(engine, EngineOptions(
            backend="torch" if backend == "distributed" else backend,
            bs=bs, inner=inner, sweeps_per_call=sweeps_per_call,
            mesh=mesh, axis=axis, trace=trace, device=device,
        ), algo)
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} was asked for but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        self.algo = algo
        self.bs = bs
        self.inner = inner
        self.backend = backend
        self.sweeps_per_call = sweeps_per_call
        self.device = dev
        self.n = algo.n
        self.d = algo.d
        self.trace = trace
        self.trace_attrs = dict(trace_attrs or {})
        with tspan(trace, "pack", algo=algo.name, n=algo.n, d=algo.d, bs=bs,
                   backend=backend, **self.trace_attrs):
            if backend == "torch":
                be, x0, c, fixed, _ = harness.pack(algo, bs)
                self.nb = be.nb
                self._rows = harness.block_segments(be, dev)
                self.x0 = harness.to_device(x0, dev)
                self.c = harness.to_device(c, dev)
                self.fixed = harness.to_device(fixed, dev)
                self.x = self.x0.clone()
            elif backend == "distributed":
                from repro_torch.engine.distributed import DistContext

                self._dist = DistContext(algo, bs, mesh=mesh, axis=axis,
                                         inner=inner, device=device)
                self.nb = self._dist.nb
                self.x0 = harness.to_device(self._dist.x0, dev)
                self.c = harness.to_device(self._dist.c, dev)
                self.fixed = harness.to_device(self._dist.fixed, dev)
                self.x = self.x0.clone()
            else:
                from repro_torch.kernels.ops import pack_algorithm

                ops = pack_algorithm(algo, bs, device=dev)
                self.nb = int(ops["rowptr"].shape[0]) - 1
                # the state is its own buffer, never x0: the kernel writes it
                self.x = ops.pop("x")
                self.x0, self.c, self.fixed = ops["x0"], ops["c"], ops["fixed"]
                self._ops = ops
                # cold start: every block dirty
                self.dirty = torch.ones(self.nb, dtype=torch.int32, device=dev)
        self._real_mask = torch.arange(self.x.shape[0], device=dev) < self.n
        self.col_done = torch.zeros(self.d, dtype=torch.bool, device=dev)
        self.col_rounds = torch.zeros(self.d, dtype=torch.int32, device=dev)

    @property
    def state(self) -> torch.Tensor:
        """The resident (n, d) state, padding rows stripped: a view of the
        buffer the next batch writes, so copy what must outlive it."""
        return self.x[: self.n]

    def load_state_column(self, j: int, col) -> None:
        """Overwrite state column ``j`` rows ``< n`` (delta-rebuild carry);
        padding rows keep their pinned fills."""
        if not isinstance(col, torch.Tensor):
            col = harness.to_device(np.asarray(col, np.float32), self.device)
        self.x[: self.n, j] = col.reshape(-1).to(torch.float32)

    def set_col_rounds(self, j: int, rounds: int) -> None:
        """Seed column ``j``'s cumulative round count (delta-rebuild carry)."""
        from repro_torch.engine.convergence import device_index

        self.col_rounds = self.col_rounds.index_fill(
            0, device_index([j], self.device), int(rounds))

    def swap_in(self, j: int, q_x0, q_c, q_fixed) -> None:
        """Install a new query into column ``j`` (between batches); with a
        tracer a ``swap_in`` span, ``touched`` the vertices whose blocks
        it marks dirty."""
        with tspan(self.trace, "swap_in", slot=j) as sp:
            self._swap_in_inner(j, q_x0, q_c, q_fixed, sp)

    def _swap_in_inner(self, j: int, q_x0, q_c, q_fixed, sp) -> None:
        from repro_torch.engine.convergence import reinit_columns

        self.col_done, self.col_rounds = reinit_columns(
            self.col_done, self.col_rounds, [j]
        )
        q_x0, q_c = np.asarray(q_x0), np.asarray(q_c)
        q_fixed = np.asarray(q_fixed).astype(bool)
        self.x, self.x0, self.c, self.fixed = harness.swap_in_column_device(
            self.x, self.x0, self.c, self.fixed, j, self.n, q_x0, q_c, q_fixed,
            x0_fill=self.algo.semiring.identity, c_fill=self.algo.c_pad_fill,
        )
        if self.backend == "kernel" and self.sweeps_per_call > 1:
            from repro_torch.graphs.delta import out_closure
            from repro_torch.kernels.gs_sweep import or_dirty_blocks

            support = harness.column_support(
                q_x0, q_c, q_fixed, reduce=self.algo.semiring.reduce,
                c_fill=self.algo.c_pad_fill,
            )
            # the support AND what its out-edges feed: an injected seed may
            # already satisfy its own equation, so its block would never
            # change and re-mark its dependents
            touched = out_closure(
                self.algo.src, self.algo.dst, support, self.n, depth=1
            )
            self.dirty = or_dirty_blocks(self.dirty, touched, self.n, self.bs)
            if sp is not NULL_SPAN:
                sp.set(touched=int(np.count_nonzero(touched)))

    def run_batch(self, max_iters: int) -> BatchReport:
        """Advance every column up to ``max_iters`` rounds (converged
        columns freeze under the per-sweep drivers; the batch stops early
        once all columns are done) and fold the report into the cumulative
        accounting. With a tracer the batch is a ``batch`` span carrying
        the session's attributes, the round count and the residuals, read
        in the batch's one readout, and under the multi-sweep kernel
        ``active``, each sweep's share of blocks swept."""
        with tspan(self.trace, "batch", backend=self.backend,
                   max_iters=max_iters, **self.trace_attrs) as sp:
            return self._run_batch_inner(max_iters, sp)

    def _run_batch_inner(self, max_iters: int, sp) -> BatchReport:
        a = self.algo
        if max_iters % self.sweeps_per_call:
            # the kernel runs sweeps_per_call sweeps per launch; another
            # budget would advance the state by uncounted sweeps
            raise ValueError(
                f"max_iters={max_iters} must be a multiple of "
                f"sweeps_per_call={self.sweeps_per_call}"
            )
        if self.backend == "torch":
            out = _run(
                self._rows, self.x, self.x0, self.c, self.fixed,
                bs=self.bs, nb=self.nb, n_real=self.n,
                sem_reduce=a.semiring.reduce, sem_edge=a.semiring.edge_op,
                comb=a.combine, res_kind=a.residual, eps=a.eps,
                max_iters=max_iters, identity=a.semiring.identity,
                inner=self.inner, extrapolate_every=0,
            )
        elif self.backend == "distributed":
            out = self._dist.run(
                self.x, self.x0, self.c, self.fixed, max_iters=max_iters,
            )
        elif self.sweeps_per_call == 1:
            from repro_torch.kernels.gs_sweep import gs_sweep

            ops = self._ops

            def sweep(x):
                # loop() keeps the pre-sweep state for freezing: sweep a copy
                return gs_sweep(
                    ops["rowptr"], ops["tilecols"], ops["tiles"], self.c,
                    self.x0, self.fixed, x.clone(),
                    semiring=ops["semiring"], combine=ops["combine"], bs=self.bs,
                )

            out = harness.loop(
                sweep, self.x, res_kind=a.residual, eps=a.eps,
                max_iters=max_iters, real_mask=self._real_mask,
            )
        else:
            from repro_torch.kernels.gs_sweep import gs_multisweep

            ops = self._ops

            def batch_fn(x, dirty):
                return gs_multisweep(
                    ops["rowptr"], ops["tilecols"], ops["revptr"],
                    ops["revrows"], dirty, ops["tiles"], self.c, self.x0,
                    self.fixed, x,
                    semiring=ops["semiring"], combine=ops["combine"],
                    res_kind=a.residual, bs=self.bs,
                    sweeps=self.sweeps_per_call, eps=float(a.eps),
                )

            out = harness.sweep_batched_loop(
                batch_fn, self.x, self.dirty,
                eps=a.eps, max_iters=max_iters, sweeps=self.sweeps_per_call,
                nb=self.nb, real_mask=self._real_mask,
            )
            self.dirty = out[7]  # the frontier carried into the next batch
            if sp is not NULL_SPAN:
                sp.set(active=[float(v) for v in out[6]])
        # the kernel wrote this buffer in place; the next batch and any swap
        # consume it directly
        self.x = out[0]
        rounds = int(out[1])
        traced = self.trace is not None and self.trace.enabled
        with harness.audited_sync():  # the batch's one (d,)-sized readout
            col_done, col_rounds, res_buf = (
                np.asarray(v.cpu()) if isinstance(v, torch.Tensor) else np.asarray(v)
                for v in (out[2], out[3], out[4] if traced else ())
            )
        if traced:
            sp.set(rounds=rounds, res=[float(v) for v in res_buf[:rounds]])
        rep = BatchReport(
            rounds=rounds, col_done=col_done.astype(bool),
            col_rounds=col_rounds.astype(np.int32),
        )
        # fold into the cumulative accounting on the device: columns done
        # before this batch only re-verified (their 1-round report is not
        # progress)
        still_active = ~self.col_done
        self.col_rounds = self.col_rounds + torch.where(
            still_active, harness.to_device(rep.col_rounds, self.device), 0
        )
        self.col_done = self.col_done | harness.to_device(rep.col_done, self.device)
        return rep
