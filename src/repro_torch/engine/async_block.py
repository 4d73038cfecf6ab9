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
        real_mask=real_mask, tracer=tracer,
    )
    res = harness.finalize(algo, *out[:6])
    res.active_block_fraction = out[6]
    from repro_torch.obs.telemetry import trace_from_block_activity

    res.convergence_trace = trace_from_block_activity(
        res.residuals, out[6], rounds=res.rounds, nb=nb, bs=bs, d=algo.d,
    )
    return res
