"""The one validated entry path to the iterative engines: :func:`solve`
(port of ``repro.engine.api``).

One frozen :class:`EngineOptions` record, one :func:`validate_options`
pass, one exception family:

* :class:`EngineOptionsError` (a ``ValueError``) — a malformed or
  meaningless option combination.
* :class:`EngineUnsupportedError` (an :class:`EngineOptionsError` and a
  ``NotImplementedError``) — a meaningful combination this package does not
  implement.

Backends: ``"torch"`` (torch ops, the reference's ``"jax"``) and
``"kernel"`` (the hand-written CUDA kernel, the reference's ``"pallas"``).
``device`` is where the solve runs; it defaults to ``"cuda"``, and a solve
asked to run on a card that is absent raises instead of running elsewhere.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Any, Iterator, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.engine.algorithms import AlgoInstance
    from repro_torch.engine.convergence import RunResult

ENGINES = ("sync", "async_block", "distributed", "push")
BACKENDS = ("torch", "kernel")


class EngineOptionsError(ValueError):
    """An :class:`EngineOptions` combination the engines reject."""


class EngineUnsupportedError(EngineOptionsError, NotImplementedError):
    """A meaningful option combination this package does not implement."""


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Every knob of the reference's ``EngineOptions``, same defaults, plus
    ``device``. See ``repro.engine.api.EngineOptions`` for each field;
    ``backend`` takes ``"torch"`` or ``"kernel"`` here, and ``trace`` a
    `repro_torch.obs.trace.Tracer`.

    device : torch device the solve runs on (default ``"cuda"``); ``"cpu"``
        runs torch ops and, on the kernel backend, the kernel's plain version.
    mesh : for ``engine="distributed"``, a 1-D
        ``torch.distributed.device_mesh.DeviceMesh`` of ``device``'s type
        with a dimension named ``axis`` (None: the default process group's
        world, or one rank when ``torch.distributed`` is not initialized).
    """

    x_init: Optional[np.ndarray] = None
    extrapolate_every: int = 0
    backend: str = "torch"
    bs: int = 256
    inner: int = 1
    sweeps_per_call: int = 1
    frontier: Optional[np.ndarray] = None
    max_iters: int = 2000
    mesh: Any = None
    axis: str = "data"
    transfer_guard: Optional[str] = None
    push_threshold: float = 0.05
    beta: float = 1.0
    buckets: int = 4
    rank: Optional[np.ndarray] = None
    trace: Any = None
    device: str = "cuda"


def validate_options(
    engine: str, o: EngineOptions, algo: "AlgoInstance | None" = None
) -> None:
    """Reject every invalid (engine, options[, algorithm]) combination —
    the reference's checks, with ``"kernel"`` in place of ``"pallas"``."""
    if engine not in ENGINES:
        raise EngineOptionsError(
            f"unknown engine {engine!r}; one of {sorted(ENGINES)}"
        )
    if o.backend not in BACKENDS:
        raise EngineOptionsError(
            f"unknown backend {o.backend!r}; one of {sorted(BACKENDS)}"
        )
    try:
        torch.device(o.device)
    except (RuntimeError, TypeError) as e:
        raise EngineOptionsError(f"device {o.device!r} is not a torch device: {e}") from None
    if o.bs < 1:
        raise EngineOptionsError(f"bs must be >= 1, got {o.bs}")
    if o.inner < 1:
        raise EngineOptionsError(f"inner must be >= 1, got {o.inner}")
    if o.max_iters < 1:
        raise EngineOptionsError(f"max_iters must be >= 1, got {o.max_iters}")
    if o.sweeps_per_call < 1:
        raise EngineOptionsError(
            f"sweeps_per_call must be >= 1, got {o.sweeps_per_call}"
        )
    if o.x_init is not None and np.ndim(o.x_init) not in (1, 2):
        raise EngineOptionsError(
            f"x_init must be (n,), (n, 1) or (n, d), "
            f"got ndim={np.ndim(o.x_init)}"
        )
    if not isinstance(o.axis, str) or not o.axis:
        raise EngineOptionsError(
            f"axis must be a non-empty mesh-axis name, got {o.axis!r}"
        )
    if o.mesh is not None and engine != "distributed":
        raise EngineOptionsError(
            "mesh names the device mesh for engine='distributed'; "
            f"engine={engine!r} runs on one device"
        )
    if o.mesh is not None:
        from repro_torch.engine.distributed import check_mesh

        check_mesh(o.mesh, o.axis, o.device)
    if o.transfer_guard not in (None, "allow", "log", "disallow"):
        raise EngineOptionsError(
            f"transfer_guard must be None, 'allow', 'log' or 'disallow', "
            f"got {o.transfer_guard!r}"
        )
    if not 0.0 <= o.push_threshold <= 1.0:
        raise EngineOptionsError(
            f"push_threshold is a frontier fraction in [0, 1], "
            f"got {o.push_threshold}"
        )
    if not 0.0 <= o.beta <= 1.0:
        raise EngineOptionsError(
            f"beta (push threshold exponent) must be in [0, 1], got {o.beta}"
        )
    if o.buckets < 1:
        raise EngineOptionsError(f"buckets must be >= 1, got {o.buckets}")
    if o.rank is not None:
        if np.ndim(o.rank) != 1:
            raise EngineOptionsError(
                f"rank must be a 1-D permutation of 0..n-1 "
                f"(rank[v] = processing position), got ndim={np.ndim(o.rank)}"
            )
        if algo is not None and len(o.rank) != algo.n:
            raise EngineOptionsError(
                f"rank covers {len(o.rank)} vertices, instance has {algo.n}"
            )
    if o.trace is not None:
        from repro_torch.obs.trace import Tracer

        if not isinstance(o.trace, Tracer):
            raise EngineOptionsError(
                f"trace must be None or a repro_torch.obs.trace.Tracer, "
                f"got {type(o.trace).__name__}"
            )
    if o.backend == "kernel":
        if engine not in ("async_block", "push"):
            raise EngineUnsupportedError(
                f"backend='kernel' runs the fused block-GS sweep "
                f"(engine='async_block') or the bucketed residual-push "
                f"scatter (engine='push'); engine={engine!r} has no kernel"
            )
        if o.inner != 1:
            raise EngineOptionsError(
                "backend='kernel' runs the fused sweep; inner must be 1"
            )
    elif engine != "push" and (o.sweeps_per_call != 1 or o.frontier is not None):
        raise EngineOptionsError(
            "sweeps_per_call/frontier amortize kernel launches — "
            "kernel-backend knobs; backend='torch' supports neither"
        )
    if engine == "push":
        if o.sweeps_per_call != 1 or o.frontier is not None:
            raise EngineOptionsError(
                "engine='push' schedules its own per-round frontier; "
                "sweeps_per_call/frontier are sweep-engine knobs"
            )
        if o.inner != 1:
            raise EngineOptionsError(
                "engine='push' settles one vertex at a time; inner is a "
                "block-engine knob"
            )
        if o.extrapolate_every:
            raise EngineUnsupportedError(
                "engine='push' is itself the sparse acceleration; Aitken "
                "extrapolation applies to the dense sweep engines only"
            )
    if engine == "sync" and o.inner != 1:
        raise EngineOptionsError(
            "engine='sync' runs whole-graph Jacobi rounds; inner is a "
            "block-engine knob"
        )
    if o.extrapolate_every:
        if algo is not None and algo.semiring.reduce != "sum":
            raise EngineUnsupportedError(
                f"extrapolate_every is only valid for linear sum-semiring "
                f"systems; {algo.name!r} uses reduce={algo.semiring.reduce!r}"
            )
        if not o.extrapolate_every >= 2:
            raise EngineOptionsError(
                f"extrapolate_every must be 0 (off) or >= 2, "
                f"got {o.extrapolate_every}"
            )
        if o.sweeps_per_call > 1 or o.frontier is not None:
            raise EngineUnsupportedError(
                "extrapolate_every needs per-sweep host control; "
                "use sweeps_per_call=1"
            )


_SYNC_DEBUG_MODE = {"allow": 0, "log": 1, "disallow": 2}


@contextlib.contextmanager
def _transfer_guard(mode: Optional[str], device: torch.device) -> Iterator[None]:
    """``transfer_guard`` as ``torch.cuda.set_sync_debug_mode`` around the
    solve (the engines' own readouts are audited and exempt); a no-op on the
    CPU."""
    if mode is None or device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(_SYNC_DEBUG_MODE[mode])
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def solve(
    algo: "AlgoInstance",
    engine: str = "async_block",
    options: Optional[EngineOptions] = None,
    **overrides: Any,
) -> "RunResult":
    """Converge ``algo`` with the chosen engine — the single entry path.

    ``engine``: ``"sync"`` (Jacobi rounds, torch ops only),
    ``"async_block"`` (block Gauss–Seidel), ``"distributed"`` (blocks
    sharded across the ranks of ``options.mesh``, `engine.distributed`),
    ``"push"`` (vertex-granular residual push, `engine.push`) or
    ``"auto"`` (the frontier-size router: estimate the initial pending
    fraction with `engine.push.estimate_frontier_fraction` and pick
    ``"push"`` below ``options.push_threshold``, ``"async_block"`` above or
    whenever the semiring has no push formulation).
    ``options`` is an :class:`EngineOptions`; keyword ``overrides`` are
    applied on top. ``rank=`` runs the solve relabeled and returns the
    state in the caller's id space.
    """
    o = options if options is not None else EngineOptions()
    if overrides:
        try:
            o = dataclasses.replace(o, **overrides)
        except TypeError:
            bad = sorted(set(overrides) - {f.name for f in dataclasses.fields(o)})
            raise EngineOptionsError(
                f"unknown EngineOptions field(s) {bad}; valid fields: "
                f"{[f.name for f in dataclasses.fields(o)]}"
            ) from None
    if engine == "auto":
        # the frontier-size router, resolved before validation so the chosen
        # engine's constraints (and only those) apply; sweep-only knobs are
        # dropped when push wins
        from repro_torch.engine import push as _push

        try:
            use_push = _push.estimate_frontier_fraction(algo, o.x_init) < o.push_threshold
        except NotImplementedError:
            use_push = False
        if use_push:
            engine = "push"
            o = dataclasses.replace(
                o, sweeps_per_call=1, frontier=None, extrapolate_every=0,
            )
        else:
            engine = "async_block"
    validate_options(engine, o, algo)
    device = torch.device(o.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={o.device!r} was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    from repro_torch.engine import async_block, distributed, push, sync
    from repro_torch.obs.trace import tspan

    impl = {"sync": sync._solve, "async_block": async_block._solve,
            "distributed": distributed._solve, "push": push._solve}[engine]
    # the span covers the whole call: the relabel into rank space and back
    with tspan(o.trace, "solve", algo=algo.name, engine=engine,
               backend=o.backend, n=algo.n, d=algo.d) as sp:
        rank: Optional[np.ndarray] = None
        if o.rank is not None:
            from repro_torch.engine.harness import permute_state
            from repro_torch.graphs.graph import check_permutation

            rank = np.asarray(o.rank)
            check_permutation(rank, algo.n)
            algo = algo.relabel(rank)
            o = dataclasses.replace(
                o,
                rank=None,
                x_init=None if o.x_init is None
                else permute_state(np.asarray(o.x_init), rank),
                frontier=None if o.frontier is None
                else permute_state(np.asarray(o.frontier), rank),
            )
        with _transfer_guard(o.transfer_guard, device):
            res = impl(algo, o)
        sp.set(rounds=res.rounds, converged=bool(res.converged))
        if rank is not None:
            x = np.asarray(res.x).reshape(algo.n, -1)[rank]
            if algo.d == 1:
                x = x[:, 0]
            res = dataclasses.replace(res, x=x)
    return res
