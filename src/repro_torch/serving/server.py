"""Continuous-batching GraphServer — the serving front end over the engines
(port of ``repro.serving.server``).

A static f32[n, d] batch wastes its converged columns, because per-query
round counts are heavily skewed (paper Fig. 7) and every finished query's
slot idles until the slowest one drains. :class:`GraphServer` is the graph
analogue of an LLM server's continuous batching:

* :meth:`submit` files a :class:`Ticket`. Queries of the same *family*
  (same tenant + algorithm structure — edges, semiring, combine, eps; see
  `scheduler.family_key`) share one resident state matrix whose columns are
  slots.
* The event loop (:meth:`step`) packs queued tickets into free columns,
  runs a bounded batch of engine rounds (`engine.async_block.
  AsyncBlockSession`), and on per-column convergence **swaps the finished
  column out and a queued query in**: the newcomer's ``x0``/``c``/``fixed``
  overwrite the column on the device (`harness.swap_in_column_device`), its
  convergence bookkeeping resets, and under the multi-sweep kernel the
  depth-1 out-closure of its support is OR-ed into the dirty frontier
  (`kernels.gs_sweep.or_dirty_blocks`) so only what the newcomer needs is
  re-touched.
* The server is **multi-tenant**: it hosts several independent graphs side
  by side (:meth:`add_tenant`), each with its own graph version, families,
  and deltas. :meth:`step` interleaves family batches round-robin *across
  tenants* with a rotating start; `ServerStats.tenant_batches` exposes the
  share each tenant actually received.
* Results land in a byte-budgeted LRU graph-version cache (`serving.cache`)
  keyed by ``(tenant, algo, params)``; a later identical submit is served
  without running anything.
* :meth:`apply_delta` ingests a live :class:`~repro_torch.graphs.delta.
  GraphDelta` between batches for one tenant: its graph version bumps, its
  cache entries whose support intersects the delta-touched blocks are
  invalidated (the rest promoted), and its in-flight queries either
  continue warm (``delta_mode="warm"``, the carry assembled on the device)
  or restart on the new graph (``delta_mode="restart"``, keeping per-query
  round counts solo-exact).

The sessions live on ``device`` (``"cuda"`` unless the caller asks for
``"cpu"``): state, operands, frontier bitmaps and per-column accounting stay
there across batches, swaps and delta rebuilds. The host reads, each in an
audited readout (`engine.harness.audited_sync`): the ``(d,)`` accounting
once per family batch, one ``(n,)`` column per resolved ticket, and one warm
column per push absorption. ``transfer_guard`` arms
``torch.cuda.set_sync_debug_mode`` around every :meth:`step`, so any other
synchronisation inside a tick faults.

Correctness contract (held against the reference by
``tests/test_torch_serving.py``): a query's resolved state and round count
equal a solo ``run_async_block`` of the same query on the graph version it
ran against — bitwise for min/max semirings, within eps (and a round) for
sum semirings under ``sweeps_per_call > 1`` — for any arrival schedule,
batch granularity and admission policy, because state-matrix columns are
independent under every sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.gograph import RankMaintainer, regional_rerank
from repro_torch.core.metric import MetricTracker
from repro_torch.engine import harness
from repro_torch.engine.algorithms import ALGORITHMS, AlgoInstance, get_algorithm, remake
from repro_torch.engine.api import _transfer_guard
from repro_torch.engine.async_block import AsyncBlockSession
from repro_torch.engine.incremental import (
    affected_region,
    instance_edge_diff,
)
from repro_torch.graphs.delta import GraphDelta
from repro_torch.graphs.graph import Graph, check_permutation, rank_to_order
from repro_torch.obs.trace import Tracer, tspan
from repro_torch.serving.cache import ResultCache
from repro_torch.serving.scheduler import Scheduler, canon, family_key
from repro_torch.serving.stats import ServerStats

DEFAULT_TENANT = "default"


@dataclasses.dataclass
class Ticket:
    """One submitted query, tracked from admission to resolution."""

    id: int
    algo: str
    params: dict
    priority: int
    deadline: Optional[float]     # seconds after submit (EDF policy input)
    family: tuple                 # (tenant,) + scheduler.family_key(...)
    submitted_at: float
    graph_version: int            # version submitted at; updated on resolve
    tenant: str = DEFAULT_TENANT
    status: str = "queued"        # queued | running | done | cached | failed
    started_at: Optional[float] = None
    resolved_at: Optional[float] = None
    rounds: int = 0               # engine rounds this query consumed
    converged: bool = False
    from_cache: bool = False
    result: Optional[np.ndarray] = None   # (n,) state at resolution
    error: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.status in ("done", "cached", "failed")


@dataclasses.dataclass
class _ReorderTuner:
    """Per-tenant rounds-saved measurement behind the online reordering knob.

    The payoff of a better order depends on graph structure — some tenants
    simply cannot win. The tuner compares the mean resolved rounds-per-query
    over a window before each order swap against the window after it;
    ``patience`` consecutive swaps with no measured gain flip ``enabled``
    off, and the server stops re-ranking that tenant (the metric tracker
    keeps counting, so telemetry still shows the decay it chose to ignore).
    """

    patience: int
    window: int = 8
    min_gain: float = 0.0
    strikes: int = 0
    swaps: int = 0
    enabled: bool = True
    _recent: list = dataclasses.field(default_factory=list)
    _before: Optional[float] = None
    _after: Optional[list] = None

    def record_resolve(self, rounds: int) -> None:
        self._recent.append(rounds)
        if len(self._recent) > 4 * self.window:
            del self._recent[: len(self._recent) // 2]
        if self._after is not None:
            self._after.append(rounds)
            if len(self._after) >= self.window:
                self._judge()

    def note_swap(self) -> None:
        self.swaps += 1
        if self._recent:
            tail = self._recent[-self.window:]
            self._before = sum(tail) / len(tail)
            self._after = []
        # no resolved history yet: nothing to compare against, skip measuring

    def _judge(self) -> None:
        assert self._after is not None
        after = sum(self._after) / len(self._after)
        if self._before is not None and self._before - after <= self.min_gain:
            self.strikes += 1
            if self.strikes >= self.patience:
                self.enabled = False
        else:
            self.strikes = 0
        self._before, self._after = None, None


@dataclasses.dataclass
class _Tenant:
    """One independently served (and independently evolving) graph."""

    name: str
    g: Graph
    graph_version: int = 0
    # online reordering state (None everywhere = id-order serving): rank is
    # the tenant's processing order, order its inverse (order[p] = vertex at
    # position p), tracker the incremental M
    # counter, maintainer the persistent extend_rank, tuner the rounds-win
    # measurement that can disable re-ranking for this tenant
    rank: Optional[np.ndarray] = None
    order: Optional[np.ndarray] = None
    tracker: Optional[MetricTracker] = None
    maintainer: Optional[RankMaintainer] = None
    tuner: Optional[_ReorderTuner] = None


@dataclasses.dataclass
class _Family:
    """One resident state matrix + its slot bookkeeping."""

    key: tuple
    tenant: str
    probe: AlgoInstance                 # d = 1 structural reference
    session: AsyncBlockSession
    tickets: list                       # Optional[Ticket] per slot
    queries: list                       # Optional[AlgoInstance] per slot
    # (ticket_id, instance) built by _ensure_family's probe pass, consumed
    # by _fill_slots so the family-opening query isn't constructed twice
    probe_cache: Optional[tuple] = None

    def free_slots(self) -> list[int]:
        return [j for j, t in enumerate(self.tickets) if t is None]

    def occupied(self) -> list[tuple[int, Ticket]]:
        return [(j, t) for j, t in enumerate(self.tickets) if t is not None]


class GraphServer:
    """Continuous-batching query server over one or more (evolving) graphs.

    Parameters
    ----------
    graph : the default tenant's graph (mutated only through
        :meth:`apply_delta`). Add further tenants with :meth:`add_tenant`
        or pass ``graphs`` directly.
    graphs : optional ``{tenant_name: Graph}`` mapping served alongside
        (or instead of) ``graph``.
    slots : columns per family's resident state matrix (the ``d`` of the
        f32[n, d] batches).
    rounds_per_batch : engine rounds between swap opportunities. Smaller =
        tighter refill latency, more host round-trips; must be a multiple
        of ``sweeps_per_call``.
    backend / inner / sweeps_per_call / bs : forwarded to
        `engine.async_block.AsyncBlockSession` (``"torch"``, ``"kernel"``,
        or ``"distributed"``: each family backed by the superstep of
        `engine.distributed.DistContext` over the default process group's
        ranks, or one rank when ``torch.distributed`` is not initialized).
    device : torch device the families live on (``"cuda"`` unless asked
        otherwise; a card that is absent raises).
    policy : admission order — "fifo" | "priority" | "deadline".
    cache : enable the graph-version result cache.
    cache_max_bytes : byte budget for the cache (LRU eviction); None =
        unbounded.
    refill : "continuous" (swap per converged column — the point of this
        module) or "static" (refill only when every slot resolved; the
        benchmark baseline).
    delta_mode : in-flight queries across :meth:`apply_delta` — "warm"
        (keep progress; min/max still resolve bitwise-exact states, sum
        within eps; round counts reflect the warm continuation) or
        "restart" (recompute from x0 on the new graph; round counts stay
        solo-exact).
    transfer_guard : synchronisation sanitizer wrapped around every
        :meth:`step` tick (None = off, or ``"allow"`` / ``"log"`` /
        ``"disallow"``, as ``torch.cuda.set_sync_debug_mode`` 0 / 1 / 2 on a
        CUDA device; no effect on the CPU); with ``"disallow"`` any
        unaudited synchronisation inside the serving loop faults.
    push_threshold : frontier-fraction cutoff for vertex-granular delta
        absorption (0 = off). When :meth:`apply_delta` lands a warm-mode
        delta whose depth-1 out-closure (`GraphDelta.touched_vertices`
        with ``closure=1``) covers less than this fraction of the tenant's
        vertices, each in-flight column is resolved to its new fixpoint by
        the residual push engine (``solve(engine="push")``) during the
        rebuild — work proportional to the touched neighborhood — instead
        of re-sweeping ``bs``-blocks next tick (the push engine's
        ``backend="torch"``, as the reference absorbs with its ``"jax"``).
    rank : processing order for the default tenant (``rank[v]`` = position,
        e.g. a `core.gograph.gograph_order` result). The tenant's sessions
        pack and sweep relabeled; queries and results stay in id space.
        ``add_tenant`` takes a per-tenant rank. None = id order, unless
        ``reorder_threshold > 0`` (which starts from the identity order).
    reorder_threshold : online reordering trigger (0 = off). Each tenant
        gets a `core.metric.MetricTracker`; after a delta lands, any rank
        region whose positive-edge fraction fell below this value (and
        below its level at the last re-rank) is repaired with
        `core.gograph.regional_rerank` and the new order is swapped into
        the tenant's families at the batch boundary (:meth:`swap_order`
        semantics: in-flight state carried by a permutation on the device,
        bitwise for min/max).
    reorder_regions : rank regions the metric tracker watches per tenant.
    reorder_patience : consecutive order swaps with no measured
        rounds-per-query win before the per-tenant auto-tuner disables
        reordering for that tenant (`ServerStats.reorders_disabled`).
    trace : optional `repro_torch.obs.trace.Tracer` shared by the serving
        loop and the per-family engine sessions. The server emits ``delta_apply`` spans,
        ``reorder_swap`` / ``resolve`` events, and forwards the tracer to
        each `AsyncBlockSession` (``pack`` / ``batch`` / ``sweep_call``
        spans tagged with tenant, family, and graph version). Tracing is
        batch-granular: it adds no readout beyond the audited per-batch
        one.
    """

    def __init__(
        self, graph: Optional[Graph] = None, *,
        graphs: Optional[dict] = None, slots: int = 8, bs: int = 64,
        rounds_per_batch: int = 8, inner: int = 1, backend: str = "torch",
        sweeps_per_call: int = 1, policy: str = "fifo", cache: bool = True,
        cache_max_bytes: Optional[int] = None,
        refill: str = "continuous", delta_mode: str = "warm",
        max_rounds_per_query: int = 2000,
        transfer_guard: Optional[str] = None,
        push_threshold: float = 0.0,
        rank: Optional[np.ndarray] = None,
        reorder_threshold: float = 0.0,
        reorder_regions: int = 8,
        reorder_patience: int = 2,
        trace: Optional[Tracer] = None,
        device: str = "cuda",
    ) -> None:
        if refill not in ("continuous", "static"):
            raise ValueError(f"unknown refill mode {refill!r}")
        if not 0.0 <= reorder_threshold <= 1.0:
            raise ValueError(
                f"reorder_threshold is an M fraction in [0, 1], "
                f"got {reorder_threshold}"
            )
        if reorder_regions < 1:
            raise ValueError(
                f"reorder_regions must be >= 1, got {reorder_regions}"
            )
        if reorder_patience < 1:
            raise ValueError(
                f"reorder_patience must be >= 1, got {reorder_patience}"
            )
        if rank is not None and graph is None:
            raise ValueError(
                "rank orders the default tenant; pass graph=, or use "
                "add_tenant(name, graph, rank=...) for named tenants"
            )
        if transfer_guard not in (None, "allow", "log", "disallow"):
            raise ValueError(
                f"transfer_guard must be None, 'allow', 'log' or 'disallow', "
                f"got {transfer_guard!r}"
            )
        if not 0.0 <= push_threshold <= 1.0:
            raise ValueError(
                f"push_threshold is a frontier fraction in [0, 1], "
                f"got {push_threshold}"
            )
        if delta_mode not in ("warm", "restart"):
            raise ValueError(f"unknown delta_mode {delta_mode!r}")
        if trace is not None and not isinstance(trace, Tracer):
            raise TypeError(
                f"trace must be a repro_torch.obs.trace.Tracer or None, "
                f"got {type(trace).__name__}"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} was asked for but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if rounds_per_batch < 1:
            # 0 would run zero-round batches forever without ever resolving
            raise ValueError(
                f"rounds_per_batch must be >= 1, got {rounds_per_batch}"
            )
        if sweeps_per_call < 1:
            raise ValueError(f"sweeps_per_call must be >= 1, got {sweeps_per_call}")
        if rounds_per_batch % sweeps_per_call:
            raise ValueError(
                "rounds_per_batch must be a multiple of sweeps_per_call "
                "(the kernel advances whole batches of sweeps)"
            )
        self.reorder_threshold = reorder_threshold
        self.reorder_regions = reorder_regions
        self.reorder_patience = reorder_patience
        self.tenants: dict[str, _Tenant] = {}
        if graph is not None:
            ten = _Tenant(DEFAULT_TENANT, graph)
            self.tenants[DEFAULT_TENANT] = ten
            self._init_tenant_order(ten, rank)
        for name, g in (graphs or {}).items():
            if name in self.tenants:
                raise ValueError(f"duplicate tenant {name!r}")
            ten = _Tenant(name, g)
            self.tenants[name] = ten
            self._init_tenant_order(ten, None)
        if not self.tenants:
            raise ValueError("GraphServer needs at least one graph to serve")
        self.slots = slots
        self.bs = bs
        self.rounds_per_batch = rounds_per_batch
        self.inner = inner
        self.backend = backend
        self.sweeps_per_call = sweeps_per_call
        self.refill = refill
        self.delta_mode = delta_mode
        self.max_rounds_per_query = max_rounds_per_query
        self.transfer_guard = transfer_guard
        self.push_threshold = push_threshold
        self.scheduler = Scheduler(policy)
        self.cache = ResultCache(max_bytes=cache_max_bytes) if cache else None
        self.trace = trace
        self.stats = ServerStats(slots=slots)
        # LIVE (queued/running) tickets only: terminal transitions drop the
        # entry so a long-running server doesn't retain every (n,) result
        # ever served — the caller's own Ticket reference from submit()
        # keeps the result alive exactly as long as the caller wants it
        self.tickets: dict[int, Ticket] = {}
        self._families: dict[tuple, _Family] = {}
        self._next_id = 0
        self._rr = 0   # rotating tenant offset for cross-tenant fairness

    # ---------------------------------------------------------- back-compat
    # single-tenant spelling: srv.g / srv.graph_version read the default
    # tenant, exactly the pre-multi-tenant surface

    @property
    def g(self) -> Graph:
        return self.tenants[DEFAULT_TENANT].g

    @property
    def graph_version(self) -> int:
        return self.tenants[DEFAULT_TENANT].graph_version

    # ------------------------------------------------------------------ API

    def add_tenant(self, name: str, graph: Graph,
                   rank: Optional[np.ndarray] = None) -> None:
        """Serve another independent graph under ``name``, optionally under
        a processing order ``rank`` (see the constructor's ``rank``)."""
        if name in self.tenants:
            raise ValueError(f"duplicate tenant {name!r}")
        ten = _Tenant(name, graph)
        self.tenants[name] = ten
        self._init_tenant_order(ten, rank)

    def swap_order(self, rank: np.ndarray,
                   tenant: str = DEFAULT_TENANT) -> None:
        """Swap a new processing order into ``tenant`` at a batch boundary.

        Every in-flight column's state (and its convergence bookkeeping) is
        carried into the new order by a pure device-side permutation
        (`harness.gather_rows` — a bit-copy, so min/max states move
        bitwise), queued tickets are untouched (they pack under the new
        order at swap-in), and round counts continue exactly: a swap is
        invisible to a query's value trajectory, only future sweeps visit
        vertices in the new order. The online-reordering path
        (``reorder_threshold``) calls the same machinery after a regional
        re-rank.
        """
        ten = self._tenant(tenant)
        rank = np.asarray(rank)
        check_permutation(rank, ten.g.n)
        rank_old = ten.rank
        if ten.tuner is None:
            ten.tuner = _ReorderTuner(patience=self.reorder_patience)
        self._set_rank(ten, rank)
        for fam in self._families.values():
            if fam.tenant == tenant:
                self._rebuild_family(fam, rank_old=rank_old)

    def submit(
        self, algo: str, params: Optional[dict] = None, *,
        tenant: str = DEFAULT_TENANT,
        priority: int = 0, deadline: Optional[float] = None,
    ) -> Ticket:
        """File a query against ``tenant``'s graph; returns its
        :class:`Ticket` (possibly already resolved from the cache). One
        query per ticket — batched constructors (``ppr`` with one seed,
        ``sssp`` with one source) are submitted per column."""
        if algo not in ALGORITHMS:
            raise KeyError(
                f"unknown algorithm {algo!r}; one of {sorted(ALGORITHMS)}"
            )
        ten = self._tenant(tenant)
        params = dict(params or {})
        t = Ticket(
            id=self._next_id, algo=algo, params=params, priority=priority,
            deadline=deadline, family=(tenant,) + family_key(algo, params),
            submitted_at=self.stats.now(), graph_version=ten.graph_version,
            tenant=tenant,
        )
        self._next_id += 1
        self.tickets[t.id] = t
        self.stats.record_submit(tenant=tenant)
        if self.cache is not None:
            entry = self.cache.get(
                (tenant, algo, canon(params)), ten.graph_version
            )
            if entry is not None:
                t.status = "cached"
                t.from_cache = True
                t.converged = True
                t.result = entry.x.copy()
                t.resolved_at = self.stats.now()
                self.tickets.pop(t.id, None)
                self.stats.record_cache_hit(tenant=tenant, family=algo)
                if self.trace is not None:
                    self.trace.event(
                        "resolve", tenant=tenant, algo=algo, rounds=0,
                        converged=True, from_cache=True,
                    )
                return t
        self.scheduler.push(t)
        return t

    def step(self) -> int:
        """One server tick: for every family with work, fill free columns
        from the queue and run one bounded batch of rounds. Families are
        interleaved round-robin across tenants with a rotating start, so
        every tick gives every tenant with work a batch before any tenant
        gets a second one. Returns the number of family batches executed
        (0 = fully idle)."""
        # every synchronisation inside a tick is audited; the guard makes
        # any other one a fault
        with _transfer_guard(self.transfer_guard, self.device):
            return self._step_inner()

    def _step_inner(self) -> int:
        keys = list(self._families)
        keys += [k for k in self.scheduler.families() if k not in self._families]
        by_tenant: dict[str, list[tuple]] = {}
        for k in keys:
            by_tenant.setdefault(k[0], []).append(k)
        names = list(by_tenant)
        if names:
            off = self._rr % len(names)
            names = names[off:] + names[:off]
            self._rr += 1
        worked = 0
        # one family per tenant per round of the interleave
        rotations = max((len(v) for v in by_tenant.values()), default=0)
        for i in range(rotations):
            for name in names:
                fams = by_tenant[name]
                if i >= len(fams):
                    continue
                worked += self._run_family_batch(fams[i])
        return worked

    def _run_family_batch(self, key: tuple) -> int:
        fam = self._ensure_family(key)
        if fam is None:
            return 0
        self._fill_slots(fam)
        occupied = fam.occupied()
        if not occupied:
            return 0
        rep = fam.session.run_batch(self.rounds_per_batch)
        self.stats.record_batch(len(occupied), rep.rounds, tenant=fam.tenant)
        # one host readout of the (d,)-sized accounting per family batch
        with harness.audited_sync():
            col_done = fam.session.col_done.cpu().numpy()
            col_rounds = fam.session.col_rounds.cpu().numpy()
        for j, t in occupied:
            # the session's cumulative accounting (reset per swap-in,
            # carried across delta rebuilds) is the single source of
            # per-query round truth
            t.rounds = int(col_rounds[j])
            if bool(col_done[j]):
                self._resolve(fam, j, t, converged=True)
            elif t.rounds >= self.max_rounds_per_query:
                self._resolve(fam, j, t, converged=False)
        return 1

    def run(self, max_steps: Optional[int] = None) -> dict:
        """Drive :meth:`step` until every submitted ticket resolved (or
        ``max_steps``); returns ``stats.summary()``."""
        steps = 0
        while self.scheduler.total_pending() or self._busy():
            if max_steps is not None and steps >= max_steps:
                break
            if self.step() == 0:
                break
            steps += 1
        return self.stats.summary()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the server's metrics registry —
        serve it verbatim from a ``/metrics`` endpoint."""
        return self.stats.metrics_text()

    def apply_delta(self, delta: GraphDelta,
                    tenant: str = DEFAULT_TENANT) -> None:
        """Ingest a live graph mutation for one tenant between batches.

        Bumps the tenant's graph version, region-invalidates its cache
        entries (entries whose support misses every delta-touched block are
        *promoted* to the new version instead; other tenants' entries are
        never inspected), rebuilds each of the tenant's families on the
        mutated graph, and carries in-flight queries per ``delta_mode``.
        Queued tickets need nothing: queries are instantiated against the
        tenant's current graph at swap-in time, so a query that arrives the
        same batch a delta lands simply runs on the new graph.
        """
        ten = self._tenant(tenant)
        with tspan(self.trace, "delta_apply", tenant=tenant,
                   graph_version=ten.graph_version + 1):
            self._apply_delta_inner(delta, ten)

    def _apply_delta_inner(self, delta: GraphDelta, ten: _Tenant) -> None:
        tenant = ten.name
        g_new = delta.apply(ten.g)
        ten.graph_version += 1
        if self.cache is not None:
            touched = np.unique(delta.touched_vertices() // self.bs)
            self.cache.apply_delta(
                touched, ten.graph_version, n_new=g_new.n,
                select=lambda key: key[0] == tenant,
            )
        ten.g = g_new
        self.stats.record_delta(tenant)
        rank_old = ten.rank
        if ten.rank is not None:
            # incremental order maintenance: place appended vertices (rank-
            # relative order of existing vertices is preserved, so the O(|d|)
            # tracker update stays exact), then check for regional decay
            rank_ext = ten.maintainer.extend(g_new)
            if ten.tracker is not None:
                ten.tracker.apply_delta(
                    delta, rank_new=rank_ext if delta.n_add else None
                )
            ten.rank = rank_ext
            ten.order = rank_to_order(rank_ext)
            if (ten.tracker is not None and ten.tuner.enabled
                    and self.reorder_threshold > 0.0):
                decayed = ten.tracker.decayed_regions(self.reorder_threshold)
                if len(decayed):
                    members = ten.tracker.region_members(decayed)
                    rank2 = regional_rerank(g_new, rank_ext, members)
                    self._set_rank(ten, rank2)
        for fam in self._families.values():
            if fam.tenant == tenant:
                self._rebuild_family(fam, delta=delta, rank_old=rank_old)

    # ------------------------------------------------------------ internals

    def _tenant(self, name: str) -> _Tenant:
        try:
            return self.tenants[name]
        except KeyError:
            raise KeyError(
                f"unknown tenant {name!r}; one of {sorted(self.tenants)}"
            ) from None

    def _busy(self) -> bool:
        return any(f.occupied() for f in self._families.values())

    def _init_tenant_order(self, ten: _Tenant,
                           rank: Optional[np.ndarray]) -> None:
        """Arm a tenant's ordering state: an explicit rank, or the identity
        order when online reordering is on (the tracker needs *some* base
        order to watch decay against); no rank + reordering off keeps the
        id-order fast path (every ordering field stays None)."""
        if rank is None:
            if self.reorder_threshold == 0.0:
                return
            rank = np.arange(ten.g.n, dtype=np.int64)
        else:
            rank = np.asarray(rank)
            check_permutation(rank, ten.g.n)
        ten.rank = rank
        ten.order = rank_to_order(rank)
        ten.maintainer = RankMaintainer(rank)
        ten.tuner = _ReorderTuner(patience=self.reorder_patience)
        if self.reorder_threshold > 0.0:
            ten.tracker = MetricTracker(
                ten.g, rank, regions=self.reorder_regions
            )

    def _set_rank(self, ten: _Tenant, rank_new: np.ndarray) -> None:
        """Adopt an arbitrary new order for a tenant (rank already
        validated): rebase the metric tracker (relative order is not
        preserved, so the O(|delta|) update rule does not apply), restart
        incremental order maintenance from the new rank, and let the
        auto-tuner open a rounds-per-query measurement window."""
        ten.rank = np.asarray(rank_new)
        ten.order = rank_to_order(ten.rank)
        if ten.tracker is not None:
            ten.tracker.rebase(ten.g, ten.rank)
        ten.maintainer = RankMaintainer(ten.rank)
        if ten.tuner is not None:
            ten.tuner.note_swap()
        self.stats.record_reorder(ten.name)
        if self.trace is not None:
            # covers both entry points uniformly: explicit swap_order and
            # the post-delta regional re-rank
            self.trace.event(
                "reorder_swap", tenant=ten.name,
                graph_version=ten.graph_version,
                swaps=0 if ten.tuner is None else ten.tuner.swaps,
            )

    # constructor params that name vertices; validated against the CURRENT
    # graph at swap-in time — numpy would otherwise accept a negative id
    # silently (aliasing vertex n+v) and an oversized one as an IndexError
    # that would escape the per-ticket failure handling
    _VERTEX_PARAMS = ("source", "target", "seeds", "sources")

    def _build_query(self, t: Ticket) -> AlgoInstance:
        g = self._tenant(t.tenant).g
        for name in self._VERTEX_PARAMS:
            if name in t.params:
                v = np.asarray(t.params[name]).reshape(-1)
                if len(v) and (v.min() < 0 or v.max() >= g.n):
                    raise ValueError(
                        f"{name}={t.params[name]} out of range for a graph "
                        f"with n={g.n} vertices"
                    )
        q = get_algorithm(t.algo, g, **t.params)
        if q.d != 1:
            raise ValueError(
                f"one query per ticket: {t.algo} with {t.params} builds "
                f"d={q.d} columns; submit them as separate tickets"
            )
        return q

    def _fail(self, t: Ticket, err: Exception) -> None:
        t.status = "failed"
        t.error = f"{type(err).__name__}: {err}"
        t.resolved_at = self.stats.now()
        self.tickets.pop(t.id, None)
        self.stats.record_fail(tenant=t.tenant)

    def _make_family(self, key: tuple, tenant: str,
                     probe: AlgoInstance) -> _Family:
        n, d = probe.n, self.slots
        # a ranked tenant's session lives in rank space: the resident state
        # matrix row p is the vertex at order position p, so the engine's
        # block sweep IS the GoGraph processing order. fam.probe (and every
        # fam.queries entry) stays in id space — compat checks, delta diffs
        # and cache support are order-independent concerns
        ten = self._tenant(tenant)
        structural = probe.relabel(ten.rank) if ten.rank is not None else probe
        # idle columns are pinned everywhere: they converge on their first
        # verification round and can never influence a real query's column
        idle = dataclasses.replace(
            structural,
            x0=np.zeros((n, d), np.float32),
            c=np.full((n, d), probe.c_pad_fill, np.float32),
            fixed=np.ones((n, d), bool),
            exact_fn=None, params=None,
        )
        session = AsyncBlockSession(
            idle, bs=self.bs, inner=self.inner, backend=self.backend,
            sweeps_per_call=self.sweeps_per_call, device=str(self.device),
            trace=self.trace,
            trace_attrs={
                "tenant": tenant, "family": probe.name,
                "graph_version": ten.graph_version,
            },
        )
        return _Family(
            key=key, tenant=tenant, probe=probe, session=session,
            tickets=[None] * d, queries=[None] * d,
        )

    def _ensure_family(self, key: tuple) -> Optional[_Family]:
        fam = self._families.get(key)
        if fam is not None:
            return fam
        while True:
            t = self.scheduler.peek(key)
            if t is None:
                return None
            try:
                q = self._build_query(t)
            except (ValueError, KeyError, TypeError, IndexError) as e:
                self.scheduler.pop(key)
                self._fail(t, e)
                continue
            # the probe only donates structure; the ticket stays queued and
            # is admitted through the ordinary _fill_slots path (which
            # reuses this already-built instance)
            fam = self._make_family(key, t.tenant, q)
            fam.probe_cache = (t.id, q)
            self._families[key] = fam
            return fam

    def _check_compat(self, fam: _Family, q: AlgoInstance, t: Ticket) -> None:
        p = fam.probe
        ok = (
            p.n == q.n and p.m == q.m and p.semiring == q.semiring
            and p.combine == q.combine and p.residual == q.residual
            and p.eps == q.eps
            and np.array_equal(p.src, q.src) and np.array_equal(p.dst, q.dst)
            and np.array_equal(p.w, q.w)
        )
        if not ok:
            raise ValueError(
                f"{t.algo} with {t.params} is structurally incompatible with "
                f"family {fam.key}; scheduler.COLUMN_PARAMS misclassifies one "
                f"of its parameters as per-column"
            )

    def _install(self, fam: _Family, j: int, t: Ticket, q: AlgoInstance) -> None:
        x0, c, fixed = q.x0[:, 0], q.c[:, 0], q.fixed[:, 0]
        order = self._tenant(fam.tenant).order
        if order is not None:
            # pack the id-space query into the session's rank space (host
            # gathers: these (n,) operands are crossing to the device anyway)
            x0, c, fixed = x0[order], c[order], fixed[order]
        fam.session.swap_in(j, x0, c, fixed)
        fam.tickets[j] = t
        fam.queries[j] = q
        t.status = "running"
        if t.started_at is None:   # delta rebuilds re-install running tickets
            t.started_at = self.stats.now()

    def _fill_slots(self, fam: _Family) -> None:
        free = fam.free_slots()
        if self.refill == "static" and len(free) < self.slots:
            return  # static batching: refill only at the full-batch barrier
        for j in free:
            while True:
                t = self.scheduler.pop(fam.key)
                if t is None:
                    return
                if fam.probe_cache is not None and fam.probe_cache[0] == t.id:
                    q = fam.probe_cache[1]   # the family's own probe: built
                    fam.probe_cache = None   # and compat-checked by identity
                else:
                    try:
                        q = self._build_query(t)
                        self._check_compat(fam, q, t)
                    except (ValueError, KeyError, TypeError, IndexError) as e:
                        self._fail(t, e)
                        continue
                self._install(fam, j, t, q)
                break

    def _resolve(self, fam: _Family, j: int, t: Ticket, converged: bool) -> None:
        q = fam.queries[j]
        ten = self._tenant(fam.tenant)
        # the ONE (n,)-sized device->host transfer of a query's lifecycle: a
        # copy, since the next batch writes the state buffer in place
        with harness.audited_sync():
            x = fam.session.state[:, j].cpu().numpy()
        if ten.rank is not None:
            x = x[ten.rank]   # rank space -> id space (x_id[v] = x_r[rank[v]])
        t.result = x
        if ten.tuner is not None and converged:
            was_enabled = ten.tuner.enabled
            ten.tuner.record_resolve(t.rounds)
            if was_enabled and not ten.tuner.enabled:
                self.stats.record_reorder_disabled(ten.name)
        t.converged = converged
        t.status = "done"
        t.resolved_at = self.stats.now()
        t.graph_version = self._tenant(t.tenant).graph_version
        self.tickets.pop(t.id, None)
        self.stats.record_resolve(t)
        if self.trace is not None:
            self.trace.event(
                "resolve", tenant=t.tenant, algo=t.algo, rounds=t.rounds,
                converged=converged, graph_version=t.graph_version,
            )
        if self.cache is not None and converged:
            support = harness.column_support(
                q.x0[:, 0], q.c[:, 0], q.fixed[:, 0],
                reduce=q.semiring.reduce, c_fill=q.c_pad_fill, x=x,
            )
            blocks = np.unique(np.nonzero(support)[0] // self.bs)
            self.cache.put(
                (t.tenant, t.algo, canon(t.params)), x, t.rounds, blocks,
                t.graph_version,
                x0_fill=harness.X0_FILL[q.semiring.reduce],
            )
        if not converged:
            # neutralize the slot: a stale non-converged column would keep
            # every future batch from early-exiting (converged columns are
            # frozen/fixpoints and cost nothing, so they can stay)
            n = q.n
            fam.session.swap_in(
                j, np.zeros(n, np.float32),
                np.full(n, q.c_pad_fill, np.float32), np.ones(n, bool),
            )
        fam.tickets[j] = None
        fam.queries[j] = None

    def _rebuild_family(
        self, fam: _Family, delta: Optional[GraphDelta] = None,
        rank_old: Optional[np.ndarray] = None,
    ) -> None:
        ten = self._tenant(fam.tenant)
        probe_old = fam.probe
        probe_new = remake(probe_old, ten.g)
        occupied = [(j, t, fam.queries[j]) for j, t in fam.occupied()]
        # the old session's state on the device, (n_old, d): each column read
        # below is copied before anything launches on a buffer again
        old_state = fam.session.state
        new = self._make_family(fam.key, fam.tenant, probe_new)
        # a pure order swap (delta is None) always carries state: the carry
        # is a bit-exact permutation, so even delta_mode="restart" (which
        # exists to keep round counts solo-exact) loses nothing by keeping it
        carry = self.delta_mode == "warm" or delta is None
        region = None
        if carry and delta is not None and probe_new.semiring.reduce != "sum":
            # a loosening delta (deletions / weights moved against the
            # reduce direction) can invalidate warm values; mask everything
            # downstream of the loosened edges back to x0 and recompute —
            # the same regional argument as engine.incremental, which never
            # needed the prior state to be *converged*, only path-witnessed
            diff = instance_edge_diff(probe_old, probe_new)
            if diff.loosening:
                seeds = np.concatenate([diff.removed_dst, diff.loosened_dst])
                region = affected_region(probe_new, seeds)
        # vertex-granular absorption: a sparse delta's depth-1 out-closure
        # bounds the first warm round's frontier, so when it is a sliver of
        # the graph the push engine resolves each in-flight column at
        # touched-neighborhood cost right now, and the next family batch's
        # sweep is just the verification round
        absorb = False
        if (self.push_threshold > 0.0 and delta is not None
                and self.delta_mode == "warm" and occupied):
            g_new = self._tenant(fam.tenant).g
            closure = delta.touched_vertices(g_new, closure=1)
            absorb = len(closure) / max(g_new.n, 1) < self.push_threshold
        for j, t, q_old in occupied:
            q_new = remake(q_old, ten.g)
            self._install(new, j, t, q_new)
            if carry:
                # warm carry on the device (the torch mirror of `engine.
                # incremental.warm_state` for one column): surviving
                # vertices keep their values, appended vertices start at
                # x0, pins and the loosened region serve x0. The carry is
                # assembled in id space — the old session's rank (if any)
                # undone first, the new tenant order applied last, two row
                # gathers (`harness.gather_rows`, bit-copies: min/max
                # states move bitwise)
                dev = self.device
                old_col = old_state[: q_old.n, j]
                if rank_old is not None:
                    old_col = harness.gather_rows(old_col, rank_old)
                base = harness.to_device(np.asarray(q_new.x0[:, 0], np.float32), dev)
                col = torch.cat([old_col, base[q_old.n:]])
                col = torch.where(harness.to_device(q_new.fixed[:, 0], dev), base, col)
                if region is not None:
                    col = torch.where(harness.to_device(region, dev), base, col)
                rounds = t.rounds
                if absorb:
                    from repro_torch.engine.api import solve

                    # push absorption reads one warm column per delta
                    with harness.audited_sync():
                        col_host = col.cpu().numpy()
                    try:
                        res = solve(
                            q_new, engine="push", x_init=col_host,
                            backend="torch", device=str(dev),
                            max_iters=self.max_rounds_per_query,
                        )
                    except NotImplementedError:
                        pass   # semiring with no push form: plain warm carry
                    else:
                        col = harness.to_device(
                            np.asarray(res.x, np.float32).reshape(-1), dev
                        )
                        rounds += res.rounds
                if ten.order is not None:
                    col = harness.gather_rows(col, ten.order)
                new.session.load_state_column(j, col)
                # the new session's accounting starts at 0; carry the
                # rounds the warm continuation (and any push absorption)
                # already consumed
                new.session.set_col_rounds(j, rounds)
            else:
                t.rounds = 0   # restart: solo-exact counts on the new graph
        fam.probe = probe_new
        fam.session = new.session
        fam.tickets = new.tickets
        fam.queries = new.queries
