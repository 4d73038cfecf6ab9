"""Serving telemetry: ticket latency, throughput, slot occupancy (port of
``repro.serving.stats``).

Two clocks run side by side. The *wall* clock (``time.perf_counter``) feeds
the operational numbers — queries/sec, p50/p99 ticket latency, deadline
misses. The *round* clock (engine rounds actually executed) feeds the
numbers the correctness and benchmark contracts are stated in: per-query
round counts are deterministic (they equal a solo run of the query — see
`repro_torch.serving.server`), so tests and the CI smoke assert on them while the
wall numbers ride along for humans.

`ServerStats` is a *view* over a :class:`repro_torch.obs.MetricsRegistry`: every
counter it used to keep as a plain int is now a labeled metric family
(``repro_queries_submitted_total{tenant=...}`` and friends), and the
latency / wait / rounds sample lists are registry histograms with both
Prometheus bucket series and the bounded recent-sample windows the
percentiles have always been computed from. The legacy attribute surface
(``stats.rounds_total``, ``stats.tenant_batches``, ...) is preserved as
read-only roll-ups so existing tests, benchmarks, and dashboards keep
working unchanged, while ``GraphServer.metrics_text()`` exposes the same
numbers in the Prometheus text format.
"""
from __future__ import annotations

import time
from typing import Any, Optional

from repro_torch.obs.metrics import MetricsRegistry, bounded_append, percentile

__all__ = ["ServerStats", "percentile"]

# Round-count histogram buckets: powers of two out to 1024. Queries converge
# in rounds-units (tens, occasionally hundreds), so the default sub-second
# latency buckets would dump every observation into the +Inf tail.
ROUNDS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                  512.0, 1024.0)


class ServerStats:
    """Running counters + traces for one :class:`~repro_torch.serving.GraphServer`.

    Per-tenant / per-family slices come from metric labels: ``tenant`` is
    the submitting tenant's name, ``family`` is the batching family's
    algorithm name (queries of one algorithm on one tenant share a family;
    the label deliberately reuses the algo name rather than an opaque
    family id so a Prometheus query groups the way an operator thinks).
    """

    def __init__(self, slots: int, max_samples: int = 100_000,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.slots = slots
        # sample lists are bounded: when one exceeds max_samples the oldest
        # half is dropped, so percentiles/occupancy reflect the most recent
        # window and a long-running server's telemetry stays O(max_samples)
        self.max_samples = max_samples
        self.registry = registry if registry is not None \
            else MetricsRegistry(max_samples)
        r = self.registry
        self._submitted = r.counter(
            "repro_queries_submitted_total",
            "Queries accepted by submit()", ("tenant",))
        self._resolved = r.counter(
            "repro_queries_resolved_total",
            "Queries resolved (cache hits included)", ("tenant",))
        self._unconverged = r.counter(
            "repro_queries_unconverged_total",
            "Queries resolved without reaching eps", ("tenant",))
        self._failed = r.counter(
            "repro_queries_failed_total",
            "Submissions rejected before running a round", ("tenant",))
        self._cache_hits = r.counter(
            "repro_cache_hits_total",
            "Queries answered from the result cache", ("tenant",))
        self._batches = r.counter(
            "repro_batches_total",
            "Engine batches dispatched", ("tenant",))
        self._rounds = r.counter(
            "repro_rounds_total",
            "Engine rounds executed", ("tenant",))
        self._round_slots = r.counter(
            "repro_round_slots_total",
            "Rounds x occupied slots (useful work)", ("tenant",))
        self._deltas = r.counter(
            "repro_deltas_applied_total",
            "Graph deltas applied", ("tenant",))
        self._deadline_misses = r.counter(
            "repro_deadline_misses_total",
            "Resolved past the ticket deadline", ("tenant", "family"))
        self._reorders = r.counter(
            "repro_reorders_total",
            "Vertex-order swaps applied", ("tenant",))
        self._reorders_disabled = r.gauge(
            "repro_reorders_disabled",
            "1 once the tenant's reorder auto-tuner gave up", ("tenant",))
        self._occupancy = r.gauge(
            "repro_slot_occupancy",
            "Occupied-slot fraction of the most recent batch")
        self._latency_h = r.histogram(
            "repro_latency_seconds",
            "Ticket latency, submit to resolve", ("tenant", "family"))
        self._wait_h = r.histogram(
            "repro_wait_seconds",
            "Ticket queue wait, submit to first round", ("tenant", "family"))
        self._rounds_h = r.histogram(
            "repro_query_rounds",
            "Engine rounds a resolved query consumed", ("tenant", "family"),
            buckets=ROUNDS_BUCKETS)
        self.occupancy_trace: list[float] = []
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

    def now(self) -> float:
        return time.perf_counter()

    @staticmethod
    def _lab(value: Optional[str]) -> str:
        return value if value is not None else ""

    # ---- legacy scalar surface (label-blind roll-ups) -------------------

    @property
    def submitted(self) -> int:
        return int(self._submitted.total())

    @property
    def resolved(self) -> int:
        return int(self._resolved.total())

    @property
    def unconverged(self) -> int:
        return int(self._unconverged.total())

    @property
    def failed(self) -> int:
        """Invalid submissions — never ran a round."""
        return int(self._failed.total())

    @property
    def cache_hits(self) -> int:
        """The cache's own stats() has the full picture."""
        return int(self._cache_hits.total())

    @property
    def batches(self) -> int:
        return int(self._batches.total())

    @property
    def rounds_total(self) -> int:
        """Engine rounds executed, all families."""
        return int(self._rounds.total())

    @property
    def round_slots_total(self) -> int:
        """Rounds x occupied slots (useful work)."""
        return int(self._round_slots.total())

    @property
    def deltas_applied(self) -> int:
        return int(self._deltas.total())

    @property
    def deadline_misses(self) -> int:
        return int(self._deadline_misses.total())

    @property
    def tenant_batches(self) -> dict[str, int]:
        """Per-tenant batch counts — what the cross-tenant fairness gate
        reads (no tenant's share may starve; see benchmarks)."""
        return {k: int(v) for k, v in
                self._batches.per_label("tenant").items()}

    @property
    def tenant_rounds(self) -> dict[str, int]:
        return {k: int(v) for k, v in
                self._rounds.per_label("tenant").items()}

    @property
    def reorders(self) -> dict[str, int]:
        """Order swaps (regional re-rank or explicit swap_order) per tenant."""
        return {k: int(v) for k, v in
                self._reorders.per_label("tenant").items()}

    @property
    def reorders_disabled(self) -> dict[str, bool]:
        """Tenants whose reorder auto-tuner measured no rounds-win and
        gave up."""
        return {k: True for k, v in
                self._reorders_disabled.per_label("tenant").items() if v}

    # ---- recorders ------------------------------------------------------

    def record_submit(self, tenant: Optional[str] = None) -> None:
        self._submitted.inc(tenant=self._lab(tenant))
        if self._t0 is None:
            self._t0 = self.now()

    def record_cache_hit(self, tenant: Optional[str] = None,
                         family: Optional[str] = None) -> None:
        ten, fam = self._lab(tenant), self._lab(family)
        self._cache_hits.inc(tenant=ten)
        self._resolved.inc(tenant=ten)
        self._t_last = self.now()
        # A hit is a real resolve the client experienced: it belongs in the
        # latency/wait/rounds populations as zeros, not outside them —
        # otherwise wait percentiles overstate the served workload.
        self._latency_h.observe(0.0, tenant=ten, family=fam)
        self._wait_h.observe(0.0, tenant=ten, family=fam)
        self._rounds_h.observe(0, tenant=ten, family=fam)

    def record_batch(self, occupied: int, rounds: int,
                     tenant: Optional[str] = None) -> None:
        ten = self._lab(tenant)
        self._batches.inc(tenant=ten)
        self._rounds.inc(rounds, tenant=ten)
        self._round_slots.inc(rounds * occupied, tenant=ten)
        occ = occupied / max(1, self.slots)
        self._occupancy.set(occ)
        bounded_append(self.occupancy_trace, occ, self.max_samples)

    def record_delta(self, tenant: Optional[str] = None) -> None:
        """A graph delta landed on the tenant's device-resident CSR."""
        self._deltas.inc(tenant=self._lab(tenant))

    def record_reorder(self, tenant: str) -> None:
        """An order swap (regional re-rank or explicit swap_order) landed."""
        self._reorders.inc(tenant=tenant)

    def record_reorder_disabled(self, tenant: str) -> None:
        """The tenant's auto-tuner measured no rounds-win and gave up."""
        self._reorders_disabled.set(1, tenant=tenant)

    def record_fail(self, tenant: Optional[str] = None) -> None:
        """A submission rejected before running (bad params); kept out of
        the resolve counters and latency percentiles so parameter errors
        can't masquerade as engine non-convergence or skew p99."""
        self._failed.inc(tenant=self._lab(tenant))
        self._t_last = self.now()

    def record_resolve(self, ticket: Any) -> None:
        ten = self._lab(getattr(ticket, "tenant", None))
        fam = self._lab(getattr(ticket, "algo", None))
        self._resolved.inc(tenant=ten)
        if not ticket.converged:
            self._unconverged.inc(tenant=ten)
        self._t_last = self.now()
        latency = ticket.resolved_at - ticket.submitted_at
        self._latency_h.observe(latency, tenant=ten, family=fam)
        if ticket.started_at is not None:
            self._wait_h.observe(ticket.started_at - ticket.submitted_at,
                                 tenant=ten, family=fam)
        self._rounds_h.observe(ticket.rounds, tenant=ten, family=fam)
        if ticket.deadline is not None and latency > ticket.deadline:
            self._deadline_misses.inc(tenant=ten, family=fam)

    # ---- exporters ------------------------------------------------------

    def metrics_text(self) -> str:
        """Prometheus text exposition of every family in the registry."""
        return self.registry.prometheus_text()

    def summary(self) -> dict[str, Any]:
        """One dict with everything a dashboard (or the benchmark JSON)
        wants; cheap enough to call every tick. All pre-registry keys are
        preserved verbatim; ``per_tenant`` / ``per_family`` add the labeled
        breakdowns (rounds and latency digests, deadline misses)."""
        elapsed = (
            (self._t_last - self._t0)
            if self._t0 is not None and self._t_last is not None
            else 0.0
        )
        occ = self.occupancy_trace
        resolved = self.resolved
        per_tenant: dict[str, Any] = {}
        for ten, samples in self._rounds_h.per_label("tenant").items():
            per_tenant[ten] = {
                "resolved": int(self._resolved.value(tenant=ten)),
                "rounds_p50": percentile(samples, 50),
                "rounds_p99": percentile(samples, 99),
            }
        for ten, samples in self._latency_h.per_label("tenant").items():
            per_tenant.setdefault(ten, {})["latency_p99_s"] = (
                percentile(samples, 99))
        per_family: dict[str, Any] = {}
        for fam, samples in self._rounds_h.per_label("family").items():
            per_family[fam] = {
                "rounds_p50": percentile(samples, 50),
                "rounds_p99": percentile(samples, 99),
                "deadline_misses": int(
                    self._deadline_misses.per_label("family").get(fam, 0)),
            }
        return {
            "submitted": self.submitted,
            "resolved": resolved,
            "unconverged": self.unconverged,
            "failed": self.failed,
            "cache_hits": self.cache_hits,
            "batches": self.batches,
            "rounds_total": self.rounds_total,
            "round_slots_total": self.round_slots_total,
            "deltas_applied": self.deltas_applied,
            "deadline_misses": self.deadline_misses,
            "tenant_batches": self.tenant_batches,
            "tenant_rounds": self.tenant_rounds,
            "reorders": self.reorders,
            "reorders_disabled": self.reorders_disabled,
            "per_tenant": per_tenant,
            "per_family": per_family,
            "elapsed_s": elapsed,
            "throughput_qps": resolved / elapsed if elapsed > 0 else 0.0,
            "latency_p50_s": self._latency_h.percentile(50),
            "latency_p99_s": self._latency_h.percentile(99),
            "wait_p50_s": self._wait_h.percentile(50),
            "wait_p99_s": self._wait_h.percentile(99),
            "rounds_p50": self._rounds_h.percentile(50),
            "rounds_p99": self._rounds_h.percentile(99),
            "occupancy_mean": sum(occ) / len(occ) if occ else 0.0,
        }
