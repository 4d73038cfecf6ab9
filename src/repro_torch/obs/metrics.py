"""Metrics registry: counters / gauges / histograms + two exporters (port
of ``repro.obs.metrics``, pure Python).

One process-local registry holds every operational number the serving
layer (and anything else) wants to expose. Metrics are *families*: a name,
a help string, and a fixed tuple of label names; each distinct label-value
combination is a child time series. Two exporters:

* :meth:`MetricsRegistry.summary` — a plain nested dict, the programmatic
  form `ServerStats.summary()` builds on (and the benchmark JSONs embed).
* :meth:`MetricsRegistry.prometheus_text` — the Prometheus text exposition
  format (``# HELP`` / ``# TYPE`` / samples with escaped label values),
  served verbatim by ``GraphServer.metrics_text()`` so a scrape endpoint
  is one ``web.Response(text=srv.metrics_text())`` away.

Histograms keep three things per child: cumulative bucket counts (the
Prometheus ``_bucket{le=...}`` series), exact ``sum``/``count``, and a
*bounded* reservoir of recent samples for nearest-rank percentiles — the
same window-halving rule `ServerStats` has always used (when the list
exceeds ``max_samples`` the oldest half is dropped), so a long-running
server's percentiles track the recent window in O(max_samples) memory.

Everything here is host-side Python on host scalars. Recording a device
value means the *call site* synced it — a hot-path decision, made in an
audited readout (`engine.harness.audited_sync`).
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Union

Number = Union[int, float]

# Default histogram buckets: tuned for the serving layer's two populations,
# sub-second latencies and round counts in the tens-to-hundreds.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
)


def percentile(values: Iterable[Number], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input.

    Nearest-rank keeps the answer an *observed* sample — a p99 users
    actually experienced — instead of an interpolated value between two
    observations. Edge behavior (pinned by tests/test_obs.py): ``q=0``
    returns the minimum (rank clamps to 1), ``q=100`` the maximum, a
    single-sample list returns that sample for every q.
    """
    vals = sorted(float(v) for v in values)
    if not vals:
        return 0.0
    rank = max(1, int(-(-q * len(vals) // 100)))  # ceil without math import
    return vals[min(rank, len(vals)) - 1]


def bounded_append(samples: list, value: Any, max_samples: int) -> None:
    """Append under the window-halving bound: past ``max_samples`` the
    oldest half is dropped, so the list is O(max_samples) forever and its
    percentiles reflect the most recent window."""
    samples.append(value)
    if len(samples) > max_samples:
        del samples[: len(samples) // 2]


def _label_values(labelnames: tuple[str, ...],
                  labels: dict[str, Any]) -> tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"metric labels {sorted(labels)} != declared {sorted(labelnames)}"
        )
    return tuple(str(labels[n]) for n in labelnames)


def _escape(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    """Render a sample value: integers without a trailing .0 noise-free."""
    return str(int(value)) if float(value).is_integer() else repr(float(value))


class _Metric:
    """Shared family plumbing: name, help, labelnames, child lookup."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...]) -> None:
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: dict[tuple[str, ...], Any] = {}

    def _child(self, labels: dict[str, Any], default: Any) -> tuple[str, ...]:
        key = _label_values(self.labelnames, labels)
        if key not in self._children:
            self._children[key] = default
        return key

    def _series(self, key: tuple[str, ...], suffix: str = "",
                extra: Optional[tuple[str, str]] = None) -> str:
        pairs = [f'{n}="{_escape(v)}"' for n, v in zip(self.labelnames, key,
                                                       strict=True)]
        if extra is not None:
            pairs.append(f'{extra[0]}="{_escape(extra[1])}"')
        body = "{" + ",".join(pairs) + "}" if pairs else ""
        return f"{self.name}{suffix}{body}"

    def header(self) -> list[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.kind}"]


class Counter(_Metric):
    """Monotone counter family (Prometheus ``counter``)."""

    kind = "counter"

    def inc(self, value: Number = 1, **labels: Any) -> None:
        if value < 0:
            raise ValueError(f"counters only go up; inc({value})")
        key = self._child(labels, 0.0)
        self._children[key] += value

    def value(self, **labels: Any) -> float:
        return float(self._children.get(
            _label_values(self.labelnames, labels), 0.0))

    def total(self) -> float:
        """Sum over every child — the label-blind roll-up."""
        return float(sum(self._children.values()))

    def per_label(self, labelname: str) -> dict[str, float]:
        """Roll up children by one label: ``{label_value: sum}``."""
        i = self.labelnames.index(labelname)
        out: dict[str, float] = {}
        for key, v in self._children.items():
            out[key[i]] = out.get(key[i], 0.0) + v
        return out

    def expose(self) -> list[str]:
        return [f"{self._series(k)} {_fmt(v)}"
                for k, v in sorted(self._children.items())]

    def summary_value(self) -> Any:
        if not self.labelnames:
            return float(self._children.get((), 0.0))
        return {"|".join(k): float(v)
                for k, v in sorted(self._children.items())}


class Gauge(_Metric):
    """Set-to-current-value family (Prometheus ``gauge``)."""

    kind = "gauge"

    def set(self, value: Number, **labels: Any) -> None:
        key = self._child(labels, 0.0)
        self._children[key] = float(value)

    def inc(self, value: Number = 1, **labels: Any) -> None:
        key = self._child(labels, 0.0)
        self._children[key] += value

    def value(self, **labels: Any) -> float:
        return float(self._children.get(
            _label_values(self.labelnames, labels), 0.0))

    def per_label(self, labelname: str) -> dict[str, float]:
        i = self.labelnames.index(labelname)
        return {k[i]: float(v) for k, v in sorted(self._children.items())}

    def expose(self) -> list[str]:
        return [f"{self._series(k)} {_fmt(v)}"
                for k, v in sorted(self._children.items())]

    def summary_value(self) -> Any:
        if not self.labelnames:
            return float(self._children.get((), 0.0))
        return {"|".join(k): float(v)
                for k, v in sorted(self._children.items())}


class _HistChild:
    """One histogram time series: buckets + sum/count + bounded samples."""

    __slots__ = ("bucket_counts", "sum", "count", "samples")

    def __init__(self, n_buckets: int) -> None:
        self.bucket_counts = [0] * n_buckets   # non-cumulative per bucket
        self.sum = 0.0
        self.count = 0
        self.samples: list[float] = []


class Histogram(_Metric):
    """Histogram family (Prometheus ``histogram`` + native percentiles).

    ``observe`` is O(len(buckets)); percentiles come from the bounded
    recent-sample reservoir (`bounded_append` window-halving), matching the
    nearest-rank semantics `ServerStats` has always reported.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...],
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 max_samples: int = 100_000) -> None:
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one finite bucket")
        self.max_samples = max_samples

    def observe(self, value: Number, **labels: Any) -> None:
        key = self._child(labels, None)
        child = self._children[key]
        if child is None:
            child = self._children[key] = _HistChild(len(self.buckets) + 1)
        v = float(value)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        child.bucket_counts[i] += 1
        child.sum += v
        child.count += 1
        bounded_append(child.samples, v, self.max_samples)

    def percentile(self, q: float, **labels: Any) -> float:
        """Nearest-rank percentile of the recent-sample window. With labels,
        one child's window; without (on a labeled family), every child's
        windows merged — the label-blind roll-up `summary()` reports."""
        if labels or not self.labelnames:
            key = _label_values(self.labelnames, labels)
            child = self._children.get(key)
            return percentile(child.samples, q) if child is not None else 0.0
        merged: list[float] = []
        for child in self._children.values():
            merged.extend(child.samples)
        return percentile(merged, q)

    def count(self, **labels: Any) -> int:
        child = self._children.get(_label_values(self.labelnames, labels))
        return 0 if child is None else child.count

    def total_count(self) -> int:
        return sum(c.count for c in self._children.values())

    def per_label(self, labelname: str) -> dict[str, list[float]]:
        """Merge recent-sample windows by one label value."""
        i = self.labelnames.index(labelname)
        out: dict[str, list[float]] = {}
        for key, child in sorted(self._children.items()):
            out.setdefault(key[i], []).extend(child.samples)
        return out

    def expose(self) -> list[str]:
        lines: list[str] = []
        for key, child in sorted(self._children.items()):
            cum = 0
            for b, n in zip(self.buckets, child.bucket_counts,
                            strict=False):
                cum += n
                lines.append(
                    f"{self._series(key, '_bucket', ('le', _fmt(b)))} {cum}"
                )
            lines.append(
                f"{self._series(key, '_bucket', ('le', '+Inf'))} {child.count}"
            )
            lines.append(f"{self._series(key, '_sum')} {_fmt(child.sum)}")
            lines.append(f"{self._series(key, '_count')} {child.count}")
        return lines

    def summary_value(self) -> Any:
        out = {}
        for key, child in sorted(self._children.items()):
            out["|".join(key) if key else "all"] = {
                "count": child.count,
                "sum": child.sum,
                "p50": percentile(child.samples, 50),
                "p99": percentile(child.samples, 99),
            }
        return out


class MetricsRegistry:
    """Name-keyed collection of metric families.

    ``counter`` / ``gauge`` / ``histogram`` get-or-create: asking for an
    existing name returns the existing family (and rejects a mismatched
    re-declaration loudly, so two layers can't silently fork a metric).
    """

    def __init__(self, max_samples: int = 100_000) -> None:
        self.max_samples = max_samples
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls: type, name: str, help: str,
                       labelnames: Sequence[str], **kw: Any) -> Any:
        existing = self._metrics.get(name)
        if existing is not None:
            if type(existing) is not cls or existing.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-declared as {cls.__name__}"
                    f"{tuple(labelnames)}; existing is "
                    f"{type(existing).__name__}{existing.labelnames}"
                )
            return existing
        m = cls(name, help, tuple(labelnames), **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets,
                                   max_samples=self.max_samples)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def summary(self) -> dict[str, Any]:
        """``{metric_name: value}`` — scalars for unlabeled counters/gauges,
        ``{joined_labels: value}`` dicts for labeled families, and
        count/sum/p50/p99 digests for histogram children."""
        return {name: m.summary_value()
                for name, m in sorted(self._metrics.items())}

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format, newline-terminated."""
        lines: list[str] = []
        for _, m in sorted(self._metrics.items()):
            lines.extend(m.header())
            lines.extend(m.expose())
        return "\n".join(lines) + "\n" if lines else ""
