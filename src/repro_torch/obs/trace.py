"""Structured span tracing for the engines and the serving loop.

The paper's quantity of interest is *rounds*, and rounds are only visible
from the host side of the batch boundary — so the tracer records exactly
the host-side control-flow edges where round/convergence information
already surfaces, never anything per-round on device:

``solve``         one engine entry (`repro_torch.engine.api.solve`)
``pack``          operand packing (block padding / flat-BSR layout)
``batch``         one bounded-round session batch (`AsyncBlockSession`)
``sweep_call``    one megakernel dispatch inside a batch (dispatch-side
                  duration: the launch is asynchronous, the following
                  batch-granular readout is the real sync point)
``delta_apply``   one `GraphServer.apply_delta` ingestion
``reorder_swap``  one online order swap (`GraphServer._set_rank`)
``resolve``       instantaneous event: a ticket resolved (tenant / algo /
                  rounds / converged — the per-query round histogram source)

Spans carry flat attribute dicts (``tenant`` / ``algo`` / ``engine`` /
``graph_version`` / ...). Attribute values MUST be host scalars, strings,
or small lists of host scalars — never device tensors: an implicit
coercion (``float(cuda_scalar)``) at a recording call site is a hidden
device->host sync.

Cost model (the "zero-cost-when-disabled" contract): a disabled tracer's
:meth:`Tracer.span` returns the shared :data:`NULL_SPAN` singleton — no
span object, no timestamp, no buffer traffic; the only cost at a disabled
call site is building the keyword dict. Enabled spans pay two
``perf_counter`` reads, one small object, and (when a JSONL sink is
configured) one serialized line. All spans are batch-granular or coarser,
so even enabled tracing is O(batches), never O(rounds).

Finished spans land in an in-memory ring buffer (``deque(maxlen=ring)`` —
a long-lived server keeps the most recent window) and, optionally, in a
JSONL sink: one JSON object per finished span, written and flushed at span
exit so a live reader (``examples/observe_serving.py``) can tail the file
mid-run.
"""
from __future__ import annotations

import collections
import json
import time
from types import TracebackType
from typing import IO, Any, Optional, Union

SPAN_NAMES = (
    "solve", "pack", "batch", "sweep_call", "delta_apply", "reorder_swap",
    "resolve",
)


class _NullSpan:
    """The shared do-nothing span a disabled tracer hands out.

    One module-level instance serves every disabled call site: entering,
    exiting, and :meth:`set` are all no-ops, so ``with tracer.span(...)``
    costs nothing measurable when tracing is off.
    """

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(
        self,
        exc_type: Optional[type[BaseException]],
        exc: Optional[BaseException],
        tb: Optional[TracebackType],
    ) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One finished-or-open span: a named, timed, attributed interval."""

    __slots__ = ("name", "attrs", "t_start", "t_end", "_tracer")

    def __init__(self, tracer: Optional["Tracer"], name: str,
                 attrs: dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs
        self.t_start: float = 0.0
        self.t_end: Optional[float] = None
        self._tracer = tracer

    @property
    def duration_s(self) -> float:
        """Wall duration; 0.0 while the span is still open."""
        return 0.0 if self.t_end is None else self.t_end - self.t_start

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes discovered mid-span (e.g. the batch's round
        count, known only after the batch-granular readout)."""
        self.attrs.update(attrs)
        return self

    def to_json(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "t_start": self.t_start,
            "duration_s": self.duration_s,
            **self.attrs,
        }

    def __enter__(self) -> "Span":
        self.t_start = time.perf_counter()
        return self

    def __exit__(
        self,
        exc_type: Optional[type[BaseException]],
        exc: Optional[BaseException],
        tb: Optional[TracebackType],
    ) -> bool:
        self.t_end = time.perf_counter()
        if self._tracer is not None:
            self._tracer._record(self)
        return False

    def __repr__(self) -> str:  # debugging/REPL aid only
        return f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, {self.attrs})"


class Tracer:
    """Span recorder: ring buffer + optional JSONL sink.

    Parameters
    ----------
    enabled : master switch. Disabled tracers hand out :data:`NULL_SPAN`
        and record nothing — the zero-cost path.
    ring : finished spans kept in memory (oldest evicted first).
    jsonl : optional sink — a filesystem path (opened lazily, append mode)
        or any object with ``write``; each finished span becomes one JSON
        line, flushed immediately.
    """

    def __init__(self, enabled: bool = True, ring: int = 4096,
                 jsonl: Union[str, IO[str], None] = None) -> None:
        self.enabled = enabled
        self.spans: collections.deque[Span] = collections.deque(maxlen=ring)
        self._jsonl = jsonl
        self._sink: Optional[IO[str]] = None
        self._owns_sink = False

    def span(self, name: str, **attrs: Any) -> Union[Span, _NullSpan]:
        """Open a span; use as ``with tracer.span("batch", tenant=t) as sp``."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instantaneous (zero-duration) span."""
        if not self.enabled:
            return
        sp = Span(self, name, attrs)
        sp.t_start = time.perf_counter()
        sp.t_end = sp.t_start
        self._record(sp)

    def find(self, name: str) -> list[Span]:
        """Recorded spans with the given name, oldest first."""
        return [s for s in self.spans if s.name == name]

    def close(self) -> None:
        """Close a path-opened sink (file-like sinks stay the caller's)."""
        if self._sink is not None and self._owns_sink:
            self._sink.close()
        self._sink = None

    # ------------------------------------------------------------ internal

    def _record(self, span: Span) -> None:
        self.spans.append(span)
        sink = self._ensure_sink()
        if sink is not None:
            sink.write(json.dumps(span.to_json()) + "\n")
            sink.flush()

    def _ensure_sink(self) -> Optional[IO[str]]:
        if self._sink is None and self._jsonl is not None:
            if isinstance(self._jsonl, str):
                self._sink = open(self._jsonl, "a", encoding="utf-8")
                self._owns_sink = True
            else:
                self._sink = self._jsonl
        return self._sink


def tspan(tracer: Optional[Tracer], name: str,
          **attrs: Any) -> Union[Span, _NullSpan]:
    """``tracer.span(...)`` that also accepts ``tracer=None`` (tracing off).

    The one helper every instrumented call site uses, so ``None`` /
    disabled / enabled all read identically:
    ``with tspan(o.trace, "pack", algo=algo.name): ...``
    """
    if tracer is None or not tracer.enabled:
        return NULL_SPAN
    return Span(tracer, name, attrs)
