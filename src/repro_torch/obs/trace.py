"""Structured span tracing for the engines and the serving loop.

The paper's quantity of interest is *rounds*, and rounds are only visible
from the host side of the batch boundary — so the tracer records exactly
the host-side control-flow edges where round/convergence information
already surfaces, never anything per-round on device:

``solve``          one engine entry (`repro_torch.engine.api.solve`), the
                   relabel into the caller's order included
``relabel``        an order applied to an instance's edges and vectors
                   (`AlgoInstance.relabel`)
``pack``           operand packing (block padding / flat-BSR layout)
``pack_tiles``     inside ``pack``: the flat-BSR tiles built and staged
                   (`kernels.ops.pack_algorithm`)
``pack_operands``  inside ``pack``: reverse dependencies, padded vectors
                   and their copies to the device
``batch``          one bounded-round session batch (`AsyncBlockSession`);
                   ``active`` is the per-sweep share of blocks swept, read
                   in the batch's one readout (multi-sweep kernel only)
``tick``           one `GraphServer.step`
``query_build``    a ticket's algorithm instance built (`_build_query`;
                   ``edges`` the edges it read: m for a family's probe, 0
                   for a later ticket, built from its columns)
``query_check``    its structure held to the family's probe in O(1), the
                   edge arrays by identity (`_check_compat`)
``install``        a ticket put into a slot (`_install`)
``swap_in``        a column re-initialised on the device
                   (`AsyncBlockSession.swap_in`; ``touched`` counts the
                   depth-1 out-closure that marks blocks dirty)
``delta_apply``    one `GraphServer.apply_delta` ingestion (``inserted`` /
                   ``deleted`` links, ``families`` rebuilt, in-flight
                   columns ``carried`` warm and ``absorbed`` by push, and
                   ``closure``, the delta's depth-1 out-closure, where
                   ``push_threshold > 0`` computed it)
``delta_graph``    inside ``delta_apply``: the graph mutated, the cache
                   invalidated, the order maintained or regionally re-ranked
``family_rebuild`` inside ``delta_apply`` (or `GraphServer.swap_order`):
                   one family re-packed (its ``pack`` spans) and its
                   in-flight columns carried over
``carry``          inside ``family_rebuild``: one in-flight column re-made
                   on the new graph, re-installed, carried warm (``warm``),
                   any push absorption; ``slot``, and ``touched`` as
                   ``swap_in``'s. A rebuild opens no ``install`` or
                   ``swap_in``: those stay the admission of new tickets
``reorder_swap``   instantaneous event: one online order swap
``resolve``        a ticket resolved: the column readout, relabel, tuner
                   and cache put (tenant / algo / rounds / converged — the
                   per-query round histogram source); a cache hit at
                   submit is an instantaneous ``resolve`` event

Spans carry flat attribute dicts (``tenant`` / ``algo`` / ``engine`` /
``graph_version`` / ...). Attribute values MUST be host scalars, strings,
or small lists of host scalars — never device tensors: an implicit
coercion (``float(cuda_scalar)``) at a recording call site is a hidden
device->host sync.

Every span has an ``id`` (unique within its tracer) and a ``parent``: the
id of the span that was innermost and open when it began (``None`` at the
top). The innermost open span lives in a `contextvars.ContextVar`, so code
that holds no tracer opens a child of it with :func:`child`. A span opened
under one that carries ``ticket`` carries the same ``ticket``: the spans
of one query share it. :func:`self_times` gives each span's duration less
the time its children cover.

While it is open, an enabled span also holds a profiler range named
``repro_torch.<name>`` (`torch._C._profiler._RecordFunctionFast` where
PyTorch has it, else `torch.profiler.record_function`). A `torch.profiler`
that is running then holds the program's spans on its own timeline, the
device's kernels beside them; with no profiler running the range costs
under a microsecond.

Cost model (the "zero-cost-when-disabled" contract): a disabled tracer's
:meth:`Tracer.span` returns the shared :data:`NULL_SPAN` singleton — no
span object, no timestamp, no range, no buffer traffic; the only cost at a
disabled call site is building the keyword dict (and, for :func:`child`,
one `ContextVar` lookup). Enabled spans pay two ``perf_counter`` reads,
one small object, a profiler range, and (when a JSONL sink is configured)
one serialized line. All spans are per ticket, batch or coarser, so even
enabled tracing is O(batches + tickets), never O(rounds).

Finished spans land in an in-memory ring buffer (``deque(maxlen=ring)`` —
a long-lived server keeps the most recent window) and, optionally, in a
JSONL sink: one JSON object per finished span, written and flushed at span
exit so a live reader (``examples/observe_serving.py``) can tail the file
mid-run.
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import json
import time
from types import TracebackType
from typing import IO, Any, Iterable, Optional, Union

import torch

SPAN_NAMES = (
    "solve", "relabel", "pack", "pack_tiles", "pack_operands", "batch",
    "tick", "query_build", "query_check", "install", "swap_in",
    "delta_apply", "reorder_swap", "resolve",
    "delta_graph", "family_rebuild", "carry",
)

# the cheapest profiler range this PyTorch has: both take the range's name
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function

# the innermost open span of this thread / task
_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_torch_span", default=None)


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

    __slots__ = ("name", "attrs", "t_start", "t_end", "id", "parent",
                 "_tracer", "_token", "_range")

    def __init__(self, tracer: Optional["Tracer"], name: str,
                 attrs: dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs
        self.t_start: float = 0.0
        self.t_end: Optional[float] = None
        self.id: int = 0 if tracer is None else next(tracer._ids)
        self.parent: Optional[int] = None
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None
        self._range: Any = None

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
            "id": self.id,
            "parent": self.parent,
            **self.attrs,
        }

    def _adopt(self, parent: Optional["Span"]) -> None:
        """Link to the innermost open span; inherit its ticket."""
        if parent is not None:
            self.parent = parent.id
            if "ticket" in parent.attrs:
                self.attrs.setdefault("ticket", parent.attrs["ticket"])

    def __enter__(self) -> "Span":
        self._adopt(_CURRENT.get())
        self._token = _CURRENT.set(self)
        self._range = _RANGE(f"repro_torch.{self.name}")
        self._range.__enter__()
        self.t_start = time.perf_counter()
        return self

    def __exit__(
        self,
        exc_type: Optional[type[BaseException]],
        exc: Optional[BaseException],
        tb: Optional[TracebackType],
    ) -> bool:
        self.t_end = time.perf_counter()
        self._range.__exit__(exc_type, exc, tb)
        self._range = None
        _CURRENT.reset(self._token)
        self._token = None
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
        self._ids = itertools.count(1)
        self._jsonl = jsonl
        self._sink: Optional[IO[str]] = None
        self._owns_sink = False

    def span(self, name: str, **attrs: Any) -> Union[Span, _NullSpan]:
        """Open a span; use as ``with tracer.span("batch", tenant=t) as sp``."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instantaneous (zero-duration) span, a child of the
        innermost open span."""
        if not self.enabled:
            return
        sp = Span(self, name, attrs)
        sp._adopt(_CURRENT.get())
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

    The one helper every instrumented call site that holds a tracer uses,
    so ``None`` / disabled / enabled all read identically:
    ``with tspan(o.trace, "pack", algo=algo.name): ...``
    """
    if tracer is None or not tracer.enabled:
        return NULL_SPAN
    return Span(tracer, name, attrs)


def child(name: str, **attrs: Any) -> Union[Span, _NullSpan]:
    """A span under the innermost open one, in that span's tracer, for code
    that holds no tracer (``with child("relabel"): ...``); :data:`NULL_SPAN`
    when no span is open or its tracer is disabled."""
    cur = _CURRENT.get()
    if cur is None or cur._tracer is None or not cur._tracer.enabled:
        return NULL_SPAN
    return Span(cur._tracer, name, attrs)


def self_times(spans: Iterable[dict[str, Any]]) -> dict[int, float]:
    """Each span's self time, by id: its duration less the part of its
    interval that its children (the spans naming it as ``parent``) cover.
    Takes :meth:`Span.to_json` dicts, as a JSONL sink holds them."""
    spans = list(spans)
    kids: dict[int, list[tuple[float, float]]] = collections.defaultdict(list)
    for s in spans:
        if s.get("parent") is not None:
            kids[s["parent"]].append((s["t_start"], s["t_start"] + s["duration_s"]))
    out = {}
    for s in spans:
        lo, hi = s["t_start"], s["t_start"] + s["duration_s"]
        covered, reach = 0.0, lo
        for a, b in sorted(kids.get(s["id"], ())):
            a, b = max(a, reach), min(b, hi)
            if b > a:
                covered += b - a
                reach = b
        out[s["id"]] = max(0.0, s["duration_s"] - covered)  # rounding
    return out
