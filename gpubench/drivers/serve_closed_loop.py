"""Closed-loop clients of ``repro_torch.serving.GraphServer``.

``mix["clients"]`` clients each hold one ticket: a single-source query of
``mix["algo"]`` from the next vertex of the seeded stream
(`gpubench.traffic.query_sources`), and, as soon as it resolves, the next
one. Warm-up builds the family and runs until ``mix["warmup_resolved"]``
tickets have resolved, so every client has a ticket in flight and the
slots are in their steady turnover when the window opens. The window then
runs whole server ticks until ``seconds`` have passed. With ``trace`` the
server carries a `Tracer` from the start, and after the window the loop
runs on for ``mix["profile_seconds"]`` under the profiler.

Timestamps are the server's own (``Ticket.submitted_at`` /
``resolved_at``, ``time.perf_counter``): a ticket's latency is from its
submission, which may precede the window, to its resolution inside it.

Each answer is ``(source, answer, graph_version)``, the version of the
graph the ticket resolved at: 0 unless the mix changes the graph. A mix
with ``"deltas": {"every_s", "insert", "delete"}`` does: between ticks,
each time ``every_s`` seconds of the host clock have passed since the
window (or the profiled sub-window) opened, the next batch of
`gpubench.traffic.delta_batches` goes to ``GraphServer.apply_delta``;
warm-up is delta-free. The batches are drawn at set-up, as many as the
two windows can take, so the window holds only the program's work; the
record gets them in order (``deltas``) and each apply's seconds, closed
by a device sync (``delta_s``). The configuration's
``deployment.push_threshold`` reaches the server where it is given.
"""
from __future__ import annotations

import gc
import itertools
import time

import numpy as np


def run(ctx) -> dict:
    import torch
    from torch.profiler import record_function

    from gpubench.profiling import DeviceWindow, labels
    from gpubench.traffic import Reservoir, delta_batches, query_sources
    from repro_torch.graphs.delta import GraphDelta
    from repro_torch.graphs.graph import Graph
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import GraphServer

    dep, mix, dev = ctx.config["deployment"], ctx.mix, ctx.device
    g = ctx.graph
    params = dict(ctx.config["algorithms"][mix["algo"]])
    tracer = Tracer(ring=10_000_000) if ctx.trace else None
    srv = GraphServer(
        Graph(g.n, g.src, g.dst, g.w), rank=ctx.rank, slots=dep["d"],
        bs=dep["bs"], rounds_per_batch=dep["rounds_per_batch"],
        backend=dep["backend"], sweeps_per_call=dep["sweeps_per_call"],
        cache=dep["cache"], cache_max_bytes=dep["cache_max_bytes"],
        refill=dep["refill"], device=str(dev), trace=tracer,
        **{k: dep[k] for k in ("push_threshold",) if k in dep},
    )
    sources = query_sources(g.n, mix, ctx.seed)
    cursor = 0

    def submit():
        nonlocal cursor
        # past the last vertex the stream starts over (the cache may answer)
        s = int(sources[cursor % len(sources)])
        cursor += 1
        p = dict(params)
        p[mix["source_param"]] = [s] if mix["source_list"] else s
        t = srv.submit(mix["algo"], p)
        t.source = s
        return t

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    flight = [submit() for _ in range(mix["clients"])]

    def tick() -> list:
        """One server tick; the tickets it resolved, each replaced by its
        client's next one."""
        with record_function("gpubench.step"):
            srv.step()
        done = []
        with record_function("gpubench.clients"):
            for i, t in enumerate(flight):
                if t.done:
                    done.append(t)
                    flight[i] = submit()
        return done

    deltas = mix.get("deltas")
    applied, delta_s = [], []
    if deltas:
        every = float(deltas["every_s"])
        if every <= 0:
            raise ValueError(f"deltas.every_s must be positive, got {every}")
        # each window takes a batch a whole ``every`` after it opened, and
        # one more at most for the time a tick runs past its end
        due = int(ctx.seconds / every) + 1
        if ctx.trace:
            due += int(mix["profile_seconds"] / every) + 1
        drawn = list(itertools.islice(delta_batches(g, deltas, ctx.seed), due))

    def delta_due(t_open: float, before: int) -> None:
        """Between ticks: the next batch, once its time has come in the
        window opened at ``t_open`` with ``before`` batches applied."""
        if not deltas or (time.perf_counter() - t_open
                          < every * (len(applied) - before + 1)):
            return
        b = drawn[len(applied)]
        t = time.perf_counter()
        srv.apply_delta(GraphDelta(add_src=b["add_src"], add_dst=b["add_dst"],
                                   add_w=b["add_w"], del_src=b["del_src"],
                                   del_dst=b["del_dst"]))
        sync()
        delta_s.append(time.perf_counter() - t)
        applied.append(b)

    resolved = 0
    while resolved < mix["warmup_resolved"]:
        resolved += len(tick())
    sync()

    # what set-up left behind is never scanned again by the collector
    gc.collect()
    gc.freeze()
    sample = Reservoir(mix["sample"], ctx.seed)
    longest = None
    rounds_before = {t.id: t.rounds for t in flight}
    rounds0 = srv.stats.rounds_total
    latencies, rounds, useful = [], [], 0
    attempted = failed = 0
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    while True:
        for t in tick():
            attempted += 1
            failed += t.status == "failed" or not t.converged
            latencies.append(t.resolved_at - t.submitted_at)
            rounds.append(t.rounds)
            useful += t.rounds - rounds_before.get(t.id, 0)
            if longest is None or t.rounds > longest.rounds:
                longest = t
            if not sample.offer(lambda t=t: t) and t is not longest:
                t.result = None
        if time.perf_counter() - t_start >= ctx.seconds:
            break
        delta_due(t_start, 0)
    sync()
    t_end = time.perf_counter()
    useful += sum(t.rounds - rounds_before.get(t.id, 0) for t in flight)
    rounds_window = srv.stats.rounds_total - rounds0
    batch_s = [] if tracer is None else [
        s.duration_s for s in tracer.find("batch") if t_start <= s.t_start < t_end]

    gc.unfreeze()
    profile, prof_rounds = None, 0
    if ctx.trace:
        r0 = srv.stats.rounds_total
        calls = [f"repro_torch.serving.server:GraphServer.{m}" for m in (
            "_build_query", "_check_compat", "_install", "_resolve")]
        calls += [f"repro_torch.engine.async_block:AsyncBlockSession.{m}"
                  for m in ("swap_in", "run_batch")]
        with labels(*calls), DeviceWindow(dev) as w:
            t_p, before = time.perf_counter(), len(applied)
            while time.perf_counter() - t_p < mix["profile_seconds"]:
                tick()
                delta_due(t_p, before)
        profile, prof_rounds = w.result, srv.stats.rounds_total - r0

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept = [t for t in sample.items if t.status == "done"]
    if longest is not None and longest.status == "done" and longest not in kept:
        kept.append(longest)
    answers = [(t.source, np.asarray(t.result, np.float32), t.graph_version)
               for t in kept]
    del srv, flight, sample, longest, kept
    more = {"deltas": applied, "delta_s": delta_s} if deltas else {}
    return {
        "setup_s": setup_s, "window_s": t_end - t_start,
        "completed": attempted - failed, "attempted": attempted,
        "failed": failed, "latencies": np.asarray(latencies),
        "rounds": np.asarray(rounds), "useful_slot_rounds": useful,
        "slot_rounds": dep["d"] * rounds_window, "window_rounds": rounds_window,
        "batch_s": batch_s,
        "peak_bytes": peak, "profile": profile, "profile_rounds": prof_rounds,
        "n": g.n, "m": g.m, "d": dep["d"], "answers": answers, **more,
    }
