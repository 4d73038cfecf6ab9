"""One client calling ``repro_torch.solve`` batch after batch.

Each call builds ``mix["algo"]`` for the next ``d`` vertices of the seeded
stream (`gpubench.traffic.query_sources`) and converges it through the
documented entry, ``solve(algo, engine="async_block", rank=order, ...)``
with the configuration's deployment settings, which packs the graph anew
on every call. Warm-up is ``mix["warmup_batches"]`` such calls. The window
runs whole calls until ``seconds`` have passed; a call's ``d`` queries
count when it returns. With ``trace`` every call carries a `Tracer`, and
after the window calls go on for ``mix["profile_seconds"]`` under the
profiler.
"""
from __future__ import annotations

import gc
import time

import numpy as np


def run(ctx) -> dict:
    import torch
    from torch.profiler import record_function

    from gpubench.profiling import DeviceWindow, labels
    from gpubench.traffic import Reservoir, query_sources
    from repro_torch import solve
    from repro_torch.engine.algorithms import get_algorithm
    from repro_torch.graphs.graph import Graph
    from repro_torch.obs.trace import Tracer

    dep, mix, dev = ctx.config["deployment"], ctx.mix, ctx.device
    g = ctx.graph
    graph = Graph(g.n, g.src, g.dst, g.w)
    params = dict(ctx.config["algorithms"][mix["algo"]])
    d = dep["d"]
    tracer = Tracer(ring=1_000_000) if ctx.trace else None
    sources = query_sources(g.n, mix, ctx.seed)
    cursor = 0

    def call():
        nonlocal cursor
        # past the last vertex the stream starts over
        batch = np.take(sources, np.arange(cursor, cursor + d), mode="wrap")
        cursor += d
        with record_function("gpubench.solve"):
            algo = get_algorithm(mix["algo"], graph,
                                 **{mix["source_param"]: batch}, **params)
            res = solve(algo, engine="async_block", backend=dep["backend"],
                        bs=dep["bs"], sweeps_per_call=dep["sweeps_per_call"],
                        rank=ctx.rank, device=str(dev), trace=tracer)
        return batch, res

    for _ in range(mix["warmup_batches"]):
        call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    # what set-up left behind is never scanned again by the collector
    gc.collect()
    gc.freeze()
    sample = Reservoir(mix["sample"], ctx.seed)
    longest = (-1, None)
    col_rounds, attempted, failed, window_rounds = [], 0, 0, 0
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    while True:
        batch, res = call()
        x = np.asarray(res.x, np.float32).reshape(g.n, -1)
        attempted += d
        window_rounds += int(res.rounds)
        failed += int((~np.asarray(res.col_converged, bool)).sum())
        col_rounds.extend(int(r) for r in res.col_rounds)
        for j, s in enumerate(batch):
            sample.offer(lambda j=j, s=s: (int(s), x[:, j].copy()))
            if int(res.col_rounds[j]) > longest[0]:
                longest = (int(res.col_rounds[j]), (int(s), x[:, j].copy()))
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    t_end = time.perf_counter()  # solve returned host arrays: the device is done
    pack_s = [] if tracer is None else [
        s.duration_s for s in tracer.find("pack") if t_start <= s.t_start < t_end]

    gc.unfreeze()
    profile, prof_rounds = None, 0
    if ctx.trace:
        calls = ["repro_torch.engine.algorithms:AlgoInstance.relabel",
                 "repro_torch.kernels.ops:pack_algorithm",
                 "repro_torch.engine.harness:sweep_batched_loop",
                 "repro_torch.engine.harness:finalize"]
        with labels(*calls), DeviceWindow(dev) as w:
            t_p = time.perf_counter()
            while time.perf_counter() - t_p < mix["profile_seconds"]:
                prof_rounds += int(call()[1].rounds)
        profile = w.result

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    answers = list(sample.items)
    if longest[1] is not None and all(s != longest[1][0] for s, _ in answers):
        answers.append(longest[1])
    return {
        "setup_s": setup_s, "window_s": t_end - t_start,
        "completed": attempted - failed, "attempted": attempted,
        "failed": failed, "rounds": np.asarray(col_rounds), "pack_s": pack_s,
        "window_rounds": window_rounds,
        "peak_bytes": peak, "profile": profile, "profile_rounds": prof_rounds,
        "n": g.n, "m": g.m, "d": d, "answers": answers,
    }
