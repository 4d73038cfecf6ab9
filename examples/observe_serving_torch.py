"""Observability walkthrough on the PyTorch port: trace a skewed serving
workload end to end.

A hub cluster plus a path tail feeding into it, so SSSP sources on the hub
converge in a handful of rounds while tail sources need dozens, served to
TWO tenants of one :class:`repro_torch.serving.GraphServer` with a
``repro_torch.obs.Tracer`` writing every span to a JSONL file. Afterwards
the script reads the sink back (exactly what a dashboard would do) and
renders, with no dependencies beyond the stdlib and numpy:

* the per-tenant resolved-rounds histogram (text bars) from the
  ``resolve`` events — the skew made visible;
* the residual decay of one traced solo solve as a unicode sparkline from
  ``RunResult.convergence_trace`` — the paper's Fig. 7 quantity;
* the host's time by span name: count, total and self time (a span's
  duration less what its child spans cover, `repro_torch.obs.self_times`),
  so a ``tick``'s self time is the server's own host work a tick; where
  the server runs the multi-sweep kernel (``backend="kernel"``,
  ``sweeps_per_call > 1``), the mean of ``batch.active``, the share of
  blocks each sweep swept;
* an excerpt of the Prometheus exposition ``GraphServer.metrics_text()``
  serves.

    PYTHONPATH=src python examples/observe_serving_torch.py
    PYTHONPATH=src python examples/observe_serving_torch.py --device cpu

The twin of ``examples/observe_serving.py``: the same graph, tenants,
traffic and printed lines, through ``repro_torch`` on ``--device``
(default ``cuda``; without a GPU pass ``--device cpu``).
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import GraphServer, get_algorithm, solve  # noqa: E402
from repro_torch.engine.api import EngineOptions  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.graphs.graph import Graph  # noqa: E402
from repro_torch.obs import Tracer, self_times  # noqa: E402

HUB_N = 500
TAIL_N = 140
N_QUERIES = 48
SLOTS = 8
BARS = "▁▂▃▄▅▆▇█"


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but no CUDA device is "
                           "available; pass --device cpu")


def skewed_graph(hub_n: int = HUB_N, tail_n: int = TAIL_N) -> Graph:
    """Hub + path-tail-into-hub: hub sources resolve fast, tail sources
    slow — skewed per-query rounds."""
    hub = gen.powerlaw_cluster(hub_n, 5, p=0.4, seed=1)
    n = hub.n + tail_n
    ps = np.arange(hub_n + 1, n, dtype=np.int32)
    pd = np.arange(hub_n, n - 1, dtype=np.int32)
    g = Graph(n, np.concatenate([hub.src, ps, [hub_n]]),
              np.concatenate([hub.dst, pd, [0]]))
    return gen.with_random_weights(g, lo=0.1, hi=1.0, seed=2)


def sparkline(values, width: int = 48) -> str:
    v = np.asarray(values, dtype=np.float64)
    if len(v) > width:   # resample long traces to the terminal width
        idx = np.linspace(0, len(v) - 1, width).astype(int)
        v = v[idx]
    v = np.log10(np.maximum(v, 1e-12))   # residuals decay geometrically
    lo, hi = v.min(), v.max()
    span = (hi - lo) or 1.0
    return "".join(BARS[int((x - lo) / span * (len(BARS) - 1))] for x in v)


def text_histogram(samples, edges) -> list[str]:
    counts, _ = np.histogram(samples, bins=edges)
    peak = max(int(counts.max()), 1)
    return [
        f"    rounds {int(lo):4d}-{int(hi):<4d} "
        f"{'█' * max(1, int(24 * c / peak)) if c else '':<24} {c}"
        for lo, hi, c in zip(edges[:-1], edges[1:], counts)
    ]


def span_table(spans) -> dict[str, tuple[int, float, float]]:
    """Host time by span name from the sink's records: ``name -> (count,
    total s, self s)``, the largest total first."""
    own = self_times(spans)
    rows: dict[str, list] = {}
    for s in spans:
        row = rows.setdefault(s["name"], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += s["duration_s"]
        row[2] += own[s["id"]]
    return {k: tuple(v) for k, v in sorted(rows.items(), key=lambda kv: -kv[1][1])}


def run(hub_n: int = HUB_N, tail_n: int = TAIL_N, n_queries: int = N_QUERIES,
        device: str = "cuda", echo=print) -> dict:
    """The script's run; returns the spans read back from the sink, the
    solo solve's result and the server's summary."""
    check_device(device)
    rng = np.random.default_rng(0)
    gw = skewed_graph(hub_n, tail_n)
    sink_path = os.path.join(tempfile.mkdtemp(prefix="repro_obs_"), "spans.jsonl")
    tracer = Tracer(jsonl=sink_path)

    # --- 1. one traced solo solve: the convergence trace ----------------
    deep_tail = gw.n - 1
    algo = get_algorithm("sssp", gw, source=deep_tail)
    res = solve(algo, options=EngineOptions(
        bs=64, trace=tracer, transfer_guard="disallow", device=device))
    tr = res.convergence_trace
    echo(f"solo SSSP from the tail tip: {res.rounds} rounds, "
         f"converged={res.converged}, unit={tr.unit}, "
         f"total work {tr.total_work:.0f}")
    echo(f"  residual decay  {sparkline(tr.residual)}")
    echo(f"  active fraction {sparkline(tr.active_fraction)}")

    # --- 2. two tenants, skewed SSSP stream, fully traced ---------------
    srv = GraphServer(gw, graphs={"replica": gw}, slots=SLOTS, bs=64,
                      rounds_per_batch=4, transfer_guard="disallow",
                      trace=tracer, device=device)
    n_tail = n_queries // 4
    sources = np.concatenate([
        rng.integers(0, hub_n, size=n_queries - n_tail),       # fast
        rng.integers(hub_n + tail_n // 4, gw.n, size=n_tail),  # slow
    ])
    rng.shuffle(sources)
    for k, s in enumerate(sources):
        tenant = "default" if k % 2 == 0 else "replica"
        srv.submit("sssp", {"source": int(s)}, tenant=tenant)
    srv.run()
    tracer.close()

    # --- 3. read the sink back, like a dashboard would ------------------
    with open(sink_path, encoding="utf-8") as fh:
        spans = [json.loads(line) for line in fh]
    resolves = [s for s in spans if s["name"] == "resolve"]
    batches = [s for s in spans if s["name"] == "batch"]
    echo(f"\nJSONL sink {sink_path}: {len(spans)} spans "
         f"({len(batches)} batches, {len(resolves)} resolves)")
    edges = [0, 8, 16, 32, 64, 128, 512]
    tenant_rounds = {}
    for tenant in ("default", "replica"):
        rounds = [r["rounds"] for r in resolves if r["tenant"] == tenant]
        tenant_rounds[tenant] = rounds
        echo(f"  tenant {tenant!r}: {len(rounds)} resolved, "
             f"p99 rounds {int(np.percentile(rounds, 99))}")
        for line in text_histogram(rounds, edges):
            echo(line)
    table = span_table(spans)
    echo(f"\n  {'span':<14} {'count':>6} {'total ms':>10} {'self ms':>10}")
    for name, (count, total, own) in table.items():
        echo(f"  {name:<14} {count:6d} {1e3 * total:10.2f} {1e3 * own:10.2f}")
    active = [a for b in batches for a in b.get("active", ())]
    if active:
        echo(f"  blocks swept a sweep: mean {np.mean(active):.3f} over "
             f"{len(active)} sweeps")

    # --- 4. the Prometheus endpoint -------------------------------------
    echo("\nmetrics_text() excerpt:")
    wanted = ("repro_queries_resolved_total", "repro_rounds_total",
              "repro_query_rounds_count")
    metrics = [line for line in srv.metrics_text().splitlines() if line.startswith(wanted)]
    for line in metrics:
        echo("  " + line)
    s = srv.stats.summary()
    echo(f"\nsummary: rounds p50/p99 {s['rounds_p50']:.0f}/"
         f"{s['rounds_p99']:.0f}, per-tenant batches {s['tenant_batches']}")
    return {"spans": spans, "solo": res, "tenant_rounds": tenant_rounds,
            "table": table, "metrics": metrics, "summary": s, "sink": sink_path}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    run(device=p.parse_args().device)


if __name__ == "__main__":
    main()
