"""One run of one cell: everything between the command line and the result.

`run` reads ``BENCHMARK.json``, finds the cell's configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``), the
mix's driver (``drivers/<driver>.py``), the check of the mix's algorithm
(``checks/<check>.py``), the cell's limits (``limits/<cell>.json``) and one
reader for each metric (``metrics/<metric>.py``), all by name. In order it
generates the graph from the seed, computes the GoGraph order, hands both
to the driver (which warms up, measures and, with ``trace``, profiles),
checks a seeded sample of the answers against the plain reference, and
reads the metrics. A new configuration, mix, check or metric is new files
and new entries in ``BENCHMARK.json``; nothing here names one.

An answer is ``(source, answer)`` or ``(source, answer, version)``: the
version of the graph it was computed on, 0 the generated graph and ``v``
the graph after the first ``v`` batches of the record's ``deltas``. The
check groups the answers by version, rebuilds each version named, and
only those, with `graphs.apply_delta`, calls the check once a version and
takes each compared number's largest over the versions (every compared
number is an error held under its limit). An answer that names a version
never applied makes every compared number infinite. With one version the
check is one call on the generated graph.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np

HERE = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str, base: Path = HERE):
    """``<base>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    mod_name = f"gpubench.{kind}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell as the files describe it."""

    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    metrics: list  # the BENCHMARK.json entries this run reports
    base: Path = HERE  # the benchmark's folder, where the files were found


def find_cell(name: str, trace: bool, base: Path = HERE) -> Cell:
    """Resolve a cell's files by the names in ``BENCHMARK.json``, which
    sits in the folder above ``base``."""
    bench = load_json(base.parent / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"unknown workload {name!r}; one of {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if name in m.get("workloads", [name])]
    return Cell(
        name=name, workload=w,
        config=load_json(base.parent / conf["file"]),
        mix=load_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(base / "limits" / f"{name}.json"),
        metrics=metrics, base=base,
    )


@dataclasses.dataclass
class Context:
    """What a driver gets: the inputs and the settings of one run."""

    graph: Any            # graphs.EdgeList
    rank: np.ndarray      # GoGraph order, rank[v] = position
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: Any           # torch.device
    t0: float             # process start by the host clock


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, t0: float,
        device: str = "cuda") -> dict:
    """One run; returns the result line's object (``compared`` last)."""
    import torch

    from gpubench import graphs
    from repro_torch.core.gograph import gograph_order
    from repro_torch.graphs.graph import Graph

    dev = torch.device(device)
    g = graphs.generate(cell.config["graph"])
    t_order = time.perf_counter()
    rank = gograph_order(Graph(g.n, g.src, g.dst, g.w))
    order_s = time.perf_counter() - t_order
    driver = load_module("drivers", cell.mix["driver"], cell.base)
    ctx = Context(graph=g, rank=rank, config=cell.config, mix=cell.mix,
                  seed=seed, seconds=seconds, trace=trace, device=dev, t0=t0)
    rec = driver.run(ctx)
    rec["order_s"] = order_s
    log(f"order {order_s:.3f} s, setup {rec['setup_s']:.3f} s, window "
        f"{rec['window_s']:.3f} s, {rec['attempted']} attempted, "
        f"{rec['window_rounds']} rounds")
    # the program's state is gone (the driver returned); the reference runs
    # after the peak was read, in memory the program no longer holds
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compared, versions = compare(cell, g, rec["answers"], rec.get("deltas", []), device)
    log(f"check of {len(rec['answers'])} answers at {len(versions)} graph version(s) "
        f"{versions} {time.perf_counter() - t_check:.3f} s: "
        + ", ".join(f"{k} {v['value']!r}" for k, v in compared.items()))
    correct = (rec["attempted"] > 0 and rec["failed"] == 0 and len(rec["answers"]) > 0
               and all(v["value"] <= v["limit"] for v in compared.values()))
    metrics = {}
    for m in cell.metrics:
        value = load_module("metrics", m["name"], cell.base).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {
        "correct": bool(correct),
        "attempted": int(rec["attempted"]),
        "failed": int(rec["failed"]),
        "metrics": metrics,
        "device": device_record(dev, rec),
    }
    prof = rec.get("profile")
    if trace and prof is not None:
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["compared"] = compared
    return out


def compare(cell: Cell, g, answers: list, deltas: list, device: str):
    """``(compared, versions)``: each limited number, the largest over the
    graph versions the answers name, beside its limit; and those versions.
    See the module's docstring."""
    from gpubench import graphs

    check = load_module("checks", cell.mix["check"], cell.base)
    by_version: dict = {}
    for a in answers:
        by_version.setdefault(int(a[2]) if len(a) > 2 else 0, []).append(a)
    versions = sorted(by_version)
    numbers: dict = {}
    if all(0 <= v <= len(deltas) for v in versions):
        graph, at = g, 0
        for v in versions:
            for batch in deltas[at:v]:
                graph = graphs.apply_delta(graph, batch)
            at = v
            sources = np.asarray([a[0] for a in by_version[v]], np.int64)
            got = np.stack([a[1] for a in by_version[v]], axis=1)
            for k, x in check.numbers(graph, cell.config, sources, got,
                                      device=device).items():
                numbers[k] = x if k not in numbers else float(np.maximum(numbers[k], x))
    else:
        log(f"answers name graph versions never applied: {versions} "
            f"against {len(deltas)} batches")
    compared = {k: {"value": numbers.get(k, float("inf")), "limit": float(lim)}
                for k, lim in cell.limits.items()}
    return compared, versions


def device_record(dev, rec: dict) -> dict:
    """The result's ``device`` object."""
    import torch

    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1}
    out["memory_peak_bytes"] = int(rec["peak_bytes"])
    prof = rec.get("profile")
    if prof is not None:
        out["busy_s"] = prof["busy_s"]
        out["window_s"] = prof["window_s"]
    return out
