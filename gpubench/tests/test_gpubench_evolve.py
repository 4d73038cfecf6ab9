"""The cell ``epinions-ppr-evolve``: its files found by name, its two
readers of the delta path on hand-made records, and the cell run whole
through the harness at the tests' size, traced and not."""
import json
import time

import pytest

from gpubench import harness
from gpubench.harness import HERE, find_cell, load_json, load_module

CELL = "epinions-ppr-evolve"


def test_the_cell_and_its_files_are_found():
    cell = find_cell(CELL, False)
    assert cell.workload["chips"] == 1
    assert cell.config["name"] == "soc-epinions1-evolve"
    assert cell.mix["driver"] == "serve_closed_loop" and cell.mix["check"] == "ppr"
    assert cell.mix["deltas"] == {"every_s": 5, "insert": 200, "delete": 20}
    assert cell.limits == {"ppr_max_abs_err": 1e-5}
    assert {m["name"] for m in cell.metrics} == {
        "queries_per_s", "peak_device_gb", "setup_s"}
    traced = {m["name"] for m in find_cell(CELL, True).metrics}
    assert {"delta_apply_s", "delta_idle_pct", "admit_idle_pct", "device_idle_pct",
            "sweep_roofline_pct"} <= traced
    assert not traced & {"pack_s", "prep_idle_pct", "query_p95_s.nyroad"}


def test_the_configuration_is_the_serve_one_with_the_deltas():
    """The served graph, algorithm and deployment are the serve cell's, to
    the key; the evolving one adds the push threshold, the delta mode and
    what it assumes of the deltas."""
    base = load_json(HERE / "configs" / "soc-epinions1.json")
    evolve = load_json(HERE / "configs" / "soc-epinions1-evolve.json")
    assert set(evolve) == set(base)
    for key in ("published", "published_statistics", "graph", "reduced", "precision",
                "algorithms"):
        assert evolve[key] == base[key], key
    assert evolve["deployment"] == dict(base["deployment"], push_threshold=0.05,
                                        delta_mode="warm")
    assert {k: evolve["assumed"][k] for k in base["assumed"]} == base["assumed"]
    assert {"delta_rate", "delta_batch", "delta_insert", "delta_delete", "push"} <= \
        set(evolve["assumed"])
    mix, serve = (load_json(HERE / "traffic" / f"{m}.json")
                  for m in ("ppr-closed-128-evolve", "ppr-closed-128"))
    assert {k: v for k, v in mix.items() if k not in ("deltas", "profile_seconds")} == \
        {k: v for k, v in serve.items() if k != "profile_seconds"}
    assert mix["profile_seconds"] >= 2 * mix["deltas"]["every_s"]
    bench = load_json(HERE.parent / "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == evolve["name"])
    assert entry["source"] == evolve["source"] and entry["reduced"] == []


def _profile(gaps, window_s=10.0):
    return {"profile": {"busy_s": 1.0, "window_s": window_s, "device_ops": [],
                        "idle_gaps": [[name, s] for name, s in gaps.items()]}}


def test_delta_readers_on_hand_made_records():
    apply_s = load_module("metrics", "delta_apply_s")
    assert apply_s.read({"delta_s": [0.5, 1.0, 1.5]}) == pytest.approx(1.0)
    assert apply_s.read({"delta_s": []}) is None and apply_s.read({}) is None

    idle = load_module("metrics", "delta_idle_pct")
    rec = _profile({"repro_torch.carry": 1.0, "repro_torch.pack_tiles": 0.5,
                    "repro_torch.family_rebuild": 0.25, "repro_torch.delta_apply": 0.25,
                    "repro_torch.swap_in": 3.0, "repro_torch.resolve": 2.0})
    assert idle.read(rec) == pytest.approx(20.0)
    # no profile; no program span; the parent's trace, whose apply has no
    # spans of its own (its re-installs read as admission)
    assert idle.read({}) is None and idle.read({"profile": None}) is None
    assert idle.read(_profile({"gpubench.step": 1.0, "cudaMemcpyAsync": 0.5})) is None
    assert idle.read(_profile({"repro_torch.delta_apply": 0.3, "repro_torch.pack": 0.2,
                               "repro_torch.swap_in": 3.0})) is None


def _run(cell, trace, monkeypatch):
    """A whole run; returns the result and the driver's record."""
    recs = []
    real = harness.load_module

    def load(kind, name, base=harness.HERE):
        mod = real(kind, name, base)
        if kind == "drivers":
            run = mod.run
            mod.run = lambda ctx: recs.append(run(ctx)) or recs[-1]
        return mod

    monkeypatch.setattr(harness, "load_module", load)
    out = harness.run(cell, 2**32 + 41, 2.0, trace, t0=0.0, device="cpu")
    return out, recs[0]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_cell_runs_correct_at_the_tests_size(small_cell, monkeypatch, trace):
    """The cell's own files, shrunk, with its batches of 200 and 20 links
    due every 0.3 s instead of 5 (a 2-s window): correct, its answers at
    several versions, and, traced, each apply's seconds read."""
    cell = small_cell(CELL, trace=trace)
    cell.mix["deltas"]["every_s"] = 0.3
    cell.mix["profile_seconds"] = 1.0
    out, rec = _run(cell, trace, monkeypatch)
    assert out["correct"], json.dumps(out["compared"])
    assert len({a[2] for a in rec["answers"]}) >= 2
    assert len(rec["deltas"]) == len(rec["delta_s"]) >= 4
    if trace:
        assert out["metrics"]["delta_apply_s"]["value"] == \
            pytest.approx(sum(rec["delta_s"]) / len(rec["delta_s"]))
    else:
        assert {"queries_per_s", "setup_s"} <= set(out["metrics"])
        assert "query_p95_s" not in out["metrics"]


def test_an_apply_reads_as_the_delta_path_and_never_as_admission(monkeypatch):
    """A CPU trace of one apply with 8 columns in flight, every idle name
    kept: the device's idle time falls to the delta path's spans, and none
    to the admission spans (`admit_idle_pct` reads 0) or to ``resolve``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from gpubench import graphs, profiling
    from gpubench.traffic import delta_batches
    from repro_torch.graphs.delta import GraphDelta
    from repro_torch.graphs.graph import Graph
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import GraphServer

    g = graphs.generate(dict(find_cell(CELL, False).config["graph"],
                             vertices=3000, edges=18000))
    srv = GraphServer(Graph(g.n, g.src, g.dst, g.w), slots=8, bs=64, rounds_per_batch=8,
                      backend="kernel", sweeps_per_call=8,
                      rank=np.random.default_rng(0).permutation(g.n),
                      push_threshold=0.05, trace=Tracer(), device="cpu")
    for s in range(16):
        srv.submit("ppr", {"seeds": [s]})
    srv.step()
    batch = next(delta_batches(g, {"insert": 200, "delete": 20}, 7))
    delta = GraphDelta(**batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        srv.apply_delta(delta)
        window_s = time.perf_counter() - t0
    monkeypatch.setattr(profiling, "TOP", 10_000)
    rec = {"profile": profiling.reduce_events(prof.events(), window_s)}
    assert 0 < load_module("metrics", "delta_idle_pct").read(rec) <= 100
    assert load_module("metrics", "admit_idle_pct").read(rec) == 0.0
    assert load_module("metrics", "resolve_idle_pct").read(rec) == 0.0
    assert srv.stats.delta_columns_carried == 8
