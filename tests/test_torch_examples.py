"""The port's twins of the reference's seven graph examples, and the
``run_async_block_kernel`` shim, against the reference on the CPU.

Each twin's ``run(...)`` runs at a small size on the CPU (``device="cpu"``:
the torch backend, or the sweep kernel's plain version) beside the
reference's API calls that its example makes, on the same graph: lattice
results bitwise, PageRank-family states within the engine tests' sum
tolerance and rounds within one (ROADMAP, standing records), M/|E|
exactly. The serving loop, the traced serving run and the fault-tolerant
run are held to the reference's examples themselves (their module
constants or flags shrunk), by what they print or write: the serving
loop's lines but the timed ones, the span names and counts of the JSONL
sink, the fault log after an injected failure.
"""
import collections
import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro  # noqa: E402
from repro.core import baselines as RB  # noqa: E402
from repro.core import gograph as RGO  # noqa: E402
from repro.core import metric as RM  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.graphs.delta import random_delta as r_random_delta  # noqa: E402
from repro.obs import trace as RTRACE  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EPS = 1e-6
SUM_TOL = dict(atol=10 * EPS, rtol=1e-4)   # tests/test_torch_engine.py's rule
TWINS = ("quickstart", "multi_query", "evolving_pagerank", "serving_loop",
         "observe_serving", "distributed_pagerank", "graph_end2end")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin(name: str):
    return _load(ROOT / "examples" / f"{name}_torch.py", f"_twin_{name}")


def reference_example(name: str):
    return _load(ROOT / "examples" / f"{name}.py", f"_ref_example_{name}")


def _quiet(*a, **k):
    pass


class _Lines:
    """An ``echo`` that keeps what ``print`` would write, line by line."""

    def __init__(self):
        self.buf = io.StringIO()

    def __call__(self, *a, **k):
        print(*a, **k, file=self.buf)

    @property
    def lines(self) -> list:
        return self.buf.getvalue().splitlines()


def _run_main(mod, argv=()) -> list:
    """The reference example's ``main()`` under ``argv``; its stdout lines."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["example"] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
    return out.getvalue().splitlines()


def _sum_close(t, r):
    np.testing.assert_allclose(np.asarray(t.x if hasattr(t, "x") else t),
                               np.asarray(r.x if hasattr(r, "x") else r), **SUM_TOL)


def test_quickstart_matches_reference():
    """GoGraph's M/|E| exactly; sync, async default and async GoGraph
    PageRank rounds within one and states within the sum tolerance; the
    paper's result: fewer rounds under GoGraph than under the default
    order, in both packages."""
    n = 1000
    got = twin("quickstart").run(n=n, device="cpu", echo=_quiet)
    g = RG.scrambled(RG.powerlaw_cluster(n, 5, seed=1), seed=7)
    rank = RGO.gograph_order(g)
    assert got["m_default"] == RM.positive_edge_fraction(g, RB.default_order(g))
    assert got["m_gograph"] == RM.positive_edge_fraction(g, rank)
    algo = repro.get_algorithm("pagerank", g)
    gg = algo.relabel(rank)
    want = {"sync": repro.solve(algo, engine="sync"),
            "async": repro.solve(algo, engine="async_block", bs=64, inner=2),
            "gograph": repro.solve(gg, engine="async_block", bs=64, inner=2)}
    for key, r in want.items():
        assert abs(got["rounds_" + key] - r.rounds) <= 1, (key, got["rounds_" + key], r.rounds)
        _sum_close(got["x_" + key], r)
    assert got["rounds_gograph"] < got["rounds_async"] < got["rounds_sync"]
    assert want["gograph"].rounds < want["async"].rounds
    assert got["err"] < 1e-4


def test_multi_query_matches_reference():
    """The d-column PPR batch (rounds and per-column rounds within one,
    the state within the sum tolerance) and multi-source SSSP (bitwise),
    on the same seeds and sources."""
    n, d, bs = 1500, 8, 256
    got = twin("multi_query").run(n=n, d=d, bs=bs, device="cpu", echo=_quiet)
    g = RG.scrambled(RG.powerlaw_cluster(n, 5, seed=1), seed=7)
    rng = np.random.default_rng(0)
    seeds = rng.choice(g.n, size=d, replace=False)
    np.testing.assert_array_equal(got["seeds"], seeds)
    r = repro.solve(repro.personalized_pagerank(g, seeds), bs=bs)
    assert abs(got["ppr_rounds"] - r.rounds) <= 1
    assert np.abs(got["ppr_col_rounds"] - np.asarray(r.col_rounds)).max() <= 1
    _sum_close(got["ppr_x"], r)
    sources = rng.choice(g.n, size=min(8, d), replace=False)
    np.testing.assert_array_equal(got["sources"], sources)
    gw = RG.with_random_weights(g, seed=2)
    rm = repro.solve(repro.multi_source_sssp(gw, sources), bs=bs)
    np.testing.assert_array_equal(got["sssp_x"], np.asarray(rm.x))
    assert got["sssp_rounds"] == rm.rounds and got["sssp_converged"] and rm.converged


def test_evolving_pagerank_matches_reference():
    """Two delta batches: the extended rank and M/|E| exactly; warm and
    cold rounds within one; the warm state within run_incremental's
    tolerance (20 eps) of the reference's."""
    n, batches, bs = 1500, 2, 256
    got = twin("evolving_pagerank").run(n=n, batches=batches, bs=bs, device="cpu",
                                       echo=_quiet)
    g = RG.scrambled(RG.powerlaw_cluster(n, 5, seed=1), seed=7)
    rank = RGO.gograph_order(g)
    algo = repro.get_algorithm("pagerank", g)
    prior = repro.solve(algo.relabel(rank), bs=bs, inner=2)
    assert abs(got["initial_rounds"] - prior.rounds) <= 1
    x_served = np.asarray(prior.x)[rank]
    for step, mine in enumerate(got["steps"]):
        delta = r_random_delta(g, frac_add=0.01, n_add_vertices=n // 1000, seed=100 + step)
        g_new = delta.apply(g)
        algo_new = repro.remake(algo, g_new)
        rank = RGO.extend_rank(g_new, rank)
        np.testing.assert_array_equal(mine["rank"], rank)
        assert mine["m"] == RM.positive_edge_fraction(g_new, rank)
        warm = repro.run_incremental(algo_new, algo, x_served, engine="async_block", bs=bs,
                                     inner=2, rank=rank)
        cold = repro.solve(algo_new.relabel(rank), bs=bs, inner=2)
        assert abs(mine["warm_rounds"] - warm.rounds) <= 1
        assert abs(mine["cold_rounds"] - cold.rounds) <= 1
        np.testing.assert_allclose(mine["warm_x"], np.asarray(warm.x), atol=20 * EPS, rtol=1e-5)
        g, algo, x_served = g_new, algo_new, np.asarray(warm.x)


_TIMED = ("throughput", "latency")


def test_serving_loop_matches_reference():
    """The reference's example and the twin on a 400-vertex graph for 20
    ticks print the same lines but the timed ones (throughput and latency):
    the ticks' submissions, resolutions, cache hits, occupancy and queue,
    the delta and its cache promotions, the drained counts, rounds p50/p99
    and the cache's statistics."""
    ref = reference_example("serving_loop")
    ref.N, ref.TICKS = 400, 20
    want = _run_main(ref)
    echo = _Lines()
    got = twin("serving_loop").run(n=400, ticks=20, device="cpu", echo=echo)
    keep = lambda lines: [x for x in lines if not x.startswith(_TIMED)]  # noqa: E731
    assert keep(echo.lines) == keep(want)
    assert got["summary"]["resolved"] == got["summary"]["submitted"] > 0


def test_observe_serving_matches_reference():
    """The traced run at the reference's sizes: the JSONL sink's span names
    and their counts, each tenant's resolved count, and the solo SSSP's
    rounds equal to the reference's; the port's host-time table has a row
    for each span name."""
    lines = _run_main(reference_example("observe_serving"))
    sink = next(re.match(r"JSONL sink (\S+):", x).group(1) for x in lines
                if x.startswith("JSONL sink "))
    with open(sink, encoding="utf-8") as fh:
        want = [json.loads(x) for x in fh]
    got = twin("observe_serving").run(device="cpu", echo=_quiet)
    # the reference's own spans; the port's further spans and the retired
    # sweep_call are not the reference's to hold
    shared = set(RTRACE.SPAN_NAMES) - {"sweep_call"}
    assert collections.Counter(s["name"] for s in got["spans"] if s["name"] in shared) == \
        collections.Counter(s["name"] for s in want if s["name"] in shared)
    for tenant in ("default", "replica"):
        assert len(got["tenant_rounds"][tenant]) == sum(
            1 for s in want if s["name"] == "resolve" and s["tenant"] == tenant)
    # the host-time table: one row a span name in the sink, self <= total
    counts = collections.Counter(s["name"] for s in got["spans"])
    assert {k: row[0] for k, row in got["table"].items()} == counts
    assert all(0.0 <= own <= total for _, total, own in got["table"].values())
    solo = next(x for x in lines if x.startswith("solo SSSP"))
    assert f"{got['solo'].rounds} rounds" in solo


def test_distributed_pagerank_matches_reference():
    """One gloo rank of the twin's own against the reference's distributed
    engine on this process's one host device, and both packages'
    async_block solves: rounds within one, states within the sum
    tolerance, the intra-shard fraction of one shard."""
    import jax

    n = 1000
    got = twin("distributed_pagerank").run(n=n, device="cpu", echo=_quiet)
    g = RG.scrambled(RG.powerlaw_cluster(n, 5, seed=1), seed=3)
    algo = repro.get_algorithm("pagerank", g).relabel(RGO.gograph_order(g))
    assert got["ranks"] == len(jax.devices()) == 1 and got["intra"] == 1.0
    single = repro.solve(algo, engine="async_block", bs=64)
    dist_r = repro.solve(algo, engine="distributed", bs=64)
    assert abs(got["single_rounds"] - single.rounds) <= 1
    assert abs(got["dist_rounds"] - dist_r.rounds) <= 1
    _sum_close(got["single_x"], single)
    _sum_close(got["dist_x"], dist_r)


@pytest.mark.parametrize("kernel", [False, True], ids=["torch", "kernel"])
def test_graph_end2end_fault_log_matches_reference(kernel):
    """``--inject-failure`` at n = 1000: the twin (torch backend against
    the reference's jax, or ``--kernel``: the sweep kernel's plain version
    against ``--pallas`` in interpret mode) logs the reference's fault log
    line for line, restores from its checkpoint and converges in the
    reference's rounds (within one) to the exact fixpoint."""
    lines = _run_main(reference_example("graph_end2end"),
                      ["--n", "1000", "--inject-failure"] + (["--pallas"] if kernel else []))
    at = lines.index("fault log:")
    want_log = [x.strip() for x in lines[at + 1:]]
    want_rounds = int(re.search(r"rounds=(\d+)", lines[at - 1]).group(1))
    got = twin("graph_end2end").run(n=1000, kernel=kernel, inject_failure=True, device="cpu",
                                    echo=_quiet)
    assert got["log"] == want_log and got["failures"] == 1
    assert got["converged"] and abs(got["rounds"] - want_rounds) <= 1
    assert got["err"] < 1e-4


def _shim_instances():
    g = RG.scrambled(RG.powerlaw_cluster(300, 3, p=0.4, seed=1), seed=5)
    gw = RG.with_random_weights(g, lo=0.1, hi=1.0, seed=2)
    return {"pagerank": repro.get_algorithm("pagerank", g),
            "sssp": repro.get_algorithm("sssp", gw, source=0)}


@pytest.mark.parametrize("name,sweeps", [("pagerank", 1), ("sssp", 1), ("sssp", 4)])
def test_run_async_block_kernel_matches_pallas_shim(name, sweeps):
    """``repro_torch.kernels.ops.run_async_block_kernel`` (the kernel's
    plain version on CPU tensors) against the reference's
    ``run_async_block_pallas`` in interpret mode at n = 300: SSSP bitwise
    in state and rounds, PageRank within the sum tolerance and a round."""
    from repro.kernels.ops import run_async_block_pallas

    from repro_torch.interop import algo_fields, algo_from_arrays
    from repro_torch.kernels.ops import run_async_block_kernel

    ra = _shim_instances()[name]
    r = run_async_block_pallas(ra, bs=128, max_iters=500, interpret=True,
                               sweeps_per_call=sweeps)
    t = run_async_block_kernel(algo_from_arrays(algo_fields(ra)), bs=128, max_iters=500,
                               sweeps_per_call=sweeps, device="cpu")
    assert t.converged and r.converged
    if name == "sssp":
        np.testing.assert_array_equal(t.x, np.asarray(r.x))
        assert t.rounds == r.rounds
    else:
        _sum_close(t, r)
        assert abs(t.rounds - r.rounds) <= 1


def test_run_async_block_kernel_has_no_fallback():
    """Asked for the card where there is none, the shim raises: it never
    falls back to the plain version."""
    from repro_torch.interop import algo_fields, algo_from_arrays
    from repro_torch.kernels.ops import run_async_block_kernel

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the shim launches the kernel there")
    algo = algo_from_arrays(algo_fields(_shim_instances()["sssp"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_async_block_kernel(algo, device="cuda")


@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_a_gpu(name):
    """Each twin's default device is the card: without one it raises
    before any work, unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        twin(name).run(device="cuda", echo=_quiet)
