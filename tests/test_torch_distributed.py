"""The port's distributed engine against the reference's, on the CPU.

One rank runs in this process against the reference on its one host device
and against the port's own ``async_block`` torch backend (one rank sweeps
every block in order, which is that backend's sweep). Four ranks run as
fresh subprocesses over gloo (a `FileStore` in a temporary directory, no
fixed port), beside the reference on four forced host devices
(`tests.util.run_with_devices`), on a graph whose block count is padded:
n = 300 at bs = 32 gives 10 blocks, padded to 12 for 4 ranks. Which rows
are stale inside a superstep sets the round counts, so a port that padded
or assigned blocks otherwise would converge in other rounds.

Lattice semirings match bitwise in state, ``rounds`` and ``col_rounds``.
Sum semirings match the state within ``atol=1e-6`` (the reference's own
distributed-against-legacy tolerance, ``tests/test_api.py``) and rounds
within one: the stopping round of a PageRank-family run follows the f32
summation order (ROADMAP §C).
"""
import os
import subprocess
import sys
import tempfile
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro.engine.async_block import AsyncBlockSession as RSession  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.serving import GraphServer as RServer  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.engine.api import EngineOptionsError  # noqa: E402
from repro_torch.engine.async_block import AsyncBlockSession  # noqa: E402
from repro_torch.engine.distributed import DistContext  # noqa: E402
from repro_torch.graphs.graph import Graph as TGraph  # noqa: E402
from repro_torch.interop import algo_fields, algo_from_arrays  # noqa: E402
from repro_torch.serving import GraphServer  # noqa: E402

from tests.util import run_with_devices  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N = 300
BS = 32
RANKS = 4
SUM = ("pagerank", "katz", "php", "adsorption", "ppr")
ALGOS = sorted(repro.ALGORITHMS)
WEIGHTED = ("sssp", "sswp", "ms_sssp")
RANK_TIMEOUT = 300


def _graphs():
    g = RG.scrambled(RG.powerlaw_cluster(N, 3, p=0.4, seed=1), seed=5)
    return g, RG.with_random_weights(g, lo=0.1, hi=1.0, seed=2)


G, GW = _graphs()


def _port(ra):
    return algo_from_arrays(algo_fields(ra))


def _check(name, t, r, *, atol=1e-6):
    """Port result ``t`` against reference result ``r``."""
    if name in SUM:
        np.testing.assert_allclose(t.x, np.asarray(r.x), rtol=0, atol=atol)
        assert abs(t.rounds - r.rounds) <= 1, (t.rounds, r.rounds)
        assert np.all(np.abs(np.asarray(t.col_rounds) - np.asarray(r.col_rounds)) <= 1)
    else:
        np.testing.assert_array_equal(t.x, np.asarray(r.x))
        assert t.rounds == r.rounds
        np.testing.assert_array_equal(t.col_rounds, np.asarray(r.col_rounds))
    assert t.converged and r.converged


# ---------------------------------------------------------------------------
# one rank, in process
# ---------------------------------------------------------------------------

# test_api.py's CASES, a d = 4 PPR batch, and every family of ALGORITHMS
CASES = ([("pagerank", {}), ("sssp", {"source": 3}), ("sswp", {"source": 3}),
          ("ppr", {"seeds": [0, 5, 17, 99]})]
         + [(name, {}) for name in ALGOS])


def _instance(name, params):
    return repro.get_algorithm(name, GW if name in WEIGHTED or params else G, **params)


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{len(p)}" for n, p in CASES])
def test_one_rank_matches_reference(name, params):
    ra = _instance(name, params)
    r = repro.solve(ra, engine="distributed", bs=BS)
    t = rt.solve(_port(ra), engine="distributed", bs=BS, device="cpu")
    _check(name, t, r)


@pytest.mark.parametrize("name,params", CASES[:4], ids=[n for n, _ in CASES[:4]])
def test_one_rank_equals_async_block_torch(name, params):
    """One rank sweeps every block in order against its own copy: the
    torch backend's sweep, bit for bit."""
    ta = _port(_instance(name, params))
    d = rt.solve(ta, engine="distributed", bs=BS, device="cpu")
    a = rt.solve(ta, engine="async_block", backend="torch", bs=BS, device="cpu")
    assert d.rounds == a.rounds
    np.testing.assert_array_equal(d.x, a.x)
    np.testing.assert_array_equal(d.col_rounds, a.col_rounds)
    np.testing.assert_array_equal(d.residuals, a.residuals)


@pytest.mark.parametrize("name,params", CASES[:3], ids=[n for n, _ in CASES[:3]])
def test_run_distributed_shim_equals_solve(name, params):
    ta = _port(_instance(name, params))
    s = rt.solve(ta, engine="distributed", bs=BS, inner=2, device="cpu")
    r = rt.run_distributed(ta, bs=BS, inner=2, device="cpu")
    assert s.rounds == r.rounds
    np.testing.assert_array_equal(s.x, r.x)
    np.testing.assert_array_equal(s.col_rounds, r.col_rounds)


def test_inner_warm_start_and_extrapolation_match_reference():
    # the tolerance of test_torch_engine.py's inner and extrapolated runs:
    # both stop one eps-sized step from the fixpoint, and an Aitken jump
    # scales a step by up to rho / (1 - rho) = 19 (harness._RHO_MAX), so
    # the packages' summation orders part by a few eps, not ulps
    ra = repro.get_algorithm("pagerank", G)
    ta = _port(ra)
    for kw in ({"inner": 2}, {"extrapolate_every": 4}):
        _check("pagerank", rt.solve(ta, engine="distributed", bs=BS, device="cpu", **kw),
               repro.solve(ra, engine="distributed", bs=BS, **kw), atol=10 * ra.eps)
    rs = repro.get_algorithm("sssp", GW, source=3)
    first = rt.solve(_port(rs), engine="distributed", bs=BS, device="cpu")
    warm = rt.solve(_port(rs), engine="distributed", bs=BS, x_init=first.x, device="cpu")
    assert warm.rounds <= 1
    np.testing.assert_array_equal(warm.x, first.x)


def test_rank_relabels_before_the_engine():
    from repro.core.gograph import gograph_order

    rank = gograph_order(GW)
    ra = repro.get_algorithm("sssp", GW, source=7)
    r = repro.solve(ra, engine="distributed", bs=BS, rank=rank)
    t = rt.solve(_port(ra), engine="distributed", bs=BS, rank=rank, device="cpu")
    _check("sssp", t, r)


def test_session_reports_match_reference():
    """AsyncBlockSession(backend="distributed") on one rank: per-batch
    reports, cumulative accounting and state across a swap equal the
    reference session's."""
    rq = repro.get_algorithm("ms_sssp", GW, sources=[0, 5, 9])
    rs = RSession(rq, bs=BS, backend="distributed")
    ts = AsyncBlockSession(_port(rq), bs=BS, backend="distributed", device="cpu")
    assert ts.x.shape == (ts._dist.npad2, 3)
    nq = repro.get_algorithm("sssp", GW, source=33)
    for step in range(5):
        rrep, trep = rs.run_batch(2), ts.run_batch(2)
        assert trep.rounds == rrep.rounds
        np.testing.assert_array_equal(trep.col_done, rrep.col_done)
        np.testing.assert_array_equal(trep.col_rounds, rrep.col_rounds)
        np.testing.assert_array_equal(ts.col_rounds.numpy(), np.asarray(rs.col_rounds))
        np.testing.assert_array_equal(ts.state.numpy(), np.asarray(rs.state))
        if step == 1:
            for s in (rs, ts):
                s.swap_in(1, nq.x0[:, 0], nq.c[:, 0], nq.fixed[:, 0])


def test_server_tickets_match_reference():
    """GraphServer(backend="distributed") on one rank against the
    reference's: the same tickets in the same ticks, a delta landing warm
    mid-run."""
    from repro.graphs.delta import random_delta
    from repro_torch.interop import delta_fields, delta_from_arrays

    kw = dict(slots=2, bs=BS, rounds_per_batch=2, cache=False)
    r = RServer(GW, backend="distributed", **kw)
    t = GraphServer(TGraph(GW.n, GW.src.copy(), GW.dst.copy(), GW.w.copy()),
                    backend="distributed", device="cpu", **kw)
    qs = [("sssp", {"source": 0}), ("ppr", {"seeds": [7]}), ("bfs", {"source": 3}),
          ("sssp", {"source": 100}), ("ppr", {"seeds": [200]})]
    pairs = [(r.submit(a, p), t.submit(a, p)) for a, p in qs]
    r.step()
    t.step()
    delta = random_delta(GW, frac_add=0.01, n_add_vertices=2, seed=5)
    r.apply_delta(delta)
    t.apply_delta(delta_from_arrays(delta_fields(delta)))
    r.run()
    t.run()
    for rt_, tt in pairs:
        assert tt.status == rt_.status == "done"
        _check(tt.algo, types.SimpleNamespace(x=tt.result, rounds=tt.rounds,
                                              col_rounds=[tt.rounds], converged=tt.converged),
               types.SimpleNamespace(x=rt_.result, rounds=rt_.rounds,
                                     col_rounds=[rt_.rounds], converged=rt_.converged))


def test_mismatched_mesh_raises():
    ta = _port(repro.get_algorithm("sssp", GW, source=3))
    cuda_mesh = types.SimpleNamespace(mesh_dim_names=("data",), device_type="cuda", ndim=1)
    with pytest.raises(EngineOptionsError, match="cuda"):
        rt.solve(ta, engine="distributed", mesh=cuda_mesh, device="cpu")
    with pytest.raises(EngineOptionsError, match="named 'data'"):
        DistContext(ta, BS, mesh=types.SimpleNamespace(
            mesh_dim_names=("model",), device_type="cpu", ndim=1), device="cpu")
    with pytest.raises(EngineOptionsError, match="DeviceMesh"):
        rt.solve(ta, engine="distributed", mesh=object(), device="cpu")
    with pytest.raises(EngineOptionsError):
        AsyncBlockSession(ta, bs=BS, backend="distributed", mesh=cuda_mesh, device="cpu")


# ---------------------------------------------------------------------------
# four ranks: gloo subprocesses against the reference on four host devices
# ---------------------------------------------------------------------------

# Each rank: the same graph from the test's npz, every family cold and warm
# from its converged state, the padded block count, and a mesh of CPU
# devices refused for a solve on "cuda".
RANK_CODE = textwrap.dedent("""
    import datetime, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    from repro_torch.engine import ALGORITHMS, get_algorithm
    from repro_torch.engine.api import EngineOptionsError
    from repro_torch.engine.distributed import DistContext, run_distributed
    from repro_torch.graphs.graph import Graph
    z = np.load(os.path.join(tmp, "graph.npz"))
    g = Graph(int(z["n"]), z["src"], z["dst"])
    gw = Graph(int(z["n"]), z["src"], z["dst"], z["w"])
    out = {}
    for name in sorted(ALGORITHMS):
        a = get_algorithm(name, gw if name in ("sssp", "sswp", "ms_sssp") else g)
        for tag in ("cold", "warm"):
            x_init = out.get(name + ".cold.x")  # the warm run starts from the cold one's
            r = run_distributed(a, mesh=mesh, bs=32, x_init=x_init, device="cpu")
            for k in ("x", "rounds", "col_rounds", "converged"):
                out[f"{name}.{tag}.{k}"] = np.asarray(getattr(r, k))
    out["nb"] = DistContext(get_algorithm("pagerank", g), 32, mesh=mesh, device="cpu").nb
    try:
        run_distributed(get_algorithm("pagerank", g), mesh=mesh, device="cuda")
        out["cuda_refused"] = False
    except EngineOptionsError:
        out["cuda_refused"] = True
    np.savez(os.path.join(tmp, f"port{rank}.npz"), **out)
    dist.destroy_process_group()
""")

REF_CODE = textwrap.dedent("""
    import numpy as np
    from repro.engine import ALGORITHMS, get_algorithm
    from repro.engine.distributed import DistContext, run_distributed
    from repro.graphs.graph import Graph
    tmp = TMP
    z = np.load(tmp + "/graph.npz")
    g = Graph(int(z["n"]), z["src"], z["dst"])
    gw = Graph(int(z["n"]), z["src"], z["dst"], z["w"])
    out = {}
    for name in sorted(ALGORITHMS):
        a = get_algorithm(name, gw if name in ("sssp", "sswp", "ms_sssp") else g)
        for tag in ("cold", "warm"):
            r = run_distributed(a, bs=32, x_init=out.get(name + ".cold.x"))
            for k in ("x", "rounds", "col_rounds", "converged"):
                out[f"{name}.{tag}.{k}"] = np.asarray(getattr(r, k))
    out["nb"] = DistContext(get_algorithm("pagerank", g), 32).nb
    np.savez(tmp + "/ref.npz", **out)
    print("ok")
""")


@pytest.fixture(scope="module")
def four_ranks():
    """Both four-way runs on the same graph; the port's ranks start first
    and run beside the reference's subprocess."""
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "graph.npz"), n=GW.n, src=GW.src, dst=GW.dst, w=GW.w)
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(k), str(RANKS), tmp],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for k in range(RANKS)]
        try:
            run_with_devices(f"TMP = {tmp!r}\n" + REF_CODE, n_devices=RANKS,
                             timeout=RANK_TIMEOUT)
            errs = [p.communicate(timeout=RANK_TIMEOUT)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for k, p in enumerate(procs):
            assert p.returncode == 0, f"rank {k} failed:\n{errs[k][-3000:]}"
        ref = dict(np.load(os.path.join(tmp, "ref.npz")))
        ranks = [dict(np.load(os.path.join(tmp, f"port{k}.npz"))) for k in range(RANKS)]
    return ref, ranks


def _result(out, name, tag):
    return types.SimpleNamespace(**{k: out[f"{name}.{tag}.{k}"]
                                    for k in ("x", "rounds", "col_rounds", "converged")})


def test_four_ranks_pad_the_blocks_as_the_reference(four_ranks):
    ref, ranks = four_ranks
    assert int(ref["nb"]) == int(ranks[0]["nb"]) == 12  # 10 blocks, padded


@pytest.mark.parametrize("name", ALGOS)
def test_four_ranks_match_reference(four_ranks, name):
    ref, ranks = four_ranks
    _check(name, _result(ranks[0], name, "cold"), _result(ref, name, "cold"))


@pytest.mark.parametrize("name", ALGOS)
def test_four_ranks_warm_restart(four_ranks, name):
    """tests/test_incremental.py's distributed warm restart on the port's
    four ranks: at most one round, the same bits."""
    _, ranks = four_ranks
    cold, warm = _result(ranks[0], name, "cold"), _result(ranks[0], name, "warm")
    assert int(warm.rounds) <= 1
    np.testing.assert_array_equal(warm.x, cold.x)


def test_four_ranks_agree_bit_for_bit(four_ranks):
    _, ranks = four_ranks
    for k in range(1, RANKS):
        assert sorted(ranks[k]) == sorted(ranks[0])
        for key, v in ranks[0].items():
            np.testing.assert_array_equal(ranks[k][key], v, err_msg=f"rank {k} {key}")


def test_four_ranks_rounds_against_one(four_ranks):
    """tests/test_engines.py's bound on the reference's distributed rounds:
    at least the one-rank rounds, at most 3x plus 5; SSSP's lattice fixpoint
    is unique, so four ranks reach the one-rank state bit for bit."""
    _, ranks = four_ranks
    for name in ("pagerank", "sssp"):
        four = _result(ranks[0], name, "cold")
        a = repro.get_algorithm(name, GW if name in WEIGHTED else G)
        one = rt.solve(_port(a), engine="distributed", bs=BS, device="cpu")
        assert one.rounds <= int(four.rounds) <= 3 * one.rounds + 5
        if name == "sssp":
            np.testing.assert_array_equal(four.x, one.x)
        else:
            np.testing.assert_allclose(four.x, one.x, rtol=1e-4, atol=2e-5)
    assert bool(ranks[0]["cuda_refused"])
