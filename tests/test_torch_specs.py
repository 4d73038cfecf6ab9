"""The port's specs, graph packings, orders and metrics equal the reference's
on the same seeded inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.gograph import GoGraphConfig as RGoGraphConfig  # noqa: E402
from repro.core.gograph import extend_rank as r_extend_rank  # noqa: E402
from repro.core.gograph import gograph_order as r_gograph_order  # noqa: E402
from repro.core.gograph import regional_rerank as r_regional_rerank  # noqa: E402
from repro.core.metric import metric_m as r_metric_m  # noqa: E402
from repro.core.metric import positive_edge_fraction as r_pef  # noqa: E402
from repro.engine import algorithms as RA  # noqa: E402
from repro.graphs import blocked as RB  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.kernels import semirings as RS  # noqa: E402
from repro.kernels.ops import pack_algorithm as r_pack_algorithm  # noqa: E402

from repro_torch.core.gograph import GoGraphConfig  # noqa: E402
from repro_torch.core.gograph import extend_rank, gograph_order, regional_rerank  # noqa: E402
from repro_torch.core.metric import metric_m, metric_m_torch, positive_edge_fraction  # noqa: E402
from repro_torch.engine import algorithms as TA  # noqa: E402
from repro_torch.graphs import blocked as TB  # noqa: E402
from repro_torch.graphs import generators as TG  # noqa: E402
from repro_torch.kernels import semirings as TS  # noqa: E402
from repro_torch.kernels.ops import pack_algorithm  # noqa: E402
from repro_torch.interop import algo_fields, algo_from_arrays, operands_from_arrays  # noqa: E402

N = 311


def _graphs(weighted: bool = True):
    rg = RG.scrambled(RG.powerlaw_cluster(N, 4, p=0.5, seed=1), seed=11)
    tg = TG.scrambled(TG.powerlaw_cluster(N, 4, p=0.5, seed=1), seed=11)
    if weighted:
        rg = RG.with_random_weights(rg, lo=0.1, hi=1.0, seed=3)
        tg = TG.with_random_weights(tg, lo=0.1, hi=1.0, seed=3)
    return rg, tg


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


GENERATORS = {
    "powerlaw_cluster": lambda m: m.powerlaw_cluster(200, 3, p=0.4, seed=2),
    "barabasi_albert": lambda m: m.barabasi_albert(200, 3, seed=4),
    "erdos_renyi": lambda m: m.erdos_renyi(200, 4.0, seed=5),
    "community_graph": lambda m: m.community_graph(200, 8, 6.0, 0.85, seed=6),
    "grid_2d": lambda m: m.grid_2d(10, 12, seed=7),
    "weights_scrambled": lambda m: m.with_random_weights(
        m.scrambled(m.erdos_renyi(150, 3.0, seed=8), seed=9), lo=0.5, hi=2.0, seed=10),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_identical(name):
    r, t = GENERATORS[name](RG), GENERATORS[name](TG)
    assert r.n == t.n
    _same(r.src, t.src)
    _same(r.dst, t.dst)
    _same(r.weights, t.weights)


CONSTRUCTORS = {
    "pagerank": {},
    "katz": {},
    "php": {"target": 5},
    "adsorption": {"seeds": np.array([1, 7])},
    "sssp": {"source": 3},
    "bfs": {"source": 3},
    "cc": {},
    "sswp": {"source": 4},
    "reachability": {"source": 4},
    "ppr": {"seeds": [0, 9, 20]},
    "ms_sssp": {"sources": [1, 2, 30]},
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_identical(name):
    rg, tg = _graphs()
    r = RA.get_algorithm(name, rg, **CONSTRUCTORS[name])
    t = TA.get_algorithm(name, tg, **CONSTRUCTORS[name])
    for f in ("src", "dst", "w", "x0", "c", "fixed"):
        _same(getattr(r, f), getattr(t, f))
    for f in ("name", "n", "combine", "residual", "eps", "monotone_dir", "c_pad_fill"):
        assert getattr(r, f) == getattr(t, f)
    assert (r.semiring.reduce, r.semiring.edge_op, r.semiring.identity) == (
        t.semiring.reduce, t.semiring.edge_op, t.semiring.identity)
    rank = np.random.default_rng(0).permutation(N)
    rr, tr = r.relabel(rank), t.relabel(rank)
    for f in ("src", "dst", "x0", "c", "fixed"):
        _same(getattr(rr, f), getattr(tr, f))
    if name in ("pagerank", "sssp", "cc", "ms_sssp"):
        _same(r.exact(), t.exact())
    _same(TA.remake(t, tg).x0, t.x0)


def test_semiring_tables_identical():
    assert TS.ACC_IDENTITY == RS.ACC_IDENTITY
    assert TS.TILE_FILL == RS.TILE_FILL
    assert TS.DELTA_METRIC == RS.DELTA_METRIC
    assert np.float32(TA.BIG) == np.float32(RA.BIG)


@pytest.mark.parametrize("kind", ["linf", "l1", "changed"])
def test_delta_cols_matches(kind):
    rng = np.random.default_rng(1)
    new = rng.standard_normal((40, 3)).astype(np.float32)
    old = new.copy()
    old[rng.random((40, 3)) < 0.5] += 1.0
    ref = RS.delta_cols(kind, new, old, xp=np)
    got = TS.delta_cols(kind, torch.from_numpy(new), torch.from_numpy(old)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("bs,fill", [(16, 0.0), (64, 0.0), (64, float(RA.BIG)), (32, float(-RA.BIG))])
def test_pack_bsr_flat_identical(bs, fill):
    rg, tg = _graphs()
    r = RB.pack_bsr_flat(rg, bs, fill=fill)
    t = TB.pack_bsr_flat(tg, bs, fill=fill, device="cpu")
    _same(r.rowptr, t.rowptr)
    _same(r.tilecols, t.tilecols)
    _same(r.tilerows, t.tilerows)
    _same(r.tiles, t.tiles.numpy())
    assert r.stats() == t.stats()
    for a, b in zip(RB.block_reverse_deps(r.rowptr, r.tilecols),
                    TB.block_reverse_deps(t.rowptr, t.tilecols), strict=True):
        _same(a, b)


def test_pack_bsr_flat_empty_graph():
    r = RB.pack_bsr_flat(RG.Graph(10, [], []), 4)
    t = TB.pack_bsr_flat(TG.Graph(10, [], []), 4, device="cpu")
    _same(r.tiles, t.tiles.numpy())
    _same(r.rowptr, t.rowptr)
    for a, b in zip(r.reverse_deps(), t.reverse_deps(), strict=True):
        _same(a, b)


@pytest.mark.parametrize("bs", [16, 64])
def test_pack_in_edges_and_padding_identical(bs):
    rg, tg = _graphs()
    r, t = RB.pack_in_edges(rg, bs), TB.pack_in_edges(tg, bs)
    for f in ("esrc", "edst", "ew", "emask"):
        _same(getattr(r, f), getattr(t, f))
    x = np.random.default_rng(2).random((N, 3)).astype(np.float32)
    _same(RB.pad_state(x, bs, fill=7.0), TB.pad_state(x, bs, fill=7.0))
    assert RB.num_blocks(N, bs) == TB.num_blocks(N, bs)
    assert RB.padded_n(N, bs) == TB.padded_n(N, bs)


@pytest.mark.parametrize("bs", [16, 64])
def test_frontier_blocks_identical(bs):
    mask = np.random.default_rng(3).random(N) < 0.05
    _same(RB.frontier_blocks(mask, N, bs), TB.frontier_blocks(mask, N, bs))
    _same(RB.frontier_blocks(None, N, bs), TB.frontier_blocks(None, N, bs))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gograph_order_identical(seed):
    rg = RG.scrambled(RG.powerlaw_cluster(400, 5, p=0.5, seed=seed), seed=seed + 10)
    tg = TG.scrambled(TG.powerlaw_cluster(400, 5, p=0.5, seed=seed), seed=seed + 10)
    r = r_gograph_order(rg, RGoGraphConfig(seed=seed))
    t = gograph_order(tg, GoGraphConfig(seed=seed))
    _same(r, t)
    members = np.arange(0, 400, 7)
    _same(r_regional_rerank(rg, r, members), regional_rerank(tg, t, members))
    grown_r = RG.Graph(410, np.concatenate([rg.src, [400, 405]]), np.concatenate([rg.dst, [3, 401]]))
    grown_t = TG.Graph(410, np.concatenate([tg.src, [400, 405]]), np.concatenate([tg.dst, [3, 401]]))
    _same(r_extend_rank(grown_r, r), extend_rank(grown_t, t))


def test_metric_m_identical():
    rg, tg = _graphs()
    rank = r_gograph_order(rg)
    m = r_metric_m(rg, rank)
    assert metric_m(tg, rank) == m
    assert positive_edge_fraction(tg, rank) == r_pef(rg, rank)
    got = metric_m_torch(torch.from_numpy(tg.src), torch.from_numpy(tg.dst),
                         torch.from_numpy(np.asarray(rank)))
    assert got.dtype == torch.int64 and int(got) == m


@pytest.mark.parametrize("name", ["ppr", "ms_sssp", "php"])
def test_algo_from_arrays_round_trip(name):
    rg, _ = _graphs()
    r = RA.get_algorithm(name, rg, **CONSTRUCTORS[name])
    fields = algo_fields(r)
    t = algo_from_arrays(fields)
    back = algo_fields(t)
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            _same(v, back[k])
        elif k != "params":
            assert v == back[k], k
    assert t.exact_fn is None
    assert t.c_pad_fill == r.c_pad_fill and t.d == r.d


def test_algo_from_arrays_rejects_wrong_identity():
    rg, _ = _graphs()
    fields = algo_fields(RA.make_sssp(rg, 0))
    fields["semiring"]["identity"] = 0.0
    with pytest.raises(ValueError, match="identity"):
        algo_from_arrays(fields)


@pytest.mark.parametrize("name", ["ppr", "ms_sssp", "sswp"])
def test_operands_from_arrays_match_port_pack(name):
    rg, tg = _graphs()
    r = RA.get_algorithm(name, rg, **CONSTRUCTORS[name])
    t = TA.get_algorithm(name, tg, **CONSTRUCTORS[name])
    ref = r_pack_algorithm(r, 64)
    host = {k: np.asarray(v) for k, v in ref.items()
            if k not in ("semiring", "combine", "bsr_stats", "npad", "x0_host")}
    ops = operands_from_arrays(host, device="cpu")
    mine = pack_algorithm(t, 64, device="cpu")
    for k in host:
        assert ops[k].dtype == mine[k].dtype, k
        _same(ops[k].numpy(), mine[k].numpy())
    assert mine["semiring"] == ref["semiring"] and mine["combine"] == ref["combine"]
    assert mine["bsr_stats"] == ref["bsr_stats"]
