"""The port's competitor orders (paper §V-A) against the reference's, on the
CPU: every reorderer of ``all_reorderers`` gives the same rank array, byte
for byte, per seed and graph, and each rank is a permutation."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import baselines as RB  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402

import repro_torch.core as TC  # noqa: E402
from repro_torch.core import baselines as TB  # noqa: E402
from repro_torch.graphs.graph import Graph as TGraph  # noqa: E402

_G: dict = {}
GRAPHS = ["ic", "er", "ba", "sparse"]


def _graphs(kind: str):
    """The same graph in both packages' Graph types."""
    if kind not in _G:
        g = {
            "ic": lambda: RG.scrambled(RG.powerlaw_cluster(300, 4, p=0.5, seed=1), seed=11),
            "er": lambda: RG.erdos_renyi(250, 3.0, seed=4),
            "ba": lambda: RG.scrambled(RG.barabasi_albert(280, 2, seed=3), seed=5),
            # isolated vertices and ties in degree everywhere
            "sparse": lambda: RG.erdos_renyi(200, 0.6, seed=8),
        }[kind]()
        _G[kind] = (g, TGraph(g.n, g.src.copy(), g.dst.copy(),
                              None if g.w is None else g.w.copy()))
    return _G[kind]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("name", list(RB.all_reorderers()))
def test_reorderer_rank_identical(name, kind, seed):
    rg, tg = _graphs(kind)
    r = RB.all_reorderers(seed=seed)[name](rg)
    t = TB.all_reorderers(seed=seed)[name](tg)
    assert t.dtype == r.dtype and t.tobytes() == r.tobytes()
    assert np.array_equal(np.sort(t), np.arange(tg.n))


def test_registry_names_and_order():
    assert list(TB.all_reorderers()) == list(RB.all_reorderers())
    assert TC.all_reorderers is TB.all_reorderers


@pytest.mark.parametrize("window", [1, 2, 5, 9])
@pytest.mark.parametrize("kind", GRAPHS)
def test_gorder_window_identical(kind, window):
    rg, tg = _graphs(kind)
    assert TB.gorder_like(tg, window=window).tobytes() == RB.gorder_like(rg, window=window).tobytes()


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("kind", GRAPHS)
def test_seeded_orders_identical(kind, seed):
    rg, tg = _graphs(kind)
    assert TB.random_order(tg, seed=seed).tobytes() == RB.random_order(rg, seed=seed).tobytes()
    assert TB.rabbit_like(tg, seed=seed).tobytes() == RB.rabbit_like(rg, seed=seed).tobytes()


def test_edgeless_graph():
    from repro.graphs.graph import Graph as RGraph

    e = np.zeros(0, np.int32)
    rg, tg = RGraph(5, e, e), TGraph(5, e.copy(), e.copy())
    for name in ("Default", "Random", "DegSort", "HubSort", "HubCluster", "Gorder"):
        r = RB.all_reorderers()[name](rg)
        t = TB.all_reorderers()[name](tg)
        assert t.tobytes() == r.tobytes()
