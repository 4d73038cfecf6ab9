"""The port's graph I/O, dataset registry and dense BSR packing against the
reference's, on the same files and seeded graphs."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine.algorithms import BIG  # noqa: E402
from repro.graphs import blocked as RB  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.graphs import io as RIO  # noqa: E402

from repro_torch.graphs import blocked as TB  # noqa: E402
from repro_torch.graphs import generators as TG  # noqa: E402
from repro_torch.graphs import io as TIO  # noqa: E402

# a SNAP-style file: comments, blank lines, sparse ids, a self-loop, a
# repeated edge, and weights on all but one line
SNAP = """# Directed graph (each unordered pair of nodes is saved once)
# FromNodeId\tToNodeId\tWeight
1000\t7\t0.5
7\t42\t1.25

42\t1000\t2.0
99999\t7
7\t7\t3.0
1000\t7\t0.75
"""


def _same_graph(r, t):
    assert r.n == t.n
    np.testing.assert_array_equal(r.src, t.src)
    np.testing.assert_array_equal(r.dst, t.dst)
    assert (r.w is None) == (t.w is None)
    if r.w is not None:
        np.testing.assert_array_equal(r.w, t.w)
        assert r.w.dtype == t.w.dtype


@pytest.fixture
def snap_file(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text(SNAP)
    return str(p)


@pytest.mark.parametrize("weighted", [False, True])
def test_load_edge_list_matches_reference(snap_file, weighted):
    r = RIO.load_edge_list(snap_file, weighted=weighted)
    t = TIO.load_edge_list(snap_file, weighted=weighted)
    _same_graph(r, t)
    # ids compacted by first appearance: 1000 -> 0, 7 -> 1, 42 -> 2, 99999 -> 3
    assert t.n == 4
    np.testing.assert_array_equal(t.src, [0, 1, 2, 3, 1, 0])
    np.testing.assert_array_equal(t.dst, [1, 2, 0, 1, 1, 1])
    if weighted:
        np.testing.assert_array_equal(t.w, np.float32([0.5, 1.25, 2.0, 1.0, 3.0, 0.75]))


@pytest.mark.parametrize("weighted", [False, True])
def test_npz_round_trip_and_cross_read(tmp_path, weighted):
    g = TG.powerlaw_cluster(200, 3, seed=4)
    if weighted:
        g = TG.with_random_weights(g, seed=5)
    p = str(tmp_path / "g.npz")
    TIO.save_npz(g, p)
    _same_graph(g, TIO.load_npz(p))
    # the two packages read each other's files
    _same_graph(RIO.load_npz(p), TIO.load_npz(p))
    q = str(tmp_path / "r.npz")
    RIO.save_npz(RIO.load_npz(p), q)
    _same_graph(TIO.load_npz(q), g)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_load_cached_memoizes_and_refreshes(snap_file):
    cache = snap_file + ".npz"
    first = TIO.load_cached(snap_file, weighted=True)
    assert os.path.exists(cache)
    _same_graph(first, TIO.load_cached(snap_file, weighted=True))
    _same_graph(RIO.load_cached(snap_file, weighted=True), first)
    # an edge list newer than its cache is parsed again
    with open(snap_file, "a") as f:
        f.write("5\t6\t1.0\n")
    mtime = os.path.getmtime(cache) + 10
    os.utime(snap_file, (mtime, mtime))
    again = TIO.load_cached(snap_file, weighted=True)
    assert again.n == first.n + 2 and again.m == first.m + 1


def test_datasets_registry_matches_reference():
    assert sorted(TG.DATASETS) == sorted(RG.DATASETS) == sorted(
        ["ic-like", "sk-like", "gl-like", "wk-like", "cp-like", "lj-like"])
    with pytest.raises(KeyError):
        TG.load_dataset("no-such-graph")


@pytest.mark.parametrize("name", ["ic-like", "gl-like"])
def test_load_dataset_matches_reference(name):
    _same_graph(RG.load_dataset(name), TG.load_dataset(name))


def _graphs():
    rg = RG.with_random_weights(
        RG.scrambled(RG.powerlaw_cluster(311, 4, p=0.5, seed=1), seed=11), lo=0.1, hi=1.0, seed=3)
    tg = TG.with_random_weights(
        TG.scrambled(TG.powerlaw_cluster(311, 4, p=0.5, seed=1), seed=11), lo=0.1, hi=1.0, seed=3)
    return rg, tg


@pytest.mark.parametrize("bs,fill", [(16, 0.0), (64, 0.0), (16, float(BIG)), (64, float(-BIG))])
def test_pack_bsr_matches_reference(bs, fill):
    rg, tg = _graphs()
    r = RB.pack_bsr(rg, bs, fill=fill)
    t = TB.pack_bsr(tg, bs, fill=fill, device="cpu")
    np.testing.assert_array_equal(r.cols, t.cols)
    np.testing.assert_array_equal(r.colmask, t.colmask)
    assert isinstance(t.tiles, torch.Tensor) and t.tiles.device.type == "cpu"
    np.testing.assert_array_equal(r.tiles, t.tiles.numpy())
    assert (t.nb, t.k_max, t.fill) == (r.nb, r.k_max, r.fill)
    assert t.stats() == r.stats()
    # the dense layout's real tiles are the flat layout's, in the same order
    flat = TB.pack_bsr_flat(tg, bs, fill=fill, device="cpu")
    np.testing.assert_array_equal(t.tiles[torch.from_numpy(t.colmask)].numpy(),
                                  flat.tiles.numpy())


def test_packers_default_to_the_card():
    """pack_bsr and pack_bsr_flat place their tiles on "cuda" unless asked,
    like every other entry point of the port."""
    import inspect

    for pack in (TB.pack_bsr, TB.pack_bsr_flat):
        assert inspect.signature(pack).parameters["device"].default == "cuda"
