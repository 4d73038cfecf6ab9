import numpy as np
import pytest

from gpubench import graphs
from gpubench.harness import load_module
from gpubench.harness import HERE, load_json

CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))


def _check_simple(g):
    assert g.src.min() >= 0 and g.src.max() < g.n
    assert g.dst.min() >= 0 and g.dst.max() < g.n
    assert not np.any(g.src == g.dst)
    assert len(np.unique(g.src * g.n + g.dst)) == g.m
    assert g.w.dtype == np.float32 and len(g.w) == g.m


@pytest.mark.parametrize("name", CONFIGS)
def test_published_counts(name):
    cfg = load_json(HERE / "configs" / f"{name}.json")
    g = graphs.generate(cfg["graph"])
    pub = cfg["published"]
    assert g.n == pub["vertices"]
    assert g.m == pub.get("edges", pub.get("arcs"))
    _check_simple(g)


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_graph(name):
    spec = dict(load_json(HERE / "configs" / f"{name}.json")["graph"])
    spec.update(vertices=3000, **({"edges": 18000} if "edges" in spec else {"arcs": 8000}))
    a, b, c = (graphs.generate(dict(spec, seed=s)) for s in (7, 7, 8))
    assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
    assert np.array_equal(a.w, b.w)
    assert not np.array_equal(a.src, c.src)


def _undirected_clustering(n, src, dst):
    """Average local clustering and triangle count of the undirected graph,
    vertices of degree under 2 counting 0 (as SNAP counts them)."""
    import scipy.sparse as sp

    a = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n)).tocsr()
    u = ((a + a.T) > 0).astype(np.float64).tocsr()
    deg = np.asarray(u.sum(1)).ravel()
    tri = np.zeros(n)
    for lo in range(0, n, 4000):
        b = u[lo:lo + 4000]
        tri[lo:lo + 4000] = np.asarray((b @ u).multiply(b).sum(1)).ravel() / 2
    pairs = deg * (deg - 1) / 2
    local = np.where(pairs > 0, tri / np.maximum(pairs, 1), 0.0)
    return float(local.mean()), float(tri.sum() / 3)


def _largest_components(n, src, dst):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    a = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n)).tocsr()
    sizes = [np.bincount(connected_components(a, directed=True, connection=c)[1]).max()
             for c in ("strong", "weak")]
    return int(sizes[0]), int(sizes[1])


def test_trust_graph_has_the_published_structure():
    """soc-epinions1's graph holds SNAP's published statistics where the
    work depends on them: local clustering (the communities that the order
    and the dense tiles feed on), the share in the largest strongly
    connected component (who PPR mass can reach and return from), and one
    weak component."""
    cfg = load_json(HERE / "configs" / "soc-epinions1.json")
    pub = cfg["published_statistics"]
    g = graphs.generate(cfg["graph"])
    clustering, triangles = _undirected_clustering(g.n, g.src, g.dst)
    scc, wcc = _largest_components(g.n, g.src, g.dst)
    assert clustering == pytest.approx(pub["average_clustering"], rel=0.1)
    assert triangles == pytest.approx(pub["triangles"], rel=0.2)
    assert scc / g.n == pytest.approx(pub["largest_scc"] / g.n, abs=0.03)
    assert wcc >= pub["largest_wcc"]


def test_trust_growth_without_closure_has_fewer_triangles():
    """Closure is what makes the triangles: the same growth with
    ``closure`` 0 has half the clustering or less."""
    spec = dict(load_json(HERE / "configs" / "soc-epinions1.json")["graph"],
                vertices=20000, edges=134000)
    with_c, _ = _undirected_clustering(20000, *_edges(graphs.generate(spec)))
    without, _ = _undirected_clustering(20000, *_edges(graphs.generate(dict(spec, closure=0.0))))
    assert without < with_c / 2


def _edges(g):
    return g.src, g.dst


def test_road_is_connected_and_symmetric():
    spec = {"generator": "road_lattice", "vertices": 1000, "cols": 31,
            "arcs": 2 * 1500, "weight_lo": 1, "weight_hi": 1000, "seed": 3}
    g = graphs.generate(spec)
    _check_simple(g)
    fwd = dict(zip(zip(g.src.tolist(), g.dst.tolist()), g.w.tolist()))
    assert all(fwd[(b, a)] == w for (a, b), w in fwd.items())
    assert g.w.min() >= 1 and g.w.max() <= 1000 and np.all(g.w == np.round(g.w))
    seen = np.zeros(g.n, bool)
    seen[0] = True
    frontier = [0]
    adj = [[] for _ in range(g.n)]
    for a, b in zip(g.src.tolist(), g.dst.tolist()):
        adj[a].append(b)
    while frontier:
        nxt = [b for a in frontier for b in adj[a] if not seen[b]]
        seen[nxt] = True
        frontier = list(set(nxt))
    assert seen.all()


def test_lattice_counts():
    a, b = load_module("generators", "road_lattice")._lattice(10, 4)  # rows of 4: 4, 4, 2
    assert len(a) == 3 + 3 + 1 + 4 + 2
