"""A graph that changes under the window: the benchmark's own versions of
the graph (`graphs.apply_delta`, `traffic.delta_batches`), a whole run of
the serve cell with ``deltas`` added to its mix and nothing else, and the
faults of a changing graph that the check has to catch."""
import itertools

import numpy as np
import pytest

from gpubench import graphs, harness
from gpubench.traffic import delta_batches

SPEC = {"insert": 40, "delete": 4}
# every 0.3 s in a 2-s window: six batches, 264 of the 18,000 links of the
# shrunk trust graph changed by the last. Sound runs read 1.8e-6 to 2.5e-6
# against the limit 2e-5; a graph left unchanged or every answer held to
# version 0 reads 1.3e-3 to 0.13 (five seeds each, on the CPU)
DELTAS = dict(SPEC, every_s=0.3)


def _graph(n=60, m=300, seed=0):
    rng = np.random.default_rng(seed)
    key = rng.choice(n * n, size=4 * m, replace=False)
    key = key[key // n != key % n][:m]
    return graphs.EdgeList(n, key // n, key % n, rng.random(m).astype(np.float32))


def _batch(add=(), dele=()):
    add, dele = np.asarray(add, np.int64).reshape(-1, 2), np.asarray(dele, np.int64).reshape(-1, 2)
    return {"add_src": add[:, 0], "add_dst": add[:, 1], "add_w": np.ones(len(add), np.float32),
            "del_src": dele[:, 0], "del_dst": dele[:, 1]}


def _absent(g):
    have = set(zip(g.src.tolist(), g.dst.tolist()))
    return next((a, b) for a in range(g.n) for b in range(g.n) if a != b and (a, b) not in have)


def test_apply_delta_removes_then_appends():
    g = _graph()
    new, old = _absent(g), (int(g.src[3]), int(g.dst[3]))
    h = graphs.apply_delta(g, _batch(add=[new], dele=[old]))
    pairs = set(zip(h.src.tolist(), h.dst.tolist()))
    assert h.m == g.m and new in pairs and old not in pairs
    assert h.w[-1] == 1.0 and (h.src[-1], h.dst[-1]) == new


@pytest.mark.parametrize("fault", ["present", "absent", "self_loop", "out_of_range",
                                   "inserted_twice", "deleted_twice"])
def test_apply_delta_refuses_an_ambiguous_batch(fault):
    g = _graph()
    edge, free = (int(g.src[0]), int(g.dst[0])), _absent(g)
    batch = {"present": _batch(add=[edge]), "absent": _batch(dele=[free]),
             "self_loop": _batch(add=[(5, 5)]), "out_of_range": _batch(add=[(0, g.n)]),
             "inserted_twice": _batch(add=[free, free]),
             "deleted_twice": _batch(dele=[edge, edge])}[fault]
    with pytest.raises(ValueError):
        graphs.apply_delta(g, batch)


def test_delta_batches_same_seed_same_batches():
    g = _graph(n=400, m=2400)
    a, b, c = (list(itertools.islice(delta_batches(g, SPEC, s), 8))
               for s in (2**32 + 1, 2**32 + 1, 2**32 + 2))
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not all(np.array_equal(x["add_src"], y["add_src"]) for x, y in zip(a, c))
    # each batch drawn against the graph the ones before it left: applying
    # them in order raises on no pair, and each has its sizes
    h = g
    for batch in a:
        assert len(batch["add_src"]) == 40 and len(batch["del_src"]) == 4
        h = graphs.apply_delta(h, batch)
    assert h.m == g.m + 8 * 36


def test_delta_batches_favour_the_trusted():
    """Destinations by in-degree + 1: the top tenth of vertices by in-degree
    take over three times their share of the vertices, and at most their
    share of in-degree + 1 (a pair already present is drawn again, and the
    trusted are the likeliest to be linked already); every weight is 1."""
    rng = np.random.default_rng(3)
    n = 2000
    dst = np.minimum(rng.zipf(1.8, size=20000) - 1, n - 1)
    src = rng.integers(n, size=20000)
    key = np.unique((src * n + dst)[src != dst])
    g = graphs.EdgeList(n, key // n, key % n, np.ones(len(key), np.float32))
    top = np.argsort(np.bincount(g.dst, minlength=n))[-n // 10:]
    batch = next(delta_batches(g, dict(SPEC, insert=400), 1))
    share = np.isin(batch["add_dst"], top).mean()
    indeg = np.bincount(g.dst, minlength=n) + 1.0
    expect = indeg[top].sum() / indeg.sum()
    assert 3 * len(top) / n < share < expect + 0.05, (share, expect)
    assert np.all(batch["add_w"] == 1.0)


def _with_deltas(small_cell):
    cell = small_cell("epinions-ppr-serve")
    cell.mix["deltas"] = dict(DELTAS)
    cell.config["deployment"]["push_threshold"] = 0.05
    return cell


def _run(cell, monkeypatch):
    """A whole run; returns the result, the driver's record and the server."""
    from repro_torch.serving.server import GraphServer

    recs, servers = [], []
    real_load, real_init = harness.load_module, GraphServer.__init__

    def load(kind, name, base=harness.HERE):
        mod = real_load(kind, name, base)
        if kind == "drivers":
            run = mod.run
            mod.run = lambda ctx: recs.append(run(ctx)) or recs[-1]
        return mod

    def init(self, *a, **k):
        real_init(self, *a, **k)
        servers.append(self)

    monkeypatch.setattr(harness, "load_module", load)
    monkeypatch.setattr(GraphServer, "__init__", init)
    out = harness.run(cell, 2**32 + 29, 2.0, False, t0=0.0, device="cpu")
    return out, recs[0], servers[0]


def test_sound_run_with_deltas_is_correct(small_cell, monkeypatch):
    out, rec, srv = _run(_with_deltas(small_cell), monkeypatch)
    assert out["correct"], out["compared"]
    versions = {a[2] for a in rec["answers"]}
    assert len(versions) >= 2, versions
    assert len(rec["deltas"]) == srv.graph_version == len(rec["delta_s"]) >= 4
    assert srv.push_threshold == 0.05
    assert all(s > 0 for s in rec["delta_s"])


def test_without_deltas_every_answer_is_version_0(small_cell, monkeypatch):
    out, rec, srv = _run(small_cell("epinions-ppr-serve"), monkeypatch)
    assert out["correct"]
    assert "deltas" not in rec and "delta_s" not in rec and srv.graph_version == 0
    assert [a[2] for a in rec["answers"]] == [0] * len(rec["answers"])


@pytest.mark.parametrize("fault", ["graph_kept", "labelled_0", "version_never_applied"])
def test_delta_fault_makes_the_run_incorrect(small_cell, monkeypatch, fault):
    from repro_torch.serving.server import GraphServer

    if fault == "graph_kept":
        def apply_delta(self, delta, tenant="default"):
            self.tenants[tenant].graph_version += 1

        monkeypatch.setattr(GraphServer, "apply_delta", apply_delta)
    else:
        real = GraphServer._resolve

        def resolve(self, fam, j, t, converged):
            real(self, fam, j, t, converged)
            t.graph_version = 0 if fault == "labelled_0" else t.graph_version + 1000

        monkeypatch.setattr(GraphServer, "_resolve", resolve)
    out, rec, _ = _run(_with_deltas(small_cell), monkeypatch)
    assert len(rec["deltas"]) >= 4
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("check", ["ppr", "sssp"])
def test_two_tuples_check_as_one_call_on_the_graph(small_cell, check):
    """Answers without a version are checked by one call of the check on the
    generated graph, to the bit, as before versions existed."""
    name = {"ppr": "epinions-ppr-serve", "sssp": "nyroad-sssp-serve"}[check]
    cell = small_cell(name)
    g = graphs.generate(cell.config["graph"])
    mod = harness.load_module("checks", cell.mix["check"])
    sources = np.asarray([5, 17, 400, 999], np.int64)
    ref = mod._reference(g, cell.config, sources, "cpu") if check == "ppr" \
        else mod._reference(g, sources, "cpu")
    rng = np.random.default_rng(1)
    got = (ref * (1 + 1e-5 * rng.standard_normal(ref.shape))).astype(np.float32)
    answers = [(int(s), got[:, i]) for i, s in enumerate(sources)]
    direct = mod.numbers(g, cell.config, sources, got, device="cpu")
    for given in (answers, [a + (0,) for a in answers]):
        compared, versions = harness.compare(cell, g, given, [], "cpu")
        assert versions == [0]
        assert compared == {k: {"value": direct[k], "limit": float(lim)}
                            for k, lim in cell.limits.items()}
