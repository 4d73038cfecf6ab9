"""The push-scatter kernel's plain version against the reference's oracle
(``ref_push_round``) and the reference kernel (``push_scatter_pallas`` in
interpret mode), on the same seeded numpy operands.

Against the oracle every output is compared exactly (``assert_array_equal``)
for all four semirings: the plain version rounds each product before the
add, in the oracle's slot and edge order. Against the Pallas kernel the
lattice semirings are compared exactly; plus_times is held to
``rtol=1e-6, atol=1e-7`` (values are O(1)), because XLA may contract the
multiply-add of the interpreted kernel into one fused operation.

The graph carries a self-loop, a hub of degree > 128 (the reference's
multi-chunk path) and a duplicated edge; slot lists carry ``-1`` pads.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.engine.algorithms import BIG  # noqa: E402
from repro.graphs import generators as RG  # noqa: E402
from repro.graphs.graph import Graph as RGraph  # noqa: E402
from repro.kernels.push_scatter import push_scatter_pallas  # noqa: E402
from repro.kernels.ref import ref_push_round  # noqa: E402

K = importlib.import_module("repro_torch.kernels.push_scatter")

N = 311
ECAP = 128
PAIRS = ["plus_times", "min_plus", "max_min", "max_times"]
HUB, LOOP, DUP = 0, 5, 7


def _graph():
    g = RG.scrambled(RG.powerlaw_cluster(N, 3, p=0.5, seed=21), seed=22)
    rng = np.random.default_rng(23)
    hub_dst = rng.choice(np.arange(1, N), size=150, replace=False)
    src = np.concatenate([g.src, np.full(150, HUB), [LOOP, DUP, DUP]]).astype(np.int32)
    dst = np.concatenate([g.dst, hub_dst, [LOOP, 8, 8]]).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=len(src)).astype(np.float32)
    return RGraph(N, src, dst, w)


def _state(pair: str, d: int, seed: int):
    rng = np.random.default_rng(seed)
    if pair == "plus_times":
        p = rng.uniform(0.0, 1.0, (N, d))
        r = rng.uniform(-0.1, 0.2, (N, d))
    elif pair == "min_plus":
        p = rng.uniform(0.0, 5.0, (N, d))
        p[rng.random((N, d)) < 0.3] = BIG
        r = rng.uniform(0.0, 5.0, (N, d))
        r[rng.random((N, d)) < 0.3] = BIG
    else:
        p = rng.uniform(0.0, 1.0, (N, d))
        p[rng.random((N, d)) < 0.3] = -BIG
        r = rng.uniform(0.0, 1.0, (N, d))
        r[rng.random((N, d)) < 0.3] = -BIG
    return p.astype(np.float32), r.astype(np.float32)


def _slots(buckets: int, seed: int):
    """A slot list over ~120 vertices (hub, self-loop and duplicate first
    among them), with -1 pads scattered through and at the end."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(N), size=120, replace=False)
    ids = np.concatenate([[HUB, LOOP, DUP], ids[~np.isin(ids, [HUB, LOOP, DUP])]])
    rng.shuffle(ids)
    vid = ids.astype(np.int64)
    for pos in rng.choice(len(vid), size=9, replace=False):
        vid = np.insert(vid, pos, -1)
    cap = -(-len(vid) // buckets)
    out = np.full(buckets * cap, -1, np.int32)
    out[: len(vid)] = vid
    return out, cap


def _operands(pair: str, d: int, buckets: int):
    g = _graph()
    indptr, nbrs, eid = g.csr()
    vid, cap = _slots(buckets, seed=31 + buckets)
    safe = np.maximum(vid, 0)
    seg_s = np.where(vid >= 0, indptr[safe], 0).astype(np.int32)
    seg_l = np.where(vid >= 0, indptr[safe + 1] - indptr[safe], 0).astype(np.int32)
    p, r = _state(pair, d, seed=41 + d)
    return {
        "indptr": indptr, "vid": vid, "seg_start": seg_s, "seg_len": seg_l,
        "nbrs": nbrs.astype(np.int32), "ew": g.w[eid].astype(np.float32),
        "p": p, "r": r, "cap": cap,
    }


def _expected_counts(o, buckets: int):
    pushed = np.zeros((buckets, 1), np.float32)
    edges = np.zeros((buckets, 1), np.float32)
    for k, u in enumerate(o["vid"]):
        if u >= 0:
            pushed[k // o["cap"], 0] += 1
            edges[k // o["cap"], 0] += o["seg_len"][k]
    return pushed, edges


def _run_port(fn, o, pair: str, buckets: int):
    t = {k: torch.as_tensor(o[k]) for k in ("vid", "seg_start", "seg_len", "nbrs", "ew")}
    p, r = torch.tensor(o["p"]), torch.tensor(o["r"])
    return fn(t["vid"], t["seg_start"], t["seg_len"], t["nbrs"], t["ew"], p, r,
              semiring=pair, buckets=buckets, cap=o["cap"])


@pytest.mark.parametrize("buckets", [1, 4])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("pair", PAIRS)
def test_plain_matches_oracle_and_pallas(pair, d, buckets):
    o = _operands(pair, d, buckets)
    assert o["seg_len"][o["vid"] == HUB][0] > ECAP  # the multi-chunk path runs
    p, r, pushed, edges = (a.numpy() for a in
                           _run_port(K.push_scatter_plain, o, pair, buckets))
    wp, wr, wpushed, wedges = ref_push_round(
        o["vid"], o["indptr"], o["nbrs"], o["ew"], o["p"], o["r"], semiring=pair)
    np.testing.assert_array_equal(p, wp)
    np.testing.assert_array_equal(r, wr)
    want_pushed, want_edges = _expected_counts(o, buckets)
    np.testing.assert_array_equal(pushed, want_pushed)
    np.testing.assert_array_equal(edges, want_edges)
    assert pushed.sum() == wpushed and edges.sum() == wedges

    pad = np.zeros(ECAP, np.int32)
    kp, kr, kpushed, kedges = (np.asarray(a) for a in push_scatter_pallas(
        jnp.asarray(o["vid"]), jnp.asarray(o["seg_start"]), jnp.asarray(o["seg_len"]),
        jnp.asarray(np.concatenate([o["nbrs"], pad])),
        jnp.asarray(np.concatenate([o["ew"], pad.astype(np.float32)])),
        jnp.asarray(o["p"]), jnp.asarray(o["r"]),
        semiring=pair, buckets=buckets, cap=o["cap"], ecap=ECAP, interpret=True))
    np.testing.assert_array_equal(pushed, kpushed)
    np.testing.assert_array_equal(edges, kedges)
    if pair == "plus_times":
        np.testing.assert_allclose(p, kp, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r, kr, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(p, kp)
        np.testing.assert_array_equal(r, kr)


def test_self_loop_lands_on_the_emptied_row():
    """Pushing only the self-loop vertex: its residual row is emptied before
    its own message lands on it."""
    g = _graph()
    indptr, nbrs, eid = g.csr()
    p = np.zeros((N, 1), np.float32)
    r = np.zeros((N, 1), np.float32)
    r[LOOP] = 1.0
    vid = np.array([LOOP], np.int32)
    lo, hi = indptr[LOOP], indptr[LOOP + 1]
    seg_s, seg_l = np.array([lo], np.int32), np.array([hi - lo], np.int32)
    ew = g.w[eid].astype(np.float32)
    pp, rr, _, _ = K.push_scatter_plain(
        torch.as_tensor(vid), torch.as_tensor(seg_s), torch.as_tensor(seg_l),
        torch.as_tensor(nbrs.astype(np.int32)), torch.as_tensor(ew),
        torch.tensor(p), torch.tensor(r), semiring="plus_times", buckets=1, cap=1)
    w_loop = ew[lo:hi][nbrs[lo:hi] == LOOP]
    assert pp[LOOP, 0] == 1.0
    assert rr[LOOP, 0] == np.float32(w_loop.sum())


@pytest.mark.parametrize("pair", PAIRS)
def test_wrapper_on_cpu_runs_plain(pair):
    o = _operands(pair, 3, 4)
    before = K.launches
    got = _run_port(K.push_scatter, o, pair, 4)
    assert K.launches == before  # CPU tensors never launch the kernel
    want = _run_port(K.push_scatter_plain, o, pair, 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_unsupported_semiring_and_shapes_rejected():
    o = _operands("plus_times", 1, 1)
    for fn in (K.push_scatter, K.push_scatter_plain):
        with pytest.raises(NotImplementedError, match="unsupported semiring 'min_times'"):
            _run_port(fn, o, "min_times", 1)
    with pytest.raises(ValueError, match="vid has shape"):
        _run_port(K.push_scatter, o, "plus_times", 2)
