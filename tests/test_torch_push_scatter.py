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


# ---------------------------------------------------------------------------
# the kernel's schedule: conflict-free waves
# ---------------------------------------------------------------------------

from hypothesis import given, settings, strategies as st  # noqa: E402


def _closed(o, k):
    lo, n = o["seg_start"][k], o["seg_len"][k]
    return {int(o["vid"][k])} | {int(v) for v in o["nbrs"][lo:lo + n]}


def _check_waves(o, waves, wmax):
    """In order, disjoint within a wave, and maximal: a wave ends at the
    cap or where the next live slot meets it."""
    vid = o["vid"]
    live = [int(k) for k in np.flatnonzero(vid >= 0)]
    assert [k for ws, we in waves for k in range(ws, we) if vid[k] >= 0] == live
    for i, (ws, we) in enumerate(waves):
        assert vid[ws] >= 0 and vid[we - 1] >= 0 and we - ws <= wmax
        seen: set = set()
        for k in range(ws, we):
            if vid[k] >= 0:
                c = _closed(o, k)
                assert not (c & seen), (ws, we, k)
                seen |= c
        if i + 1 < len(waves):
            nxt = waves[i + 1][0]
            assert nxt - ws >= wmax or _closed(o, nxt) & seen


@st.composite
def _rounds(draw):
    """A small graph with a hub, self-loops and parallel edges, and a slot
    list with -1 pads over one to three buckets."""
    n = draw(st.integers(4, 40))
    m = draw(st.integers(0, 3 * n))
    src = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
    dst = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
    hub = draw(st.integers(0, n - 1))
    src += [hub] * n + [hub, 1 % n, 1 % n]
    dst += list(range(n)) + [hub, 2 % n, 2 % n]
    ids = draw(st.permutations(range(n)))[:draw(st.integers(1, n))]
    vid = list(ids)
    for pos in draw(st.lists(st.integers(0, len(vid)), max_size=5)):
        vid.insert(pos, -1)
    buckets = draw(st.integers(1, 3))
    wmax = draw(st.sampled_from([2, 5, K.WMAX]))
    seed = draw(st.integers(0, 2**16))
    return n, np.array(src, np.int32), np.array(dst, np.int32), vid, buckets, wmax, seed


def _round_operands(n, src, dst, vid, buckets, seed, pair="plus_times", d=2):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, len(src)).astype(np.float32)
    indptr, nbrs, eid = RGraph(n, src, dst, w).csr()
    cap = -(-len(vid) // buckets)
    slots = np.full(buckets * cap, -1, np.int32)
    slots[: len(vid)] = vid
    safe = np.maximum(slots, 0)
    p = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    r = rng.uniform(-0.1, 0.2 if pair == "plus_times" else 1.0, (n, d)).astype(np.float32)
    return {"indptr": indptr, "vid": slots,
            "seg_start": np.where(slots >= 0, indptr[safe], 0).astype(np.int32),
            "seg_len": np.where(slots >= 0, indptr[safe + 1] - indptr[safe], 0).astype(np.int32),
            "nbrs": nbrs.astype(np.int32), "ew": w[eid], "p": p, "r": r, "cap": cap}


@settings(max_examples=60, deadline=None)
@given(_rounds())
def test_wave_cut_is_ordered_disjoint_and_maximal(case):
    n, src, dst, vid, buckets, wmax, seed = case
    o = _round_operands(n, src, dst, vid, buckets, seed)
    t = {k: torch.as_tensor(o[k]) for k in ("vid", "seg_start", "seg_len", "nbrs", "ew")}
    sched = K.push_schedule(t["vid"], t["seg_start"], t["seg_len"], t["nbrs"], t["ew"])
    _check_waves(o, K.wave_bounds_plain(o["vid"], sched["prev"], wmax), wmax)
    got = _run_port(K.push_scatter_waves, o, "plus_times", buckets)
    want = _run_port(K.push_scatter_plain, o, "plus_times", buckets)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("buckets", [1, 4])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("pair", PAIRS)
def test_scheduled_plain_matches_plain_and_pallas(pair, d, buckets):
    """The kernel's schedule executed wave by wave equals the sequential
    plain version bit for bit, and the reference kernel at the tolerance of
    test_plain_matches_oracle_and_pallas."""
    o = _operands(pair, d, buckets)
    got = _run_port(K.push_scatter_waves, o, pair, buckets)
    want = _run_port(K.push_scatter_plain, o, pair, buckets)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    t = {k: torch.as_tensor(o[k]) for k in ("vid", "seg_start", "seg_len", "nbrs", "ew")}
    waves = K.wave_bounds_plain(o["vid"], K.push_schedule(
        t["vid"], t["seg_start"], t["seg_len"], t["nbrs"], t["ew"])["prev"])
    _check_waves(o, waves, K.WMAX)
    assert 1 < len(waves) < int((o["vid"] >= 0).sum())  # slots do run together
    pad = np.zeros(ECAP, np.int32)
    kp, kr, _, _ = (np.asarray(a) for a in push_scatter_pallas(
        jnp.asarray(o["vid"]), jnp.asarray(o["seg_start"]), jnp.asarray(o["seg_len"]),
        jnp.asarray(np.concatenate([o["nbrs"], pad])),
        jnp.asarray(np.concatenate([o["ew"], pad.astype(np.float32)])),
        jnp.asarray(o["p"]), jnp.asarray(o["r"]),
        semiring=pair, buckets=buckets, cap=o["cap"], ecap=ECAP, interpret=True))
    p, r = got[0].numpy(), got[1].numpy()
    if pair == "plus_times":
        np.testing.assert_allclose(p, kp, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r, kr, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(p, kp)
        np.testing.assert_array_equal(r, kr)


def test_schedule_flags_parallel_edges_and_overlapping_segments():
    """A segment that repeats a destination is walked in order; segments
    that hold more edges than the CSR (a vertex pushed twice) make every slot
    its own wave, walked in order; both stay equal to the plain version."""
    o = _operands("plus_times", 3, 1)
    t = {k: torch.as_tensor(o[k]) for k in ("vid", "seg_start", "seg_len", "nbrs", "ew")}
    sched = K.push_schedule(t["vid"], t["seg_start"], t["seg_len"], t["nbrs"], t["ew"])
    walked = {int(-s - 2) for s in sched["sv"].tolist() if s < -1}
    repeats = {int(u) for u, lo, n in zip(o["vid"], o["seg_start"], o["seg_len"])
               if u >= 0 and len(np.unique(o["nbrs"][lo:lo + n])) < n}
    assert DUP in walked and walked == repeats
    big = dict(o)
    k = int(np.flatnonzero(o["vid"] == HUB)[0])
    for key in ("vid", "seg_start", "seg_len"):
        big[key] = np.concatenate([o[key], np.repeat(o[key][k:k + 1], 4)])
    big["cap"] = len(big["vid"])
    tb = {k: torch.as_tensor(big[k]) for k in ("vid", "seg_start", "seg_len", "nbrs", "ew")}
    sb = K.push_schedule(tb["vid"], tb["seg_start"], tb["seg_len"], tb["nbrs"], tb["ew"])
    assert int(sb["eoff"].max()) == 0 and bool((sb["sv"] != -1).eq(sb["sv"] < -1).all())
    assert len(K.wave_bounds_plain(big["vid"], sb["prev"])) == int((big["vid"] >= 0).sum())
    got = _run_port(K.push_scatter_waves, big, "plus_times", 1)
    want = _run_port(K.push_scatter_plain, big, "plus_times", 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_push_waves_on_cpu_is_the_plain_cut():
    o = _operands("min_plus", 1, 4)
    t = {k: torch.as_tensor(o[k]) for k in ("vid", "seg_start", "seg_len", "nbrs", "ew")}
    ws, we, nw = K.push_waves(t["vid"], t["seg_start"], t["seg_len"], t["nbrs"], t["ew"])
    want = K.wave_bounds_plain(o["vid"], K.push_schedule(
        t["vid"], t["seg_start"], t["seg_len"], t["nbrs"], t["ew"])["prev"])
    assert int(nw[0]) == len(want)
    assert list(zip(ws.tolist(), we.tolist())) == want


def test_small_rounds_run_slot_by_slot():
    """Rounds of at most SEQUENTIAL_SLOTS slots skip the schedule: every
    live slot is a wave of its own and walks its edges in order, which is
    the plain version's order; larger rounds take the wave schedule."""
    o = _operands("plus_times", 1, 4)
    t = {k: torch.as_tensor(o[k]) for k in ("vid", "seg_start", "seg_len", "nbrs", "ew")}
    small = {k: v[:12] for k, v in t.items() if k in ("vid", "seg_start", "seg_len")}
    small.update(nbrs=t["nbrs"], ew=t["ew"])
    sched = K.sequential_schedule(**small)
    live = [k for k in range(12) if o["vid"][k] >= 0]
    assert K.wave_bounds_plain(small["vid"], sched["prev"]) == [(k, k + 1) for k in live]
    assert sched["sv"].tolist() == [-(int(v) + 2) if v >= 0 else -1 for v in o["vid"][:12]]
    assert int(sched["eoff"].abs().sum()) == 0 and len(sched["e_v"]) == 0
    assert K._schedule(**small)["sv"].tolist() == sched["sv"].tolist()
    assert len(o["vid"]) > K.SEQUENTIAL_SLOTS
    full = K._schedule(t["vid"], t["seg_start"], t["seg_len"], t["nbrs"], t["ew"])
    assert torch.equal(full["prev"], K.push_schedule(
        t["vid"], t["seg_start"], t["seg_len"], t["nbrs"], t["ew"])["prev"])
