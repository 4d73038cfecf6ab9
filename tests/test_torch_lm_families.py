"""The port's MoE, recurrent and encoder-decoder modules against the
reference's.

The same inputs and weights, drawn from a numpy seed, go through a function
of ``repro.models`` and its counterpart in ``repro_torch.models`` on the
CPU. Tolerance: f32 at atol 1e-5 / rtol 1e-4 (the layer tests'); the
routing (top-k choices, positions in the expert buffers, what is kept) and
the RG-LRU's associative scan bit for bit; the model-level functions at atol
2e-4 / rtol 2e-3 (the model tests'). The interop round trips carry the
encoder-decoder's and the recurrent families' trees across exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMo  # noqa: E402
from repro.models import recurrent as RR  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.interop import lm_caches_from_arrays, lm_params_from_arrays  # noqa: E402
from repro_torch.models import encdec as PE  # noqa: E402
from repro_torch.models import moe as PMo  # noqa: E402
from repro_torch.models import recurrent as PR  # noqa: E402
from tests.test_torch_lm_model import ref_weights  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _both(tree):
    """A nest of numpy arrays as (reference arrays, port tensors)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(a)), tree))


def _close(ref, got, **tol) -> None:
    r, g = _np(ref), _np(got)
    assert r.shape == g.shape
    np.testing.assert_allclose(g, r, **(tol or TOL))


def _close_tree(ref: dict, got: dict, **tol) -> None:
    assert sorted(ref) == sorted(got)
    for k in ref:
        _close(ref[k], got[k], **tol)


def _normal(rng, shape, fan_in):
    return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)


# ------------------------------------------------------------------- MoE

def _moe_params(cfg, rng, zero_router=False) -> dict:
    d, e, f = cfg.d_model, cfg.e_padded, cfg.d_expert
    p = {"wg": np.zeros((d, e), np.float32) if zero_router else _normal(rng, (d, e), d),
         "wi": _normal(rng, (e, d, f), d), "wg_up": _normal(rng, (e, d, f), d),
         "wo": _normal(rng, (e, f, d), f)}
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p["shared"] = {"wi": _normal(rng, (d, fs), d), "wg": _normal(rng, (d, fs), d),
                       "wo": _normal(rng, (fs, d), fs)}
        p["shared_gate"] = _normal(rng, (d, 1), d)
    return p


def _ref_moe_routing(cfg, params, x, monkeypatch):
    """The reference's apply_moe, run eagerly, with the two one-hot calls
    recorded: the first receives the top-k choices, the second the
    positions in the expert buffers."""
    seen = []
    one_hot = jax.nn.one_hot

    def recording(idx, n, **kw):
        seen.append((np.asarray(idx), n))
        return one_hot(idx, n, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", recording)
    y, aux = RMo.apply_moe(cfg, params, x)
    monkeypatch.setattr(jax.nn, "one_hot", one_hot)
    (gate_idx, _), (pos, capacity) = seen
    return y, aux, gate_idx, pos, capacity


MOE_CASES = {
    # padded and shared experts; 3 groups of 16 tokens, 6 slots an expert
    "drop": (dict(capacity_factor=1.25), 48),
    "nodrop": (dict(capacity_factor=16.0), 48),
    # 50 tokens: 3 groups do not divide them, 2 of 25 do
    "drop-uneven": (dict(capacity_factor=1.0), 50),
    "geglu-unpadded": (dict(mlp_kind="geglu", pad_experts_to=None, n_shared=0), 48),
}


@pytest.mark.parametrize("case", MOE_CASES)
def test_apply_moe(case, monkeypatch):
    over, s = MOE_CASES[case]
    kw = dict(d_model=32, n_experts=6, top_k=2, d_expert=16, n_shared=2,
              pad_experts_to=8, group_tokens=16)
    kw.update(over)
    cfg = RMo.MoEConfig(**kw)
    pcfg = PMo.MoEConfig(**kw)
    rng = np.random.default_rng(0)
    rp, tp = _both(_moe_params(cfg, rng))
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    y, aux, gate_idx, pos, capacity = _ref_moe_routing(cfg, rp, jnp.asarray(x), monkeypatch)

    xt = torch.from_numpy(x)
    g, per = PMo.group_shape(pcfg, 2, s)
    r = PMo.route(pcfg, tp, xt.reshape(g, per, 32))
    assert r["capacity"] == capacity
    np.testing.assert_array_equal(r["gate_idx"].numpy(), gate_idx)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    keep = pos < capacity
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert keep.all() == (case in ("nodrop",)), keep.mean()
    assert (gate_idx < cfg.n_experts).all()   # padded experts never chosen
    py, paux = PMo.apply_moe(pcfg, tp, xt)
    _close(y, py)
    _close(aux, paux)


@pytest.mark.parametrize("case", ["drop", "nodrop"])
def test_apply_moe_bf16(case, monkeypatch):
    """bf16 input and weights: the router's logits are rounded to bf16 in
    both packages, so the routing (choices, positions, what is kept) is
    equal bit for bit; ``y`` within 2^-6 of its largest magnitude (bf16's
    half ulp is 2^-9: the packages round between different ops), aux
    within 1e-3 (its probabilities are f32 of the same bf16 logits)."""
    over, s = MOE_CASES[case]
    kw = dict(d_model=32, n_experts=6, top_k=2, d_expert=16, n_shared=2,
              pad_experts_to=8, group_tokens=16)
    kw.update(over)
    cfg, pcfg = RMo.MoEConfig(**kw), PMo.MoEConfig(**kw)
    rng = np.random.default_rng(2)
    p = _moe_params(cfg, rng)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p)
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    xr, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    y, aux, gate_idx, pos, capacity = _ref_moe_routing(cfg, rp, xr, monkeypatch)
    g, per = PMo.group_shape(pcfg, 2, s)
    r = PMo.route(pcfg, tp, xt.reshape(g, per, 32))
    assert r["capacity"] == capacity
    np.testing.assert_array_equal(r["gate_idx"].numpy(), gate_idx)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    np.testing.assert_array_equal(r["keep"].numpy(), pos < capacity)
    assert (pos < capacity).all() == (case == "nodrop")
    py, paux = PMo.apply_moe(pcfg, tp, xt)
    assert py.dtype == torch.bfloat16
    _close(y, py, atol=2.0 ** -6 * float(np.abs(_np(y)).max()), rtol=0)
    _close(aux, paux, atol=1e-3, rtol=0)


def test_moe_tied_router_bitwise(monkeypatch):
    """A zero router ties every real expert: both packages pick the lowest
    indices, fill experts 0 and 1 in token order and drop the same pairs."""
    kw = dict(d_model=32, n_experts=6, top_k=2, d_expert=16, n_shared=2,
              pad_experts_to=8, group_tokens=16)
    cfg, pcfg = RMo.MoEConfig(**kw), PMo.MoEConfig(**kw)
    rng = np.random.default_rng(1)
    rp, tp = _both(_moe_params(cfg, rng, zero_router=True))
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    y, aux, gate_idx, pos, capacity = _ref_moe_routing(cfg, rp, jnp.asarray(x), monkeypatch)
    r = PMo.route(pcfg, tp, torch.from_numpy(x).reshape(4, 16, 32))
    np.testing.assert_array_equal(r["gate_idx"].numpy(), gate_idx)
    assert (gate_idx == np.arange(2)).all()
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    np.testing.assert_array_equal(r["probs"].numpy(), np.full((4, 16, 8), 1 / 6, np.float32)
                                  * (np.arange(8) < 6))
    assert (pos[..., 0] == np.arange(16)).all() and capacity == 6
    py, paux = PMo.apply_moe(pcfg, tp, torch.from_numpy(x))
    _close(y, py)
    _close(aux, paux)  # means over the groups: summed in another order


# ---------------------------------------------------------------- RG-LRU

def _rglru_params(cfg, rng) -> dict:
    d, r = cfg.d_model, cfg.d_rnn
    return {"wx": _normal(rng, (d, r), d), "wy": _normal(rng, (d, r), d),
            "wo": _normal(rng, (r, d), r),
            "conv": (rng.standard_normal((cfg.conv_width, r)) * 0.1).astype(np.float32),
            "w_a": _normal(rng, (r, r), r), "w_i": _normal(rng, (r, r), r),
            "lambda": np.log(np.expm1(np.linspace(0.9, 0.999, r))).astype(np.float32)}


@pytest.mark.parametrize("s", [1, 2, 7, 37, 64])
def test_rglru_scan_bitwise(s):
    """The port's associative scan forms the reference's products and sums
    in the same tree: equal bits, from a zero start and a carried state."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.1, 1.0, (2, s, 5)).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 5)).astype(np.float32)
    for start in (None, h0):
        want = RR._rglru_scan(jnp.asarray(a), jnp.asarray(b),
                              None if start is None else jnp.asarray(start))
        got = PR._rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                             None if start is None else torch.from_numpy(start))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_rglru_full_and_stepped():
    """The whole sequence, then the same tokens in three calls carrying the
    state (a prefill, one decode step, the rest): every output and state."""
    cfg = RR.RGLRUConfig(d_model=32, d_rnn=32)
    pcfg = PR.RGLRUConfig(d_model=32, d_rnn=32)
    rng = np.random.default_rng(2)
    rp, tp = _both(_rglru_params(cfg, rng))
    x = rng.standard_normal((2, 37, 32)).astype(np.float32)
    ry, rs = RR.apply_rglru(cfg, rp, jnp.asarray(x))
    py, ps = PR.apply_rglru(pcfg, tp, torch.from_numpy(x))
    _close(ry, py)
    _close_tree(rs, ps)
    rstate = RR.rglru_state(cfg, 2, jnp.float32)
    pstate = PR.rglru_state(pcfg, 2, torch.float32, "cpu")
    outs = []
    for lo, hi in ((0, 20), (20, 21), (21, 37)):
        ry, rstate = RR.apply_rglru(cfg, rp, jnp.asarray(x[:, lo:hi]), rstate)
        py, pstate = PR.apply_rglru(pcfg, tp, torch.from_numpy(x[:, lo:hi]), pstate)
        _close(ry, py)
        _close_tree(rstate, pstate)
        outs.append(py)
    _close(ps["h"], pstate["h"])
    _close(torch.cat(outs, 1), PR.apply_rglru(pcfg, tp, torch.from_numpy(x))[0])


# ----------------------------------------------------------------- xLSTM

def _linear_params(rng, shapes: dict) -> dict:
    return {k: _normal(rng, shape, shape[0]) for k, shape in shapes.items()}


@pytest.mark.parametrize("chunk", [16, 4, 1])
def test_apply_mlstm_chunks(chunk):
    """37 tokens (a multiple of no chunk but 1) after a first call of 10
    carried the state: outputs and (C, n, m)."""
    kw = dict(d_model=32, n_heads=4, chunk=chunk)
    cfg, pcfg = RR.MLSTMConfig(**kw), PR.MLSTMConfig(**kw)
    di, d = cfg.d_inner, cfg.d_model
    rng = np.random.default_rng(3)
    rp, tp = _both(_linear_params(rng, {
        "w_up": (d, di), "w_gate": (d, di), "wq": (di, di), "wk": (di, di),
        "wv": (di, di), "w_if": (di, 2 * cfg.n_heads), "w_down": (di, d)}))
    x = rng.standard_normal((2, 47, 32)).astype(np.float32)
    ry, rs = RR.apply_mlstm(cfg, rp, jnp.asarray(x[:, :10]))
    py, ps = PR.apply_mlstm(pcfg, tp, torch.from_numpy(x[:, :10]))
    _close(ry, py)
    _close_tree(rs, ps)
    ry, rs = RR.apply_mlstm(cfg, rp, jnp.asarray(x[:, 10:]), rs)
    py, ps = PR.apply_mlstm(pcfg, tp, torch.from_numpy(x[:, 10:]), ps)
    _close(ry, py)
    _close_tree(rs, ps)
    ry, rs = RR.step_mlstm(cfg, rp, jnp.asarray(x[:, :1]), rs)
    py, ps = PR.step_mlstm(pcfg, tp, torch.from_numpy(x[:, :1]), ps)
    _close(ry, py)
    _close_tree(rs, ps)


@pytest.mark.parametrize("time_chunk", [1, 4, 16])
def test_apply_slstm_time_chunks(time_chunk):
    """23 tokens from a carried state: the reference at each time_chunk
    against the port (which steps one token at a time)."""
    cfg = RR.SLSTMConfig(d_model=32, n_heads=4, time_chunk=time_chunk)
    pcfg = PR.SLSTMConfig(d_model=32, n_heads=4)
    di, d, hd = cfg.d_inner, cfg.d_model, cfg.d_inner // cfg.n_heads
    assert pcfg.d_inner == di == 64
    rng = np.random.default_rng(4)
    p = _linear_params(rng, {"w_up": (d, di), "w_gates": (di, 4 * di), "w_down": (di, d)})
    p["r_gates"] = (rng.standard_normal((4, hd, 4 * hd)) * hd ** -0.5 * 0.5).astype(np.float32)
    rp, tp = _both(p)
    x = rng.standard_normal((2, 31, 32)).astype(np.float32)
    rs = RR.apply_slstm(cfg, rp, jnp.asarray(x[:, :8]))[1]
    ps = PR.apply_slstm(pcfg, tp, torch.from_numpy(x[:, :8]))[1]
    _close_tree(rs, ps)
    ry, rs = RR.apply_slstm(cfg, rp, jnp.asarray(x[:, 8:]), rs)
    py, ps = PR.apply_slstm(pcfg, tp, torch.from_numpy(x[:, 8:]), ps)
    _close(ry, py)
    _close_tree(rs, ps)


def test_slstm_width_rounds_up():
    cfg = PR.SLSTMConfig(d_model=1024, n_heads=4)
    assert cfg.d_inner == 1408 == RR.SLSTMConfig(d_model=1024, n_heads=4).d_inner


# -------------------------------------------------------- encoder-decoder

def _whisper(kv_chunk: int):
    over = {"kv_chunk": kv_chunk}
    return (dataclasses.replace(ref_reduced("whisper-tiny"), **over),
            dataclasses.replace(get_reduced("whisper-tiny"), **over))


# (kv_chunk, frames, tokens): the cross-attention chunked when
# tokens * frames > kv_chunk^2, in decode too at kv_chunk 8 over 72 frames
ENCDEC_CASES = {"cross-full": (32, 16, 24), "cross-chunked": (32, 48, 24),
                "all-chunked": (8, 72, 20)}


@pytest.mark.parametrize("case", ENCDEC_CASES)
def test_encdec(case):
    kv_chunk, t, s = ENCDEC_CASES[case]
    rcfg, pcfg = _whisper(kv_chunk)
    tree = ref_weights(rcfg, seed=5)
    rp = jax.tree.map(jnp.asarray, tree)
    model = lm_params_from_arrays(pcfg, tree, device="cpu")
    tp = model.params
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((2, t, rcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, rcfg.vocab, size=(2, s + 2))
    r_enc = RE.encode(rcfg, rp, jnp.asarray(frames))
    p_enc = PE.encode(pcfg, tp, torch.from_numpy(frames))
    _close(r_enc, p_enc, **MODEL_TOL)
    rl, _ = RE.decoder_forward(rcfg, rp, jnp.asarray(toks), r_enc)
    pl, none = PE.decoder_forward(pcfg, tp, torch.from_numpy(toks), p_enc)
    assert none is None
    _close(rl, pl, **MODEL_TOL)

    rl, rc, _ = RE.prefill(rcfg, rp, jnp.asarray(frames), jnp.asarray(toks[:, :s]), s + 2)
    pl, pc, p_enc = model.prefill(torch.from_numpy(frames), torch.from_numpy(toks[:, :s]), s + 2)
    _close(rl, pl, **MODEL_TOL)
    for i in (s, s + 1):
        pos = np.full((2,), i)
        rl, rc = RE.decode_step(rcfg, rp, rc, r_enc, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos))
        pl, pc = model.decode_step(pc, p_enc, torch.from_numpy(toks[:, i:i + 1]),
                                   torch.from_numpy(pos))
        _close(rl, pl, **MODEL_TOL)
    ref_c = lm_caches_from_arrays(pcfg, jax.tree.map(np.asarray, rc), device="cpu")
    assert len(ref_c) == len(pc) == pcfg.dec_layers
    for a, b in zip(ref_c, pc):
        np.testing.assert_array_equal(b["slot_pos"].numpy(), a["slot_pos"].numpy())
        _close(a["k"], b["k"], **MODEL_TOL)
        _close(a["v"], b["v"], **MODEL_TOL)
    # the last step against the port's own decoder over every token
    full = PE.decoder_forward(pcfg, tp, torch.from_numpy(toks), p_enc)[0]
    _close(full[:, -1], pl[:, 0], **MODEL_TOL)


# ------------------------------------------------------------ interop

def _flat(tree, prefix="") -> dict:
    """path -> leaf of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _ref_per_layer(cfg, tree) -> dict:
    """A reference tree (parameters or caches) in the port's per-layer
    layout, stacked axes taken apart."""
    def unstack(t, n):
        return [jax.tree.map(lambda a, i=i: a[i], t) for i in range(n)]

    if cfg.arch_type == "encdec":
        if "enc" not in tree:          # decoder caches
            return unstack(tree, cfg.dec_layers)
        out = {k: tree[k] for k in ("emb", "frontend_proj", "final_norm")}
        out["enc"] = unstack(tree["enc"], cfg.enc_layers)
        out["dec"] = unstack(tree["dec"], cfg.dec_layers)
        return out
    n_cycles = cfg.n_layers // len(cfg.pattern)
    per = [unstack(c, n_cycles) for c in tree["cycles"]]
    layers = [per[j][i] for i in range(n_cycles) for j in range(len(cfg.pattern))]
    layers += list(tree["rem"])
    if "emb" not in tree:              # decode caches
        return layers
    return {"emb": tree["emb"], "final_norm": tree["final_norm"], "layers": layers}


@pytest.mark.parametrize("arch", ["whisper-tiny", "recurrentgemma-2b", "xlstm-350m",
                                  "qwen2-moe-a2.7b"])
def test_interop_round_trip(arch):
    """A reference parameter tree and decode-cache tree carried into the
    port: every leaf lands, unchanged, at its layer, of the reference's
    dtype (the RG-LRU's Lambda f32 in a bf16 model)."""
    # a name of its own: the reference caches abstract shapes by name, not dtype
    over = {"dtype": "bfloat16", "name": arch + "-reduced-bf16"}
    rcfg = dataclasses.replace(ref_reduced(arch), **over)
    pcfg = dataclasses.replace(get_reduced(arch), **over)
    tree = ref_weights(rcfg, seed=7)
    shapes, _ = RM.abstract_params(rcfg)
    model = lm_params_from_arrays(pcfg, tree, device="cpu")
    want = _flat(_ref_per_layer(rcfg, tree))
    empty = jax.tree.map(lambda a: np.empty(a.shape, a.dtype), shapes)
    dtypes = {k: a.dtype.name for k, a in _flat(_ref_per_layer(rcfg, empty)).items()}
    got = _flat(model.params)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert str(t.dtype).removeprefix("torch.") == dtypes[k], k
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(jnp.asarray(want[k], dtypes[k]), np.float32), k)
    if arch == "recurrentgemma-2b":
        assert got["/layers/0/rglru/lambda"].dtype == torch.float32

    # the decode caches: K/V, slot positions and recurrent states
    if rcfg.arch_type == "encdec":
        rcache = RE.init_dec_caches(rcfg, 2, 9)
    else:
        rcache = RM.build_model(rcfg).init_caches(2, 9)
    rng = np.random.default_rng(8)
    rcache = jax.tree.map(
        lambda a: np.asarray(rng.integers(-1, 9, a.shape) if a.dtype == jnp.int32
                             else rng.standard_normal(a.shape)).astype(a.dtype), rcache)
    got = _flat(lm_caches_from_arrays(pcfg, rcache, device="cpu"))
    mine = _flat(model.init_caches(2, 9))
    want = _flat(_ref_per_layer(rcfg, rcache))
    assert sorted(got) == sorted(mine) == sorted(want)
    for k, t in got.items():
        assert t.dtype == mine[k].dtype and t.shape == mine[k].shape, k
        np.testing.assert_array_equal(_np(t), np.asarray(want[k]).astype(_np(t).dtype), k)
