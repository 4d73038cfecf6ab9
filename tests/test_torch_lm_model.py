"""The port's LM serving path against the reference's.

For each reduced configuration (dense, MoE, recurrent and the
encoder-decoder) the same weights, drawn from a numpy seed in the
reference's layout and carried across by ``interop.lm_params_from_arrays``,
go through the reference's ``forward`` (``decoder_forward`` over the
encoder's output for whisper), ``prefill``, four ``decode_step``s and
``loss_fn`` (jitted, on the CPU) and through the port's on the CPU. The
caches compared include the recurrent states, and the loss its MoE aux
term. Tolerance: f32 at atol 2e-4 / rtol 2e-3, the reference's own
decode-against-forward test. The registry's ten configurations equal the
reference's field by field.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.interop import lm_caches_from_arrays, lm_params_from_arrays  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.layers import count_params, tree_leaves  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
STEPS = 4
# case -> (arch, prompt length, config overrides). Prompts of 24 take
# attention_full (kv_chunk 32), of 40 attention_chunked; gemma3's and
# recurrentgemma's window of 8 makes their local caches roll; q_chunk 16
# takes attention_chunked_q. The MoE cases at capacity 1.25 drop tokens in
# the prefill; at 16 none drop. xlstm's 20 tokens are not a multiple of its
# mLSTM chunk of 8. whisper's 24 tokens over 48 frames take the chunked
# cross-attention (24 * 48 > 32^2), its decode steps the full one.
CASES = {
    "olmo-1b": ("olmo-1b", 24, {}),
    "deepseek-7b": ("deepseek-7b", 40, {}),
    "deepseek-7b-int8kv": ("deepseek-7b", 24, {"kv_cache_dtype": "int8"}),
    "gemma-7b": ("gemma-7b", 24, {}),
    "gemma3-4b": ("gemma3-4b", 40, {}),
    "gemma3-4b-qchunk16": ("gemma3-4b", 40, {"q_chunk": 16}),
    "internvl2-76b": ("internvl2-76b", 20, {}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", 24, {}),
    "qwen2-moe-a2.7b-nodrop": ("qwen2-moe-a2.7b", 40, {"moe_capacity": 16.0}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", 40, {}),
    "granite-moe-1b-a400m-nodrop": ("granite-moe-1b-a400m", 24, {"moe_capacity": 16.0}),
    "recurrentgemma-2b": ("recurrentgemma-2b", 40, {}),
    "xlstm-350m": ("xlstm-350m", 20, {}),
    "whisper-tiny": ("whisper-tiny", 24, {}),
}
DENSE = ("olmo-1b", "deepseek-7b", "gemma-7b", "gemma3-4b", "internvl2-76b")
FAMILIES = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m", "recurrentgemma-2b", "xlstm-350m",
            "whisper-tiny")
FRAMES = 48  # encoder frames of the encoder-decoder cases
# a prefill token may drop at a capacity that its decode step never meets,
# so a dropping MoE case is held to the reference only
DROPS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def ref_weights(cfg, seed: int) -> dict:
    """Weights in the reference's layout from ``default_rng(seed)``: fan-in
    scaled normals (an expert's or a head's matrix by its own input
    width), norm scales and biases ~ N(0, 0.1^2), the RG-LRU's Lambda as the
    reference initialises it; each array of the dtype the reference gives
    that parameter."""
    shapes, _ = RM.abstract_params(cfg)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        stacked = path[0].key in ("cycles", "enc", "dec")
        core = s.shape[1:] if stacked else s.shape
        if name == "lambda":
            lam = np.log(np.expm1(np.linspace(0.9, 0.999, core[0])))
            return np.broadcast_to(lam, s.shape).astype(np.float32)
        if name in ("scale", "bias"):
            std = 0.1
        elif name == "emb":
            std = core[1] ** -0.5
        elif name == "r_gates" or (len(core) == 3 and path[-2].key == "moe"):
            std = core[1] ** -0.5
        else:
            std = core[0] ** -0.5
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _ref_params(tree: dict, shapes) -> dict:
    """``tree`` as reference arrays of the reference's parameter dtypes."""
    return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)


@functools.lru_cache(maxsize=None)
def run_case(case: str) -> dict:
    """Both packages through forward, prefill, STEPS decode steps and the
    loss on the same weights and tokens."""
    arch, s, over = CASES[case]
    rcfg = dataclasses.replace(RC.get_reduced(arch), **over)
    pcfg = dataclasses.replace(PC.get_reduced(arch), **over)
    tree = ref_weights(rcfg, seed=0)
    rparams = _ref_params(tree, RM.abstract_params(rcfg)[0])
    rmodel = RM.build_model(rcfg)
    pmodel = lm_params_from_arrays(pcfg, tree, device="cpu")
    encdec = rcfg.arch_type == "encdec"

    rng = np.random.default_rng(1)
    b = 2
    toks = rng.integers(0, rcfg.vocab, size=(b, s + STEPS))
    prefix = (rng.standard_normal((b, rcfg.prefix_len, rcfg.d_model)).astype(np.float32)
              if rcfg.prefix_len else None)
    frames = (rng.standard_normal((b, FRAMES, rcfg.d_model)).astype(np.float32)
              if encdec else None)
    labels = rng.integers(0, rcfg.vocab, size=(b, s))
    labels[0, :3] = -1                         # masked positions
    p0 = rcfg.prefix_len + s                   # position of the first decode token
    max_seq = p0 + STEPS
    jp = None if prefix is None else jnp.asarray(prefix)
    tp = None if prefix is None else torch.from_numpy(prefix)

    out: dict = {"cfg": pcfg, "model": pmodel}
    if encdec:
        jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
        r_enc = jax.jit(lambda p, f: RE.encode(rcfg, p, f))(rparams, jf)
        p_enc = pmodel.encode(tf)
        out["encode"] = (r_enc, p_enc)
        fwd = jax.jit(lambda p, t, e: RE.decoder_forward(rcfg, p, t, e)[0])
        out["fwd"] = (fwd(rparams, jnp.asarray(toks), r_enc),
                      pmodel.forward(torch.from_numpy(toks), p_enc)[0])
        pre = jax.jit(lambda p, f, t: rmodel.prefill(p, f, t, max_seq=max_seq))
        rl, rcache, _ = pre(rparams, jf, jnp.asarray(toks[:, :s]))
        pl, pcache, p_enc = pmodel.prefill(tf, torch.from_numpy(toks[:, :s]), max_seq)
        dec = jax.jit(lambda p, c, t, pos: rmodel.decode_step(p, c, r_enc, t, pos))
        pdec = functools.partial(pmodel.decode_step, enc_out=p_enc)
    else:
        fwd = jax.jit(lambda p, t, pe: rmodel.forward(p, t, prefix_embeds=pe)[0])
        out["fwd"] = (fwd(rparams, jnp.asarray(toks), jp),
                      pmodel.forward(torch.from_numpy(toks), prefix_embeds=tp)[0])
        pre = jax.jit(lambda p, t, pe: rmodel.prefill(p, t, max_seq=max_seq, prefix_embeds=pe))
        rl, rcache = pre(rparams, jnp.asarray(toks[:, :s]), jp)
        pl, pcache = pmodel.prefill(torch.from_numpy(toks[:, :s]), max_seq, prefix_embeds=tp)
        dec = jax.jit(lambda p, c, t, pos: rmodel.decode_step(p, c, t, pos))
        pdec = pmodel.decode_step
    out["prefill"] = (rl, pl)
    out["prefill_caches"] = (lm_caches_from_arrays(pcfg, jax.tree.map(np.asarray, rcache),
                                                   device="cpu"),
                             [{k: v.clone() for k, v in c.items()} for c in pcache])
    steps = []
    for i in range(STEPS):
        t1 = toks[:, s + i:s + i + 1]
        pos = np.full((b,), p0 + i)
        rl, rcache = dec(rparams, rcache, jnp.asarray(t1), jnp.asarray(pos))
        pl, pcache = pdec(pcache, tokens1=torch.from_numpy(t1), pos=torch.from_numpy(pos))
        steps.append((rl, pl))
    out["decode"] = steps
    out["decode_caches"] = (lm_caches_from_arrays(pcfg, jax.tree.map(np.asarray, rcache),
                                                  device="cpu"), pcache)
    batch = {"tokens": toks[:, :s], "labels": labels}
    if prefix is not None:
        batch["prefix_embeds"] = prefix
    if encdec:
        batch["frames"] = frames
    loss = jax.jit(lambda p, bt: rmodel.loss_fn(p, bt))
    rloss, raux = loss(rparams, jax.tree.map(jnp.asarray, batch))
    ploss, paux = pmodel.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    out["loss"] = (rloss, ploss)
    out["aux"] = (raux["aux"], paux["aux"])
    return out


def _assert_caches(ref: list, got: list) -> None:
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert sorted(r) == sorted(g), i
        for name in r:
            assert r[name].dtype == g[name].dtype, (i, name)
            if name == "slot_pos":
                np.testing.assert_array_equal(_np(g[name]), _np(r[name]))
            elif r[name].dtype == torch.int8:
                # a value on a rounding boundary may land one step over
                assert np.abs(_np(g[name]).astype(int) - _np(r[name])).max() <= 1, (i, name)
            else:
                np.testing.assert_allclose(_np(g[name]), _np(r[name]), **TOL,
                                           err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("case", CASES)
def test_forward_logits(case):
    r, p = run_case(case)["fwd"]
    assert p.dtype == torch.float32 and tuple(p.shape) == np.asarray(r).shape
    np.testing.assert_allclose(_np(p), _np(r), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_prefill_logits(case):
    r, p = run_case(case)["prefill"]
    assert tuple(p.shape) == np.asarray(r).shape
    np.testing.assert_allclose(_np(p), _np(r), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_prefill_caches(case):
    _assert_caches(*run_case(case)["prefill_caches"])


@pytest.mark.parametrize("case", CASES)
def test_decode_steps(case):
    out = run_case(case)
    for i, (r, p) in enumerate(out["decode"]):
        np.testing.assert_allclose(_np(p), _np(r), **TOL, err_msg=f"step {i}")
    _assert_caches(*out["decode_caches"])


@pytest.mark.parametrize("case", CASES)
def test_loss(case):
    out = run_case(case)
    r, p = out["loss"]
    np.testing.assert_allclose(float(p), float(r), **TOL)
    r, p = out["aux"]
    np.testing.assert_allclose(float(p), float(r), **TOL)
    if "moe" in case:
        assert float(p) > 0


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == "whisper-tiny"])
def test_encode(case):
    r, p = run_case(case)["encode"]
    np.testing.assert_allclose(_np(p), _np(r), **TOL)


@pytest.mark.parametrize("case", [c for c in CASES if "int8" not in c and c not in DROPS])
def test_decode_matches_own_forward(case):
    """The port's last decode step against its own forward over the prompt
    and the decoded tokens (the reference's decode-against-forward test;
    an int8 cache attends quantized K/V, and a MoE prefill at capacity 1.25
    drops tokens, so those are held to the reference above instead)."""
    out = run_case(case)
    full = out["fwd"][1]
    np.testing.assert_allclose(_np(out["decode"][-1][1][:, 0]), _np(full[:, -1]), **TOL)


# ---------------------------------------------------------------- registry

def test_all_archs_listed():
    assert PC.ALL_ARCHS == RC.ALL_ARCHS
    with pytest.raises(KeyError):
        PC.get_config("not-an-arch")


@pytest.mark.parametrize("arch", RC.ALL_ARCHS)
def test_config_fields_and_counts(arch):
    for get in ("get_config", "get_reduced"):
        r, p = getattr(RC, get)(arch), getattr(PC, get)(arch)
        assert dataclasses.asdict(p) == dataclasses.asdict(r), (arch, get)
        assert p.n_params() == r.n_params()
        assert p.n_active_params() == r.n_active_params()
        assert p.resolved_head_dim == r.resolved_head_dim
    assert PC.get_train_overrides(arch) == RC.get_train_overrides(arch)


def _ref_specs_per_layer(cfg):
    """The reference's abstract parameters unstacked to one entry per layer,
    in the port's layout: (shape, dtype name) and axes."""
    shapes, specs = RM.abstract_params(cfg)
    is_axes = lambda a: isinstance(a, tuple)  # noqa: E731
    sd = lambda a: (tuple(a.shape), a.dtype.name)  # noqa: E731

    def unstack(shape_tree, spec_tree, n):
        return ([jax.tree.map(lambda a: (tuple(a.shape[1:]), a.dtype.name), shape_tree)] * n,
                [jax.tree.map(lambda a: tuple(a[1:]), spec_tree, is_leaf=is_axes)] * n)

    if cfg.arch_type == "encdec":
        top = ("emb", "frontend_proj", "final_norm")
        s = {k: jax.tree.map(sd, shapes[k]) for k in top}
        a = {k: jax.tree.map(tuple, specs[k], is_leaf=is_axes) for k in top}
        s["enc"], a["enc"] = unstack(shapes["enc"], specs["enc"], cfg.enc_layers)
        s["dec"], a["dec"] = unstack(shapes["dec"], specs["dec"], cfg.dec_layers)
        return s, a
    n_cycles = cfg.n_layers // len(cfg.pattern)
    lay_s, lay_a = [], []
    for i in range(n_cycles):
        for j in range(len(cfg.pattern)):
            lay_s.append(jax.tree.map(lambda a: (tuple(a.shape[1:]), a.dtype.name),
                                      shapes["cycles"][j]))
            lay_a.append(jax.tree.map(lambda a: tuple(a[1:]), specs["cycles"][j],
                                      is_leaf=is_axes))
    lay_s += [jax.tree.map(sd, p) for p in shapes["rem"]]
    lay_a += [jax.tree.map(tuple, s, is_leaf=is_axes) for s in specs["rem"]]
    top = ("emb", "final_norm")
    s = {k: jax.tree.map(sd, shapes[k]) for k in top}
    a = {k: jax.tree.map(tuple, specs[k], is_leaf=is_axes) for k in top}
    s["layers"], a["layers"] = lay_s, lay_a
    return s, a


# What the reference's analytic n_params leaves out of the full
# configurations (+) or counts beyond their tensors (-), norms aside:
# qwen2-moe's shared gates (24 x 2,048), the RG-LRU's conv and Lambda
# (18 x 5 x 2,560), whisper's frontend_proj (384^2), and for xlstm the
# sLSTM's width rounded to 1,408 (not 1,365) and its block-diagonal
# recurrence, less the mLSTM's w_if (12 x 2,048 x 8).
ANALYTIC_GAP = {"qwen2-moe-a2.7b": 49_152, "granite-moe-1b-a400m": 0,
                "recurrentgemma-2b": 230_400, "whisper-tiny": 147_456,
                "xlstm-350m": -13_983_744}


@pytest.mark.parametrize("arch,full", [(a, False) for a in DENSE + FAMILIES]
                         + [("gemma3-4b", True)] + [(a, True) for a in FAMILIES])
def test_param_specs(arch, full):
    get = "get_config" if full else "get_reduced"
    rcfg, pcfg = getattr(RC, get)(arch), getattr(PC, get)(arch)
    shapes, axes = PM.abstract_params(pcfg)
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    got = {k: jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), v)
           for k, v in shapes.items()}
    want_s, want_a = _ref_specs_per_layer(rcfg)
    assert got == want_s
    assert axes == want_a
    # the analytic count is the matrices' (norm scales are not counted)
    norms = sum(t.numel() for k, t in _named_leaves(shapes) if "norm" in k)
    if arch in DENSE:
        assert count_params(shapes) - norms == pcfg.n_params()
    elif full:
        assert count_params(shapes) - norms - pcfg.n_params() == ANALYTIC_GAP[arch]


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def test_build_model_defaults_to_cuda():
    cfg = PC.get_reduced("olmo-1b")
    if torch.cuda.is_available():
        assert PM.build_model(cfg).weights.emb.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PM.build_model(cfg)


def test_model_holds_its_parameters():
    """Parameters are the module's own frozen tensors; one generator seed
    gives the same weights, ``init`` draws anew in place."""
    cfg = PC.get_reduced("gemma3-4b")
    m1 = PM.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    m2 = PM.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    names = [n for n, _ in m1.named_parameters()]
    assert len(names) == len(tree_leaves(m1.params)) == 2 + 9 * cfg.n_layers
    assert "weights.layers.6.attn.wq" in names
    assert all(not p.requires_grad for p in m1.parameters())
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    wq = m1.weights.layers[0].attn.wq
    before = wq.clone()
    params = m1.init(torch.Generator().manual_seed(4))
    assert params["layers"][0]["attn"]["wq"] is wq and not torch.equal(wq, before)
    caches = m1.init_caches(2, 12)
    kinds = PT.layer_kinds(cfg)
    assert kinds == list(cfg.pattern) + ["local+mlp"]
    for kind, c in zip(kinds, caches):
        assert c["k"].shape == (2, 8 if kind == "local+mlp" else 12, cfg.n_kv, cfg.head_dim)


def test_bf16_forward_and_decode():
    """gemma3-4b reduced in bf16: forward and decode logits against the
    reference within 5% of the largest logit (bf16 rounds each layer's
    activations; the reference rounds between the ops of an activation,
    torch once), caches' slot positions exactly."""
    rcfg = dataclasses.replace(RC.get_reduced("gemma3-4b"), dtype="bfloat16")
    pcfg = dataclasses.replace(PC.get_reduced("gemma3-4b"), dtype="bfloat16")
    tree = ref_weights(rcfg, seed=5)
    rparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    rmodel = RM.build_model(rcfg)
    pmodel = lm_params_from_arrays(pcfg, tree, device="cpu")
    assert pmodel.weights.emb.dtype == torch.bfloat16
    toks = np.random.default_rng(6).integers(0, rcfg.vocab, size=(2, 13))
    r = _np(jax.jit(lambda p, t: rmodel.forward(p, t)[0])(rparams, jnp.asarray(toks)))
    p = _np(pmodel.forward(torch.from_numpy(toks))[0])
    np.testing.assert_allclose(p, r, atol=0.05 * np.abs(r).max(), rtol=0)
    rl, rc = rmodel.prefill(rparams, jnp.asarray(toks[:, :12]), max_seq=13)
    pl, pc = pmodel.prefill(torch.from_numpy(toks[:, :12]), 13)
    rl, rc = rmodel.decode_step(rparams, rc, jnp.asarray(toks[:, 12:]), jnp.full((2,), 12))
    pl, pc = pmodel.decode_step(pc, torch.from_numpy(toks[:, 12:]), torch.full((2,), 12))
    np.testing.assert_allclose(_np(pl), _np(rl), atol=0.05 * np.abs(_np(rl)).max(), rtol=0)
    ref_c = lm_caches_from_arrays(pcfg, jax.tree.map(np.asarray, rc), device="cpu")
    assert ref_c[0]["k"].dtype == torch.bfloat16
    for a, b in zip(ref_c, pc):
        np.testing.assert_array_equal(_np(b["slot_pos"]), _np(a["slot_pos"]))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_bf16_recurrent_forward_and_decode(arch):
    """A recurrent family in bf16 (the RG-LRU's Lambda stays f32 in both
    packages): forward, prefill and two decode steps against the reference
    within 5% of the largest logit, as the dense bf16 case; the carried
    states within 5% of their largest magnitude."""
    _bf16_against_reference(arch, {})


@pytest.mark.parametrize("arch,capacity", [("qwen2-moe-a2.7b", 1.25),
                                           ("qwen2-moe-a2.7b", 16.0),
                                           ("granite-moe-1b-a400m", 1.25)])
def test_bf16_moe_forward_and_decode(arch, capacity):
    """A MoE family in bf16, at a capacity whose prefill drops tokens and
    one where none drop: forward, prefill and two decode steps against the
    reference within 5% of the largest logit, caches as the recurrent bf16
    case."""
    _bf16_against_reference(arch, {"moe_capacity": capacity})


def _bf16_against_reference(arch: str, over: dict) -> None:
    # a name of its own: the reference caches abstract shapes by name, not dtype
    over = {**over, "dtype": "bfloat16",
            "name": arch + "-reduced-bf16-" + "-".join(map(str, over.values()))}
    rcfg = dataclasses.replace(RC.get_reduced(arch), **over)
    pcfg = dataclasses.replace(PC.get_reduced(arch), **over)
    tree = ref_weights(rcfg, seed=8)
    rparams = _ref_params(tree, RM.abstract_params(rcfg)[0])
    rmodel = RM.build_model(rcfg)
    pmodel = lm_params_from_arrays(pcfg, tree, device="cpu")
    toks = np.random.default_rng(9).integers(0, rcfg.vocab, size=(2, 14))

    def close(got, want):
        got, want = _np(got), np.asarray(want).astype(np.float32)
        np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max(), rtol=0)

    close(pmodel.forward(torch.from_numpy(toks))[0],
          jax.jit(lambda p, t: rmodel.forward(p, t)[0])(rparams, jnp.asarray(toks)))
    rl, rc = rmodel.prefill(rparams, jnp.asarray(toks[:, :12]), max_seq=14)
    pl, pc = pmodel.prefill(torch.from_numpy(toks[:, :12]), 14)
    close(pl, rl)
    for i in (12, 13):
        rl, rc = rmodel.decode_step(rparams, rc, jnp.asarray(toks[:, i:i + 1]), jnp.full((2,), i))
        pl, pc = pmodel.decode_step(pc, torch.from_numpy(toks[:, i:i + 1]), torch.full((2,), i))
        close(pl, rl)
    ref_c = lm_caches_from_arrays(pcfg, jax.tree.map(np.asarray, rc), device="cpu")
    for a, b in zip(ref_c, pc):
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype
            if name == "slot_pos":
                np.testing.assert_array_equal(_np(b[name]), _np(a[name]))
            else:
                close(b[name], _np(a[name]))


def test_embed_and_logits_round_like_the_reference():
    """In bf16 the reference scales the embedding by sqrt(d) rounded to
    bf16, and rounds the tied-logit product to bf16 before its f32 cast."""
    from repro.models import transformer as RT

    rcfg = dataclasses.replace(RC.get_reduced("gemma3-4b"), dtype="bfloat16")
    pcfg = dataclasses.replace(PC.get_reduced("gemma3-4b"), dtype="bfloat16")
    rng = np.random.default_rng(7)
    emb = (rng.standard_normal((rcfg.vocab, rcfg.d_model)) * 0.125).astype(np.float32)
    toks = rng.integers(0, rcfg.vocab, size=(2, 9))
    rp = {"emb": jnp.asarray(emb, jnp.bfloat16)}
    tp = {"emb": torch.from_numpy(emb).bfloat16()}
    x_ref = RT.embed_tokens(rcfg, rp, jnp.asarray(toks))
    x = PT.embed_tokens(pcfg, tp, torch.from_numpy(toks))
    np.testing.assert_array_equal(_np(x), np.asarray(x_ref).astype(np.float32))
    logits = PT.logits_from(pcfg, tp, x)
    assert logits.dtype == torch.float32
    assert torch.equal(logits, logits.bfloat16().float())
    ref = np.asarray(RT.logits_from(rcfg, rp, x_ref))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(_np(logits) - ref) <= ulp).all()
