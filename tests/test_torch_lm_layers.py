"""The port's LM layers, attention and KV caches against the reference's.

The same inputs, drawn from a numpy seed, go through a function of
``repro.models`` and its counterpart in ``repro_torch.models`` on the CPU.
Tolerances: f32 at atol 1e-5 / rtol 1e-4 (the reference's own attention
tests); bf16 within 1% of the largest magnitude of the reference's output
(about one bf16 ulp there: the reference rounds between the elementwise ops
of an activation, torch once); caches exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import blocks as RB  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import blocks as PB  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dt: str):
    """The same values as a reference array and a port tensor of dtype dt."""
    jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(ref, got, dt: str) -> None:
    r, g = _np(ref), _np(got)
    assert r.shape == g.shape
    if dt == "f32":
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(g, r, atol=1e-2 * np.abs(r).max(), rtol=0)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["rms", "layernorm", "nonparam"])
def test_norm(kind, dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32) * 3 + 0.5
    p = {"scale": 0.1 * rng.standard_normal(64), "bias": 0.1 * rng.standard_normal(64)}
    p = {"rms": {"scale": p["scale"]}, "layernorm": p, "nonparam": {}}[kind]
    rp = {k: _both(v.astype(np.float32), dt)[0] for k, v in p.items()}
    tp = {k: _both(v.astype(np.float32), dt)[1] for k, v in p.items()}
    xr, xt = _both(x, dt)
    _close(RL.apply_norm(kind, rp, xr), PL.apply_norm(kind, tp, xt), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta, dt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.array([0, 1, 2, 3, 5, 700, 4127])
    xr, xt = _both(x, dt)
    np.testing.assert_array_equal(_np(RL.rope_freqs(32, theta)), _np(PL.rope_freqs(32, theta)))
    # prefill positions (1, S) and decode positions (B, 1)
    _close(RL.apply_rope(xr, jnp.asarray(pos)[None, :], theta),
           PL.apply_rope(xt, torch.from_numpy(pos)[None, :], theta), dt)
    dpos = np.array([[9], [4100]])
    _close(RL.apply_rope(xr[:, :1], jnp.asarray(dpos), theta),
           PL.apply_rope(xt[:, :1], torch.from_numpy(dpos), theta), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp(kind, dt):
    rng = np.random.default_rng(2)
    d, f = 64, 96
    x = rng.standard_normal((2, 8, d)).astype(np.float32) * 2
    w = {"wi": rng.standard_normal((d, f)) * d ** -0.5,
         "wg": rng.standard_normal((d, f)) * d ** -0.5,
         "wo": rng.standard_normal((f, d)) * f ** -0.5}
    if kind == "gelu":
        del w["wg"]
    rp = {k: _both(v.astype(np.float32), dt)[0] for k, v in w.items()}
    tp = {k: _both(v.astype(np.float32), dt)[1] for k, v in w.items()}
    xr, xt = _both(x, dt)
    _close(RL.apply_mlp(RL.MLPConfig(kind, d, f), rp, xr),
           PL.apply_mlp(PL.MLPConfig(kind, d, f), tp, xt), dt)


# ------------------------------------------------------------- attention

def _qkv(seed, b, s, hq, hkv, hd, dt, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or s
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
    return [_both(a, dt) for a in (q, k, v)]


def _cfgs(window, **kw):
    r = RA.AttnConfig(d_model=0, window=window, **kw)
    return r, PA.AttnConfig(**dataclasses.asdict(r))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("window", [None, 7])
def test_attention_full(window, dt):
    rc, pc = _cfgs(window, n_heads=8, n_kv=4, head_dim=16, kv_chunk=16)
    (qr, qt), (kr, kt), (vr, vt) = _qkv(3, 2, 40, 8, 4, 16, dt)
    pos = np.arange(40)
    _close(RA.attention_full(rc, qr, kr, vr, jnp.asarray(pos), jnp.asarray(pos)),
           PA.attention_full(pc, qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(pos)), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("window", [None, 7])
def test_attention_chunked(window, dt):
    """GQA (8 query heads over 4 KV heads), 50 positions in chunks of 16:
    the last chunk is padded."""
    rc, pc = _cfgs(window, n_heads=8, n_kv=4, head_dim=16, kv_chunk=16)
    (qr, qt), (kr, kt), (vr, vt) = _qkv(4, 2, 50, 8, 4, 16, dt)
    pos = np.arange(50)
    _close(RA.attention_chunked(rc, qr, kr, vr, jnp.asarray(pos), jnp.asarray(pos)),
           PA.attention_chunked(pc, qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(pos)), dt)


@pytest.mark.parametrize("window", [None, 11])
@pytest.mark.parametrize("q_chunk", [8, 16, 24])
def test_attention_chunked_q(q_chunk, window):
    rc, pc = _cfgs(window, n_heads=4, n_kv=2, head_dim=16, kv_chunk=8)
    (qr, qt), (kr, kt), (vr, vt) = _qkv(5, 2, 64, 4, 2, 16, "f32")
    pos = np.arange(64)
    ref = RA.attention_chunked_q(rc, qr, kr, vr, jnp.asarray(pos), jnp.asarray(pos), q_chunk)
    got = PA.attention_chunked_q(pc, qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(pos),
                                 q_chunk)
    _close(ref, got, "f32")
    _close(RA.attention_full(rc, qr, kr, vr, jnp.asarray(pos), jnp.asarray(pos)), got, "f32")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention(window, dt):
    """A rolling cache: slots hold scattered positions, some empty (-1)."""
    rc, pc = _cfgs(window, n_heads=8, n_kv=2, head_dim=16)
    rng = np.random.default_rng(6)
    b, s_c = 3, 12
    (qr, qt), (kr, kt), (vr, vt) = _qkv(7, b, 1, 8, 2, 16, dt, sk=s_c)
    slot_pos = np.stack([rng.permutation(s_c) + off for off in (0, 5, 20)]).astype(np.int32)
    slot_pos[0, rng.choice(s_c, 4, replace=False)] = -1
    pos = np.array([9, 14, 31])
    ref = RA.decode_attention(rc, qr, kr, vr, jnp.asarray(pos), jnp.asarray(slot_pos))
    got = PA.decode_attention(pc, qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(slot_pos))
    _close(ref, got, dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_project_qkv_and_output_proj(dt):
    """head_dim * n_heads != d_model, GQA, RoPE at theta 1e6."""
    rng = np.random.default_rng(8)
    rc, pc = _cfgs(None, n_heads=4, n_kv=2, head_dim=32, rope_theta=1e6)
    rc = dataclasses.replace(rc, d_model=48)
    pc = dataclasses.replace(pc, d_model=48)
    w = {"wq": rng.standard_normal((48, 4, 32)), "wk": rng.standard_normal((48, 2, 32)),
         "wv": rng.standard_normal((48, 2, 32)), "wo": rng.standard_normal((128, 48))}
    w = {k: (v * v.shape[0] ** -0.5).astype(np.float32) for k, v in w.items()}
    rp = {k: _both(v, dt)[0] for k, v in w.items()}
    tp = {k: _both(v, dt)[1] for k, v in w.items()}
    xr, xt = _both(rng.standard_normal((2, 5, 48)).astype(np.float32), dt)
    pos = np.arange(5)
    for r, t in zip(RA.project_qkv(rc, rp, xr, jnp.asarray(pos)[None, :]),
                    PA.project_qkv(pc, tp, xt, torch.from_numpy(pos)[None, :])):
        _close(r, t, dt)
    ar, at = _both(rng.standard_normal((2, 5, 4, 32)).astype(np.float32), dt)
    _close(RA.output_proj(rc, rp, ar), PA.output_proj(pc, tp, at), dt)


# ---------------------------------------------------------------- caches

def _cache_cfgs(kv_dtype: str):
    r = dataclasses.replace(ref_reduced("gemma3-4b"), kv_cache_dtype=kv_dtype)
    p = dataclasses.replace(get_reduced("gemma3-4b"), kv_cache_dtype=kv_dtype)
    return r, p


def _assert_cache_equal(ref: dict, got: dict) -> None:
    assert sorted(ref) == sorted(got)
    for name in ref:
        r, g = np.asarray(ref[name]), got[name]
        assert str(g.dtype).removeprefix("torch.") == r.dtype.name, name
        np.testing.assert_array_equal(_np(g), _np(r), err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("kind,s", [("attn+mlp", 13), ("local+mlp", 13), ("local+mlp", 8)])
def test_fill_kv_cache(kind, s, kv_dtype):
    """A global cache (13 of 20 slots written) and a rolling one (window 8:
    13 positions keep the last 8 at slot pos % 8; 8 positions fill it)."""
    rcfg, pcfg = _cache_cfgs(kv_dtype)
    rng = np.random.default_rng(9)
    k = rng.standard_normal((2, s, rcfg.n_kv, rcfg.head_dim)).astype(np.float32)
    v = rng.standard_normal((2, s, rcfg.n_kv, rcfg.head_dim)).astype(np.float32) * 3
    pos = np.arange(s)
    ref = RB._fill_kv_cache(RB.block_cache(kind, rcfg, 2, 20, jnp.float32),
                            jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    got = PB._fill_kv_cache(PB.block_cache(kind, pcfg, 2, 20, torch.float32, "cpu"),
                            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos))
    _assert_cache_equal(ref, got)


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("kind", ["attn+mlp", "local+mlp"])
def test_append_kv_cache(kind, kv_dtype):
    """Two decode writes after a prefill; the rolling cache wraps."""
    rcfg, pcfg = _cache_cfgs(kv_dtype)
    rng = np.random.default_rng(10)
    s = 7
    k = rng.standard_normal((2, s, rcfg.n_kv, rcfg.head_dim)).astype(np.float32)
    ref = RB._fill_kv_cache(RB.block_cache(kind, rcfg, 2, 12, jnp.float32),
                            jnp.asarray(k), jnp.asarray(k), jnp.arange(s))
    got = PB._fill_kv_cache(PB.block_cache(kind, pcfg, 2, 12, torch.float32, "cpu"),
                            torch.from_numpy(k), torch.from_numpy(k), torch.arange(s))
    for pos in (np.array([7, 7]), np.array([8, 8])):
        k1 = rng.standard_normal((2, 1, rcfg.n_kv, rcfg.head_dim)).astype(np.float32)
        v1 = -2 * k1
        ref = RB._append_kv_cache(ref, jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(pos))
        got = PB._append_kv_cache(got, torch.from_numpy(k1), torch.from_numpy(v1),
                                  torch.from_numpy(pos))
        _assert_cache_equal(ref, got)


def test_int8_round_trip():
    """Quantize and dequantize: the same int8 values (half to even), the
    same scales, the same dequantized values in f32 and bf16."""
    rng = np.random.default_rng(11)
    t = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 4
    t[0, 0, 0] = 0.0                                   # the 1e-8 scale floor
    t[1, 1, 1, :4] = [127.0, 63.5, -0.5, 1.5]          # exact halves
    rq, rs = RB._quantize_kv(jnp.asarray(t))
    tq, ts = PB._quantize_kv(torch.from_numpy(t))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    for dt in DTYPES:
        jd, td = DTYPES[dt]
        np.testing.assert_array_equal(_np(PB._dequantize_kv(tq, ts, td)),
                                      _np(RB._dequantize_kv(rq, rs, jd)))
