"""The port's checkpoints against the reference's format.

* The port's own manager: a round trip of f32, bf16 and int32 leaves bit
  for bit, ``keep_last`` retention, and a crashed ``.tmp`` cleared by the
  next save.
* A reference checkpoint of a bf16 model and its AdamW state (the
  reference's numpy writes bf16 as ``'<V2'``) restores in the port to the
  same parameters and optimizer state, bit for bit, through
  ``restore_train_state``; the two packages write the same manifest
  (paths, shapes, dtype names) for the same state.
* A checkpoint written by the port restores in the reference's manager to
  the same bits.
* ``interop.lm_arrays_from_params`` inverts ``lm_params_from_arrays``:
  the reference's stacked numpy tree back, bit for bit (bf16 widened to
  f32), for a decoder with a remainder layer and the encoder-decoder.
* Restore onto ZeRO-1 shards: each of four data ranks reads its part of
  ``m`` and ``v`` from the memory-mapped leaves, equal to its part of the
  whole (a stacked leaf sharded on its layers axis: the owned layers only).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.ckpt.manager import CheckpointManager as RManager  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager, _flatten  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    lm_arrays_from_params, lm_params_from_arrays, train_state_from_arrays,
)
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.sharding.rules import default_rules  # noqa: E402
from repro_torch.train import loop as PL  # noqa: E402

from tests.test_torch_lm_model import _ref_params, ref_weights  # noqa: E402

ARCHS = ("olmo-1b", "gemma3-4b", "whisper-tiny")  # dense; cycles + remainder; encdec


def test_roundtrip_retention_and_tmp_cleanup(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=g), "b": [torch.randn(5, generator=g).bfloat16()],
              "empty": {}, "n": np.arange(6, dtype=np.int64)}
    opt = {"step": torch.tensor(7, dtype=torch.int32)}
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crashed write
    for step in (1, 2, 3):
        mgr.save(step, params, opt)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    tree, manifest = mgr.restore(template={"params": params, "opt": opt})
    assert manifest["step"] == 3
    assert manifest["paths"] == ["['opt']['step']", "['params']['b'][0]", "['params']['n']",
                                 "['params']['w']"]
    assert tree["params"]["b"][0].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(tree["params"]), tree_leaves(
            {k: params[k] for k in sorted(params)})):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert int(tree["opt"]["step"]) == 7
    flat, _ = mgr.restore(step=2)
    assert sorted(flat) == manifest["paths"]


def _same(a, b) -> None:
    """Two trees equal bit for bit, leaf by leaf at the same paths."""
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def _ref_state(arch, **over):
    """A bf16 reduced model's parameters and an AdamW state after one
    update, in the reference."""
    # a name of its own: the reference caches abstract shapes by name and depth
    base = RC.get_reduced(arch)
    rcfg = dataclasses.replace(base, dtype="bfloat16", name=base.name + "-bf16", **over)
    tree = ref_weights(rcfg, 3)
    params = _ref_params(tree, RM.abstract_params(rcfg)[0])
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
    new, opt, _ = jax.jit(RO.adamw_update, static_argnums=0)(
        RO.AdamWConfig(), params, grads, RO.init_opt_state(params))
    return rcfg, new, opt


def _port_model(arch, params, **over):
    pcfg = dataclasses.replace(PC.get_reduced(arch), dtype="bfloat16", **over)
    arrays = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    return pcfg, lm_params_from_arrays(pcfg, arrays, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_port(tmp_path, arch):
    rcfg, params, opt = _ref_state(arch)
    RManager(str(tmp_path / "ref")).save(5, params, opt)
    pcfg, model = _port_model(arch, params)
    _, sh = PL.make_train_step(model, None, default_rules(None), PL.TrainConfig())
    got_p, got_opt, step = CheckpointManager(str(tmp_path / "ref")).restore_train_state(
        model, None, sh)
    assert step == 5
    _same(got_p, model.params)
    want = train_state_from_arrays(pcfg, jax.tree.map(np.asarray, opt), device="cpu")
    for key in ("m", "v"):
        _same(got_opt[key], want[key])
    assert int(got_opt["step"]) == int(want["step"]) == 1
    # the port writes the same manifest for the same state
    PL.save_train_state(CheckpointManager(str(tmp_path / "port")), model, 5, got_p, got_opt, sh)
    manifests = [json.load(open(tmp_path / d / "step_00000005" / "manifest.json"))
                 for d in ("ref", "port")]
    for key in ("paths", "leaves", "n_leaves", "step"):
        assert manifests[0][key] == manifests[1][key], key
    assert "bfloat16" in {leaf["dtype"] for leaf in manifests[0]["leaves"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_reference(tmp_path, arch):
    rcfg, params, opt = _ref_state(arch)
    pcfg, model = _port_model(arch, params)
    popt = train_state_from_arrays(pcfg, jax.tree.map(np.asarray, opt), device="cpu")
    _, sh = PL.make_train_step(model, None, default_rules(None), PL.TrainConfig())
    PL.save_train_state(CheckpointManager(str(tmp_path)), model, 9,
                        tree_map(lambda t: t.detach(), model.params), popt, sh)
    shapes, _ = RM.abstract_params(rcfg)
    template = {"params": shapes, "opt": jax.eval_shape(RO.init_opt_state, shapes)}
    tree, manifest = RManager(str(tmp_path)).restore(template=template)
    assert manifest["step"] == 9
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves({"params": params, "opt": opt})):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":  # the reference's numpy reads '<V2' raw
            np.testing.assert_array_equal(np.asarray(a).view(np.uint16), b.view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(a), b)


class _FakeMesh:
    """A (data 4, model 1) DeviceMesh's surface as rank ``rank`` sees it;
    no process group (a restore only reads)."""

    mesh_dim_names = ("data", "model")
    shape = (4, 1)

    def __init__(self, rank):
        self.rank = rank

    def get_local_rank(self, ax):
        return self.rank if ax == "data" else 0

    def get_group(self, ax):
        return None


# olmo at 4 layers: 4 stacked cycles, owned one a rank; gemma3's one cycle
# and remainder layer shard inside each layer's tensors
@pytest.mark.parametrize("arch,over", [("olmo-1b", {"n_layers": 4}), ("gemma3-4b", {})])
def test_restore_onto_zero1_shards(tmp_path, arch, over):
    rcfg, params, opt = _ref_state(arch, **over)
    RManager(str(tmp_path)).save(5, params, opt)
    pcfg, model = _port_model(arch, params, **over)
    mgr = CheckpointManager(str(tmp_path))
    _, sh = PL.make_train_step(model, None, default_rules(None), PL.TrainConfig())
    _, whole, _ = mgr.restore_train_state(model, None, sh)
    owned = 0
    for r in range(4):
        mesh = _FakeMesh(r)
        _, sh_r = PL.make_train_step(model, mesh, default_rules(mesh),
                                     PL.TrainConfig(zero1=True))
        places = sh_r["placements"]
        got_p, got, _ = mgr.restore_train_state(model, mesh, sh_r)
        _same(got_p, model.params)
        for key in ("m", "v"):
            def check(part, full, pl):
                want = full if pl is None else pl.local(full)
                assert (part is None) == (want is None)
                if want is not None:
                    assert torch.equal(part, want)
                return pl is not None and pl.dim is None and want is not None

            owned += sum(tree_leaves(tree_map(check, got[key], whole[key], places)))
    # a stacked leaf sharded on its layers axis is owned layer by layer
    assert bool(owned) == (rcfg.n_layers == 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_arrays_from_params_inverts_lm_params_from_arrays(arch, dtype):
    base = RC.get_reduced(arch)
    rcfg = dataclasses.replace(base, dtype=dtype, name=f"{base.name}-{dtype}")
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, rcfg.jnp_dtype).astype(jnp.float32)),
                        ref_weights(rcfg, 6))
    pcfg = dataclasses.replace(PC.get_reduced(arch), dtype=dtype)
    back = lm_arrays_from_params(pcfg, lm_params_from_arrays(pcfg, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
