"""Carry an algorithm instance or packed kernel operands across packages.

The port never imports the reference package. These functions take plain
data — numpy arrays and scalars — so a caller holding a reference
``AlgoInstance`` or the numpy form of its ``pack_algorithm`` output can hand
the very same instance and operands to the port:

* :func:`algo_fields` reads an instance of either package into such a dict
  (attribute access only, no import);
* :func:`algo_from_arrays` builds the port's :class:`AlgoInstance` from it
  (``exact_fn`` is dropped);
* :func:`operands_from_arrays` turns packed operands into torch tensors on a
  device, with the dtypes the kernel wrapper takes;
* :func:`delta_fields` reads a ``GraphDelta`` of either package into plain
  data, and :func:`delta_from_arrays` builds the port's
  :class:`~repro_torch.graphs.delta.GraphDelta` from it. A prior converged
  state crosses as its numpy ``x``;
* :func:`lm_params_from_arrays` loads the numpy form of a reference LM
  parameter tree into the port's :class:`~repro_torch.models.model.Model`,
  and :func:`lm_caches_from_arrays` turns a reference decode-cache tree into
  the port's per-layer caches.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.engine.algorithms import AlgoInstance, Semiring
from repro_torch.graphs.delta import GraphDelta
from repro_torch.models.layers import tree_map
from repro_torch.models.model import Model, ModelConfig
from repro_torch.models.transformer import _layer_plan

_ARRAY_FIELDS = ("src", "dst", "w", "x0", "c", "fixed")
_SCALAR_FIELDS = ("name", "n", "combine", "residual", "eps", "monotone_dir")


def algo_fields(algo: Any) -> dict:
    """The fields of an AlgoInstance-like object as numpy arrays and host
    scalars; the semiring as its three fields ``reduce``, ``edge_op`` and
    ``identity``."""
    out = {f: np.asarray(getattr(algo, f)) for f in _ARRAY_FIELDS}
    out.update({f: getattr(algo, f) for f in _SCALAR_FIELDS})
    sr = algo.semiring
    out["semiring"] = {"reduce": sr.reduce, "edge_op": sr.edge_op,
                       "identity": float(sr.identity)}
    out["params"] = getattr(algo, "params", None)
    return out


def algo_from_arrays(fields: dict) -> AlgoInstance:
    """Build the port's AlgoInstance from :func:`algo_fields`-style data."""
    sr = fields["semiring"]
    semiring = Semiring(sr["reduce"], sr["edge_op"])
    if "identity" in sr and float(sr["identity"]) != semiring.identity:
        raise ValueError(
            f"semiring identity {sr['identity']} disagrees with "
            f"{semiring} (identity {semiring.identity})"
        )
    return AlgoInstance(
        name=str(fields["name"]),
        n=int(fields["n"]),
        src=np.asarray(fields["src"], np.int32).copy(),
        dst=np.asarray(fields["dst"], np.int32).copy(),
        w=np.asarray(fields["w"], np.float32).copy(),
        x0=np.asarray(fields["x0"], np.float32).copy(),
        c=np.asarray(fields["c"], np.float32).copy(),
        fixed=np.asarray(fields["fixed"], bool).copy(),
        semiring=semiring,
        combine=str(fields["combine"]),
        residual=str(fields["residual"]),
        eps=float(fields["eps"]),
        monotone_dir=int(fields["monotone_dir"]),
        params=fields.get("params"),
    )


_INT_KEYS = ("rowptr", "tilecols", "tilerows", "revptr", "revrows", "dirty")
_FLOAT_KEYS = ("tiles", "c", "x0", "fixed", "x")


def operands_from_arrays(packed: dict, device: str | torch.device = "cuda") -> dict:
    """Torch tensors on ``device`` from the numpy form of packed kernel
    operands (the keys of ``pack_algorithm``'s output). Index arrays become
    int32, state and tile arrays float32, each a fresh contiguous buffer;
    other entries pass through unchanged."""
    out: dict = {}
    for k, v in packed.items():
        if k in _INT_KEYS:
            out[k] = torch.tensor(np.asarray(v, np.int32), device=device)
        elif k in _FLOAT_KEYS:
            out[k] = torch.tensor(np.asarray(v, np.float32), device=device)
        else:
            out[k] = v
    return out


_DELTA_ARRAYS = ("add_src", "add_dst", "del_src", "del_dst", "rew_src",
                 "rew_dst", "rew_w")


def delta_fields(delta: Any) -> dict:
    """The fields of a GraphDelta-like object as numpy arrays (``add_w``
    stays None when absent) and ``n_add`` as an int."""
    out = {f: np.asarray(getattr(delta, f)) for f in _DELTA_ARRAYS}
    add_w = getattr(delta, "add_w", None)
    out["add_w"] = None if add_w is None else np.asarray(add_w)
    out["n_add"] = int(delta.n_add)
    return out


def delta_from_arrays(fields: dict) -> GraphDelta:
    """Build the port's GraphDelta from :func:`delta_fields`-style data."""
    kw = {f: np.asarray(fields[f]).copy() for f in _DELTA_ARRAYS}
    add_w = fields.get("add_w")
    return GraphDelta(n_add=int(fields["n_add"]),
                      add_w=None if add_w is None else np.asarray(add_w).copy(),
                      **kw)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as JAX hands them out) as a
    fresh tensor on ``device``, cast to ``dtype`` when given."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype)


def _per_layer(cfg: ModelConfig, cycles: list, rem: list) -> list:
    """The reference's depth layout (``cycles[j]`` stacked over cycles,
    then ``rem[i]``) as one entry per layer in execution order."""
    n_cycles, _ = _layer_plan(cfg)
    layers = [tree_map(lambda a, i=i: a[i], cycles[j])
              for i in range(n_cycles) for j in range(len(cfg.pattern))]
    return layers + list(rem)


def lm_params_from_arrays(cfg: ModelConfig, tree: dict, device="cuda") -> Model:
    """The port's Model holding the reference's parameters: ``tree`` is the
    reference's parameter pytree as numpy (``emb``, ``final_norm``,
    ``cycles[j]`` stacked over cycles, ``rem[i]``); every array is cast to
    the model dtype."""
    dtype = cfg.torch_dtype
    layers = _per_layer(cfg, tree["cycles"], tree["rem"])
    params = {
        "emb": _tensor(tree["emb"], device, dtype),
        "final_norm": tree_map(lambda a: _tensor(a, device, dtype), tree["final_norm"]),
        "layers": [tree_map(lambda a: _tensor(a, device, dtype), p) for p in layers],
    }
    return Model(cfg, device=device, params=params)


def lm_caches_from_arrays(cfg: ModelConfig, tree: dict, device="cuda") -> list[dict]:
    """The port's per-layer decode caches from a reference cache tree
    (``{"cycles": [...], "rem": [...]}`` as numpy), dtypes kept."""
    layers = _per_layer(cfg, tree["cycles"], tree["rem"])
    return [tree_map(lambda a: _tensor(a, device), c) for c in layers]
