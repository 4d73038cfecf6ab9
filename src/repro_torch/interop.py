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
  parameter tree (decoder-only or encoder-decoder) into the port's
  :class:`~repro_torch.models.model.Model`, and :func:`lm_caches_from_arrays`
  turns a reference decode-cache tree (K/V caches and recurrent states)
  into the port's per-layer caches;
* :func:`reference_layout` arranges any tree in the port's per-layer
  layout (parameters, optimizer moments, logical axes) in the reference's
  stacked one and :func:`port_layout` back, :func:`lm_arrays_from_params` (the inverse of
  :func:`lm_params_from_arrays`) gives the reference's numpy parameter
  tree, and :func:`train_state_from_arrays` brings the reference's
  optimizer state (``m``, ``v``, ``step``) into the port's layout.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.engine.algorithms import AlgoInstance, Semiring
from repro_torch.graphs.delta import GraphDelta
from repro_torch.models.layers import tree_map
from repro_torch.models.model import Model, ModelConfig, abstract_params
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


def _unstack(tree: dict, n: int) -> list:
    """A tree stacked over a leading axis of ``n`` as ``n`` trees."""
    return [tree_map(lambda a, i=i: a[i], tree) for i in range(n)]


def _as_dtypes(tree: Any, like: Any, device) -> Any:
    """``tree``'s arrays as tensors on ``device``, each of the dtype of the
    tensor at the same place in ``like``."""
    if isinstance(tree, dict):
        return {k: _as_dtypes(v, like[k], device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_dtypes(v, w, device) for v, w in zip(tree, like)]
    return _tensor(tree, device, like.dtype)


def _take_layer(x, i, n):
    return x if i is None else x[i]


def port_layout(cfg: ModelConfig, tree: dict, leaf: Callable = _take_layer) -> dict:
    """A tree in the reference's stacked parameter layout (the inverse of
    :func:`reference_layout`) in the port's per-layer one: each port leaf is
    ``leaf(x, i, n)`` of the reference leaf ``x`` it comes from, layer ``i``
    of the ``n`` that ``x`` stacks (``i`` None: ``x`` is not stacked);
    by default ``x[i]``."""
    def unstacked(t):
        return tree_map(lambda x: leaf(x, None, None), t)

    def stacked(t, i, n):
        return tree_map(lambda x: leaf(x, i, n), t)

    if cfg.arch_type == "encdec":
        out = {k: unstacked(tree[k]) for k in ("emb", "frontend_proj", "final_norm")}
        out["enc"] = [stacked(tree["enc"], i, cfg.enc_layers) for i in range(cfg.enc_layers)]
        out["dec"] = [stacked(tree["dec"], i, cfg.dec_layers) for i in range(cfg.dec_layers)]
        return out
    n_cycles, _ = _layer_plan(cfg)
    layers = [stacked(tree["cycles"][j], i, n_cycles)
              for i in range(n_cycles) for j in range(len(cfg.pattern))]
    return {"emb": unstacked(tree["emb"]), "final_norm": unstacked(tree["final_norm"]),
            "layers": layers + [unstacked(r) for r in tree["rem"]]}


def lm_params_from_arrays(cfg: ModelConfig, tree: dict, device="cuda") -> Model:
    """The port's Model holding the reference's parameters. ``tree`` is the
    reference's parameter pytree as numpy: for a decoder ``emb``,
    ``final_norm``, ``cycles[j]`` stacked over cycles and ``rem[i]``; for an
    encoder-decoder ``emb``, ``frontend_proj``, ``final_norm`` and
    ``enc``/``dec`` stacked over their layers. Every array is cast to the
    dtype the port gives that parameter (the model dtype, f32 for the
    RG-LRU's ``lambda``)."""
    shapes, _ = abstract_params(cfg)
    return Model(cfg, device=device, params=_as_dtypes(port_layout(cfg, tree), shapes, device))


def lm_caches_from_arrays(cfg: ModelConfig, tree: dict, device="cuda") -> list[dict]:
    """The port's per-layer decode caches from a reference cache tree as
    numpy, dtypes kept: ``{"cycles": [...], "rem": [...]}`` of K/V caches
    and recurrent states for a decoder, one dict stacked over ``dec_layers``
    for an encoder-decoder."""
    if cfg.arch_type == "encdec":
        layers = _unstack(tree, cfg.dec_layers)
    else:
        layers = _per_layer(cfg, tree["cycles"], tree["rem"])
    return [tree_map(lambda a: _tensor(a, device), c) for c in layers]


def _stack_trees(trees: list, stack: Callable, is_leaf: Callable) -> Any:
    """One tree whose leaves are ``stack`` of the leaves at that place in
    ``trees`` (None for no trees: the reference's empty cycle slot)."""
    if not trees:
        return None
    first = trees[0]
    if is_leaf(first):
        return stack(trees)
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees], stack, is_leaf) for k in first}
    return [_stack_trees([t[i] for t in trees], stack, is_leaf) for i in range(len(first))]


def _is_tensor(x) -> bool:
    return not isinstance(x, (dict, list))


def reference_layout(cfg: ModelConfig, tree: dict, stack: Callable,
                     is_leaf: Callable = _is_tensor) -> dict:
    """``tree`` in the port's layout (``layers`` in execution order, or
    ``enc``/``dec`` lists) in the reference's: ``cycles[j]`` holds layer
    ``j`` of every full cycle of the pattern, each leaf ``stack`` of that
    leaf over the cycles (None when no cycle is full), ``rem[i]`` the
    remainder layers as they are; an encoder-decoder's ``enc`` and ``dec``
    stacked over their layers. ``is_leaf`` tells leaves from the tree's
    dicts and lists (a tree of logical-axes tuples passes its own)."""
    if cfg.arch_type == "encdec":
        out = {k: tree[k] for k in ("emb", "frontend_proj", "final_norm")}
        out["enc"] = _stack_trees(tree["enc"], stack, is_leaf)
        out["dec"] = _stack_trees(tree["dec"], stack, is_leaf)
        return out
    n_cycles, rem = _layer_plan(cfg)
    c, layers = len(cfg.pattern), tree["layers"]
    return {"emb": tree["emb"], "final_norm": tree["final_norm"],
            "cycles": [_stack_trees([layers[i * c + j] for i in range(n_cycles)], stack,
                                    is_leaf) for j in range(c)],
            "rem": list(layers[n_cycles * c:])}


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_arrays_from_params(cfg: ModelConfig, params: dict) -> dict:
    """The reference's numpy parameter tree (the layout
    :func:`lm_params_from_arrays` takes) from the port's parameter tree or
    Model. bf16 leaves widen to f32 (exactly: numpy has no bf16 without
    ``ml_dtypes``); the reference's ``jnp.asarray(a, dtype)`` rounds them
    back to the same bits."""
    if isinstance(params, Model):
        params = params.params
    tree = reference_layout(cfg, params, lambda ts: torch.stack([t.detach().cpu() for t in ts]))
    return tree_map(lambda t: None if t is None else _numpy(t), tree)


def _leaf_tensor(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return _tensor(a, device, dtype)


def train_state_from_arrays(cfg: ModelConfig, opt: dict, device="cuda") -> dict:
    """The port's optimizer state from the reference's: ``opt`` holds
    ``m`` and ``v`` in the reference's stacked parameter layout (numpy
    arrays or tensors) and ``step``; ``m``/``v`` become per-layer f32
    tensors on ``device``, ``step`` an int32 scalar."""
    def layout(tree):
        return tree_map(lambda a: _leaf_tensor(a, device, torch.float32),
                        port_layout(cfg, tree))

    return {"m": layout(opt["m"]), "v": layout(opt["v"]),
            "step": _leaf_tensor(np.asarray(opt["step"], np.int32), device)}
