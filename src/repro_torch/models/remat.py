"""Rematerialisation (activation checkpointing) of the training forward.

The reference wraps each cycle of layers in ``jax.checkpoint`` under the
config's ``remat`` policy; :func:`maybe_remat` is its counterpart on
``torch.utils.checkpoint`` (non-reentrant):

* ``"none"``: the function itself;
* ``"full"``: ``checkpoint(fn)``, only the cycle's inputs are kept;
* ``"dots"``: selective checkpointing that keeps the outputs of the matrix
  products (``jax.checkpoint_policies.dots_saveable``);
* ``"save_tp"``: selective checkpointing that keeps only the tensors named
  ``"tp_attn_out"`` and ``"tp_mlp_out"`` (each layer's attention and MLP
  outputs) by :func:`checkpoint_name`.

Remat changes what is kept for the backward pass, never the values: the
recomputation runs the same ops on the same inputs. It applies only while
autograd records (``torch.is_grad_enabled()``); a forward under
``no_grad`` or ``inference_mode`` runs the function as it is.
"""
from __future__ import annotations

import threading
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

SAVE_TP_NAMES = ("tp_attn_out", "tp_mlp_out")
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}
_STATE = threading.local()


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` itself, or, inside a ``"save_tp"`` rematerialised function
    that keeps ``name``, a copy of ``x`` that the policy saves."""
    if name not in getattr(_STATE, "names", ()):
        return x
    _STATE.tagging = True
    try:
        return x.clone()
    finally:
        _STATE.tagging = False


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _names_policy(ctx, op, *args, **kwargs):
    if getattr(_STATE, "tagging", False):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _naming(fn: Callable, names: tuple) -> Callable:
    def run(*args):
        prev = getattr(_STATE, "names", ())
        _STATE.names = names
        try:
            return fn(*args)
        finally:
            _STATE.names = prev
    return run


def maybe_remat(remat: str, fn: Callable) -> Callable:
    """``fn`` (tensor arguments) under the remat policy ``remat``."""
    if remat == "none":
        return fn
    if remat == "full":
        body, context_fn = fn, None
    elif remat == "dots":
        body = fn
        context_fn = lambda: create_selective_checkpoint_contexts(_dots_policy)  # noqa: E731
    elif remat == "save_tp":
        body = _naming(fn, SAVE_TP_NAMES)
        context_fn = lambda: create_selective_checkpoint_contexts(_names_policy)  # noqa: E731
    else:
        raise ValueError(remat)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if context_fn is None:
            return checkpoint(body, *args, use_reentrant=False)
        return checkpoint(body, *args, use_reentrant=False, context_fn=context_fn)

    return wrapped
