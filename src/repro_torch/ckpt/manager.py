"""Atomic, elastic checkpointing in the reference's format.

Layout per step, the reference's exactly, so that a checkpoint written by
either package restores in the other:

    <dir>/step_000123.tmp/        (written first)
        manifest.json             (step, n_leaves, leaves, paths, extra)
        arr_00000.npy ...         (one .npy per leaf, *full* array)
    <dir>/step_000123/            (atomic rename on completion)

Leaves are numbered in JAX's flattening order of ``{"params": ...,
"opt": ...}``: dict keys sorted, lists in order, None and empty dicts
holding no leaf; each leaf's path is its JAX key string
(``['params']['cycles'][0]['attn']['wq']``). A model's trees are written in
the reference's *stacked* layout (``interop.reference_layout``). bf16
leaves are written as the reference's numpy writes them, two raw bytes an
element under the descr ``'<V2'`` with ``"bfloat16"`` in the manifest, and
read back as int16 viewed as ``torch.bfloat16``: no ``ml_dtypes`` needed.

* atomicity: a checkpoint is visible iff its directory lost the ``.tmp``
  suffix; a crash mid-write leaves a ``.tmp`` that restore ignores and the
  next save removes.
* elastic restore: leaves hold their full logical shape, so a restore can
  take any rank's shard; each ``.npy`` is memory-mapped and only the
  shard is read (``restore(shardings=...)``).
* retention: the ``keep_last`` newest checkpoints are kept.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_BF16 = "bfloat16"


def _flatten(tree, path: str = "", tuples_are_leaves: bool = False) -> list:
    """(JAX key string, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{path}[{k!r}]", tuples_are_leaves)]
    if isinstance(tree, list) or (isinstance(tree, tuple) and not tuples_are_leaves):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{path}[{i}]", tuples_are_leaves)]
    return [(path, tree)]


def _unflatten(template, leaves: list):
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(template)


def _write(path: str, leaf) -> tuple[list, str]:
    """One leaf as ``.npy``; (shape, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False, "shape": tuple(t.shape)})
                f.write(raw.tobytes())
            return list(t.shape), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _read(path: str, dtype: str, index=None) -> torch.Tensor:
    """A leaf (its ``index`` when given, read through a memory map)."""
    mm = np.load(path, mmap_mode="r")
    arr = np.array(mm if index is None else mm[index])
    if dtype == _BF16 or arr.dtype.kind == "V":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, params, opt_state=None, extra: dict | None = None):
        """Write ``{"params": params, "opt": opt_state}`` (trees of tensors,
        numpy arrays or scalars) as checkpoint ``step``; returns its path."""
        tree = {"params": params}
        if opt_state is not None:
            tree["opt"] = opt_state
        flat = _flatten(tree)
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "n_leaves": len(flat), "leaves": [], "extra": extra or {},
                    "paths": [p for p, _ in flat]}
        for i, (path, leaf) in enumerate(flat):
            shape, dtype = _write(os.path.join(tmp, f"arr_{i:05d}.npy"), leaf)
            manifest["leaves"].append({"shape": shape, "dtype": dtype, "path": path})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, template=None, shardings=None):
        """(tree, manifest). Leaves are CPU tensors (bf16 ones included).

        template: a tree of the checkpoint's structure (any leaves); without
        it the result is a flat dict keyed by path. shardings: a tree
        matching ``template`` whose leaves are indexes (tuples of slices, ``()``
        for the whole array): this rank's shard of each leaf, read from a
        memory-mapped ``.npy`` so only the shard is loaded.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints in " + self.dir)
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        n = manifest["n_leaves"]
        index = ([idx for _, idx in _flatten(shardings, tuples_are_leaves=True)]
                 if shardings is not None else [None] * n)
        if len(index) != n:
            raise ValueError(f"shardings has {len(index)} leaves, the checkpoint {n}")
        arrays = [_read(os.path.join(d, f"arr_{i:05d}.npy"), manifest["leaves"][i]["dtype"],
                        index[i]) for i in range(n)]
        if template is not None:
            return _unflatten(template, arrays), manifest
        return {manifest["leaves"][i]["path"]: arrays[i] for i in range(n)}, manifest

    def restore_train_state(self, model, mesh, shardings, step=None):
        """For the train loop: (params, opt_state, step) in the port's
        layout on the model's device, this rank's ZeRO-1 shards of ``m``
        and ``v`` read from the memory-mapped leaves (``shardings`` is what
        ``train.loop.make_train_step`` returned)."""
        from repro_torch.train.loop import restore_layout

        return restore_layout(self, model, shardings, step)
