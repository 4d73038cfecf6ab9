"""Per-cell step builders: (arch x shape x mesh) -> a callable on this
rank's tensors and the abstract (meta) tensors it takes.

The same builders drive real execution and the dry-run: a cell's ``fn`` is
the train step (``train.loop.make_train_step``) or the serving prefill and
decode on this rank's shards over the "model" axis (``sharding.tp``), so it
runs on real tensors on the card and, unchanged, on fake tensors under
``launch.dryrun``. Where the reference hands ``jax.jit`` global shapes and
their shardings, a port cell carries this rank's part of every argument
(``Cell.args``) and the specs it was cut by (``Cell.in_shardings``, tuples
as ``sharding.rules`` writes them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.data.tokens import TokenBatch, _data_rank, shard_rows
from repro_torch.launch.shapes import SHAPES, WHISPER_ENC_FRAMES, ShapeCell
from repro_torch.models import blocks as B
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, ModelConfig, abstract_params
from repro_torch.sharding.rules import ShardingRules, axis_sizes, batch_axes_for_mesh
from repro_torch.sharding.tp import shard_params
from repro_torch.train.loop import (
    TrainConfig, init_opt_state, make_train_step, model_tp,
)

# ---------------------------------------------------------------- shardings


def _batch_axes(mesh, global_batch: int) -> tuple:
    """The batch axes of ``mesh`` that ``global_batch`` divides over,
    dropping the outermost until it does (the reference's rule)."""
    sizes = axis_sizes(mesh)
    ba = batch_axes_for_mesh(mesh)
    size = math.prod(sizes[a] for a in ba) if ba else 1
    while ba and global_batch % size != 0:
        ba = ba[1:] if len(ba) > 1 else ()
        size = math.prod(sizes[a] for a in ba) if ba else 1
    return ba


def _entry(ba: tuple):
    """A spec entry of the batch axes: None, one name, or the tuple."""
    return None if not ba else (ba[0] if len(ba) == 1 else tuple(ba))


def cache_shardings(cfg: ModelConfig, mesh, cache_shapes, batch_axes) -> list:
    """The spec of every leaf of the port's decode caches (``cache_shapes``:
    the whole caches, a list of per-layer dicts as ``init_caches`` makes
    them), by the reference's rule, dispatched on the leaf's key:

    * K/V caches split by sequence over "model" where
      ``cfg.decode_seq_shard`` is set; else by KV head where ``n_kv``
      divides over "model"; else replicated. Their int8 scales mirror them;
      ``slot_pos`` is split by sequence under ``decode_seq_shard`` only.
    * Every leaf split over ``batch_axes`` on its batch dimension, and any
      entry that does not divide its dimension dropped.

    The exceptions, where the port holds a leaf otherwise than the
    reference (``blocks.block_cache``), all of them recurrent states, which
    the reference splits over the batch alone: the RG-LRU's ``h`` and
    ``conv`` are split over "model" on their channels; the mLSTM's ``C``,
    ``n`` and ``m`` on their heads and the sLSTM's ``h``, ``c``, ``n`` and
    ``m`` on their heads' channels, where "model" divides the heads (under
    ``default_rules``: the dimensions that the rules split as ``ffn``). The
    reference's rule puts the batch axes of a remainder layer's recurrent
    state (a layer it does not stack) on dimension 1; the port on its batch
    dimension."""
    sizes = axis_sizes(mesh)
    m = sizes.get("model", 1)
    ba = _entry(tuple(batch_axes or ()))
    kinds = (["enc-dec self"] * len(cache_shapes) if cfg.arch_type == "encdec"
             else T.layer_kinds(cfg))
    kv_ok = cfg.n_kv % m == 0

    def guard(spec, shape):
        out = []
        for e, d in zip(spec, shape):
            axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
            out.append(e if e is not None and d % math.prod(sizes[a] for a in axes) == 0
                       else None)
        return tuple(out)

    def leaf(kind, key, t):
        nd = t.dim()
        if key in ("k", "v", "k_scale", "v_scale"):
            heads = [None] * (nd - 3)   # the head_dim of k/v
            if cfg.decode_seq_shard:
                spec = [ba, "model", None] + heads
            elif kv_ok:
                spec = [ba, None, "model"] + heads
            else:
                spec = [ba, None, None] + heads
        elif key == "slot_pos":
            spec = [ba, "model" if cfg.decode_seq_shard else None]
        elif kind == "rglru+mlp":     # h (B, d_rnn), conv (B, W-1, d_rnn)
            spec = [ba] + [None] * (nd - 2) + ["model"]
        elif kind in ("mlstm", "slstm"):
            inner = (B._mlstm_cfg if kind == "mlstm" else B._slstm_cfg)(cfg).d_inner
            heads_ok = cfg.n_heads % m == 0 and inner % m == 0
            spec = [ba, "model" if heads_ok else None] + [None] * (nd - 2)
        else:
            spec = [ba] + [None] * (nd - 1)
        return guard(spec, t.shape)

    return [{k: leaf(kind, k, t) for k, t in c.items()} for kind, c in zip(kinds, cache_shapes)]


# ------------------------------------------------------------------- inputs


def _meta(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> dict:
    """Meta-tensor stand-ins (global shapes and dtypes, the reference's)
    for every model input of this cell."""
    b, s = shape.global_batch, shape.seq
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "train":
        if cfg.arch_type == "encdec":
            return {"frames": _meta((b, s, cfg.d_model), f32),
                    "tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
        out = {"tokens": _meta((b, s - cfg.prefix_len), i32),
               "labels": _meta((b, s - cfg.prefix_len), i32)}
        if cfg.prefix_len:
            out["prefix_embeds"] = _meta((b, cfg.prefix_len, cfg.d_model), f32)
        return out
    if shape.kind == "prefill":
        if cfg.arch_type == "encdec":
            return {"frames": _meta((b, min(s, WHISPER_ENC_FRAMES), cfg.d_model), f32),
                    "tokens": _meta((b, s), i32)}
        out = {"tokens": _meta((b, s - cfg.prefix_len), i32)}
        if cfg.prefix_len:
            out["prefix_embeds"] = _meta((b, cfg.prefix_len, cfg.d_model), f32)
        return out
    if shape.kind == "decode":
        out = {"tokens": _meta((b, 1), i32), "pos": _meta((b,), i32)}
        if cfg.arch_type == "encdec":
            out["enc_out"] = _meta((b, WHISPER_ENC_FRAMES, cfg.d_model), cfg.torch_dtype)
        return out
    raise ValueError(shape.kind)


# -------------------------------------------------------------------- cells


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeCell
    fn: object                  # callable on this rank's tensors
    args: tuple                 # this rank's part of each argument (meta tensors)
    in_shardings: tuple         # the specs the arguments were cut by
    donate: tuple = ()          # arguments the step writes into (the decode caches)
    notes: list = dataclasses.field(default_factory=list)
    tp: object = None           # the "model" axis's TPContext (None: one rank)


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's rows of a global batch over ``n`` data-parallel ranks
    (the shape alone: the cell's tensors are abstract)."""
    return _meta((t.shape[0] // n,) + tuple(t.shape[1:]), t.dtype)


def train_rows(ins: dict, microbatches: int, dp: int, rank: int) -> TokenBatch:
    """Data rank ``rank`` of ``dp``'s part of a train cell's global inputs
    ``ins`` (the shapes alone), laid out for ``microbatches`` as
    ``data.tokens.TokenDataset`` lays out its rows: its part of each
    microbatch (``shard_rows``; none where a microbatch's rows do not reach
    it), the batch carrying the layout the train step reads."""
    held, shard = shard_rows(next(iter(ins.values())).shape[0], microbatches, dp, rank)
    batch = TokenBatch({k: _meta((microbatches * held,) + tuple(t.shape[1:]), t.dtype)
                        for k, t in ins.items()})
    batch.microbatches, batch.shard_rows = microbatches, shard
    return batch


def build_cell(cfg: ModelConfig, shape_name: str, mesh, rules: ShardingRules,
               tcfg: Optional[TrainConfig] = None) -> Cell:
    """The cell of ``cfg`` at ``shape_name`` on ``mesh`` (a DeviceMesh over
    the process group that is up: real ranks, or the dry-run's fake ones)
    under ``rules``. Its ``fn`` takes this rank's tensors: the train step's
    ``(params, opt_state, batch)``, prefill's ``(params, batch)`` and
    decode's ``(params, caches, batch)``; ``args`` are meta tensors of
    their shapes."""
    shape = SHAPES[shape_name]
    ba = _batch_axes(mesh, shape.global_batch)
    cfg = dataclasses.replace(cfg, decode_batch_axes=_entry(ba))
    model = Model(cfg, device="meta", params=abstract_params(cfg)[0])
    _, _, param_sh, tp = model_tp(model, mesh, rules)
    notes = list(rules.fallbacks)
    dp = math.prod(axis_sizes(mesh)[a] for a in ba) if ba else 1
    ins = input_specs(cfg, shape)
    batch = {k: _rows(v, dp) for k, v in ins.items()}
    bspec = (_entry(ba),)
    params = shard_params(model.params, tp)

    if shape.kind == "train":
        tcfg = tcfg or TrainConfig()
        step, sh = make_train_step(model, mesh, rules, tcfg)
        opt = init_opt_state(params, sh["placements"])
        rank, count = _data_rank(mesh)
        batch = train_rows(ins, tcfg.row_microbatches, count, rank)
        return Cell(cfg.name, shape, step, (params, opt, batch),
                    (param_sh, sh["opt"], {k: bspec for k in batch}), notes=notes, tp=tp)

    if shape.kind == "prefill":
        if cfg.arch_type == "encdec":
            def fn(params, batch):
                with torch.inference_mode():
                    return E.prefill(cfg, params, batch["frames"], batch["tokens"], shape.seq,
                                     tp=tp)
        else:
            def fn(params, batch):
                with torch.inference_mode():
                    return T.prefill(cfg, params, batch["tokens"], shape.seq,
                                     prefix_embeds=batch.get("prefix_embeds"), mesh=mesh, tp=tp)
        return Cell(cfg.name, shape, fn, (params, batch),
                    (param_sh, {k: bspec for k in batch}), notes=notes, tp=tp)

    # decode: this rank's part of the caches, in the decode's layout
    rows = shape.global_batch // dp
    if cfg.arch_type == "encdec":
        caches = E.init_dec_caches(cfg, rows, shape.seq, "meta", tp, mesh)
        whole = E.init_dec_caches(cfg, shape.global_batch, shape.seq, "meta")

        def fn(params, caches, batch):
            with torch.inference_mode():
                return E.decode_step(cfg, params, caches, batch["enc_out"], batch["tokens"],
                                     batch["pos"], tp=tp, mesh=mesh)
    else:
        caches = T.init_caches(cfg, rows, shape.seq, "meta", tp, mesh)
        whole = T.init_caches(cfg, shape.global_batch, shape.seq, "meta")

        def fn(params, caches, batch):
            with torch.inference_mode():
                return T.decode_step(cfg, params, caches, batch["tokens"], batch["pos"],
                                     mesh=mesh, tp=tp)
    cache_sh = cache_shardings(cfg, mesh, whole, ba)
    return Cell(cfg.name, shape, fn, (params, caches, batch),
                (param_sh, cache_sh, {k: bspec for k in batch}), donate=(1,), notes=notes,
                tp=tp)
