"""Decoder-only LM assembled from a layer-kind pattern.

The reference scans full *cycles* of the pattern over stacked parameters
and unrolls the remainder layers after them. The port runs the same layers
in a plain Python loop in that execution order: cycle ``i``, kind ``j`` is
layer ``i * len(pattern) + j``, and the remainder layers come last. The
parameters are ``{"emb", "final_norm", "layers": [one dict per layer]}`` and
the decode caches a list of per-layer dicts (K/V caches, or a recurrent
block's state), both in that order. With ``cfg.decode_seq_shard`` and a
mesh, ``decode_step`` runs the sequence-sharded split-KV decode on this
rank's shards (:func:`shard_caches`, :func:`decode_rows`). Without caches,
each cycle of layers runs under ``cfg.remat`` (``models.remat``).

``tp=`` (``sharding.tp.TPContext``) runs every entry point on this rank's
shards of the weights over the mesh's "model" axis: the training forward,
and serving, whose caches are this rank's part (:func:`init_caches`) and
whose logits are gathered whole over the vocab split.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import blocks as B
from repro_torch.models.layers import apply_norm, dtype_scalar, init_embedding, init_norm
from repro_torch.models.remat import maybe_remat


def _layer_plan(cfg):
    c = len(cfg.pattern)
    n_cycles = cfg.n_layers // c
    rem = cfg.n_layers - n_cycles * c
    return n_cycles, [cfg.pattern[i] for i in range(rem)]


def layer_kinds(cfg) -> list[str]:
    """The kind of every layer, in execution order."""
    n_cycles, rem_kinds = _layer_plan(cfg)
    return list(cfg.pattern) * n_cycles + rem_kinds


def init_params(cfg, generator: Optional[torch.Generator] = None, device=None):
    """(params, specs). Draws from ``generator`` on its device (embedding
    first, then the layers in execution order); with ``device="meta"`` it
    allocates nothing and needs no generator."""
    device = torch.device(device if device is not None else generator.device)
    dtype = cfg.torch_dtype
    params, specs = {}, {}
    params["emb"], specs["emb"] = init_embedding(generator, cfg.vocab, cfg.d_model, dtype, device)
    params["final_norm"], specs["final_norm"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    params["layers"], specs["layers"] = [], []
    for kind in layer_kinds(cfg):
        p, s = B.block_init(kind, generator, cfg, dtype, device)
        params["layers"].append(p)
        specs["layers"].append(s)
    return params, specs


# ---------------------------------------------------------------------------

def _run_layers(cfg, params, x, positions, caches=None, decode=False, mesh=None, tp=None,
                share=None):
    """Shared depth loop. caches: None | list of per-layer dicts.

    Each full cycle of the pattern runs as one body, under ``cfg.remat``
    (``models.remat``) when there are no caches and no decode, as the
    reference wraps its scanned cycle body; the remainder layers follow.
    """
    n_cycles, rem_kinds = _layer_plan(cfg)
    c = len(cfg.pattern)
    layers = params["layers"]
    layer_caches = caches if caches is not None else [None] * cfg.n_layers

    def span(kinds, x, aux, ps, cs):
        new = []
        for kind, p, cache in zip(kinds, ps, cs):
            x, nc, a = B.block_apply(kind, cfg, p, x, positions, cache=cache,
                                     decode=decode, mesh=mesh, tp=tp,
                                     share=share)
            aux = aux + a
            new.append(nc)
        return x, aux, new

    cycle = maybe_remat(cfg.remat if caches is None and not decode else "none", span)
    aux, new_caches = 0.0, []
    for i in range(n_cycles + 1):
        lo = i * c
        run, kinds = (cycle, cfg.pattern) if i < n_cycles else (span, rem_kinds)
        hi = lo + len(kinds)
        x, aux, new = run(kinds, x, aux, layers[lo:hi], layer_caches[lo:hi])
        new_caches.extend(new)
    return x, (new_caches if caches is not None else None), aux


def _vocab_split(cfg, params, tp) -> bool:
    return tp is not None and params["emb"].shape[0] < cfg.vocab


def embed_tokens(cfg, params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """With ``tp`` and ``vocab`` split over the model axis, each rank looks
    up the tokens in its vocab range, zeroes the others and the group sums
    the rows (one term each: exact)."""
    dtype = cfg.torch_dtype
    if _vocab_split(cfg, params, tp):
        emb = params["emb"]
        local = tokens - tp.offset(emb.shape[0])
        mine = (local >= 0) & (local < emb.shape[0])
        rows = emb[torch.where(mine, local, 0)].to(dtype)
        x = tp.leave(torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype,
                                                                    device=rows.device)))
    else:
        x = params["emb"][tokens].to(dtype)
    return x * dtype_scalar(math.sqrt(cfg.d_model), dtype)


def logits_from(cfg, params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The tied logits (with ``vocab`` split, this rank's range of them)."""
    if _vocab_split(cfg, params, tp):
        x = tp.enter(x)
    # the product in the model dtype, then f32, as the reference rounds it
    return torch.matmul(x, params["emb"].t()).float()


def forward(cfg, params, tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None,
            caches=None, mesh=None, logits_positions: Optional[str] = None, tp=None,
            share=None):
    """Full-sequence forward. Returns (logits, new_caches, aux).

    logits_positions="last" computes logits for the final position only:
    the prefill path, where the (B, S, V) logit tensor would otherwise be
    the single largest compute and traffic term. ``tp``
    (``sharding.tp.TPContext``): the training forward on this rank's
    shards (``params``), the logits this rank's vocab range where
    ``vocab`` is split. ``share`` (``sharding.tp.BatchShare``): a
    data-parallel step's part of a global microbatch, over which the MoE
    takes its aux loss's statistics.
    """
    x = embed_tokens(cfg, params, tokens, tp)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches, aux = _run_layers(cfg, params, x, positions, caches=caches, mesh=mesh, tp=tp,
                                     share=share)
    if logits_positions == "last":
        x = x[:, -1:]
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    return logits_from(cfg, params, x, tp), new_caches, aux


def _vocab_parallel_ll(logits, idx, tp) -> torch.Tensor:
    """log p(idx) from this rank's range of the logits: the maximum over
    the group (MAX), the sum of exponentials and the target's logit, from
    the rank that holds it (two sums through the group)."""
    v_loc = logits.shape[-1]
    shifted = logits - tp.all_max(logits.amax(dim=-1))[..., None]
    sumexp = tp.leave(torch.exp(shifted).sum(dim=-1))
    local = idx - tp.offset(v_loc)
    mine = (local >= 0) & (local < v_loc)
    picked = torch.gather(shifted, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    return tp.leave(torch.where(mine, picked, 0.0)) - torch.log(sumexp)


def loss_fn(cfg, params, batch: dict, mesh=None, tp=None, share=None):
    """Next-token cross entropy (+ MoE aux). batch: tokens, labels[, prefix].
    With ``tp``, the cross entropy over the whole vocab from each rank's
    range of the logits (:func:`_vocab_parallel_ll`) where it is split.
    With ``share``, both are this rank's terms of the global microbatch's
    (:func:`cross_entropy`)."""
    logits, _, aux = forward(
        cfg, params, batch["tokens"], prefix_embeds=batch.get("prefix_embeds"), mesh=mesh,
        tp=tp, share=share,
    )
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # vision prefix: score text positions only
        logits = logits[:, -labels.shape[1]:]
    ce = cross_entropy(cfg, params, logits, labels, tp, share)
    return ce + aux, {"ce": ce, "aux": aux}


def cross_entropy(cfg, params, logits: torch.Tensor, labels: torch.Tensor, tp=None,
                  share=None):
    """The mean next-token cross entropy of ``labels`` (negative ones
    masked) under ``logits``; with ``tp`` and ``vocab`` split, from this
    rank's range of the logits (:func:`_vocab_parallel_ll`). With
    ``share`` (``sharding.tp.BatchShare``), the sum over this rank's rows
    divided by the global microbatch's scored tokens over the batch
    group's size: the mean over the group of these terms is the global
    microbatch's cross entropy (the reference divides after its sum)."""
    # negative labels index from the end (of the whole vocab), as the
    # reference's take_along_axis
    if _vocab_split(cfg, params, tp):
        idx = torch.where(labels < 0, labels + cfg.vocab, labels).long()
        ll = _vocab_parallel_ll(logits, idx, tp)
    else:
        logp = F.log_softmax(logits, dim=-1)
        idx = torch.where(labels < 0, labels + logits.shape[-1], labels).long()
        ll = torch.gather(logp, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = torch.clamp_min(torch.sum(mask), 1.0) if share is None else share.tokens
    return -torch.sum(ll * mask) / count


def _seq_shards(cfg, mesh) -> int:
    """The ranks of the sequence-sharded decode's axis (1: not sharded)."""
    if mesh is None or not cfg.decode_seq_shard:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(cfg.decode_seq_axis))


def init_caches(cfg, batch: int, max_seq: int, device, tp=None, mesh=None) -> list[dict]:
    """Empty decode caches of ``batch`` rows. With ``tp``, this rank's part
    (``blocks.block_cache``): a prefill's layout. With ``mesh`` too and
    ``cfg.decode_seq_shard``, the sequence-sharded decode's layout (each
    K/V cache this rank's shard of the slots, every KV head)."""
    dtype = cfg.torch_dtype
    kinds = layer_kinds(cfg)
    dims = tp.dims["layers"] if tp is not None else [None] * len(kinds)
    seq = _seq_shards(cfg, mesh)
    return [B.block_cache(kind, cfg, batch, max_seq, dtype, device, tp, d, seq)
            for kind, d in zip(kinds, dims)]


def decode_rows(cfg, mesh, batch: int) -> slice:
    """This rank's rows of a decode batch under the sequence-sharded
    decode: its contiguous shard over ``cfg.decode_batch_axes`` (all rows
    when that is None or not an axis of ``mesh``)."""
    ax = cfg.decode_batch_axes
    if ax is None or ax not in mesh.mesh_dim_names:
        return slice(0, batch)
    n = mesh.size(mesh.mesh_dim_names.index(ax))
    if batch % n:
        raise ValueError(f"a batch of {batch} does not split over {n} {ax!r} ranks")
    r = mesh.get_local_rank(ax)
    return slice(r * (batch // n), (r + 1) * (batch // n))


def shard_caches(cfg, caches: list[dict], mesh, tp=None) -> list[dict]:
    """This rank's shards of a prefill's decode caches (a decoder's, or an
    encoder-decoder's self-attention caches) for ``decode_step(...,
    mesh=mesh)`` with ``cfg.decode_seq_shard``: a K/V
    cache's slots (with their ``slot_pos``) by the rank's contiguous shard
    over ``cfg.decode_seq_axis``. Without ``tp`` the caches are whole and
    every entry's rows are taken by :func:`decode_rows`; with ``tp`` they
    are a prefill's on this rank's rows and shards (:func:`prefill`), and
    a K/V cache of this rank's KV heads is gathered over the model group
    first. Fresh tensors: the decode writes into them."""
    ax = cfg.decode_seq_axis
    n = mesh.size(mesh.mesh_dim_names.index(ax))
    r = mesh.get_local_rank(ax)
    kinds = ["attn+mlp"] * len(caches) if cfg.arch_type == "encdec" else layer_kinds(cfg)
    out = []
    for kind, c in zip(kinds, caches):
        b = next(iter(c.values())).shape[0]
        rows = slice(0, b) if tp is not None else decode_rows(cfg, mesh, b)
        if kind in B.ATTN_KINDS:
            if tp is not None and c["k"].shape[2] < cfg.n_kv:
                c = {k: v if k == "slot_pos" else tp.gather(v, dim=2) for k, v in c.items()}
            s_c = c["k"].shape[1]
            if s_c % n:
                raise ValueError(f"a cache of {s_c} slots does not split over {n} {ax!r} ranks")
            per = s_c // n
            out.append({k: v[rows, r * per:(r + 1) * per].clone() for k, v in c.items()})
        else:
            out.append({k: v[rows].clone() for k, v in c.items()})
    return out


def _whole_logits(cfg, params, logits: torch.Tensor, tp) -> torch.Tensor:
    """Serving's logits over the whole vocab: this rank's range gathered
    over the model group where ``vocab`` is split."""
    return tp.gather(logits, dim=-1) if _vocab_split(cfg, params, tp) else logits


def prefill(cfg, params, tokens: torch.Tensor, max_seq: int,
            prefix_embeds: Optional[torch.Tensor] = None, mesh=None, tp=None):
    """(last logits (B, 1, V), caches). With ``tp``, on this rank's shards
    (``params``) and rows (``tokens``): the caches are this rank's part,
    a prefill's layout (:func:`init_caches`; :func:`shard_caches` lays
    them out for the sequence-sharded decode)."""
    caches = init_caches(cfg, tokens.shape[0], max_seq, params["emb"].device, tp)
    logits, caches, _ = forward(
        cfg, params, tokens, prefix_embeds=prefix_embeds, caches=caches,
        mesh=mesh, logits_positions="last", tp=tp,
    )
    return _whole_logits(cfg, params, logits, tp), caches


def decode_step(cfg, params, caches: list[dict], tokens1: torch.Tensor, pos: torch.Tensor,
                mesh=None, tp=None):
    """tokens1: (B, 1) new token ids; pos: (B,) absolute positions. Writes
    the new token's K/V into ``caches`` and returns (logits, the per-layer
    caches, a recurrent layer's state anew). With ``tp``, on this rank's
    shards and its part of the caches; the logits are whole."""
    x = embed_tokens(cfg, params, tokens1, tp)
    x, new_caches, _ = _run_layers(cfg, params, x, pos, caches=caches, decode=True, mesh=mesh,
                                   tp=tp)
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    return _whole_logits(cfg, params, logits_from(cfg, params, x, tp), tp), new_caches
