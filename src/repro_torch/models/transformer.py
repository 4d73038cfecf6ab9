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

def _run_layers(cfg, params, x, positions, caches=None, decode=False, mesh=None):
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
                                     decode=decode, mesh=mesh)
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


def embed_tokens(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    dtype = cfg.torch_dtype
    x = params["emb"][tokens].to(dtype)
    return x * dtype_scalar(math.sqrt(cfg.d_model), dtype)


def logits_from(cfg, params, x: torch.Tensor) -> torch.Tensor:
    # the product in the model dtype, then f32, as the reference rounds it
    return torch.matmul(x, params["emb"].t()).float()


def forward(cfg, params, tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None,
            caches=None, mesh=None, logits_positions: Optional[str] = None):
    """Full-sequence forward. Returns (logits, new_caches, aux).

    logits_positions="last" computes logits for the final position only:
    the prefill path, where the (B, S, V) logit tensor would otherwise be
    the single largest compute and traffic term.
    """
    x = embed_tokens(cfg, params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches, aux = _run_layers(cfg, params, x, positions, caches=caches, mesh=mesh)
    if logits_positions == "last":
        x = x[:, -1:]
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    return logits_from(cfg, params, x), new_caches, aux


def loss_fn(cfg, params, batch: dict, mesh=None):
    """Next-token cross entropy (+ MoE aux). batch: tokens, labels[, prefix]."""
    logits, _, aux = forward(
        cfg, params, batch["tokens"], prefix_embeds=batch.get("prefix_embeds"), mesh=mesh
    )
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # vision prefix: score text positions only
        logits = logits[:, -labels.shape[1]:]
    logp = F.log_softmax(logits, dim=-1)
    # negative labels index from the end, as the reference's take_along_axis
    idx = torch.where(labels < 0, labels + logits.shape[-1], labels).long()
    ll = torch.gather(logp, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = -torch.sum(ll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def init_caches(cfg, batch: int, max_seq: int, device) -> list[dict]:
    dtype = cfg.torch_dtype
    return [B.block_cache(kind, cfg, batch, max_seq, dtype, device)
            for kind in layer_kinds(cfg)]


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


def shard_caches(cfg, caches: list[dict], mesh) -> list[dict]:
    """This rank's shards of full decode caches (a prefill's) for
    ``decode_step(..., mesh=mesh)`` with ``cfg.decode_seq_shard``: every
    entry's rows by :func:`decode_rows`, and a K/V cache's slots (with
    their ``slot_pos``) by the rank's contiguous shard over
    ``cfg.decode_seq_axis``. Fresh tensors: the decode writes into them."""
    ax = cfg.decode_seq_axis
    n = mesh.size(mesh.mesh_dim_names.index(ax))
    r = mesh.get_local_rank(ax)
    out = []
    for kind, c in zip(layer_kinds(cfg), caches):
        rows = decode_rows(cfg, mesh, next(iter(c.values())).shape[0])
        if kind in B.ATTN_KINDS:
            s_c = c["k"].shape[1]
            if s_c % n:
                raise ValueError(f"a cache of {s_c} slots does not split over {n} {ax!r} ranks")
            per = s_c // n
            out.append({k: v[rows, r * per:(r + 1) * per].clone() for k, v in c.items()})
        else:
            out.append({k: v[rows].clone() for k, v in c.items()})
    return out


def prefill(cfg, params, tokens: torch.Tensor, max_seq: int,
            prefix_embeds: Optional[torch.Tensor] = None, mesh=None):
    caches = init_caches(cfg, tokens.shape[0], max_seq, params["emb"].device)
    logits, caches, _ = forward(
        cfg, params, tokens, prefix_embeds=prefix_embeds, caches=caches,
        mesh=mesh, logits_positions="last",
    )
    return logits, caches


def decode_step(cfg, params, caches: list[dict], tokens1: torch.Tensor, pos: torch.Tensor,
                mesh=None):
    """tokens1: (B, 1) new token ids; pos: (B,) absolute positions. Writes
    the new token's K/V into ``caches`` and returns the per-layer caches,
    a recurrent layer's state anew."""
    x = embed_tokens(cfg, params, tokens1)
    x, new_caches, _ = _run_layers(cfg, params, x, pos, caches=caches, decode=True, mesh=mesh)
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    return logits_from(cfg, params, x), new_caches
