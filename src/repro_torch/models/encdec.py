"""Whisper-style encoder-decoder backbone.

As in the reference, the audio frontend (log-mel + strided convs) is a stub:
callers supply precomputed frame embeddings (B, T, d_model) and one linear
``frontend_proj`` stands in for the conv stack. Encoder layers are
bidirectional; decoder layers are causal self-attention, cross-attention
over the encoder output, then an MLP.

The parameters are ``{"emb", "frontend_proj", "final_norm", "enc": [one
dict per encoder layer], "dec": [one dict per decoder layer]}`` and the
decoder caches a list of per-layer K/V cache dicts. The cross-attention K/V
are projected from the encoder output at every call, decode steps included,
as the reference does.

Under tensor parallelism (``tp=``, a ``sharding.tp.TPContext``: training,
prefill and decode alike) the encoder layers run ``blocks.block_apply``'s
attention path, the decoder's self-attention and MLP the same split, and
the cross-attention's query and K/V projections are column-parallel over
its heads (the encoder output enters the model group once, before every
layer's K/V projections) and its output projection row-parallel; the
heads fall back as ``attention.tp_local`` reads them from the weights.
The tied logits and the loss are ``transformer``'s, vocab-parallel where
the vocab splits. Serving's self-attention caches are this rank's part
(``blocks.block_cache``'s rule: its own KV heads where they split) and its
logits are whole.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models.layers import (
    MLPConfig, apply_mlp, apply_norm, init_embedding, init_linear, init_mlp, init_norm,
)
from repro_torch.models.remat import checkpoint_name, maybe_remat
from repro_torch.models.transformer import (
    _seq_shards, _whole_logits, cross_entropy, embed_tokens, logits_from,
)


def _self_cfg(cfg, causal: bool) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        window=None, causal=causal, kv_chunk=cfg.kv_chunk,
    )


def _dec_layer_init(generator, cfg, dtype, device):
    params, specs = {}, {}
    params["norm1"], specs["norm1"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    params["self"], specs["self"] = A.init_attention(generator, _self_cfg(cfg, True),
                                                     dtype, device)
    params["norm_x"], specs["norm_x"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    params["cross"], specs["cross"] = A.init_attention(generator, _self_cfg(cfg, False),
                                                       dtype, device)
    params["norm2"], specs["norm2"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    params["mlp"], specs["mlp"] = init_mlp(
        generator, MLPConfig(cfg.mlp_kind, cfg.d_model, cfg.d_ff), dtype, device)
    return params, specs


def init_params(cfg, generator: Optional[torch.Generator] = None, device=None):
    """(params, specs). Draws from ``generator`` on its device (embedding,
    frontend, encoder layers, decoder layers); with ``device="meta"`` it
    allocates nothing and needs no generator."""
    device = torch.device(device if device is not None else generator.device)
    dtype = cfg.torch_dtype
    params, specs = {}, {}
    params["emb"], specs["emb"] = init_embedding(generator, cfg.vocab, cfg.d_model, dtype, device)
    params["frontend_proj"], specs["frontend_proj"] = init_linear(
        generator, cfg.d_model, (cfg.d_model,), ("embed", "embed_out"), dtype, device)
    params["final_norm"], specs["final_norm"] = init_norm(cfg.norm_kind, cfg.d_model, dtype, device)
    params["enc"], specs["enc"] = [], []
    for _ in range(cfg.enc_layers):
        p, s = B.block_init("enc+mlp", generator, cfg, dtype, device)
        params["enc"].append(p)
        specs["enc"].append(s)
    params["dec"], specs["dec"] = [], []
    for _ in range(cfg.dec_layers):
        p, s = _dec_layer_init(generator, cfg, dtype, device)
        params["dec"].append(p)
        specs["dec"].append(s)
    return params, specs


def encode(cfg, params, frames: torch.Tensor, tp=None) -> torch.Tensor:
    """frames: (B, T, d_model) stub embeddings -> encoder states."""
    x = torch.matmul(frames.to(cfg.torch_dtype), params["frontend_proj"])
    positions = torch.arange(x.shape[1], device=x.device)
    layer = maybe_remat(cfg.remat, lambda x, p: B.block_apply("enc+mlp", cfg, p, x, positions,
                                                              tp=tp)[0])
    for p in params["enc"]:
        x = layer(x, p)
    return x


def _local(acfg: A.AttnConfig, params, tp):
    """(config, weights, split) of an attention on this rank's shards
    (``attention.tp_local``); the unsharded ones without ``tp``."""
    return (acfg, params, None) if tp is None else A.tp_local(acfg, params, tp)


def cross_attend(cfg, p, h: torch.Tensor, enc_kv, tp=None) -> torch.Tensor:
    """The cross-attention of ``h`` (the normed decoder stream) over the
    encoder's keys/values ``enc_kv`` (:func:`_enc_kv`'s for this layer),
    projected back to the model width (summed over the model group with
    ``tp``). Chunked online softmax when the decoder side is long. It is
    neither causal nor windowed, so the query positions do not enter its
    mask: arange(sq) stands for them."""
    xcfg, p, split = _local(_self_cfg(cfg, False), p, tp)
    if split == "heads":
        h = tp.enter(h)
    qx = A._proj(h, p["wq"])
    ek, ev = enc_kv
    sq = h.shape[1]
    enc_pos = torch.arange(ek.shape[1], device=h.device)
    q_pos = torch.arange(sq, device=h.device)
    if sq * ek.shape[1] > cfg.kv_chunk * cfg.kv_chunk:
        xout = A.attention_chunked(xcfg, qx, ek, ev, q_pos, enc_pos)
    else:
        xout = A.attention_full(xcfg, qx, ek, ev, q_pos, enc_pos)
    return A.output_proj(xcfg, p, xout, tp, split)


def _dec_layer(cfg, p, x, enc_kv, positions, cache=None, decode=False, tp=None, mesh=None):
    scfg = _self_cfg(cfg, True)
    h = apply_norm(cfg.norm_kind, p["norm1"], x)
    if decode:
        attn, cache = B.attend_decode(cfg, scfg, p["self"], h, positions, cache, mesh, tp)
    else:
        attn, k, v = B.attend(cfg, scfg, p["self"], h, positions, tp, serve=cache is not None)
        if cache is not None:
            cache = B._fill_kv_cache(cache, k, v, positions)
    # the sub-layers' outputs named as block_apply's, for "save_tp"
    x = x + checkpoint_name(attn, "tp_attn_out")

    h = apply_norm(cfg.norm_kind, p["norm_x"], x)
    x = x + checkpoint_name(cross_attend(cfg, p["cross"], h, enc_kv, tp), "tp_attn_out")

    h = apply_norm(cfg.norm_kind, p["norm2"], x)
    y = apply_mlp(MLPConfig(cfg.mlp_kind, cfg.d_model, cfg.d_ff), p["mlp"], h, tp=tp)
    return x + checkpoint_name(y, "tp_mlp_out"), cache


def _enc_kv(cfg, params, enc_out: torch.Tensor, tp=None) -> list:
    """Each decoder layer's cross K/V projected from the encoder output
    (with ``tp``, this rank's heads of them: the output enters the model
    group once for every layer whose heads are split)."""
    xcfg = _self_cfg(cfg, False)
    local = [_local(xcfg, p["cross"], tp)[1:] for p in params["dec"]]
    entered = tp.enter(enc_out) if any(s == "heads" for _, s in local) else enc_out
    kv = []
    for p, split in local:
        e = entered if split == "heads" else enc_out
        kv.append((A._proj(e, p["wk"]), A._proj(e, p["wv"])))
    return kv


def decoder_forward(cfg, params, tokens: torch.Tensor, enc_out: torch.Tensor,
                    caches: Optional[list] = None, decode: bool = False, pos=None, tp=None,
                    mesh=None):
    """Returns (logits, new caches or None). Decode: tokens (B, 1), pos (B,).
    With ``tp``, on this rank's shards and its part of the caches, the
    logits this rank's vocab range where ``vocab`` is split. With
    ``cfg.decode_seq_shard`` and ``mesh``, a decode step runs the
    sequence-sharded decode (``blocks.attend_decode``)."""
    x = embed_tokens(cfg, params, tokens, tp)
    positions = pos if decode else torch.arange(x.shape[1], device=x.device)
    # without caches (a training or plain forward) each layer runs under
    # cfg.remat, as the reference's scanned decoder body
    layer = maybe_remat(cfg.remat if caches is None and not decode else "none",
                        lambda x, p, ekv, c: _dec_layer(cfg, p, x, ekv, positions,
                                                        cache=c, decode=decode, tp=tp,
                                                        mesh=mesh))
    new_caches = None if caches is None else []
    for i, (p, ekv) in enumerate(zip(params["dec"], _enc_kv(cfg, params, enc_out, tp))):
        c = None if caches is None else caches[i]
        x, nc = layer(x, p, ekv, c)
        if caches is not None:
            new_caches.append(nc)
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    return logits_from(cfg, params, x, tp), new_caches


def loss_fn(cfg, params, batch: dict, mesh=None, tp=None, share=None):
    """batch: frames (B,T,D), tokens (B,S), labels (B,S). With ``tp``,
    this rank's shards of ``params``; with ``share``, the cross entropy
    this rank's term of the global microbatch's
    (``transformer.cross_entropy``)."""
    enc_out = encode(cfg, params, batch["frames"], tp)
    logits, _ = decoder_forward(cfg, params, batch["tokens"], enc_out, tp=tp)
    ce = cross_entropy(cfg, params, logits, batch["labels"], tp, share)
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def init_dec_caches(cfg, batch: int, max_seq: int, device, tp=None, mesh=None) -> list[dict]:
    """The decoder's empty self-attention caches; with ``tp``, of this
    rank's KV heads where they are split over the model axis; with
    ``mesh`` too and ``cfg.decode_seq_shard``, the sequence-sharded
    decode's layout (this rank's shard of the slots, every KV head)."""
    seq = _seq_shards(cfg, mesh)
    if max_seq % seq:
        raise ValueError(f"a cache of {max_seq} slots does not split over {seq} ranks")
    out = []
    for i in range(cfg.dec_layers):
        n_kv = cfg.n_kv
        if seq == 1 and tp is not None and tp.dims["dec"][i]["self"]["wk"] is not None:
            n_kv //= tp.size
        shape = (batch, max_seq // seq, n_kv, cfg.head_dim)
        out.append({"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                    "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                    "slot_pos": torch.full(shape[:2], -1, dtype=torch.int32, device=device)})
    return out


def prefill(cfg, params, frames: torch.Tensor, tokens: torch.Tensor, max_seq: int, tp=None):
    """Returns (last logits (B, 1, V), decoder caches, encoder output); with
    ``tp``, on this rank's shards and rows, the caches its part."""
    enc_out = encode(cfg, params, frames, tp)
    caches = init_dec_caches(cfg, tokens.shape[0], max_seq, enc_out.device, tp)
    logits, caches = decoder_forward(cfg, params, tokens, enc_out, caches=caches, tp=tp)
    return _whole_logits(cfg, params, logits[:, -1:], tp), caches, enc_out


def decode_step(cfg, params, caches: list, enc_out: torch.Tensor, tokens1: torch.Tensor,
                pos: torch.Tensor, tp=None, mesh=None):
    """tokens1: (B, 1); pos: (B,). Writes the new token's K/V into ``caches``;
    the logits are whole under ``tp``. With ``cfg.decode_seq_shard`` and
    ``mesh``, the caches are laid out by ``transformer.shard_caches``."""
    logits, caches = decoder_forward(cfg, params, tokens1, enc_out, caches=caches, decode=True,
                                     pos=pos, tp=tp, mesh=mesh)
    return _whole_logits(cfg, params, logits, tp), caches
