"""ModelConfig + the build_model() entry point used by configs/, tests and
examples/serve_lm_torch.py.

:class:`Model` is an ``nn.Module`` that holds its parameters, registered
under the names of the parameter tree (``weights.emb``,
``weights.final_norm.scale``, ``weights.layers.3.attn.wq``, ...);
:attr:`Model.params` hands that tree to the functions of ``transformer``
(decoder-only) or ``encdec`` (``arch_type="encdec"``). The port serves, so
the parameters are frozen (``requires_grad=False``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.models import encdec as E
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_ff: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    arch_type: str = "decoder"              # decoder | encdec
    pattern: tuple = ("attn+mlp",)
    mlp_kind: str = "swiglu"
    norm_kind: str = "rms"
    rope_theta: float = 10000.0
    window: int = 1024                      # sliding-window size for "local+*"
    kv_chunk: int = 1024                    # online-softmax chunk
    q_chunk: int = 2048                     # doubly-chunked attention with
                                            # static causal/window chunk skip
                                            # (0 disables)
    rnn_chunk: int = 256                    # mLSTM chunk
    slstm_tchunk: int = 16                  # the reference's sLSTM steps per scan
                                            # iteration; the port steps one token
                                            # at a time, which is the same result
    dtype: str = "bfloat16"
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_expert: int = 0
    moe_shared: int = 0
    moe_pad_to: Optional[int] = None
    moe_capacity: float = 1.25
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # vision prefix (vlm)
    prefix_len: int = 0
    # sub-quadratic eligibility (long_500k cells)
    subquadratic: bool = False
    # distributed decode
    decode_seq_shard: bool = False
    decode_seq_axis: str = "model"
    decode_batch_axes: Optional[str] = "data"
    # KV-cache quantization: "model" (= model dtype) | "int8" (per-token,
    # per-head symmetric scales; halves at-rest cache bytes)
    kv_cache_dtype: str = "model"
    # training
    remat: str = "full"                     # none | dots | full

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def n_params(self) -> int:
        """Analytic parameter count (embedding counted once: tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab * d
        counts = {
            "attn": d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d,
            "mlp": d * self.d_ff * (3 if self.mlp_kind in ("swiglu", "geglu") else 2),
            "moe": (self.moe_pad_to or self.moe_experts) * 3 * d * self.moe_d_expert
                   + d * (self.moe_pad_to or self.moe_experts)
                   + (3 * d * self.moe_shared * self.moe_d_expert if self.moe_shared else 0),
            "rglru": 3 * d * d + 2 * d * d,      # wx, wy, wo + gates
            "mlstm": 2 * d * int(2.0 * d) + 3 * (2 * d) ** 2 + 2 * d * d,
            "slstm": d * int(4 * d / 3) * (1 + 4 + 4) + int(4 * d / 3) * d,
        }
        if self.arch_type == "encdec":
            per = counts["attn"] + counts["mlp"]
            return (total + self.enc_layers * per
                    + self.dec_layers * (2 * counts["attn"] + counts["mlp"]))
        for i in range(self.n_layers):
            kind = self.pattern[i % len(self.pattern)]
            if kind in ("attn+mlp", "local+mlp", "enc+mlp"):
                total += counts["attn"] + counts["mlp"]
            elif kind == "attn+moe":
                total += counts["attn"] + counts["moe"]
            elif kind == "rglru+mlp":
                total += counts["rglru"] + counts["mlp"]
            elif kind == "mlstm":
                total += counts["mlstm"]
            elif kind == "slstm":
                total += counts["slstm"]
        return total

    def n_active_params(self) -> int:
        """Active (per-token) parameters — differs for MoE."""
        if not self.moe_experts:
            return self.n_params()
        full = self.n_params()
        e = self.moe_pad_to or self.moe_experts
        moe_layers = sum(
            1 for i in range(self.n_layers)
            if self.pattern[i % len(self.pattern)] == "attn+moe"
        )
        routed_all = moe_layers * e * 3 * self.d_model * self.moe_d_expert
        routed_active = moe_layers * self.moe_top_k * 3 * self.d_model * self.moe_d_expert
        return full - routed_all + routed_active


def _module(cfg: ModelConfig):
    return E if cfg.arch_type == "encdec" else T


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


class _ParamTree(nn.Module):
    """A nest of dicts and lists of tensors as registered parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _ParamTree(value))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(_ParamTree(v) for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> dict:
        out: dict = dict(self._parameters)
        for name, mod in self._modules.items():
            if isinstance(mod, nn.ModuleList):
                out[name] = [m.tree() for m in mod]
            else:
                out[name] = mod.tree()
        return out


class Model(nn.Module):
    """An LM holding its parameters: decoder-only, or an encoder-decoder
    when ``cfg.arch_type == "encdec"``.

    ``Model(cfg, device)`` draws the parameters from ``generator`` (a fresh
    ``torch.Generator`` seeded 0 on ``device`` when None); ``params=`` takes
    a ready tree instead (see ``repro_torch.interop.lm_params_from_arrays``).
    The entry points take the arguments of the module's functions after
    ``cfg`` and ``params``: ``prefill(tokens, max_seq)`` and
    ``decode_step(caches, tokens1, pos)`` for a decoder,
    ``prefill(frames, tokens, max_seq)`` and
    ``decode_step(caches, enc_out, tokens1, pos)`` for an encoder-decoder,
    whose ``forward(tokens, enc_out)`` is ``encdec.decoder_forward``.
    """

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None, params: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        self._mod = _module(cfg)
        device = _resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            params, _ = self._mod.init_params(cfg, generator, device)
        self.weights = _ParamTree(params)
        self.tp = None   # a TPContext on a model of this rank's shards (shard)

    @property
    def params(self) -> dict:
        """The parameter tree (the module's own tensors, not copies)."""
        return self.weights.tree()

    def init(self, generator: torch.Generator) -> dict:
        """Draw every parameter anew from ``generator`` (on the parameters'
        device); returns the tree."""
        params, _ = self._mod.init_params(self.cfg, generator)
        with torch.no_grad():
            for dst, src in zip(self.weights.parameters(), _ParamTree(params).parameters()):
                dst.copy_(src)
        return self.params

    def param_specs(self):
        """(meta-tensor tree, logical-axes tree): no allocation."""
        return abstract_params(self.cfg)

    def forward(self, tokens, *args, **kw):
        if self._mod is E:
            return E.decoder_forward(self.cfg, self.params, tokens, *args, **kw)
        return T.forward(self.cfg, self.params, tokens, *args, **kw)

    def encode(self, frames):
        """The encoder-decoder's encoder over stub frame embeddings."""
        return E.encode(self.cfg, self.params, frames)

    def loss_fn(self, batch, mesh=None, params: Optional[dict] = None, tp=None,
                share=None):
        """(loss, {"ce", "aux"}) at the model's parameters, or at ``params``
        (a tree of the same layout: a train step's leaves that require
        grad; with ``tp``, a ``sharding.tp.TPContext``, this rank's shards
        of them over the model axis). ``share`` (``sharding.tp.BatchShare``):
        a data-parallel step's part of a global microbatch; the cross
        entropy and the MoE's aux loss are then its terms of the global
        microbatch's."""
        kw = {k: v for k, v in (("tp", tp), ("share", share)) if v is not None}
        return self._mod.loss_fn(self.cfg, self.params if params is None else params, batch,
                                 mesh=mesh, **kw)

    @torch.inference_mode()
    def prefill(self, *args, **kw):
        return self._mod.prefill(self.cfg, self.params, *args, **self._tp(kw))

    @torch.inference_mode()
    def decode_step(self, *args, **kw):
        return self._mod.decode_step(self.cfg, self.params, *args, **self._tp(kw))

    def init_caches(self, batch: int, max_seq: int, mesh=None) -> list[dict]:
        """Empty decode caches of ``batch`` rows; on a sharded model, this
        rank's part of them (with ``mesh``, a decoder's sequence-sharded
        decode layout where ``cfg.decode_seq_shard`` is set)."""
        device = self.weights.emb.device
        if self._mod is E:
            return E.init_dec_caches(self.cfg, batch, max_seq, device, tp=self.tp)
        return T.init_caches(self.cfg, batch, max_seq, device, tp=self.tp, mesh=mesh)

    def _tp(self, kw: dict) -> dict:
        return kw if self.tp is None else {"tp": self.tp, **kw}

    def shard(self, mesh, rules) -> "Model":
        """This rank's model over ``mesh``'s "model" axis under ``rules``
        (``sharding.rules.ShardingRules``): a Model holding its shards of
        these weights (``sharding.tp.shard_params``), whose ``tp``
        (``sharding.tp.TPContext``, derived as the train step derives it:
        ``train.loop.model_tp``) its entry points pass on. Itself where
        the axis has one rank."""
        from repro_torch.sharding.tp import shard_params
        from repro_torch.train.loop import model_tp

        tp = model_tp(self, mesh, rules)[3]
        if tp is None:
            return self
        out = Model(self.cfg, device="meta" if self.weights.emb.is_meta else
                    self.weights.emb.device, params=shard_params(self.params, tp))
        out.tp = tp
        return out


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> Model:
    return Model(cfg, device=device, generator=generator)


def abstract_params(cfg: ModelConfig):
    """(tree of meta tensors with each parameter's shape and dtype, tree of
    logical-axes tuples) without allocating."""
    return _module(cfg).init_params(cfg, None, "meta")
