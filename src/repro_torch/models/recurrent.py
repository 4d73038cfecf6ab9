"""Recurrent blocks: RG-LRU (Griffin / RecurrentGemma) and xLSTM cells.

* RG-LRU runs the reference's associative scan over (decay, input) pairs:
  the same odd/even recursion as ``jax.lax.associative_scan``, O(log S)
  levels of strided torch ops, so the products are formed in the same tree.
* mLSTM (matrix memory) uses the chunkwise-parallel form: attention-like
  products within a chunk and the (C, n, m) state carried across chunks by
  a Python loop (the reference's ``lax.scan``).
* sLSTM has hidden-to-hidden recurrence and is sequential; it runs one
  Python step per token. The reference unrolls ``time_chunk`` steps inside
  each scan iteration, which changes nothing in the result.

Every block applies over a full sequence from an optional carried state and
returns ``(y, new_state)``; a decode step is the same call on one token.

Under tensor parallelism (``tp=``, a ``sharding.tp.TPContext``; training,
prefill and decode alike) each block runs on this rank's shards
of its ``ffn``-split weights (:func:`tp_split`): the input enters the model
group, the up-projections are column-parallel, the weights split on their
input dimension and replicated on their output give partial sums of which
this rank takes its own part (``tp.own``), and the down-projection is
row-parallel and leaves the group. The RG-LRU is per channel; the mLSTM
and sLSTM run this rank's heads where the axis divides them, else every
head on every rank. No collective runs inside a recurrence's time loop.
A carried state is this rank's part: the RG-LRU's channels, the mLSTM's
and sLSTM's heads where the axis divides them (the state constructors'
``width``/``n_heads``), else the whole state.
With ``tp=None`` every op is the unsharded one, in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dtype_scalar, init_linear


def tp_split(tp, params: dict, dims: dict, full: int, n_heads: Optional[int] = None):
    """How a recurrent block runs on this rank's shards, read from their
    local shapes (``dims``: each weight's dimension of width ``full`` that
    the rules split over "model" as ``ffn``): None without ``tp`` or with
    every such dimension whole (today's ops); ``"channels"`` (the RG-LRU,
    ``n_heads`` None), ``"heads"`` (the axis divides ``n_heads``: this
    rank's heads, the contiguous channels of its ``ffn`` shard) or
    ``"whole"`` (every head on every rank) with every one split evenly;
    any other layout is refused."""
    if tp is None:
        return None
    local = {params[k].shape[d] for k, d in dims.items()}
    if local == {full}:
        return None
    if full % tp.size or local != {full // tp.size}:
        raise NotImplementedError(
            f"recurrent block: widths {sorted(local)} of {full} are not one even split over "
            f"{tp.size} model ranks")
    if n_heads is None:
        return "channels"
    return "heads" if n_heads % tp.size == 0 else "whole"


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) everywhere (``F.softplus``
    turns into the identity above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -_softplus(-x)


# =====================================================================
# RG-LRU (Griffin)
# =====================================================================

@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int           # recurrence width (Griffin: ~4/3 d_model; the reference uses d_model)
    conv_width: int = 4
    c_const: float = 8.0


def init_rglru(generator, cfg: RGLRUConfig, dtype, device):
    params, specs = {}, {}
    params["wx"], specs["wx"] = init_linear(generator, cfg.d_model, (cfg.d_rnn,),
                                            ("embed", "ffn"), dtype, device)
    params["wy"], specs["wy"] = init_linear(generator, cfg.d_model, (cfg.d_rnn,),
                                            ("embed", "ffn"), dtype, device)
    params["wo"], specs["wo"] = init_linear(generator, cfg.d_rnn, (cfg.d_model,),
                                            ("ffn", "embed"), dtype, device)
    # depthwise causal conv over the rnn channel
    params["conv"] = _normal(generator, (cfg.conv_width, cfg.d_rnn), 0.1, dtype, device)
    specs["conv"] = (None, "ffn")
    # recurrence gates: a (recurrent weight via Lambda), input gate
    params["w_a"], specs["w_a"] = init_linear(generator, cfg.d_rnn, (cfg.d_rnn,),
                                              ("ffn", None), dtype, device)
    params["w_i"], specs["w_i"] = init_linear(generator, cfg.d_rnn, (cfg.d_rnn,),
                                              ("ffn", None), dtype, device)
    # Lambda parametrizes the per-channel decay in (0, 1); kept in f32
    if torch.device(device).type == "meta":
        params["lambda"] = torch.empty((cfg.d_rnn,), dtype=torch.float32, device=device)
    else:
        lin = torch.linspace(0.9, 0.999, cfg.d_rnn, dtype=torch.float32, device=device)
        params["lambda"] = torch.log(torch.expm1(lin))  # softplus^-1
    specs["lambda"] = ("ffn",)
    return params, specs


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """x: (B, S, C), w: (W, C). Returns (y, new_state (B, W-1, C)). The taps
    are summed left to right, each add rounded in x's dtype, as the
    reference's Python ``sum``."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return y, new_state


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 1; ``even`` may be one longer."""
    n_odd = odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n_odd:]], dim=1)


def _associative_scan(elems: tuple) -> tuple:
    """``jax.lax.associative_scan(_combine, elems, axis=1)``: the same
    recursion (pairs combined, the odd prefix scanned, the even prefix
    completed from it), so every product and sum is the reference's."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[:, 0:-1:2] for e in elems), tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine(tuple(e[:, :-1] for e in odd), tuple(e[:, 2::2] for e in elems))
    else:
        even = _combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _rglru_scan(a: torch.Tensor, bx: torch.Tensor, h0=None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t via the associative scan; a, bx: (B, S, C)."""
    if h0 is not None:
        # fold the carried state into the first step
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], dim=1)
    _, h = _associative_scan((a, bx))
    return h


RGLRU_TP_DIMS = {"wx": 1, "wy": 1, "conv": 1, "lambda": 0, "w_a": 0, "w_i": 0, "wo": 0}


def apply_rglru(cfg: RGLRUConfig, params, x: torch.Tensor, state=None, tp=None):
    """x: (B, S, D). Returns (y, new_state dict). With ``tp``, on this
    rank's ``d_rnn`` channels: the gates' products with ``w_a`` and
    ``w_i`` are summed over the model group and this rank takes its
    channels of them; ``y`` is summed over the group."""
    split = tp_split(tp, params, RGLRU_TP_DIMS, cfg.d_rnn)
    if split:
        x = tp.enter(x)
    gate_y = F.gelu(torch.matmul(x, params["wy"]), approximate="tanh")
    u = torch.matmul(x, params["wx"])
    conv_state = None if state is None else state["conv"]
    u, conv_state = _causal_depthwise_conv(u, params["conv"], conv_state)

    if split:
        ra, ia = tp.own(torch.cat([torch.matmul(u, params["w_a"]),
                                   torch.matmul(u, params["w_i"])], dim=-1), groups=2).chunk(2, -1)
    else:
        ra, ia = torch.matmul(u, params["w_a"]), torch.matmul(u, params["w_i"])
    r = torch.sigmoid(ra.float())
    i = torch.sigmoid(ia.float())
    log_a = -cfg.c_const * r * _softplus(params["lambda"])
    a = torch.exp(log_a)
    # input normalization keeps |h| bounded (Griffin eq. 4)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    bx = beta * (i * u.float())

    h0 = None if state is None else state["h"]
    h = _rglru_scan(a, bx, h0)
    y = h.to(x.dtype) * gate_y
    y = torch.matmul(y, params["wo"])
    if split:
        y = tp.leave(y)
    return y, {"h": h[:, -1], "conv": conv_state}


def rglru_state(cfg: RGLRUConfig, batch: int, dtype, device, width: Optional[int] = None) -> dict:
    """The zero state of ``width`` channels (default: ``d_rnn``)."""
    w = cfg.d_rnn if width is None else width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device),
    }


# =====================================================================
# mLSTM (xLSTM matrix memory): chunkwise-parallel
# =====================================================================

@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def init_mlstm(generator, cfg: MLSTMConfig, dtype, device):
    di = cfg.d_inner
    params, specs = {}, {}
    for name, d_in, d_out, axes in (
        ("w_up", cfg.d_model, di, ("embed", "ffn")),
        ("w_gate", cfg.d_model, di, ("embed", "ffn")),
        ("wq", di, di, ("ffn", None)),
        ("wk", di, di, ("ffn", None)),
        ("wv", di, di, ("ffn", None)),
        ("w_if", di, 2 * cfg.n_heads, ("ffn", None)),
        ("w_down", di, cfg.d_model, ("ffn", "embed")),
    ):
        params[name], specs[name] = init_linear(generator, d_in, (d_out,), axes, dtype, device)
    return params, specs


def _mlstm_chunk_scan(q, k, v, log_i, log_f, state: dict):
    """One chunk of the mLSTM. q,k,v: (B,H,S,hd); log_i/log_f: (B,H,S) f32.

    State: C (B,H,hd,hd), n (B,H,hd), m (B,H) running stabilizer.
    Returns h (B,H,S,hd) f32 and the state at the chunk's end.
    """
    s, hd = q.shape[2], q.shape[3]
    C0, n0, m0 = state["C"], state["n"], state["m"]

    F_ = torch.cumsum(log_f, dim=-1)                   # (B,H,S) cumulative decay

    # intra-chunk decay matrix D[t, s'] = F_t - F_s' + log_i_s'  (s' <= t)
    Dmask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    D = F_[..., :, None] - F_[..., None, :] + log_i[..., None, :]
    D = torch.where(Dmask, D, -1e30)

    # stabilizers: running max of the intra-chunk and carried weights
    m_intra = D.amax(dim=-1)                            # (B,H,S)
    m_inter = F_ + m0[..., None]                        # carried state weight
    m_t = torch.maximum(m_intra, m_inter)               # (B,H,S)

    scale = hd ** -0.5
    qs = q * dtype_scalar(scale, q.dtype)
    att = torch.matmul(qs, k.transpose(-1, -2)).float()
    att = att * torch.exp(D - m_t[..., None])
    h_intra = torch.matmul(att, v.float())
    n_intra = att.sum(dim=-1)                           # (B,H,S): k-sum proxy
    # inter-chunk contribution from the carried C0, n0
    w_inter = torch.exp(m_inter - m_t)                  # (B,H,S)
    qf = q.float() * scale
    h_inter = torch.matmul(qf, C0) * w_inter[..., None]
    n_inter = torch.matmul(qf, n0[..., None])[..., 0] * w_inter

    denom = torch.maximum(torch.abs(n_intra + n_inter), torch.exp(-m_t))
    h_out = (h_intra + h_inter) / denom[..., None]

    # state update to the end of the chunk
    F_end = F_[..., -1:]                                # (B,H,1)
    m_new = torch.maximum(F_end[..., 0] + m0, (F_end - F_ + log_i).amax(dim=-1))
    wk = torch.exp(F_end - F_ + log_i - m_new[..., None])   # (B,H,S)
    kf, vf = k.float(), v.float()
    decay = torch.exp(F_end[..., 0] + m0 - m_new)
    C_new = decay[..., None, None] * C0 + torch.matmul((wk[..., None] * kf).transpose(-1, -2), vf)
    n_new = decay[..., None] * n0 + torch.sum(wk[..., None] * kf, dim=-2)
    return h_out, {"C": C_new, "n": n_new, "m": m_new}


MLSTM_TP_DIMS = {"w_up": 1, "w_gate": 1, "wq": 0, "wk": 0, "wv": 0, "w_if": 0, "w_down": 0}


def apply_mlstm(cfg: MLSTMConfig, params, x: torch.Tensor, state=None, tp=None):
    """x: (B, S, D) -> (y, state). The sequence is processed in chunks.
    With ``tp``, ``q``, ``k``, ``v`` and the gate logits are partial sums,
    added in one all-reduce: this rank's heads take their channels and
    their halves of ``w_if``'s ``[i | f]`` logits; where the axis does not
    divide the heads, every head runs on every rank and this rank takes
    its channels of ``h``. ``y`` is summed over the group."""
    b, s, _ = x.shape
    split = tp_split(tp, params, MLSTM_TP_DIMS, cfg.d_inner, cfg.n_heads)
    if split:
        x = tp.enter(x)
    up = torch.matmul(x, params["w_up"])
    gate = F.silu(torch.matmul(x, params["w_gate"]))
    nh, hd, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    if split:
        parts = [torch.matmul(up, params[k]) for k in ("wq", "wk", "wv", "w_if")]
        whole = tp.enter(tp.leave(torch.cat(parts, dim=-1)))
        qkv, gates = whole[..., :3 * di], whole[..., 3 * di:]
        if split == "heads":
            qkv, gates = tp.take(qkv, groups=3), tp.take(gates, groups=2)
            nh, di = nh // tp.size, di // tp.size
        q, k, v = qkv.chunk(3, dim=-1)
        gates = gates.float()
    else:
        q = torch.matmul(up, params["wq"])
        k = torch.matmul(up, params["wk"])
        v = torch.matmul(up, params["wv"])
        gates = torch.matmul(up, params["w_if"]).float()
    log_i = _log_sigmoid(gates[..., :nh])                 # (B,S,H)
    log_f = _log_sigmoid(gates[..., nh:])

    def heads(t):  # (B,S,di) -> (B,H,S,hd)
        return t.reshape(b, s, nh, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    log_i = log_i.transpose(1, 2)
    log_f = log_f.transpose(1, 2)

    ck = min(cfg.chunk, s)
    pad = (-s) % ck
    if pad:
        # pad with identity steps: i=0 (no write), f=1 (no decay); the final
        # state is unaffected and padded outputs are trimmed below
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, pad), value=0.0)

    if state is None:
        state = mlstm_state(cfg, b, x.device, n_heads=nh)
    hs = []
    for c0 in range(0, s + pad, ck):
        sl = slice(c0, c0 + ck)
        h, state = _mlstm_chunk_scan(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                     log_i[:, :, sl], log_f[:, :, sl], state)
        hs.append(h)
    h = torch.cat(hs, dim=2)[:, :, :s]
    h = h.transpose(1, 2).reshape(b, s, di).to(x.dtype)
    if split == "whole":
        h = tp.take(h)
    y = torch.matmul(h * gate, params["w_down"])
    if split:
        y = tp.leave(y)
    return y, state


def mlstm_state(cfg: MLSTMConfig, batch: int, device, n_heads: Optional[int] = None) -> dict:
    """The zero state of ``n_heads`` heads (default: all of them)."""
    hd = cfg.head_dim
    nh = cfg.n_heads if n_heads is None else n_heads
    return {
        "C": torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
    }


def step_mlstm(cfg: MLSTMConfig, params, x1: torch.Tensor, state: dict, tp=None):
    """Decode step: x1 (B, 1, D); with ``tp``, on this rank's shards and
    its part of the state."""
    return apply_mlstm(dataclasses.replace(cfg, chunk=1), params, x1, state, tp=tp)


# =====================================================================
# sLSTM (xLSTM scalar memory): sequential
# =====================================================================

@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor: float = 4.0 / 3.0

    @property
    def d_inner(self) -> int:
        # rounded UP to a multiple of lcm(n_heads, 64), as the reference
        di = int(self.d_model * self.proj_factor)
        align = math.lcm(self.n_heads, 64)
        return ((di + align - 1) // align) * align


def init_slstm(generator, cfg: SLSTMConfig, dtype, device):
    di = cfg.d_inner
    hd = di // cfg.n_heads
    params, specs = {}, {}
    params["w_up"], specs["w_up"] = init_linear(generator, cfg.d_model, (di,),
                                                ("embed", "ffn"), dtype, device)
    # input-to-gates: z, i, f, o stacked
    params["w_gates"], specs["w_gates"] = init_linear(generator, di, (4 * di,),
                                                      ("ffn", None), dtype, device)
    # hidden-to-gates recurrence: block-diagonal per head (xLSTM §2.3)
    params["r_gates"] = _normal(generator, (cfg.n_heads, hd, 4 * hd), hd ** -0.5 * 0.5,
                                dtype, device)
    specs["r_gates"] = (None, None, None)
    params["w_down"], specs["w_down"] = init_linear(generator, di, (cfg.d_model,),
                                                    ("ffn", "embed"), dtype, device)
    return params, specs


def _slstm_cell(r_gates: torch.Tensor, di: int, xg: torch.Tensor, carry: dict) -> dict:
    """One timestep. r_gates: (H, hd, 4hd) in the state's dtype; xg:
    (B, 4*di) pre-computed input gates; carry: dict of (B, di) f32."""
    h, c, n, m = carry["h"], carry["c"], carry["n"], carry["m"]
    nh, hd, _ = r_gates.shape
    b = h.shape[0]
    # per-head recurrence (B,H,hd) x (H,hd,4hd) -> (B,H,4hd) -> (B,4di) in
    # the (z,i,f,o)-stacked layout
    rec = torch.bmm(h.reshape(b, nh, hd).transpose(0, 1), r_gates).transpose(0, 1)
    rec = rec.reshape(b, nh, 4, hd).transpose(1, 2).reshape(b, 4 * di)
    gates = xg + rec.float()
    z, i, f, o = torch.chunk(gates, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_i = i  # exponential input gate (log-space value is the pre-activation)
    log_f = _log_sigmoid(f)
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * (c_new / torch.clamp_min(torch.abs(n_new), 1.0))
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


SLSTM_TP_DIMS = {"w_up": 1, "w_gates": 0, "w_down": 0}


def apply_slstm(cfg: SLSTMConfig, params, x: torch.Tensor, state=None, tp=None):
    """With ``tp``, the input gates ``up @ w_gates`` are a partial sum laid
    out ``[z | i | f | o]``: this rank's heads take their channels of each
    of the four with their blocks of the replicated ``r_gates``; where the
    axis does not divide the heads, every rank runs the whole recurrence
    and takes its channels of ``h``. ``r_gates`` enters the model group
    once, before the time loop. ``y`` is summed over the group."""
    b, s, _ = x.shape
    di = cfg.d_inner
    split = tp_split(tp, params, SLSTM_TP_DIMS, di, cfg.n_heads)
    if split:
        x = tp.enter(x)
    up = torch.matmul(x, params["w_up"])
    xg = torch.matmul(up, params["w_gates"])
    if split == "heads":
        xg = tp.own(xg, groups=4)
        di = di // tp.size
    elif split:
        xg = tp.enter(tp.leave(xg))
    xg = xg.float()
    if state is None:
        state = slstm_state(cfg, b, x.device, width=di)
    r_gates = params["r_gates"].to(state["h"].dtype)
    if split == "heads":
        r_gates = tp.part(r_gates, dim=0)
    elif split:
        r_gates = tp.enter(r_gates)
    hs = []
    for t in range(s):
        state = _slstm_cell(r_gates, di, xg[:, t], state)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)
    if split == "whole":
        h = tp.take(h)
    y = torch.matmul(h, params["w_down"])
    if split:
        y = tp.leave(y)
    return y, state


def slstm_state(cfg: SLSTMConfig, batch: int, device, width: Optional[int] = None) -> dict:
    """The zero state of ``width`` channels (default: ``d_inner``)."""
    shape = (batch, cfg.d_inner if width is None else width)
    out = {k: torch.zeros(shape, dtype=torch.float32, device=device) for k in ("h", "c", "n")}
    out["m"] = torch.full(shape, -1e30, dtype=torch.float32, device=device)
    return out
