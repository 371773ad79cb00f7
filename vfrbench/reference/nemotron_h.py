"""The plain Nemotron-H query tower: the reference of the Nemotron-H cells.

The published model (NVIDIA-Nemotron-3-Nano-30B-A3B's ``config.json`` and
``modeling_nemotron_h.py``; Nemotron-H, arXiv:2504.03624) written out in
plain torch, f32 (TF32 off), one token of the recurrence at a time:

* embeddings, then per ``hybrid_override_pattern`` letter one block:
  x = x + mixer(RMSNorm(x));
* ``M``, Mamba-2 (arXiv:2405.21060): in_proj -> z, xBC, dt; xBC through a
  causal depthwise conv (width ``conv_kernel``, bias) and SiLU -> x, B, C
  (``n_groups`` groups of ``ssm_state_size``; head h reads group
  h // (heads / groups)); dt = softplus(dt + dt_bias), A = -exp(A_log);
  the state recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
  y_t = h_t C_t + D x_t; y * silu(z), RMS-normed in groups of
  d_inner / n_groups, times its weight; out_proj;
* ``E``, a mixture of experts (DeepSeek-V3's router, arXiv:2412.19437):
  sigmoid scores of an f32 router; the ``num_experts_per_tok`` experts of
  the largest score + correction bias (the bias only chooses); their
  scores normalised over the chosen (+1e-20) and scaled by
  ``routed_scaling_factor``; each expert down(relu(up(x))^2); every token
  routed densely (its scores over all experts), the experts then run one
  at a time over their tokens; plus the shared expert;
* ``*``, causal GQA attention, softmax(q k^T / sqrt(head_dim)) v, no bias;
* the final RMSNorm.

Departures from the published model, both from its use as a query tower:
no LM head (an embedder stops at the final norm; the last live token's
state goes through the query projection to the joint space, as MCN's
query tower does), and no rotary embedding (``rope_theta`` is in the
config, but the published attention mixer applies no position encoding:
the Mamba blocks carry order).

Each stage states a precision (its weights' dtype in serving): "mamba",
"attention", "moe" and "projection" (the final norm and the query
projection).  A stage's products run at it (``mcn.mm``: operands rounded,
f32 products and sums), and every activation the stage stores is rounded
to it (``act``): a product's result, a norm's output, relu^2 of an
expert's input, the experts' weighted sum, the attention's output and the
residual stream after each block, as a model served at bf16 stores them.
The router's product, the convolution, dt, the recurrence's state and
the softmax stay in f32 (the query projection's result too).  Weights are
read as stored and cast to f32 one product (an expert's one expert) at a
time, so that the reference fits on the card beside a bf16 model.
The token-wise products and the experts run over the live tokens alone;
a padding token (right padding, which no live token reads) holds zeros.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from vfrbench.reference import mcn

STAGES = ("mamba", "attention", "moe", "projection")
STAGE = {"M": "mamba", "E": "moe", "*": "attention"}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def mm(a: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """a (f32) @ the stored weight w at ``prec`` (``mcn.mm``; a weight is
    cast to f32 once, by its rounding or here), its result stored at
    ``prec``."""
    return act(mcn.mm(a, w.float() if prec == "float32" else w, prec), prec)


def act(t: torch.Tensor, prec: str) -> torch.Tensor:
    """An activation as a stage of precision ``prec`` stores it."""
    return mcn.round_to(t, prec)


def on_live(fn, x: torch.Tensor, li: torch.Tensor) -> torch.Tensor:
    """``fn`` of the live tokens li of x [Q, T, ...] (flattened), zeros at
    the padding."""
    flat = x.reshape(-1, x.shape[-1])
    y = fn(flat.index_select(0, li))
    out = y.new_zeros(flat.shape[0], y.shape[-1]).index_copy_(0, li, y)
    return out.reshape(*x.shape[:-1], -1)


def conv(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """Causal depthwise conv of x [Q, T, C] with w [C, K] and bias b (or
    None)."""
    T, K = x.shape[1], w.shape[1]
    w = w.float()
    out = []
    for t in range(T):
        acc = torch.zeros_like(x[:, 0]) if b is None else \
            b.float().expand(x.shape[0], -1).clone()
        for j in range(K):
            s = t - (K - 1) + j
            if s >= 0:
                acc = acc + w[:, j] * x[:, s]
        out.append(acc)
    return torch.stack(out, 1)


def decay(dt: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The state's decay over one token: exp(dt A) [Q, H]."""
    return torch.exp(dt * A)


def mamba(h: torch.Tensor, p: Dict, dec: Dict, prec: str,
          li: torch.Tensor, live_at: List[int]) -> torch.Tensor:
    """The Mamba-2 mixer over h [Q, T, D], the queries in order of length
    (longest first): token t updates the states of the first live_at[t]
    queries, the live ones."""
    Q, T, D = h.shape
    H, P = dec["mamba_num_heads"], dec["mamba_head_dim"]
    G, N = dec["n_groups"], dec["ssm_state_size"]
    di = H * P
    zxd = on_live(lambda a: mm(a, p["in_proj"], prec), h, li)
    z, xbc, dt = zxd.split([di, di + 2 * G * N, H], dim=-1)
    xbc = F.silu(conv(xbc, p["conv_w"],
                      p["conv_b"] if dec["use_conv_bias"] else None))
    x, Bm, Cm = xbc.split([di, G * N, G * N], dim=-1)
    x = x.reshape(Q, T, H, P)
    Bm = Bm.reshape(Q, T, G, N).repeat_interleave(H // G, dim=2)
    Cm = Cm.reshape(Q, T, G, N).repeat_interleave(H // G, dim=2)
    dt = F.softplus(dt + p["dt_bias"].float())                # [Q, T, H]
    A = -torch.exp(p["A_log"].float())
    state = h.new_zeros(Q, H, P, N)
    y = torch.zeros_like(x)
    for t in range(T):
        n = live_at[t]
        s = state[:n]
        s.mul_(decay(dt[:n, t], A)[..., None, None])
        s.addcmul_((x[:n, t] * dt[:n, t, :, None])[..., None],
                   Bm[:n, t, :, None, :])
        y[:n, t] = torch.matmul(s, Cm[:n, t, :, :, None])[..., 0]
    y = y + x * p["D"].float()[:, None]
    y = y.reshape(Q, T, di) * F.silu(z)
    yg = y.reshape(Q, T, G, di // G)
    yg = yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True)
                          + dec["layer_norm_epsilon"])
    y = act(yg.reshape(Q, T, di) * p["gate_norm"].float(), prec)
    return on_live(lambda a: mm(a, p["out_proj"], prec), y, li)


def attention(h: torch.Tensor, p: Dict, dec: Dict, prec: str,
              li: torch.Tensor) -> torch.Tensor:
    Q, T, D = h.shape
    Hq, Hk, hd = (dec["num_attention_heads"], dec["num_key_value_heads"],
                  dec["head_dim"])
    qkv = on_live(lambda a: mm(a, p["qkv"], prec), h, li)
    q, k, v = qkv.split([Hq * hd, Hk * hd, Hk * hd], -1)
    q = q.reshape(Q, T, Hq, hd).transpose(1, 2)
    k = k.reshape(Q, T, Hk, hd).transpose(1, 2).repeat_interleave(Hq // Hk, 1)
    v = v.reshape(Q, T, Hk, hd).transpose(1, 2).repeat_interleave(Hq // Hk, 1)
    s = q @ k.transpose(-1, -2) / math.sqrt(hd)
    mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    a = act(torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v,
            prec)
    a = a.transpose(1, 2).reshape(Q, T, Hq * hd)
    return on_live(lambda b: mm(b, p["o"], prec), a, li)


def route(h: torch.Tensor, p: Dict, dec: Dict):
    """(chosen experts [M, k], their weights [M, k]) of tokens h [M, D]."""
    scores = torch.sigmoid(h @ p["router"].float())
    choice = scores + p["e_bias"].float()
    idx = torch.topk(choice, dec["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, idx)
    if dec["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * dec["routed_scaling_factor"]


def expert(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           prec: str) -> torch.Tensor:
    return mm(act(torch.relu(mm(x, up, prec)) ** 2, prec), down, prec)


def shared_expert(h: torch.Tensor, p: Dict, prec: str) -> torch.Tensor:
    return expert(h, p["shared_up"], p["shared_down"], prec)


def moe(h: torch.Tensor, p: Dict, dec: Dict, prec: str) -> torch.Tensor:
    """The MoE mixer over the (live) tokens h [M, D]: every token routed
    over all experts, then each expert over the tokens that chose it."""
    idx, w = route(h, p, dec)
    k = idx.shape[1]
    e = idx.reshape(-1)
    order = torch.argsort(e, stable=True)
    tok = torch.div(order, k, rounding_mode="floor")
    wt = w.reshape(-1)[order]
    counts = torch.bincount(e, minlength=p["up"].shape[0]).tolist()
    out = torch.zeros_like(h)
    start = 0
    for ex, n in enumerate(counts):
        if n:
            rows = tok[start:start + n]
            y = expert(h.index_select(0, rows), p["up"][ex], p["down"][ex],
                       prec)
            out.index_add_(0, rows, wt[start:start + n, None] * y)
        start += n
    return act(act(out, prec) + shared_expert(h, p, prec), prec)


def queries(params: Dict, dec: Dict, streams: int, tokens: torch.Tensor,
            lengths: torch.Tensor, plan: Dict[str, str]) -> torch.Tensor:
    """[S, Q, d] query embeddings of tokens [Q, T] with ``lengths`` [Q]
    live tokens (right padding), ``dec`` the published config's keys."""
    Q, T = tokens.shape
    order = torch.argsort(lengths.long(), descending=True, stable=True)
    tokens, lengths = tokens[order], lengths.long()[order]
    ls = lengths.tolist()
    live_at = [sum(L > t for L in ls) for t in range(T)]
    x = params["embeddings"][tokens.long()].float()
    li = torch.nonzero((torch.arange(T, device=x.device)[None, :]
                        < lengths[:, None]).reshape(-1))[:, 0]
    x = on_live(lambda a: a, x, li)
    for i, kind in enumerate(dec["hybrid_override_pattern"]):
        p = params[f"layer{i}"]
        if kind not in STAGE:
            raise ValueError(f"no block {kind!r}")
        prec = plan[STAGE[kind]]
        h = act(rmsnorm(x, p["norm"], dec["layer_norm_epsilon"]), prec)
        if kind == "M":
            out = mamba(h, p, dec, prec, li, live_at)
        elif kind == "E":
            out = on_live(lambda a: moe(a, p, dec, prec), h, li)
        else:
            out = attention(h, p, dec, prec, li)
        x = act(x + out, prec)
    last = x[torch.arange(Q, device=x.device), lengths - 1]
    prec = plan["projection"]
    h = act(rmsnorm(last, params["norm_f"], dec["norm_eps"]), prec)
    pr = params["query_proj"]
    q = mcn.mm(h, pr["w"].float() if prec == "float32" else pr["w"], prec)
    q = (q + pr["b"].float())[torch.argsort(order)]
    return torch.stack([q] * streams)
