"""The plain Kimi Linear query tower: the reference of the Kimi Linear
cells.

The published model (Kimi-Linear-48B-A3B-Instruct's ``config.json``; Kimi
Linear, arXiv:2510.26692) written out in plain torch, f32 (TF32 off), one
token of the recurrence at a time:

* embeddings, then per layer x = x + mixer(RMSNorm(x)) and
  x = x + channel(RMSNorm(x));
* the token mixer by ``linear_attn_config`` (layers counted from 1):
  ``kda`` (Kimi Delta Attention) at ``kda_layers``: q, k, v = W_q x,
  W_k x, W_v x, each through its causal depthwise conv (width
  ``short_conv_kernel_size``, no bias) and SiLU; q and k L2-normed per
  head (eps 1e-6); the per-channel log decay g = -exp(A_log[head])
  softplus(W_fb W_fa x + dt_bias) and beta = sigmoid(W_b x); from S = 0,
  S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T,
  o_t = S_t^T q_t / sqrt(head_dim); o RMS-normed per head times its
  weight and sigmoid(W_gb W_ga x); W_o.
  ``mla`` at ``full_attn_layers``: q = W_q x [heads, nope + rope];
  [c, k_pe] = W_kva x, c RMS-normed; [k_nope, v] = W_kvb c;
  causal softmax(q k^T / sqrt(nope + rope)) v over q = [q_nope, q_pe],
  k = [k_nope, k_pe] (k_pe shared by the heads, no rotation:
  ``mla_use_nope``); W_o;
* the channel mixer: ``mlp`` (the first ``first_k_dense_replace``
  layers), down(silu(gate x) up x); ``moe`` after: sigmoid scores of an
  f32 router over all ``num_experts``; the ``num_experts_per_token``
  experts of the largest score + correction bias (the bias only chooses);
  their scores normalised over the chosen (+1e-20,
  ``moe_renormalize``) and scaled by ``routed_scaling_factor``; each
  expert down(silu(gate x) up x); every token routed densely, the held
  experts then run one at a time over their tokens; plus the shared
  expert (``num_shared_experts`` times ``moe_intermediate_size`` wide);
* the final RMSNorm.

Departures from the published model, both from its use as a query tower
on one card: no LM head (an embedder stops at the final norm; the last
live token's state goes through the query projection to the joint space,
as MCN's query tower does), and the expert share (``held_experts``, the
first expert and the count this card holds of each MoE layer): the
routing and its weights are over all experts, and the routings to the
experts held elsewhere add nothing, as in the program.

Each stage states a precision (its weights' dtype in serving): "kda",
"mla", "mlp", "moe" and "projection" (the final norm and the query
projection).  A stage's products run at it (``mcn.mm``), and every
activation the stage stores is rounded to it (``act``): a product's
result, a conv's output, a norm's output, the SwiGLU product, the
experts' weighted sum, the attention's and the recurrence's gated output
and the residual stream after each sublayer.  The router's product, the
gates (g, beta), the recurrence's state, the softmax and the norms stay in
f32 (the query projection's result too).  Weights are read as stored and
cast to f32 one product (an expert's, one expert) at a time.  The
token-wise products and the experts run over the live tokens alone; a
padding token (right padding, which no live token reads) holds zeros.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from vfrbench.reference import mcn
from vfrbench.reference.nemotron_h import act, conv, mm, on_live, rmsnorm

STAGES = ("kda", "mla", "mlp", "moe", "projection")
L2_EPS = 1e-6


def kinds(dec: Dict) -> List[tuple]:
    kda = set(dec["linear_attn_config"]["kda_layers"])
    return [("kda" if i + 1 in kda else "mla",
             "mlp" if i < dec["first_k_dense_replace"] else "moe")
            for i in range(dec["num_hidden_layers"])]


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def decay(g: torch.Tensor) -> torch.Tensor:
    """The state's decay over one token, per channel: exp(g) [n, H, D]."""
    return torch.exp(g)


def gate_beta(b: torch.Tensor) -> torch.Tensor:
    """The delta rule's step size beta [Q, T, H]."""
    return torch.sigmoid(b)


def kda(h: torch.Tensor, p: Dict, dec: Dict, prec: str, li: torch.Tensor,
        live_at: List[int]) -> torch.Tensor:
    """The KDA mixer over h [Q, T, D], the queries in order of length
    (longest first): token t updates the states of the first live_at[t]
    queries, the live ones."""
    Q, T, _ = h.shape
    lac = dec["linear_attn_config"]
    H, Dh = lac["num_heads"], lac["head_dim"]
    HD = H * Dh
    proj = on_live(lambda a: mm(a, p["in_proj"], prec), h, li)
    qkv, fa, ga, b = proj.split([3 * HD, Dh, Dh, H], dim=-1)
    qkv = act(F.silu(conv(qkv, p["conv_w"], None)), prec)
    q, k, v = (t.reshape(Q, T, H, Dh) for t in qkv.split(HD, dim=-1))
    q, k = l2norm(q), l2norm(k)
    fb = on_live(lambda a: mm(a, p["f_b"], prec), fa, li)
    A = -torch.exp(p["A_log"].float())
    g = (A[:, None] * F.softplus(fb + p["dt_bias"].float()).reshape(
        Q, T, H, Dh))
    beta = gate_beta(b)
    state = h.new_zeros(Q, H, Dh, Dh)
    o = torch.zeros_like(v)
    scale = 1.0 / math.sqrt(Dh)
    for t in range(T):
        n = live_at[t]
        s = state[:n]
        s.mul_(decay(g[:n, t])[..., None])
        kt = k[:n, t]
        kv = torch.matmul(kt[..., None, :], s)[..., 0, :]      # S^T k
        u = beta[:n, t, :, None] * (v[:n, t] - kv)
        s.add_(kt[..., :, None] * u[..., None, :])
        o[:n, t] = torch.matmul(q[:n, t, :, None, :], s)[..., 0, :] * scale
    gate = on_live(lambda a: mm(a, p["g_b"], prec), ga, li)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True)
                        + dec["rms_norm_eps"])
    o = o * p["o_norm"].float() * torch.sigmoid(gate.reshape(Q, T, H, Dh))
    o = act(o.reshape(Q, T, HD), prec)
    return on_live(lambda a: mm(a, p["o_proj"], prec), o, li)


def kv_norm(c: torch.Tensor, p: Dict, dec: Dict) -> torch.Tensor:
    """MLA's norm of the latent c (``kv_a``'s first ``kv_lora_rank``)."""
    return rmsnorm(c, p["kv_norm"], dec["rms_norm_eps"])


def mla(h: torch.Tensor, p: Dict, dec: Dict, prec: str,
        li: torch.Tensor) -> torch.Tensor:
    Q, T, _ = h.shape
    Hq = dec["num_attention_heads"]
    dn, dr, dv = (dec["qk_nope_head_dim"], dec["qk_rope_head_dim"],
                  dec["v_head_dim"])
    R = dec["kv_lora_rank"]
    q = on_live(lambda a: mm(a, p["q"], prec), h, li).reshape(Q, T, Hq,
                                                              dn + dr)
    c, k_pe = on_live(lambda a: mm(a, p["kv_a"], prec), h, li).split(
        [R, dr], dim=-1)
    c = act(kv_norm(c, p, dec), prec)
    kv = on_live(lambda a: mm(a, p["kv_b"], prec), c, li).reshape(
        Q, T, Hq, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(-1, -1, Hq, -1)],
                  -1)
    v = kv[..., dn:]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / math.sqrt(dn + dr)
    mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    a = act(torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v,
            prec)
    a = a.transpose(1, 2).reshape(Q, T, Hq * dv)
    return on_live(lambda b_: mm(b_, p["o"], prec), a, li)


def swiglu_mlp(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
               prec: str) -> torch.Tensor:
    gu = mm(x, gate_up, prec)
    g, u = gu.chunk(2, dim=-1)
    return mm(act(F.silu(g) * u, prec), down, prec)


def route(h: torch.Tensor, p: Dict, dec: Dict):
    """(chosen experts [M, k], their weights [M, k]) of tokens h [M, D]:
    over all ``num_experts``, whichever this card holds."""
    scores = torch.sigmoid(h @ p["router"].float())
    choice = scores + p["e_bias"].float()
    idx = torch.topk(choice, dec["num_experts_per_token"], dim=-1).indices
    w = scores.gather(1, idx)
    if dec["moe_renormalize"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * dec["routed_scaling_factor"]


def shared_expert(h: torch.Tensor, p: Dict, prec: str) -> torch.Tensor:
    return swiglu_mlp(h, p["shared_up"], p["shared_down"], prec)


def held(dec: Dict) -> tuple:
    return tuple(dec["held_experts"] or (0, dec["num_experts"]))


def moe(h: torch.Tensor, p: Dict, dec: Dict, prec: str) -> torch.Tensor:
    """The MoE mixer over the (live) tokens h [M, D]: every token routed
    over all experts, then each held expert over the tokens that chose
    it."""
    idx, w = route(h, p, dec)
    first, count = held(dec)
    k = idx.shape[1]
    e = idx.reshape(-1)
    order = torch.argsort(e, stable=True)
    tok = torch.div(order, k, rounding_mode="floor")
    wt = w.reshape(-1)[order]
    ends = torch.cumsum(torch.bincount(e, minlength=dec["num_experts"]),
                        0).tolist()
    out = torch.zeros_like(h)
    for ex in range(count):
        lo, hi = (ends[first + ex - 1] if first + ex else 0), ends[first + ex]
        if hi > lo:
            rows = tok[lo:hi]
            y = swiglu_mlp(h.index_select(0, rows), p["up"][ex],
                           p["down"][ex], prec)
            out.index_add_(0, rows, wt[lo:hi, None] * y)
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
    eps = dec["rms_norm_eps"]
    for i, (mix, chan) in enumerate(kinds(dec)):
        p = params[f"layer{i}"]
        prec = plan[mix]
        h = act(rmsnorm(x, p["norm"], eps), prec)
        if mix == "kda":
            out = kda(h, p, dec, prec, li, live_at)
        else:
            out = mla(h, p, dec, prec, li)
        x = act(x + out, prec)
        prec = plan[chan]
        h = act(rmsnorm(x, p["mlp_norm"], eps), prec)
        if chan == "mlp":
            out = on_live(lambda a: swiglu_mlp(a, p["gate_up"], p["down"],
                                               prec), h, li)
        else:
            out = on_live(lambda a: moe(a, p, dec, prec), h, li)
        x = act(x + out, prec)
    last = x[torch.arange(Q, device=x.device), lengths - 1]
    prec = plan["projection"]
    h = act(rmsnorm(last, params["norm_f"], eps), prec)
    pr = params["query_proj"]
    q = mcn.mm(h, pr["w"].float() if prec == "float32" else pr["w"], prec)
    q = (q + pr["b"].float())[torch.argsort(order)]
    return torch.stack([q] * streams)
