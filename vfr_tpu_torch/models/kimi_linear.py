"""A Kimi Linear decoder LM as the query tower (Kimi Linear,
arXiv:2510.26692; Kimi-Linear-48B-A3B-Instruct's ``config.json``): token
embeddings, layers of two pre-norm sublayers with a residual each (a token
mixer, then a channel mixer), the final RMSNorm, then the last live
token's state projected to the joint space.  An embedder stops at the
final norm: there is no LM head.

Token mixers, by ``linear_attn_config`` (layers counted from 1):

* KDA (Kimi Delta Attention) at ``kda_layers``: one input product for q,
  k, v, the decay's and the output gate's low-rank inputs and beta; q, k
  and v through their causal depthwise convs (no bias) and SiLU; the
  per-channel log decay g = -exp(A_log) softplus(f_b(f_a x) + dt_bias) and
  beta = sigmoid(b x); the gated delta rule over q, k (each L2-normed per
  head) and v from a zero state (``ops/kernels/kda_kernel.py::kda_attend``:
  on the card one kernel, ``csrc/kda_chunk.cu``); the output RMS-normed
  per head, times its weight and sigmoid(g_b(g_a x)); o_proj.
* MLA at ``full_attn_layers``: q = W_q x (no low-rank q); [c, k_pe] =
  W_kva x, c RMS-normed; [k_nope, v] = W_kvb c; causal softmax attention
  over [q_nope, q_pe] and [k_nope, k_pe] (k_pe shared by the heads),
  both halves unrotated (``mla_use_nope``: no position encoding), scaled
  by (nope + rope dims)^-1/2; o.

Channel mixers: a dense SwiGLU MLP in the first ``first_k_dense_replace``
layers, then a mixture of SwiGLU experts with shared experts
(``ops/moe.py``: sigmoid router, the correction bias choosing the top
``num_experts_per_token``, their scores renormalised and scaled by
``routed_scaling_factor``).  ``held_experts`` holds a share of the
experts, the router choosing over all of them (``ops/moe.py``).

Precision: products at the weights' dtype (bf16 in serving); the router,
the gates (g, beta), the recurrence's state, the softmax and every norm in
f32; the residual stream at the embedding table's dtype.

The parameter tree (``check_params``, ``leaf_shapes``): ``embeddings``
[V, D]; per layer ``layer<i>`` with ``norm`` and ``mlp_norm`` [D], the
token mixer's leaves and the channel mixer's; ``norm_f`` [D];
``query_proj`` (``w`` [D, d], ``b`` [d]).  A KDA layer's ``in_proj``
stacks W_q, W_k, W_v, W_fa, W_ga and W_b; its ``conv_w`` the three
convs.  SwiGLU gate and up are stacked, gate first (``gate_up``, the
experts' ``up`` [E, D, 2F]).

The batch marks its stages for the port's recorder (``utils/trace.py``):
each sublayer ``encode.kda``, ``encode.mla``, ``encode.mlp`` or
``encode.moe``, and the final norm, pool and projection ``encode`` again
(with the embedding gather, before the first layer).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from vfr_tpu_torch.config import KimiLinearConfig
from vfr_tpu_torch.device import mm_f32
from vfr_tpu_torch.ops.kernels.kda_kernel import kda_attend
from vfr_tpu_torch.ops.mamba2 import causal_conv
from vfr_tpu_torch.ops.moe import moe_block, swiglu
from vfr_tpu_torch.utils import trace

F32_LEAVES = ("router", "e_bias", "A_log", "dt_bias")
L2_EPS = 1e-6       # q and k to unit length (the published kernels' eps)


def check(dec: KimiLinearConfig) -> None:
    """Raise for a configuration whose mathematics the port does not
    implement."""
    lac = dec.linear_attn_config
    kda, full = set(lac.kda_layers), set(lac.full_attn_layers)
    bad = []
    if kda & full or kda | full != set(range(1, dec.num_hidden_layers + 1)):
        bad.append("each layer (1..num_hidden_layers) KDA or full "
                   "attention, not both")
    if dec.hidden_act != "silu" or dec.moe_router_activation_func != \
            "sigmoid":
        bad.append("hidden_act silu, moe_router_activation_func sigmoid")
    if dec.num_expert_group != 1 or dec.topk_group != 1:
        bad.append("num_expert_group = topk_group = 1")
    if not dec.mla_use_nope or dec.rope_scaling is not None:
        bad.append("mla_use_nope (no rotary embedding)")
    if dec.q_lora_rank is not None:
        bad.append("q_lora_rank null")
    if dec.num_key_value_heads != dec.num_attention_heads:
        bad.append("num_key_value_heads = num_attention_heads")
    if dec.moe_layer_freq != 1 or dec.num_shared_experts < 1:
        bad.append("moe_layer_freq 1, at least one shared expert")
    if dec.held_experts is not None:
        first, count = dec.held_experts
        if first < 0 or count < 1 or first + count > dec.num_experts:
            bad.append(f"held_experts within the {dec.num_experts} experts")
    if bad:
        raise NotImplementedError("the port's Kimi Linear tower takes " +
                                  "; ".join(bad))


def kinds(dec: KimiLinearConfig) -> List[Tuple[str, str]]:
    """(token mixer, channel mixer) of each layer: ("kda" | "mla",
    "mlp" | "moe")."""
    kda = set(dec.linear_attn_config.kda_layers)
    return [("kda" if i + 1 in kda else "mla",
             "mlp" if i < dec.first_k_dense_replace else "moe")
            for i in range(dec.num_hidden_layers)]


def held(dec: KimiLinearConfig) -> Tuple[int, int]:
    """(first expert id, count) of the experts this tree holds."""
    return dec.held_experts or (0, dec.num_experts)


def kda_widths(dec: KimiLinearConfig) -> Tuple[int, int, int]:
    """(heads, head width, in_proj's outputs): q, k, v, the two low-rank
    gate inputs (a head wide each) and beta."""
    H, Dh = dec.linear_attn_config.num_heads, dec.linear_attn_config.head_dim
    return H, Dh, 3 * H * Dh + 2 * Dh + H


def leaf_shapes(dec: KimiLinearConfig, joint_dim: int
                ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(path, shape) of every leaf of the tree, in draw order."""
    D = dec.hidden_size
    H, Dh, proj = kda_widths(dec)
    K = dec.linear_attn_config.short_conv_kernel_size
    Hq, dn, dr, dv = (dec.num_attention_heads, dec.qk_nope_head_dim,
                      dec.qk_rope_head_dim, dec.v_head_dim)
    R = dec.kv_lora_rank
    E, F_ = dec.num_experts, dec.moe_intermediate_size
    Eh = held(dec)[1]
    Fs = F_ * dec.num_shared_experts
    out = [(("embeddings",), (dec.vocab_size, D))]
    for i, (mix, chan) in enumerate(kinds(dec)):
        leaves = [("norm", (D,))]
        if mix == "kda":
            leaves += [("in_proj", (D, proj)), ("conv_w", (3 * H * Dh, K)),
                       ("f_b", (Dh, H * Dh)), ("g_b", (Dh, H * Dh)),
                       ("A_log", (H,)), ("dt_bias", (H * Dh,)),
                       ("o_norm", (Dh,)), ("o_proj", (H * Dh, D))]
        else:
            leaves += [("q", (D, Hq * (dn + dr))), ("kv_a", (D, R + dr)),
                       ("kv_norm", (R,)), ("kv_b", (R, Hq * (dn + dv))),
                       ("o", (Hq * dv, D))]
        leaves.append(("mlp_norm", (D,)))
        if chan == "mlp":
            leaves += [("gate_up", (D, 2 * dec.intermediate_size)),
                       ("down", (dec.intermediate_size, D))]
        else:
            leaves += [("router", (D, E)), ("e_bias", (E,)),
                       ("up", (Eh, D, 2 * F_)), ("down", (Eh, F_, D)),
                       ("shared_up", (D, 2 * Fs)), ("shared_down", (Fs, D))]
        out += [((f"layer{i}", leaf), shape) for leaf, shape in leaves]
    out += [(("norm_f",), (D,)), (("query_proj", "w"), (D, joint_dim)),
            (("query_proj", "b"), (joint_dim,))]
    return out


def check_params(params: Dict, dec: KimiLinearConfig) -> None:
    """Raise unless every leaf of ``leaf_shapes`` is there at its shape,
    the router, its bias, A_log and dt_bias in f32."""
    check(dec)
    d = params["query_proj"]["w"].shape[1]
    for path, shape in leaf_shapes(dec, d):
        node = params
        for key in path:
            if key not in node:
                raise KeyError(f"the Kimi Linear tree has no "
                               f"{'/'.join(path)}")
            node = node[key]
        if tuple(node.shape) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(node.shape)}, "
                             f"want {shape}")
        if path[-1] in F32_LEAVES and node.dtype != torch.float32:
            raise ValueError(f"{'/'.join(path)} must be f32")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / RMS(x) * w in f32, at x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


def kda_mixer(h: torch.Tensor, p: Dict, dec: KimiLinearConfig,
              lengths: torch.Tensor) -> torch.Tensor:
    """h [B, T, D] -> [B, T, D]: the KDA token mixer (0 past ``lengths``
    before o_proj)."""
    Bsz, T, _ = h.shape
    H, Dh, _ = kda_widths(dec)
    HD = H * Dh
    proj = h @ p["in_proj"]
    qkv, fa, ga, b = proj.split([3 * HD, Dh, Dh, H], dim=-1)
    qkv = F.silu(causal_conv(qkv, p["conv_w"], None)).to(h.dtype)
    A = -torch.exp(p["A_log"]).repeat_interleave(Dh)
    g = A * F.softplus((fa @ p["f_b"]).float() + p["dt_bias"])
    beta = torch.sigmoid(b.float()).contiguous()
    o = kda_attend(qkv, g, beta, lengths, H, Dh ** -0.5, L2_EPS)
    gate = (ga @ p["g_b"]).float().reshape(Bsz, T, H, Dh)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + dec.rms_norm_eps)
    o = o * p["o_norm"].float() * torch.sigmoid(gate)
    return o.reshape(Bsz, T, HD).to(h.dtype) @ p["o_proj"]


def mla_mixer(h: torch.Tensor, p: Dict, dec: KimiLinearConfig
              ) -> torch.Tensor:
    """Causal multi-head latent attention over h [B, T, D] with no position
    encoding: scores and softmax in f32 from the products' rounded
    outputs."""
    Bsz, T, _ = h.shape
    Hq, dn, dr, dv = (dec.num_attention_heads, dec.qk_nope_head_dim,
                      dec.qk_rope_head_dim, dec.v_head_dim)
    R = dec.kv_lora_rank
    q = (h @ p["q"]).reshape(Bsz, T, Hq, dn + dr)
    c, k_pe = (h @ p["kv_a"]).split([R, dr], dim=-1)
    kv = (rmsnorm(c, p["kv_norm"], dec.rms_norm_eps) @ p["kv_b"]).reshape(
        Bsz, T, Hq, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, Hq, -1)], -1)
    q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(dn + dr)     # [B, Hq, T, T]
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ v
    a = a.transpose(1, 2).reshape(Bsz, T, Hq * dv)
    return a.to(h.dtype) @ p["o"]


def hidden(params: Dict, dec: KimiLinearConfig, tokens: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    """The final-normed state of each query's last live token [Q, D]."""
    Q, T = tokens.shape
    x = params["embeddings"][tokens.long()]            # [Q, T, D]
    lengths = lengths.long()
    live = (torch.arange(T, device=x.device)[None, :]
            < lengths[:, None]).reshape(-1)
    eps = dec.rms_norm_eps
    for i, (mix, chan) in enumerate(kinds(dec)):
        p = params[f"layer{i}"]
        trace.stage("encode." + mix)
        h = rmsnorm(x, p["norm"], eps)
        if mix == "kda":
            x = x + kda_mixer(h, p, dec, lengths)
        else:
            x = x + mla_mixer(h, p, dec)
        trace.stage("encode." + chan)
        h = rmsnorm(x, p["mlp_norm"], eps)
        if chan == "mlp":
            out = swiglu(h @ p["gate_up"]) @ p["down"]
        else:
            out = moe_block(h.reshape(Q * T, -1), p,
                            dec.num_experts_per_token,
                            dec.routed_scaling_factor, dec.moe_renormalize,
                            live, act="swiglu",
                            held=dec.held_experts).reshape(Q, T, -1)
        x = x + out
    trace.stage("encode")
    last = x[torch.arange(Q, device=x.device), (lengths - 1).clamp(min=0)]
    return rmsnorm(last, params["norm_f"], eps)


def embed_queries_multi(params: Dict, model, tokens: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Per-stream query embeddings [S, Q, d] f32: the pooled state through
    the one query projection (its product at the weights' dtype), repeated
    for every stream (a decoder tower has no per-stream projection)."""
    if model.cfg.per_stream_query_proj:
        raise ValueError("the Kimi Linear tower has one query projection")
    h = hidden(params, model.decoder, tokens, lengths)
    p = params["query_proj"]
    q = mm_f32(h, p["w"], p["w"].dtype) + p["b"].float()
    return torch.stack([q for _ in model.streams])
