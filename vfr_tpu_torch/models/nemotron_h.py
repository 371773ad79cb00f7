"""A Nemotron-H decoder LM as the query tower (NVIDIA Nemotron-H,
arXiv:2504.03624; the published ``modeling_nemotron_h.py``): token
embeddings, blocks of one pre-norm mixer with a residual each, the final
RMSNorm, then the last live token's state projected to the joint space.
An embedder stops at the final norm: there is no LM head.

Blocks, by ``hybrid_override_pattern``:

* ``M``, a Mamba-2 mixer: in_proj -> (z, xBC, dt); xBC through the causal
  depthwise conv and SiLU -> (x, B, C); dt = softplus(dt + dt_bias),
  A = -exp(A_log); the SSD scan with the D skip; the gated group RMSNorm;
  out_proj.  Everything between the two GEMMs is one call,
  ``ops/kernels/mamba2_kernel.py::mamba2_chain``: on the card one kernel
  (``csrc/mamba2_scan.cu``) that reads in_proj's product in place and
  writes out_proj's operand, on the CPU the PyTorch passes
  (``ops/mamba2.py``).
* ``E``, a mixture of experts with a shared expert (``ops/moe.py``).
* ``*``, causal GQA attention with no position encoding (the published
  mixer applies no RoPE: the Mamba blocks carry order) and no biases.

Precision: products at the weights' dtype (bf16 in serving), the router's
and the scan's in f32, every norm in f32, the residual stream at the
embedding table's dtype (the published ``residual_in_fp32`` is false).

The parameter tree (``check_params``): ``embeddings`` [V, D]; per block
``layer<i>`` with ``norm`` [D] and its mixer's leaves; ``norm_f`` [D];
``query_proj`` (``w`` [D, d], ``b`` [d]).  The experts stack ``up``
[E, D, F] and ``down`` [E, F, D].

The batch marks its stages for the port's recorder (``utils/trace.py``):
each block ``encode.mamba``, ``encode.moe`` or ``encode.attn``, and the
final norm, pool and projection ``encode`` again (with the embedding
gather, before the first block).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from vfr_tpu_torch.config import DecoderConfig
from vfr_tpu_torch.device import mm_f32
from vfr_tpu_torch.ops.kernels.mamba2_kernel import mamba2_chain
from vfr_tpu_torch.ops.moe import moe_block
from vfr_tpu_torch.utils import trace

STAGE = {"M": "encode.mamba", "E": "encode.moe", "*": "encode.attn"}
F32_LEAVES = ("router", "e_bias", "dt_bias", "A_log", "D")


def check(dec: DecoderConfig) -> None:
    """Raise for a configuration whose mathematics the port does not
    implement."""
    pattern = dec.hybrid_override_pattern
    bad = []
    if len(pattern) != dec.num_hidden_layers or set(pattern) - set(STAGE):
        bad.append("hybrid_override_pattern: one of M, E, * a layer")
    if dec.mamba_hidden_act != "silu" or dec.mlp_hidden_act != "relu2":
        bad.append("mamba_hidden_act silu, mlp_hidden_act relu2")
    if (dec.attention_bias or dec.use_bias or dec.mamba_proj_bias
            or dec.mlp_bias):
        bad.append("no projection biases")
    if dec.n_group != 1 or dec.topk_group != 1 or dec.n_shared_experts != 1:
        bad.append("n_group = topk_group = n_shared_experts = 1")
    if dec.sliding_window is not None or dec.residual_in_fp32:
        bad.append("full attention, residual at the weights' dtype")
    if (dec.mamba_num_heads % dec.n_groups
            or dec.num_attention_heads % dec.num_key_value_heads):
        bad.append("heads a multiple of groups and of KV heads")
    if bad:
        raise NotImplementedError("the port's Nemotron-H tower takes " +
                                  "; ".join(bad))


def mamba_widths(dec: DecoderConfig) -> Tuple[int, int, int]:
    """(d_inner, the conv's channels, in_proj's outputs): d_inner is
    ``mamba_num_heads * mamba_head_dim`` (not ``expand * hidden_size``)."""
    di = dec.mamba_num_heads * dec.mamba_head_dim
    conv = di + 2 * dec.n_groups * dec.ssm_state_size
    return di, conv, di + conv + dec.mamba_num_heads


def leaf_shapes(dec: DecoderConfig, joint_dim: int
                ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(path, shape) of every leaf of the tree, in draw order."""
    D = dec.hidden_size
    di, conv, proj = mamba_widths(dec)
    H, E = dec.mamba_num_heads, dec.n_routed_experts
    F_, Fs = dec.moe_intermediate_size, dec.moe_shared_expert_intermediate_size
    qkv = (dec.num_attention_heads + 2 * dec.num_key_value_heads) * \
        dec.head_dim
    out = [(("embeddings",), (dec.vocab_size, D))]
    for i, kind in enumerate(dec.hybrid_override_pattern):
        name = f"layer{i}"
        leaves = [("norm", (D,))]
        if kind == "M":
            leaves += [("in_proj", (D, proj)), ("conv_w", (conv,
                                                          dec.conv_kernel)),
                       ("conv_b", (conv,)), ("dt_bias", (H,)),
                       ("A_log", (H,)), ("D", (H,)), ("gate_norm", (di,)),
                       ("out_proj", (di, D))]
        elif kind == "E":
            leaves += [("router", (D, E)), ("e_bias", (E,)),
                       ("up", (E, D, F_)), ("down", (E, F_, D)),
                       ("shared_up", (D, Fs)), ("shared_down", (Fs, D))]
        else:
            leaves += [("qkv", (D, qkv)),
                       ("o", (dec.num_attention_heads * dec.head_dim, D))]
        out += [((name, leaf), shape) for leaf, shape in leaves]
    out += [(("norm_f",), (D,)), (("query_proj", "w"), (D, joint_dim)),
            (("query_proj", "b"), (joint_dim,))]
    return out


def check_params(params: Dict, dec: DecoderConfig) -> None:
    """Raise unless every leaf of ``leaf_shapes`` is there at its shape,
    the router, its bias and the scan's dt_bias, A_log and D in f32."""
    check(dec)
    d = params["query_proj"]["w"].shape[1]
    for path, shape in leaf_shapes(dec, d):
        node = params
        for key in path:
            if key not in node:
                raise KeyError(f"the Nemotron-H tree has no {'/'.join(path)}")
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


def mamba_mixer(h: torch.Tensor, p: Dict, dec: DecoderConfig,
                lengths: torch.Tensor) -> torch.Tensor:
    """h [B, T, D] -> [B, T, D] (the scan's output 0 past ``lengths``):
    in_proj, the fused chain, out_proj."""
    y = mamba2_chain(h @ p["in_proj"], lengths, p["conv_w"],
                     p["conv_b"] if dec.use_conv_bias else None,
                     p["dt_bias"], p["A_log"], p["D"], p["gate_norm"],
                     dec.n_groups, dec.layer_norm_epsilon)
    return y.to(h.dtype) @ p["out_proj"]


def attention_mixer(h: torch.Tensor, p: Dict, dec: DecoderConfig
                    ) -> torch.Tensor:
    """Causal GQA over h [B, T, D]: scores and softmax in f32 from the
    projections' rounded outputs, no position encoding."""
    Bsz, T, _ = h.shape
    Hq, Hk, hd = (dec.num_attention_heads, dec.num_key_value_heads,
                  dec.head_dim)
    q, k, v = (h @ p["qkv"]).split([Hq * hd, Hk * hd, Hk * hd], dim=-1)
    q = q.reshape(Bsz, T, Hk, Hq // Hk, hd).permute(0, 2, 3, 1, 4).float()
    k = k.reshape(Bsz, T, Hk, 1, hd).permute(0, 2, 3, 4, 1).float()
    v = v.reshape(Bsz, T, Hk, 1, hd).permute(0, 2, 3, 1, 4).float()
    s = (q @ k) / math.sqrt(hd)                         # [B, Hk, r, T, T]
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ v
    a = a.permute(0, 3, 1, 2, 4).reshape(Bsz, T, Hq * hd)
    return a.to(h.dtype) @ p["o"]


def hidden(params: Dict, dec: DecoderConfig, tokens: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    """The final-normed state of each query's last live token [Q, D]."""
    Q, T = tokens.shape
    x = params["embeddings"][tokens.long()]            # [Q, T, D]
    lengths = lengths.long()
    live = (torch.arange(T, device=x.device)[None, :]
            < lengths[:, None]).reshape(-1)
    eps = dec.layer_norm_epsilon
    for i, kind in enumerate(dec.hybrid_override_pattern):
        trace.stage(STAGE[kind])
        p = params[f"layer{i}"]
        h = rmsnorm(x, p["norm"], eps)
        if kind == "M":
            out = mamba_mixer(h, p, dec, lengths)
        elif kind == "E":
            out = moe_block(h.reshape(Q * T, -1), p, dec.num_experts_per_tok,
                            dec.routed_scaling_factor, dec.norm_topk_prob,
                            live).reshape(Q, T, -1)
        else:
            out = attention_mixer(h, p, dec)
        x = x + out
    trace.stage("encode")
    last = x[torch.arange(Q, device=x.device), (lengths - 1).clamp(min=0)]
    return rmsnorm(last, params["norm_f"], dec.norm_eps)


def embed_queries_multi(params: Dict, model, tokens: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Per-stream query embeddings [S, Q, d] f32: the pooled state through
    the one query projection (its product at the weights' dtype), repeated
    for every stream (a decoder tower has no per-stream projection)."""
    if model.cfg.per_stream_query_proj:
        raise ValueError("the Nemotron-H tower has one query projection")
    h = hidden(params, model.decoder, tokens, lengths)
    p = params["query_proj"]
    q = mm_f32(h, p["w"], p["w"].dtype) + p["b"].float()
    return torch.stack([q for _ in model.streams])
