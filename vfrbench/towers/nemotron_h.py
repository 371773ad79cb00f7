"""A Nemotron-H decoder LM as the query tower (the port's
``models/nemotron_h.py``): the seam's seven names (``towers/mcn.py``),
with ``stage_work`` for the per-stage readers.

The configuration's file states the published ``config.json`` keys at its
top level; ``sizes`` refuses a run whose port configuration (the preset's
``decoder`` section) differs from them.  ``make_params`` draws the weights
on the run's device one leaf at a time, at the configuration's
``param_dtype`` (bf16; the router, its correction bias and the scan's
dt_bias, A_log and D in f32), so that no f32 copy of a layer is ever
made; every query stage's products read them at that dtype (``plan``).

Work is counted from shapes (``work.py``'s rules) over the live tokens.
Every expert's weights count as read once a batch: true when every expert
gets a token, as at Q = 256 queries of 4-24 tokens (some 21,500 routings
over 128 experts).  Operations: the products at the weights' dtype; the
router's product, the convolution, the scan (5 P N a head and token: the
decay, the update, the read-out) and the attention core in f32.
"""

import dataclasses
import math

import torch

from vfrbench import inputs, work
from vfrbench.reference import mcn
from vfrbench.reference import nemotron_h as ref

STAGES = ref.STAGES
F32_LEAVES = ("router", "e_bias", "dt_bias", "A_log", "D")
PARAM_STREAM = 21
# the correction bias's common part (make_params)
E_BIAS_OFFSET = -0.6


def sizes(cell, cfg):
    """The decoder's published keys (checked against the file's), the
    weights' dtype and the traffic's mean count of causal (query, key)
    pairs a query."""
    if cfg.decoder is None:
        raise ValueError(f"preset {cfg.name!r} has no decoder section")
    dec = dataclasses.asdict(cfg.decoder)
    for key, want in dec.items():
        if key in cell.config and cell.config[key] != want:
            raise ValueError(f"{cell.name}: {key} = {cell.config[key]!r} in "
                             f"the file, {want!r} in the preset")
    lo, hi = int(cell.traffic["len_min"]), int(cell.traffic["len_max"])
    pairs = sum(L * (L + 1) / 2 for L in range(lo, hi + 1)) / (hi - lo + 1)
    return {"decoder": dec, "weights": cfg.model.param_dtype,
            "pairs_per_query": pairs}


def check(s, cfg):
    """The reference covers a Nemotron-H tower of M, E and * blocks, SiLU
    and relu^2, one shared expert, no group routing, no biases, the last
    token's state and the sqeuclidean or cosine distance."""
    dec = s["decoder"]
    if (set(dec["hybrid_override_pattern"]) - set("ME*")
            or dec["mamba_hidden_act"] != "silu"
            or dec["mlp_hidden_act"] != "relu2"
            or dec["n_shared_experts"] != 1 or dec["n_group"] != 1
            or dec["attention_bias"] or dec["use_bias"]
            or dec["mlp_bias"] or dec["sliding_window"] is not None
            or cfg.model.per_stream_query_proj
            or s["distance"] not in ("sqeuclidean", "cosine")):
        raise ValueError("the Nemotron-H reference covers M / E / * blocks "
                         "(SiLU, relu^2, one shared expert, no group "
                         "routing, no biases, full attention), one query "
                         "projection and the sqeuclidean or cosine distance")


def leaf_shapes(s):
    """(path, shape, init, scale) of every leaf, in draw order: the port's
    layout (``models/nemotron_h.py``)."""
    dec = s["decoder"]
    D, d = dec["hidden_size"], s["d"]
    H, P = dec["mamba_num_heads"], dec["mamba_head_dim"]
    G, N, K = dec["n_groups"], dec["ssm_state_size"], dec["conv_kernel"]
    E, F_ = dec["n_routed_experts"], dec["moe_intermediate_size"]
    Fs = dec["moe_shared_expert_intermediate_size"]
    Hq, Hk, hd = (dec["num_attention_heads"], dec["num_key_value_heads"],
                  dec["head_dim"])
    di = H * P
    conv = di + 2 * G * N
    res = 1 / math.sqrt(dec["num_hidden_layers"])    # a block's output
    out = [(("embeddings",), (dec["vocab_size"], D), "normal", 1.0)]
    for i, kind in enumerate(dec["hybrid_override_pattern"]):
        L = f"layer{i}"
        out.append(((L, "norm"), (D,), "norm", 0.1))
        if kind == "M":
            out += [((L, "in_proj"), (D, di + conv + H), "uniform",
                     1 / math.sqrt(D)),
                    ((L, "conv_w"), (conv, K), "uniform", 1 / math.sqrt(K)),
                    ((L, "conv_b"), (conv,), "uniform", 1 / math.sqrt(K)),
                    ((L, "dt_bias"), (H,), "dt_bias", 0.0),
                    ((L, "A_log"), (H,), "A_log", 0.0),
                    ((L, "D"), (H,), "uniform", 0.1),
                    ((L, "gate_norm"), (di,), "norm", 0.1),
                    ((L, "out_proj"), (di, D), "uniform",
                     res / math.sqrt(di))]
        elif kind == "E":
            out += [((L, "router"), (D, E), "uniform", 1 / math.sqrt(D)),
                    ((L, "e_bias"), (E,), "e_bias", 0.05),
                    ((L, "up"), (E, D, F_), "uniform", 1 / math.sqrt(D)),
                    ((L, "down"), (E, F_, D), "uniform", res / math.sqrt(F_)),
                    ((L, "shared_up"), (D, Fs), "uniform", 1 / math.sqrt(D)),
                    ((L, "shared_down"), (Fs, D), "uniform",
                     res / math.sqrt(Fs))]
        else:
            out += [((L, "qkv"), (D, (Hq + 2 * Hk) * hd), "uniform",
                     1 / math.sqrt(D)),
                    ((L, "o"), (Hq * hd, D), "uniform",
                     res / math.sqrt(Hq * hd))]
    out += [(("norm_f",), (D,), "norm", 0.1),
            (("query_proj", "w"), (D, d), "uniform", 1 / math.sqrt(D)),
            (("query_proj", "b"), (d,), "zeros", 0.0)]
    return out


def make_params(s, seed, dev):
    """Seeded weights on ``dev``, one leaf at a time from one generator:
    the embedding table N(0, 1); projections and experts U(+-1/sqrt(fan
    in)), a block's output projection (Mamba's out_proj, attention's o,
    the experts' and the shared expert's down) divided by
    sqrt(num_hidden_layers) (the published ``rescale_prenorm_residual``,
    which the published code applies to out_proj, here to every block's
    output); the conv's weights and bias U(+-1/sqrt(width)); norms 1 +
    U(+-0.1); dt_bias and A_log by the published initialisation (dt
    log-uniform over [time_step_min, time_step_max], floored at
    time_step_floor, through the inverse softplus; A uniform over
    [1, 16]); the query projection's bias 0.

    Two leaves are drawn so that a planted fault in their part shows at
    the cell's size beside the rounding of bf16 weights (the routing's
    near-ties):

    * D U(+-0.1), where the published initialisation has 1: at 1 the
      skip D x carries a head's output at these dt, and a decay without
      dt moves a Mamba block's output by some 3%; at U(+-0.1) the state's
      read-out carries it, and that fault moves it by some 40%;
    * the correction bias E_BIAS_OFFSET + U(+-0.05): the spread moves the
      choice; the common part moves no choice and no weight of a router
      that keeps the bias out of the weights, and changes the weights of
      one that lets it in by some 15% (at 0 some 3%), the chosen
      scores lying some 0.65-0.9."""
    dec = s["decoder"]
    g = inputs.generator(seed, dev, PARAM_STREAM)
    store = getattr(torch, s["weights"])
    tree = {}
    for path, shape, init, scale in leaf_shapes(s):
        dtype = torch.float32 if path[-1] in F32_LEAVES else store
        x = torch.empty(shape, dtype=dtype, device=dev)
        if init == "normal":
            x.normal_(0.0, scale, generator=g)
        elif init == "uniform":
            x.uniform_(-scale, scale, generator=g)
        elif init == "norm":
            x.uniform_(1.0 - scale, 1.0 + scale, generator=g)
        elif init == "zeros":
            x.zero_()
        elif init == "e_bias":
            x.uniform_(-scale, scale, generator=g).add_(E_BIAS_OFFSET)
        elif init == "A_log":
            x.uniform_(1.0, 16.0, generator=g).log_()
        elif init == "dt_bias":
            lo, hi = math.log(dec["time_step_min"]), math.log(
                dec["time_step_max"])
            x.uniform_(lo, hi, generator=g).exp_()
            x.clamp_(min=dec["time_step_floor"])
            x.add_(torch.log(-torch.expm1(-x)))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return tree


def plan(cfg, dev):
    """Every query stage's products on the stored weights, at their
    dtype."""
    return {stage: cfg.model.param_dtype for stage in STAGES}


def reference_queries(params, s, tokens, lengths, plan):
    """[S, Q, d]: the plain reference's queries; unit length under the
    cosine distance."""
    q = ref.queries(params, s["decoder"], s["streams"], tokens, lengths,
                    plan)
    return mcn.l2n(q) if s["distance"] == "cosine" else q


# ------------------------------------------------------------- work

def _layers(s):
    pattern = s["decoder"]["hybrid_override_pattern"]
    return {k: pattern.count(k) for k in "ME*"}


def stage_work(s, stage):
    """(bytes, operations by dtype) of one batch's ``stage``: "mamba",
    "attention" or "moe" over all its layers, or "head" (the embedding
    rows, the final norm, the pool and the query projection)."""
    dec = s["decoder"]
    L, Q, S, d = s["live_steps"], s["Q"], s["streams"], s["d"]
    D = dec["hidden_size"]
    W = s["weights"]
    wb = work.DTYPE_BYTES[W]
    act = 2 * L * D * wb                 # a block's input read, output written
    n = _layers(s)
    if stage == "mamba":
        H, P = dec["mamba_num_heads"], dec["mamba_head_dim"]
        G, N, K = dec["n_groups"], dec["ssm_state_size"], dec["conv_kernel"]
        di = H * P
        conv = di + 2 * G * N
        proj = di + conv + H
        w = (D * proj + di * D + conv * K + conv + di + D) * wb + 3 * H * 4
        prod = 2.0 * L * (D * proj + di * D)
        f32 = L * (2.0 * conv * K + 5.0 * H * P * N)
        return n["M"] * (w + act), work.add({W: n["M"] * prod},
                                             {"float32": n["M"] * f32})
    if stage == "attention":
        Hq, Hk, hd = (dec["num_attention_heads"], dec["num_key_value_heads"],
                      dec["head_dim"])
        w = (D * (Hq + 2 * Hk) * hd + Hq * hd * D + D) * wb
        prod = 2.0 * L * (D * (Hq + 2 * Hk) * hd + Hq * hd * D)
        f32 = 2.0 * 2.0 * Hq * hd * Q * s["pairs_per_query"]
        return n["*"] * (w + act), work.add({W: n["*"] * prod},
                                             {"float32": n["*"] * f32})
    if stage == "moe":
        E, F_ = dec["n_routed_experts"], dec["moe_intermediate_size"]
        Fs = dec["moe_shared_expert_intermediate_size"]
        k = dec["num_experts_per_tok"]
        w = (E * 2 * D * F_ + 2 * D * Fs + D) * wb + (D * E + E) * 4
        prod = 2.0 * L * (k * 2 * D * F_ + 2 * D * Fs)
        f32 = 2.0 * L * D * E
        return n["E"] * (w + act), work.add({W: n["E"] * prod},
                                             {"float32": n["E"] * f32})
    if stage == "head":
        bytes_ = L * D * wb + D * wb + D * d * wb + d * wb + S * Q * d * 4
        return bytes_, {W: 2.0 * Q * D * d}
    raise KeyError(f"no stage {stage!r}")


def encode_work(s):
    """(bytes, operations by dtype) of encoding one batch: every stage."""
    parts = [stage_work(s, st) for st in ("mamba", "attention", "moe",
                                          "head")]
    return (sum(b for b, _ in parts), work.add(*(o for _, o in parts)))
