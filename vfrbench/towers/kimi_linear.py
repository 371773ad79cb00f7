"""A Kimi Linear decoder LM as the query tower (the port's
``models/kimi_linear.py``): the seam's seven names (``towers/mcn.py``),
with ``stage_work`` for the per-stage readers.

The configuration's file states the published ``config.json`` keys at its
top level, ``num_experts`` as the count this card holds of each MoE layer
(listed in ``reduced``; the published count under ``published``), beside
the port's ``held_experts``; ``sizes`` refuses a run whose port
configuration (the preset's ``decoder`` section) differs from them.
``make_params`` draws the weights on the run's device one leaf at a time,
at the configuration's ``param_dtype`` (bf16; the router, its correction
bias, A_log and dt_bias in f32), so that no f32 copy of a layer is ever
made; every query stage's products read them at that dtype (``plan``).

Work is counted from shapes (``work.py``'s rules) over the live tokens.
Every held expert's weights count as read once a batch: true when every
expert gets a token, as at Q = 256 queries of 4-24 tokens (some 14,000
routings to the 128 held experts).  The experts' products count the
routings to the held experts alone (a held share of ``num_experts_per_
token``).  Operations: the products at the weights' dtype; the router's
product, the convolution, the KDA kernel (``stage_work("kda_kernel")``:
the form it computes, each causal pair (t, s) of a head's chunk a
difference, an exponential, a product and two FMAs a channel for A and B,
two FMAs a channel for the solve's and the read-out's pairs, and the two
L2 norms) and the MLA core in f32.
"""

import dataclasses
import json
import math

import torch

from vfrbench import inputs, work
from vfrbench.reference import kimi_linear as ref
from vfrbench.reference import mcn

STAGES = ref.STAGES
F32_LEAVES = ("router", "e_bias", "A_log", "dt_bias")
PARAM_STREAM = 23
TIME_STEP = (0.001, 0.1)     # dt's range at initialisation (as Mamba's)


def _plain(x):
    """A dataclass's dict as its JSON file holds it (tuples as lists)."""
    return json.loads(json.dumps(x))


def sizes(cell, cfg):
    """The decoder's published keys (checked against the file's, the
    file's ``num_experts`` the held count), the weights' dtype and the
    traffic's mean count of causal (query, key) pairs a query."""
    if cfg.decoder is None or cfg.decoder.model_type != "kimi_linear":
        raise ValueError(f"preset {cfg.name!r} has no kimi_linear decoder")
    dec = _plain(dataclasses.asdict(cfg.decoder))
    count = ref.held(dec)[1]
    published = cell.config.get("published", {})
    for key, want in dec.items():
        have = cell.config.get(key, want)
        if key == "num_experts":
            have, want = (have, published.get(key, want)), (count, want)
        if have != want:
            raise ValueError(f"{cell.name}: {key} = {have!r} in the file, "
                             f"{want!r} in the preset")
    lo, hi = int(cell.traffic["len_min"]), int(cell.traffic["len_max"])
    pairs = sum(L * (L + 1) / 2 for L in range(lo, hi + 1)) / (hi - lo + 1)
    return {"decoder": dec, "weights": cfg.model.param_dtype,
            "pairs_per_query": pairs}


def check(s, cfg):
    """The reference covers a Kimi Linear tower of KDA and NoPE MLA token
    mixers, SwiGLU channel mixers, a sigmoid router of one expert group,
    the last token's state and the sqeuclidean or cosine distance."""
    dec = s["decoder"]
    lac = dec["linear_attn_config"]
    layers = set(range(1, dec["num_hidden_layers"] + 1))
    if (set(lac["kda_layers"]) | set(lac["full_attn_layers"]) != layers
            or set(lac["kda_layers"]) & set(lac["full_attn_layers"])
            or dec["hidden_act"] != "silu"
            or dec["moe_router_activation_func"] != "sigmoid"
            or dec["num_expert_group"] != 1 or dec["topk_group"] != 1
            or not dec["mla_use_nope"] or dec["q_lora_rank"] is not None
            or dec["num_key_value_heads"] != dec["num_attention_heads"]
            or cfg.model.per_stream_query_proj
            or s["distance"] not in ("sqeuclidean", "cosine")):
        raise ValueError("the Kimi Linear reference covers KDA and NoPE "
                         "MLA layers (no low-rank q, as many KV heads as "
                         "heads), SiLU, a sigmoid router of one group, one "
                         "query projection and the sqeuclidean or cosine "
                         "distance")


def leaf_shapes(s):
    """(path, shape, init, scale) of every leaf, in draw order: the port's
    layout (``models/kimi_linear.py``)."""
    dec = s["decoder"]
    lac = dec["linear_attn_config"]
    D, d = dec["hidden_size"], s["d"]
    H, Dh, K = lac["num_heads"], lac["head_dim"], lac["short_conv_kernel_size"]
    HD = H * Dh
    Hq, dn, dr, dv = (dec["num_attention_heads"], dec["qk_nope_head_dim"],
                      dec["qk_rope_head_dim"], dec["v_head_dim"])
    R, I = dec["kv_lora_rank"], dec["intermediate_size"]
    E, F_ = dec["num_experts"], dec["moe_intermediate_size"]
    Eh = ref.held(dec)[1]
    Fs = F_ * dec["num_shared_experts"]
    res = 1 / math.sqrt(2 * dec["num_hidden_layers"])    # a sublayer's out
    u = "uniform"
    out = [(("embeddings",), (dec["vocab_size"], D), "normal", 1.0)]
    for i, (mix, chan) in enumerate(ref.kinds(dec)):
        L = f"layer{i}"
        out.append(((L, "norm"), (D,), "norm", 0.1))
        if mix == "kda":
            out += [((L, "in_proj"), (D, 3 * HD + 2 * Dh + H), u,
                     1 / math.sqrt(D)),
                    ((L, "conv_w"), (3 * HD, K), u, 1 / math.sqrt(K)),
                    ((L, "f_b"), (Dh, HD), u, 1 / math.sqrt(Dh)),
                    ((L, "g_b"), (Dh, HD), u, 1 / math.sqrt(Dh)),
                    ((L, "A_log"), (H,), "A_log", 0.0),
                    ((L, "dt_bias"), (HD,), "dt_bias", 0.0),
                    ((L, "o_norm"), (Dh,), "norm", 0.1),
                    ((L, "o_proj"), (HD, D), u, res / math.sqrt(HD))]
        else:
            out += [((L, "q"), (D, Hq * (dn + dr)), u, 1 / math.sqrt(D)),
                    ((L, "kv_a"), (D, R + dr), u, 1 / math.sqrt(D)),
                    ((L, "kv_norm"), (R,), "norm", 0.1),
                    ((L, "kv_b"), (R, Hq * (dn + dv)), u, 1 / math.sqrt(R)),
                    ((L, "o"), (Hq * dv, D), u, res / math.sqrt(Hq * dv))]
        out.append(((L, "mlp_norm"), (D,), "norm", 0.1))
        if chan == "mlp":
            out += [((L, "gate_up"), (D, 2 * I), u, 1 / math.sqrt(D)),
                    ((L, "down"), (I, D), u, res / math.sqrt(I))]
        else:
            out += [((L, "router"), (D, E), u, 1 / math.sqrt(D)),
                    ((L, "e_bias"), (E,), u, 0.05),
                    ((L, "up"), (Eh, D, 2 * F_), u, 1 / math.sqrt(D)),
                    ((L, "down"), (Eh, F_, D), u, res / math.sqrt(F_)),
                    ((L, "shared_up"), (D, 2 * Fs), u, 1 / math.sqrt(D)),
                    ((L, "shared_down"), (Fs, D), u, res / math.sqrt(Fs))]
    out += [(("norm_f",), (D,), "norm", 0.1),
            (("query_proj", "w"), (D, d), u, 1 / math.sqrt(D)),
            (("query_proj", "b"), (d,), "zeros", 0.0)]
    return out


def make_params(s, seed, dev):
    """Seeded weights on ``dev``, one leaf at a time from one generator:
    the embedding table N(0, 1); projections and experts U(+-1/sqrt(fan
    in)), each sublayer's output projection (KDA's o_proj, MLA's o, the
    MLP's, the experts' and the shared expert's down) divided by
    sqrt(2 num_hidden_layers), the count of residual sublayers; the convs
    U(+-1/sqrt(width)); norms 1 + U(+-0.1); the correction bias
    U(+-0.05); A_log and dt_bias by the published KDA initialisation
    (A uniform over [1, 16]; dt log-uniform over [0.001, 0.1] a channel,
    through the inverse softplus); the query projection's bias 0."""
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
        elif init == "A_log":
            x.uniform_(1.0, 16.0, generator=g).log_()
        elif init == "dt_bias":
            lo, hi = (math.log(t) for t in TIME_STEP)
            x.uniform_(lo, hi, generator=g).exp_()
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
    n = {"kda": 0, "mla": 0, "mlp": 0, "moe": 0}
    for mix, chan in ref.kinds(s["decoder"]):
        n[mix] += 1
        n[chan] += 1
    return n


def _kernel_work(s):
    """(bytes, operations by dtype) of one KDA layer's kernel a batch."""
    dec = s["decoder"]
    lac = dec["linear_attn_config"]
    H, Dh = lac["num_heads"], lac["head_dim"]
    L, Q, T = s["live_steps"], s["Q"], s["T"]
    wb = work.DTYPE_BYTES[s["weights"]]
    pairs = Q * s["pairs_per_query"]          # causal (t, s) pairs, s <= t
    ops = H * Dh * (7.0 * pairs + 2.0 * (pairs - L) + 2.0 * pairs + 4.0 * L)
    bytes_ = (3 * L * H * Dh * wb + L * H * Dh * 4 + L * H * 4
              + Q * T * H * Dh * 4)
    return bytes_, {"float32": ops}


def stage_work(s, stage):
    """(bytes, operations by dtype) of one batch's ``stage``: "kda",
    "mla", "mlp" or "moe" over all its sublayers, "kda_kernel" (the KDA
    kernel alone, over all KDA layers), or "head" (the embedding rows, the
    final norm, the pool and the query projection)."""
    dec = s["decoder"]
    L, Q, S, d = s["live_steps"], s["Q"], s["streams"], s["d"]
    D = dec["hidden_size"]
    W = s["weights"]
    wb = work.DTYPE_BYTES[W]
    act = 2 * L * D * wb           # a sublayer's input read, output written
    n = _layers(s)
    if stage in ("kda", "kda_kernel"):
        lac = dec["linear_attn_config"]
        H, Dh, K = (lac["num_heads"], lac["head_dim"],
                    lac["short_conv_kernel_size"])
        HD = H * Dh
        kb, kops = _kernel_work(s)
        if stage == "kda_kernel":
            return n["kda"] * kb, {"float32": n["kda"] * kops["float32"]}
        mats = D * (3 * HD + 2 * Dh + H) + 2 * Dh * HD + HD * D
        w = (mats + 3 * HD * K + Dh + D) * wb + (H + HD) * 4
        prod = 2.0 * L * mats
        f32 = L * 2.0 * 3 * HD * K + kops["float32"]
        return n["kda"] * (w + act), work.add({W: n["kda"] * prod},
                                               {"float32": n["kda"] * f32})
    if stage == "mla":
        Hq, dn, dr, dv = (dec["num_attention_heads"],
                          dec["qk_nope_head_dim"], dec["qk_rope_head_dim"],
                          dec["v_head_dim"])
        R = dec["kv_lora_rank"]
        mats = D * Hq * (dn + dr) + D * (R + dr) + R * Hq * (dn + dv) + \
            Hq * dv * D
        w = (mats + R + D) * wb
        f32 = 2.0 * Hq * (dn + dr + dv) * Q * s["pairs_per_query"]
        return n["mla"] * (w + act), work.add(
            {W: n["mla"] * 2.0 * L * mats}, {"float32": n["mla"] * f32})
    if stage == "mlp":
        I = dec["intermediate_size"]
        w = (3 * D * I + D) * wb
        return n["mlp"] * (w + act), {W: n["mlp"] * 2.0 * L * 3 * D * I}
    if stage == "moe":
        E, F_ = dec["num_experts"], dec["moe_intermediate_size"]
        Eh = ref.held(dec)[1]
        Fs = F_ * dec["num_shared_experts"]
        k = dec["num_experts_per_token"]
        w = (Eh * 3 * D * F_ + 3 * D * Fs + D) * wb + (D * E + E) * 4
        prod = 2.0 * L * (k * Eh / E * 3 * D * F_ + 3 * D * Fs)
        f32 = 2.0 * L * D * E
        return n["moe"] * (w + act), work.add({W: n["moe"] * prod},
                                               {"float32": n["moe"] * f32})
    if stage == "head":
        bytes_ = L * D * wb + D * wb + D * d * wb + d * wb + S * Q * d * 4
        return bytes_, {W: 2.0 * Q * D * d}
    raise KeyError(f"no stage {stage!r}")


def encode_work(s):
    """(bytes, operations by dtype) of encoding one batch: every stage."""
    parts = [stage_work(s, st) for st in ("kda", "mla", "mlp", "moe",
                                          "head")]
    return (sum(b for b, _ in parts), work.add(*(o for _, o in parts)))
