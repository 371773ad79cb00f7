"""The Kimi Linear query tower of the port (``models/kimi_linear.py``,
``ops/kernels/kda_kernel.py``, ``ops/moe.py``) against the benchmark's
plain reference (``vfrbench/reference/kimi_linear.py``) at a tiny size on
the CPU: the retriever's answers, the KDA recurrence (its plain version,
the kernel's matrix form of it and its shape gate), MLA against a dense
softmax, the expert share against the uncut layer, the relu^2 experts as
they were before the SwiGLU form and the share, the configuration's round
trip, the stage marks, and a tiny cell that the harness judges
``correct``, and not so under each fault planted in the reference.  An
MCN retriever's process loads none of the tower's modules."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vfr_tpu_torch.config import (ExperimentConfig, KimiLinearConfig,
                                  LinearAttnConfig, decoder_from_dict,
                                  get_preset)
from vfr_tpu_torch.eval.corpus import make_retriever
from vfr_tpu_torch.models import kimi_linear
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.models.mcn import prepare_query_params
from vfr_tpu_torch.ops import moe
from vfr_tpu_torch.ops.kernels import kda_kernel
from vfr_tpu_torch.utils import trace
from vfr_tpu_torch.utils.graphs import BatchGraphs
from vfrbench import catalog, run
from vfrbench.drivers import _common
from vfrbench.reference import kimi_linear as ref
from vfrbench.reference import mcn
from vfrbench.tests import _tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 33 + 11
# hidden 64; 4 layers: KDA + dense MLP, MLA + MoE, KDA + MoE, MLA + MoE;
# 2 KDA heads of 16; 2 MLA heads (nope 16, rope 8, v 16, latent 32); 8
# experts top-3 of which this tree holds 2..5, one shared expert
LAC = {"full_attn_layers": [2, 4], "head_dim": 16, "kda_layers": [1, 3],
       "num_heads": 2, "short_conv_kernel_size": 4}
TINY = {"hidden_size": 64, "num_hidden_layers": 4, "linear_attn_config": LAC,
        "vocab_size": 50, "intermediate_size": 48, "kv_lora_rank": 32,
        "moe_intermediate_size": 24, "num_attention_heads": 2,
        "num_key_value_heads": 2, "num_experts": 8,
        "num_experts_per_token": 3, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "held_experts": [2, 4]}
JOINT = 16
CORPUS = {"videos": 30, "vocab": 50, "row_std": 0.58}
F32 = {stage: "float32" for stage in ref.STAGES}


def _tower():
    return catalog.tower("kimi_linear")


def _dec(**kw):
    return KimiLinearConfig(**{**TINY, **kw})


def _cfg(weights="float32", **kw):
    """The tiny preset: f32 weights, compute and index unless asked."""
    cfg = get_preset("kimi_linear_serving")
    return dataclasses.replace(
        cfg, decoder=_dec(**kw),
        data=dataclasses.replace(cfg.data, max_query_len=8),
        model=dataclasses.replace(cfg.model, joint_dim=JOINT,
                                  param_dtype=weights,
                                  compute_dtype=weights),
        eval=dataclasses.replace(cfg.eval, index_dtype=weights))


def _file(dec):
    """A configuration file's top-level keys of ``dec`` (num_experts the
    held count, the published one under ``published``)."""
    d = json.loads(json.dumps(dataclasses.asdict(dec)))
    first, count = d["held_experts"] or (0, d["num_experts"])
    return {**d, "num_experts": count,
            "published": {"num_experts": d["num_experts"]}}


def _sizes(cfg):
    cell = catalog.Cell("tiny", {}, {"corpus": CORPUS, **_file(cfg.decoder)},
                        {"len_min": 2, "len_max": 8})
    return {**_common.sizes(cell, cfg), **_tower().sizes(cell, cfg)}


def _queries(Q=6, T=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, T + 1, (Q,), generator=g)
    lens[0] = T
    toks = torch.randint(2, TINY["vocab_size"], (Q, T), generator=g)
    return toks * (torch.arange(T)[None] < lens[:, None]), lens


@pytest.fixture(scope="module")
def world():
    cfg = _cfg()
    s = _sizes(cfg)
    return cfg, s, build_model(cfg), _tower().make_params(s, SEED, "cpu")


# the tower -----------------------------------------------------------------

def test_retriever_matches_the_reference(world):
    """Through ``make_retriever`` at f32, holding 4 of 8 experts: the
    reference's queries over the same index give the same rows, and the
    distances to 1e-5 of their spread."""
    cfg, s, model, params = world
    index = _common.make_index(s, cfg, SEED, "cpu")
    retrieve = make_retriever(model, index, 5, topk_method="approx")
    toks, lens = _queries(Q=12)
    d, r = retrieve(prepare_query_params(params, model), toks, lens)
    with torch.no_grad():
        q = _tower().reference_queries(params, s, toks, lens, F32)
        rd, rr = mcn.top_k(mcn.Corpus(index.m, index.weights), q, 5,
                           "float32")
    assert torch.equal(r, rr)
    assert float((d - rd).abs().max()) <= 1e-5 * float(rd.std())
    assert trace.counters()["moe.loop"] > 0


def test_prepared_tree_is_the_tree_and_is_checked(world):
    cfg, s, model, params = world
    assert prepare_query_params(params, model) is params
    bad = {**params, "layer1": {**params["layer1"],
                                "up": params["layer1"]["up"][:-1]}}
    with pytest.raises(ValueError, match="layer1/up"):
        prepare_query_params(bad, model)
    f16 = {**params, "layer0": {**params["layer0"], "A_log":
                                params["layer0"]["A_log"].half()}}
    with pytest.raises(ValueError, match="A_log must be f32"):
        prepare_query_params(f16, model)


@pytest.mark.parametrize("field,value,why", [
    ("num_expert_group", 2, "num_expert_group"),
    ("mla_use_nope", False, "mla_use_nope"),
    ("hidden_act", "gelu", "hidden_act"),
    ("q_lora_rank", 16, "q_lora_rank"),
    ("held_experts", (6, 4), "held_experts"),
])
def test_check_refuses_what_the_port_does_not_implement(field, value, why):
    kimi_linear.check(_dec())
    with pytest.raises(NotImplementedError, match=why):
        kimi_linear.check(_dec(**{field: value}))


def test_a_query_ignores_its_padding_and_its_neighbours(world):
    cfg, s, model, params = world
    toks, lens = _queries(Q=6, T=8, seed=3)
    batch = kimi_linear.embed_queries_multi(params, model, toks, lens)
    for i in range(6):
        alone = torch.zeros(1, 13, dtype=toks.dtype)
        alone[0, :8] = toks[i]
        alone[0, int(lens[i]):] = 7            # another padding token
        q = kimi_linear.embed_queries_multi(params, model, alone,
                                            lens[i:i + 1])
        torch.testing.assert_close(q[:, 0], batch[:, i], rtol=1e-5,
                                   atol=1e-5)


# KDA -----------------------------------------------------------------------

def _kda_inputs(T, B=4, H=2, D=16, seed=0):
    """q, k, v, per-channel log decays spread over four decades (some
    channels keep the state, some forget it within a token), beta, and
    lengths T, 1, T // 2 and 0."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, generator=g) for _ in range(3))
    logd = -torch.exp(torch.empty(B, T, H, D).uniform_(-7.0, 2.0,
                                                       generator=g))
    beta = torch.rand(B, T, H, generator=g)
    lens = torch.tensor([T, 1, T // 2, 0])[:B]
    return q, k, v, logd, beta, lens


@pytest.mark.parametrize("T", [1, 7, 24, kda_kernel.CHUNK])
def test_the_chunk_form_is_the_recurrence(T):
    """The KDA kernel's matrix form (A and B with per-pair per-channel
    decays, the forward solve, the read-out) equals the token-by-token
    recurrence to f32 rounding, with decays spread wide; 0 past each
    length."""
    q, k, v, g, beta, lens = _kda_inputs(T, seed=T)
    want = kda_kernel.kda_recurrence_plain(q, k, v, g, beta, lens, 0.25,
                                           1e-6)
    got = kda_kernel.kda_chunk_plain(q, k, v, g, beta, lens, 0.25, 1e-6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not want[1, 1:].any() and not want[3].any()
    # the per-channel decay matters: its per-head mean gives another o
    mean = g.mean(-1, keepdim=True).expand_as(g)
    other = kda_kernel.kda_recurrence_plain(q, k, v, mean, beta, lens,
                                            0.25, 1e-6)
    if T > 1:
        assert float((other - want).abs().max()) > 1e-2


def test_the_recurrence_is_the_delta_rule_written_out():
    """One head, one sequence: the plain recurrence is the delta rule on
    an explicit D x D state, o_t = scale S_t^T q_t."""
    q, k, v, g, beta, lens = _kda_inputs(5, B=1, H=1, D=4, seed=9)
    got = kda_kernel.kda_recurrence_plain(q, k, v, g, beta, lens, 0.5,
                                          1e-6)
    S = torch.zeros(4, 4)
    for t in range(5):
        qt = q[0, t, 0] / torch.sqrt((q[0, t, 0] ** 2).sum() + 1e-6)
        kt = k[0, t, 0] / torch.sqrt((k[0, t, 0] ** 2).sum() + 1e-6)
        S = torch.diag(torch.exp(g[0, t, 0])) @ S
        S = (torch.eye(4) - beta[0, t, 0] * torch.outer(kt, kt)) @ S + \
            beta[0, t, 0] * torch.outer(kt, v[0, t, 0])
        torch.testing.assert_close(got[0, t, 0], 0.5 * S.T @ qt, rtol=1e-5,
                                   atol=1e-6)


def test_kda_attend_on_the_cpu_reads_qkvs_columns():
    """``kda_attend`` on CPU tensors is the plain recurrence of q, k and v
    taken from qkv's column ranges (with spare columns past them)."""
    q, k, v, g, beta, lens = _kda_inputs(6, seed=2)
    B, T, H, D = q.shape
    qkv = torch.cat([t.reshape(B, T, H * D) for t in (q, k, v)]
                    + [torch.randn(B, T, 3)], -1)
    got = kda_kernel.kda_attend(qkv, g.reshape(B, T, H * D), beta, lens, H,
                                0.25, 1e-6)
    want = kda_kernel.kda_recurrence_plain(q, k, v, g, beta, lens, 0.25,
                                           1e-6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,why", [
    (dict(T=65), "at most 64 tokens"),
    (dict(D=48), "head width"),
    (dict(ld=-1), "columns"),
])
def test_the_kernel_refuses_shapes_it_does_not_take(shape, why):
    """``check_shapes`` (the CUDA wrapper's gate, run without a card)
    accepts the published widths at one chunk and refuses a longer
    sequence, an odd head width and a qkv short of q, k and v."""
    kda_kernel.check_shapes(24, 3 * 32 * 128, 32, 128)
    kda_kernel.check_shapes(64, 3 * 4 * 32, 4, 32)
    dims = {"T": 24, "H": 32, "D": 128, **shape}
    ld = 3 * dims["H"] * dims["D"] + dims.pop("ld", 0)
    with pytest.raises(ValueError, match=why):
        kda_kernel.check_shapes(dims["T"], ld, dims["H"], dims["D"])


def test_kda_mixer_matches_the_reference_recurrence(world):
    """The port's KDA mixer (one input product, the convs, the gates, the
    recurrence, the gated norm, o_proj) against the reference's
    token-by-token mixer over a KDA layer of the tiny model."""
    cfg, s, model, params = world
    p = params["layer0"]
    h = torch.randn(3, 8, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(1))
    lens = torch.full((3,), 8)
    got = kimi_linear.kda_mixer(h, p, model.decoder, lens)
    want = ref.kda(h, p, s["decoder"], "float32", torch.arange(3 * 8),
                   [3] * 8)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# MLA -----------------------------------------------------------------------

def test_mla_is_a_dense_causal_softmax(world):
    """The port's MLA mixer against the latent attention written out:
    each head's full keys [k_nope, k_pe] and values from the normed
    latent, torch's causal scaled-dot-product attention at scale
    (nope + rope)^-1/2, no rotation."""
    cfg, s, model, params = world
    p = params["layer1"]
    dec = model.decoder
    h = torch.randn(2, 7, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    got = kimi_linear.mla_mixer(h, p, dec)
    Hq, dn, dr, dv, R = 2, 16, 8, 16, 32
    q = (h @ p["q"]).view(2, 7, Hq, dn + dr).transpose(1, 2)
    kva = h @ p["kv_a"]
    c = kva[..., :R]
    c = c / torch.sqrt(c.pow(2).mean(-1, keepdim=True) + dec.rms_norm_eps) \
        * p["kv_norm"]
    kv = (c @ p["kv_b"]).view(2, 7, Hq, dn + dv).transpose(1, 2)
    k_pe = kva[..., R:][:, None].expand(-1, Hq, -1, -1)
    k = torch.cat([kv[..., :dn], k_pe], -1)
    a = F.scaled_dot_product_attention(q, k, kv[..., dn:], is_causal=True,
                                       scale=(dn + dr) ** -0.5)
    want = a.transpose(1, 2).reshape(2, 7, Hq * dv) @ p["o"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# the MoE -------------------------------------------------------------------

def _moe_layer(world):
    cfg, s, model, params = world
    return params["layer1"], s["decoder"], model.decoder


def test_the_held_shares_add_up_to_the_uncut_layer(world):
    """The share: an MoE layer of 8 experts cut in two halves (experts 0-3
    and 4-7, each its own stack), each routing over all 8 and weighing
    its choices over all k; the two routed parts, plus the shared expert
    counted once, give the uncut reference layer, in the program and in
    the reference."""
    p_held, d, dec = _moe_layer(world)
    g = torch.Generator().manual_seed(5)
    D, E, F_ = TINY["hidden_size"], 8, TINY["moe_intermediate_size"]
    up = (torch.rand(E, D, 2 * F_, generator=g) - 0.5) / 4
    down = (torch.rand(E, F_, D, generator=g) - 0.5) / 3
    p = {**p_held, "up": up, "down": down}
    h = torch.randn(30, D, generator=g)
    uncut = ref.moe(h, p, {**d, "held_experts": None}, "float32")
    shared = ref.shared_expert(h, p, "float32")
    halves = [(0, 4), (4, 4)]
    parts = [ref.moe(h, {**p, "up": up[a:a + n], "down": down[a:a + n]},
                     {**d, "held_experts": (a, n)}, "float32") - shared
             for a, n in halves]
    torch.testing.assert_close(parts[0] + parts[1] + shared, uncut,
                               rtol=1e-5, atol=1e-6)
    args = (dec.num_experts_per_token, dec.routed_scaling_factor, True)
    prog = [moe.moe_block(h, {**p, "up": up[a:a + n],
                              "down": down[a:a + n]}, *args, act="swiglu",
                          held=(a, n)) for a, n in halves]
    whole = moe.moe_block(h, p, *args, act="swiglu")
    prog_shared = moe.swiglu(h @ p["shared_up"]) @ p["shared_down"]
    torch.testing.assert_close(prog[0] + prog[1] - prog_shared, whole,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(whole, uncut, rtol=1e-5, atol=1e-6)
    assert float((prog[0] - prog_shared).abs().max()) > 1e-3


def _per_token(h, p, k, scale, held):
    """The SwiGLU MoE's routed sum token by token, in f32, over the held
    experts (first, count)."""
    first, count = held
    out = torch.zeros(h.shape[0], h.shape[1])
    for m in range(h.shape[0]):
        scores = torch.sigmoid(h[m].float() @ p["router"])
        top = torch.topk(scores + p["e_bias"], k).indices
        w = scores[top] / (scores[top].sum() + 1e-20) * scale
        for j, e in enumerate(top.tolist()):
            if first <= e < first + count:
                gu = h[m].float() @ p["up"][e - first].float()
                a = F.silu(gu[:gu.shape[0] // 2]) * gu[gu.shape[0] // 2:]
                out[m] += w[j] * (a @ p["down"][e - first].float())
    return out


@pytest.mark.parametrize("path", ["loop", "grouped"])
def test_swiglu_route_under_a_share_is_the_per_token_loop(world, path,
                                                          monkeypatch):
    """Sorted by expert, through the CPU's loop or the card's grouped
    products, the SwiGLU routed sum under the share is the token-by-token
    one; padding tokens get 0."""
    p, d, dec = _moe_layer(world)
    h = torch.randn(40, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(2))
    live = torch.ones(40, dtype=torch.bool)
    live[-7:] = False
    if path == "grouped":
        monkeypatch.setattr(moe, "_loop", moe._grouped)
    k, scale = dec.num_experts_per_token, dec.routed_scaling_factor
    idx, w = moe.route(h, p["router"], p["e_bias"], k, scale, True)
    got = moe.route_experts(h, idx, w, p["up"], p["down"], live, "swiglu",
                            (2, 4))
    want = _per_token(h, p, k, scale, (2, 4))
    torch.testing.assert_close(got[:-7], want[:-7], rtol=1e-5, atol=1e-5)
    assert float(got[-7:].abs().max()) == 0.0


def _route_experts_before(h, idx, w, up, down, live=None):
    """``ops/moe.py::route_experts`` as it was before the SwiGLU form and
    the expert share (relu^2 experts, every expert held)."""
    M, k = idx.shape
    E = up.shape[0]
    e = idx.reshape(-1)
    if live is not None:
        e = torch.where(live.repeat_interleave(k), e, E)
    order = torch.argsort(e, stable=True)
    xs = h.index_select(0, order // k).to(up.dtype)
    es = e.index_select(0, order)
    counts = torch.bincount(es, minlength=E + 1).tolist()
    y = xs.new_zeros(xs.shape[0], down.shape[2])
    start = 0
    for ex in range(E):
        n = counts[ex]
        if n:
            part = xs[start:start + n]
            y[start:start + n] = moe.relu2(part @ up[ex]) @ down[ex]
        start += n
    at = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    valid = e < E
    at = torch.where(valid, at, 0)
    w = torch.where(valid.view(M, k), w.float(), 0.0)
    return (y.index_select(0, at).view(M, k, -1) * w.view(M, k, 1)).sum(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu2_with_every_expert_held_is_as_before(dtype):
    """Nemotron-H's MoE (relu^2, every expert held): the block is bit for
    bit what it was before the SwiGLU form and the share."""
    g = torch.Generator().manual_seed(8)
    D, E, F_ = 32, 8, 24
    p = {"router": torch.randn(D, E, generator=g) / 6,
         "e_bias": torch.rand(E, generator=g) / 20,
         "up": (torch.randn(E, D, F_, generator=g) / 6).to(dtype),
         "down": (torch.randn(E, F_, D, generator=g) / 5).to(dtype),
         "shared_up": (torch.randn(D, 16, generator=g) / 6).to(dtype),
         "shared_down": (torch.randn(16, D, generator=g) / 4).to(dtype)}
    h = torch.randn(50, D, generator=g).to(dtype)
    live = torch.rand(50, generator=g) > 0.2
    idx, w = moe.route(h, p["router"], p["e_bias"], 3, 2.5, True)
    before = _route_experts_before(h, idx, w, p["up"], p["down"], live)
    assert torch.equal(moe.route_experts(h, idx, w, p["up"], p["down"],
                                         live), before)
    block = before.to(dtype) + moe.relu2(h @ p["shared_up"]) @ \
        p["shared_down"]
    assert torch.equal(moe.moe_block(h, p, 3, 2.5, True, live), block)


# the configuration ---------------------------------------------------------

def test_the_decoder_section_round_trips_by_model_type():
    """``to_json`` / ``from_json`` give back each decoder preset, its
    section's class picked by ``model_type``; a file's dict (nested
    ``linear_attn_config``, lists) reads into the same dataclasses; an
    unknown ``model_type`` is refused."""
    for name, cls in (("kimi_linear_serving", KimiLinearConfig),
                      ("nemotron3_nano_serving", None)):
        cfg = get_preset(name)
        again = ExperimentConfig.from_json(cfg.to_json())
        assert again == cfg and again.decoder == cfg.decoder
        if cls is not None:
            assert type(again.decoder) is cls
    dec = get_preset("kimi_linear_serving").decoder
    assert dec.held_experts == (0, 128)
    assert isinstance(dec.linear_attn_config, LinearAttnConfig)
    d = json.loads(json.dumps(dataclasses.asdict(dec)))
    assert decoder_from_dict(d) == dec == KimiLinearConfig(**d)
    with pytest.raises(ValueError, match="model_type"):
        decoder_from_dict({**d, "model_type": "llama"})


def test_the_configuration_is_the_published_one():
    """The configuration's file holds the published keys at the top level,
    equal to the preset's decoder (the run refuses a difference) but for
    ``num_experts``, the held count (listed in ``reduced``, the published
    256 beside it); at its widths the tree holds 25.19 B parameters."""
    c = catalog.load_json("configs", "kimi_linear_48b")
    cfg = catalog.experiment(c)
    dec = json.loads(json.dumps(dataclasses.asdict(cfg.decoder)))
    assert c["reduced"] == ["num_experts"] and c["tower"] == "kimi_linear"
    assert c["published"] == {"num_experts": 256}
    assert {k: c[k] for k in dec} == {**dec, "num_experts": 128}
    kimi_linear.check(cfg.decoder)
    cell = catalog.cell("klinear-batch")
    s = {**_common.sizes(cell, cfg), **_tower().sizes(cell, cfg)}
    shapes = _tower().leaf_shapes(s)
    n = sum(int(np.prod(shape)) for _, shape, _, _ in shapes)
    assert round(n / 1e9, 2) == 25.19
    assert [(p, tuple(sh)) for p, sh, _, _ in shapes] == \
        kimi_linear.leaf_shapes(cfg.decoder, s["d"])
    for bad in (dict(c, hidden_size=2048), dict(c, num_experts=256)):
        with pytest.raises(ValueError, match="in the file"):
            _tower().sizes(catalog.Cell("x", {}, bad, cell.traffic), cfg)


# the captured batch --------------------------------------------------------

def _capture_stand_in(monkeypatch):
    class Graph:
        def replay(self):
            pass

    def capture(self, warm, record):
        warm()
        saved, trace._node_count = trace._node_count, lambda: 0
        try:
            outs = record()
        finally:
            trace._node_count = saved
        return Graph(), outs

    monkeypatch.setattr(BatchGraphs, "_on_card", lambda self, a: True)
    monkeypatch.setattr(BatchGraphs, "_warm_and_record", capture)


def test_a_captured_batch_marks_every_sublayer(world, monkeypatch):
    """Captured (the CPU stand-in of ``BatchGraphs``' capture), the batch
    marks its stages: the embedding under ``encode``, each sublayer by its
    mixer, the head under ``encode`` again, then the score and select."""
    cfg, s, model, params = world
    _capture_stand_in(monkeypatch)
    index = _common.make_index(s, cfg, SEED, "cpu")
    retrieve = make_retriever(model, index, 5, topk_method="approx")
    toks, lens = _queries()
    retrieve(params, toks, lens)
    names = [n for n, _ in trace.snapshot()["stages"][-1]["stages"]]
    subs = ["encode.kda", "encode.mlp", "encode.mla", "encode.moe",
            "encode.kda", "encode.moe", "encode.mla", "encode.moe"]
    assert names == ["encode", *subs, "encode", "score", "select"]


# the tiny cell -------------------------------------------------------------

def _tiny_root(tmp_path, weights, limits):
    """A tiny root with the cell ``tiny-klinear-batch``: the
    configuration's file with its widths cut (listed in ``reduced``) and
    ``param_dtype`` ``weights``."""
    root = _tiny.make_root(str(tmp_path / "root"))
    c = catalog.load_json("configs", "kimi_linear_48b")
    c.update(_file(_dec()))
    c["decoder"] = dict(TINY)
    c["data"].update(_tiny.CUT_DATA)
    c["model"].update(joint_dim=JOINT, param_dtype=weights)
    c["reduced"] = (list(TINY) + list(_tiny.CUT_DATA)
                    + ["joint_dim", "param_dtype"])
    c["corpus"] = dict(CORPUS)
    _tiny.write(root, "configs", "tiny_klinear", c)
    _tiny.write(root, "workloads", "tiny-klinear-batch", {
        "config": "tiny_klinear", "traffic": "bulk", "chips": 1,
        "why": "a CPU test", "limits": limits})
    return root


def _run(root):
    bench = {"end_to_end": [{"name": "queries_per_s"}, {"name": "setup_s"}],
             "per_layer": []}
    return run.run_cell(catalog.cell("tiny-klinear-batch", root), SEED, 0.3,
                        False, torch.device("cpu"), time.perf_counter(),
                        bench=bench, root=root)


# bf16 as the cell runs: the port's readings at seeds 2**33 + 11, 5 and 99
# were at most 0.0085 / 0 / 0 / 0.0013 (dist, rank, set, lower), the
# reference a precision lower (fp8) at least 0.24 / 0.19 / 0.030 / 0.73
BF16_LIMITS = {"dist_gap": 0.1, "rank_gap": 0.05, "set_gap": 0.005,
               "lower_share": 0.1, "bad": 0}


def test_tiny_cell_runs_correct(tmp_path):
    line = _run(_tiny_root(tmp_path, "bfloat16", BF16_LIMITS))
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"queries_per_s", "setup_s"}


def _per_head_decay(g):
    return torch.exp(g.mean(-1, keepdim=True)).expand_as(g)


def _beta_one(b):
    return torch.ones_like(b)


def _no_shared(h, p, prec):
    return torch.zeros_like(h)


def _over_the_held(h, p, dec):
    """The weights normalised over the choices of the held experts only."""
    scores = torch.sigmoid(h @ p["router"].float())
    idx = torch.topk(scores + p["e_bias"].float(),
                     dec["num_experts_per_token"], dim=-1).indices
    first, count = ref.held(dec)
    mine = (idx >= first) & (idx < first + count)
    w = scores.gather(1, idx) * mine
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * \
        dec["routed_scaling_factor"]


def _no_kv_norm(c, p, dec):
    return c


FAULTS = {"none": {}, "per_head_decay": {"decay": _per_head_decay},
          "beta_one": {"gate_beta": _beta_one},
          "shared_expert_dropped": {"shared_expert": _no_shared},
          "weights_over_the_held": {"route": _over_the_held},
          "kv_norm_dropped": {"kv_norm": _no_kv_norm}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_planted_in_the_reference_reads_false(fault, tmp_path,
                                                      monkeypatch):
    """At f32 weights the port is the reference to rounding (limits 1e-4):
    each planted fault reads ``correct`` false, none reads true."""
    for name, fn in FAULTS[fault].items():
        monkeypatch.setattr(ref, name, fn)
    limits = {"dist_gap": 1e-4, "rank_gap": 1e-4, "set_gap": 1e-4,
              "lower_share": 1e-2, "bad": 0}
    line = _run(_tiny_root(tmp_path, "float32", limits))
    assert line["correct"] is (fault == "none"), line["checks"]


# the MCN path ---------------------------------------------------------------

TOWER_MODULES = ("vfr_tpu_torch.models.kimi_linear",
                 "vfr_tpu_torch.ops.kernels.kda_kernel",
                 "vfr_tpu_torch.ops.moe", "vfrbench.reference.kimi_linear")


def test_an_mcn_retriever_loads_no_module_of_the_tower(tmp_path):
    """In a fresh interpreter, a tiny MCN cell's set-up (the model, its
    retriever, a capture through the CPU stand-in and two replays) and
    window load none of the tower's modules; the tiny Kimi Linear cell's
    set-up then loads them all."""
    root = _tiny_root(tmp_path, "float32", BF16_LIMITS)
    code = textwrap.dedent(f"""
        import json, sys, torch
        sys.path.insert(0, {REPO!r})
        from vfr_tpu_torch.utils import trace
        from vfr_tpu_torch.utils.graphs import BatchGraphs
        from vfrbench import catalog
        from vfrbench.trace import Tracer

        class Graph:
            def __init__(self, warm):
                self.warm = warm

            def replay(self):
                self.warm()

        def capture(self, warm, record):
            warm()
            saved, trace._node_count = trace._node_count, lambda: 0
            try:
                outs = record()
            finally:
                trace._node_count = saved
            return Graph(warm), outs

        BatchGraphs._on_card = lambda self, a: True
        BatchGraphs._warm_and_record = capture
        want = {list(TOWER_MODULES)!r}

        def loaded():
            return sorted(m for m in want if m in sys.modules)

        def setup(name):
            cell = catalog.cell(name, {root!r})
            drv = catalog.load_module("drivers", cell.driver, {root!r})
            st = drv.setup(cell, catalog.experiment(cell.config), 1, 0.2,
                           torch.device("cpu"))
            drv.window(st, 0.2, Tracer(False, 0.2))
            return st

        st = setup("tiny-s10k-batch")
        assert st.retrieve.graphs.captures == 1
        mcn = loaded()
        setup("tiny-klinear-batch")
        print(json.dumps([mcn, loaded()]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    mcn_path, tower_path = json.loads(out.stdout.strip().splitlines()[-1])
    assert mcn_path == []
    assert tower_path == sorted(TOWER_MODULES)
