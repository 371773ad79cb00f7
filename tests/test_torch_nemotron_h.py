"""The Nemotron-H query tower of the port (``models/nemotron_h.py``,
``ops/moe.py``, ``ops/mamba2.py``) against the benchmark's plain reference
(``vfrbench/reference/nemotron_h.py``) at a tiny size on the CPU: the
retriever's answers, the Mamba-2 chain (the plain version of its fused
CUDA kernel, which runs on the card alone, the kernel's matrix form of the
scan and its shape gate), the expert route, the independence
of a query from its padding and its neighbours, and a tiny cell that the
harness judges ``correct``, and not so under each fault planted in the
reference.  An MCN retriever's process loads none of the tower's modules."""

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

from vfr_tpu_torch.config import DecoderConfig, get_preset
from vfr_tpu_torch.eval.corpus import make_retriever
from vfr_tpu_torch.models import nemotron_h
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.models.mcn import prepare_query_params
from vfr_tpu_torch.ops import moe
from vfr_tpu_torch.ops.kernels import mamba2_kernel
from vfr_tpu_torch.ops.mamba2 import causal_conv, gated_rmsnorm
from vfr_tpu_torch.utils import trace
from vfr_tpu_torch.utils.graphs import BatchGraphs
from vfrbench import catalog, run
from vfrbench.drivers import _common
from vfrbench.reference import mcn
from vfrbench.reference import nemotron_h as ref
from vfrbench.tests import _tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 33 + 7
# hidden 64; M, E and * blocks; 8 experts top-2 and a shared expert; 2
# groups of state 16; 4 Mamba heads of 16; 4 query and 2 KV heads of 16
TINY = {"hidden_size": 64, "hybrid_override_pattern": "ME*MEM*E",
        "num_hidden_layers": 8, "vocab_size": 50, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "moe_intermediate_size": 24,
        "intermediate_size": 24, "moe_shared_expert_intermediate_size": 32,
        "n_groups": 2, "ssm_state_size": 16, "mamba_num_heads": 4,
        "mamba_head_dim": 16, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16}
JOINT = 16
CORPUS = {"videos": 30, "vocab": 50, "row_std": 0.58}
F32 = {stage: "float32" for stage in ref.STAGES}


def _tower():
    return catalog.tower("nemotron_h")


def _cfg(weights="float32"):
    """The tiny preset: f32 weights, compute and index unless asked."""
    cfg = get_preset("nemotron3_nano_serving")
    return dataclasses.replace(
        cfg, decoder=DecoderConfig(**TINY),
        data=dataclasses.replace(cfg.data, max_query_len=8),
        model=dataclasses.replace(cfg.model, joint_dim=JOINT,
                                  param_dtype=weights,
                                  compute_dtype=weights),
        eval=dataclasses.replace(cfg.eval, index_dtype=weights))


def _sizes(cfg):
    cell = catalog.Cell("tiny", {}, {"corpus": CORPUS},
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


# (a) ----------------------------------------------------------------------

def test_retriever_matches_the_reference(world):
    """Through ``make_retriever`` at f32: the reference's queries over the
    same index give the same rows, and the distances to 1e-5 of their
    spread."""
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
    bad = {**params, "norm_f": params["norm_f"][:-1]}
    with pytest.raises(ValueError, match="norm_f"):
        prepare_query_params(bad, model)


# (b) ----------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 5, 24])
def test_scan_is_the_closed_form(T):
    """The scan's plain version (the step recurrence) equals the SSD's
    closed form, y_t = sum_{s <= t} exp(cs_t - cs_s) (C_t . B_s) dt_s x_s
    + D x_t with cs the running sum of dt A, dt large enough that the state
    carries; 0 past each length."""
    g = torch.Generator().manual_seed(T)
    B, H, P, G, N = 3, 4, 8, 2, 16
    x = torch.randn(B, T, H, P, generator=g)
    dt = torch.rand(B, T, H, generator=g) + 0.1
    A = -torch.rand(H, generator=g) * 2 - 0.1
    Bm, Cm = (torch.randn(B, T, G, N, generator=g) for _ in range(2))
    D = torch.rand(H, generator=g)
    lens = torch.tensor([T, max(T - 2, 1), 1])
    cs = torch.cumsum(dt * A, 1)
    want = torch.zeros(B, T, H, P)
    for b in range(B):
        for t in range(int(lens[b])):
            for h in range(H):
                cb = (Cm[b, t, h * G // H] * Bm[b, :t + 1, h * G // H]
                      ).sum(-1)
                w = torch.exp(cs[b, t, h] - cs[b, :t + 1, h]) * cb * \
                    dt[b, :t + 1, h]
                want[b, t, h] = (w[:, None] * x[b, :t + 1, h]).sum(0) + \
                    D[h] * x[b, t, h]
    got = mamba2_kernel.ssd_scan_plain(x, dt, A, Bm, Cm, D, lens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _chain_inputs(T, dtype, seed=0, Bsz=5):
    """zxd [Bsz, T, ld] (two spare columns past dt) and the tiny world's
    Mamba-2 leaves, lengths 0, 1, T and two between."""
    g = torch.Generator().manual_seed(seed)
    H, P, G, N, K = 4, 16, 2, 16, 4
    di, conv = H * P, H * P + 2 * G * N
    zxd = torch.randn(Bsz, T, di + conv + H + 2, generator=g).to(dtype)
    leaves = dict(
        conv_w=(torch.randn(conv, K, generator=g) * 0.5).to(dtype),
        conv_b=(torch.randn(conv, generator=g) * 0.1).to(dtype),
        dt_bias=torch.randn(H, generator=g),
        A_log=torch.rand(H, generator=g) * 2,
        D=torch.rand(H, generator=g),
        norm_w=(1 + 0.1 * torch.randn(di, generator=g)).to(dtype))
    lens = torch.tensor([0, 1, T, max(T // 2, 1), max(T - 3, 1)])[:Bsz]
    return zxd, lens, leaves, G


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [8, mamba2_kernel.CHUNK + 8])
def test_chain_on_the_cpu_is_the_composition(T, dtype):
    """``mamba2_chain`` on CPU tensors is conv, SiLU, softplus, the plain
    scan and the gated norm as the mixer composed them, bit for bit, from
    a zxd wider than z, xBC and dt, at lengths 0, 1 and T, and at a T
    past the kernel's chunk (the conv's window then crosses a chunk)."""
    zxd, lens, p, G = _chain_inputs(T, dtype, seed=T)
    H, di = 4, 64
    N = 16
    got = mamba2_kernel.mamba2_chain(
        zxd, lens, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
        p["D"], p["norm_w"], G, 1e-5)
    z, xbc, dt = zxd[..., :-2].split([di, di + 2 * G * N, H], dim=-1)
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    dt = F.softplus(dt.float() + p["dt_bias"])
    x, Bm, Cm = xbc.split([di, G * N, G * N], dim=-1)
    y = mamba2_kernel.ssd_scan_plain(
        x.reshape(5, T, H, di // H), dt, -torch.exp(p["A_log"]),
        Bm.reshape(5, T, G, N), Cm.reshape(5, T, G, N), p["D"], lens)
    want = gated_rmsnorm(y.reshape(5, T, di), z, p["norm_w"], di // G, 1e-5)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert not got[0].any() and not got[1, 1:].any()
    assert got[2, -1].abs().min() > 0


def _matrix_form(x, dt, A, Bm, Cm, D, lens, chunk, shares):
    """The kernel's scan (``csrc/mamba2_scan.cu``) in PyTorch: chunks of
    ``chunk`` tokens, each y_t = sum_{s <= t} exp(sum_{s < u <= t} dt_u A)
    (C_t . B_s) dt_s x_s + exp(sum_{u <= t} dt_u A) C_t h + D x_t with
    C_t . B_s summed over ``shares`` slices of the state (a cluster's
    blocks), and the state h carried to the next chunk."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2:]
    rep = H // G
    y = torch.zeros(Bsz, T, H, P)
    for b in range(Bsz):
        n_all = int(lens[b])
        for hd in range(H):
            gr = hd // rep
            h = torch.zeros(P, N)
            for t0 in range(0, n_all, chunk):
                n = min(chunk, n_all - t0)
                sl = slice(t0, t0 + n)
                da = dt[b, sl, hd] * A[hd]
                cb = sum(Cm[b, sl, gr, k::shares] @ Bm[b, sl, gr,
                                                        k::shares].T
                         for k in range(shares))
                seg = torch.zeros(n, n)
                for t in range(n):
                    for s in range(t + 1):
                        seg[t, s] = da[s + 1:t + 1].sum()
                w = torch.exp(seg).tril() * cb * dt[b, sl, hd][None]
                ein = torch.exp(torch.cumsum(da, 0))
                xs = x[b, sl, hd]
                y[b, sl, hd] = (w @ xs + ein[:, None] * (Cm[b, sl, gr] @ h.T)
                                + D[hd] * xs)
                wl = torch.exp(seg[-1]) * dt[b, sl, hd]
                h = ein[-1] * h + (wl[:, None] * xs).T @ Bm[b, sl, gr]
    return y


@pytest.mark.parametrize("T,chunk", [(8, 32), (40, 32), (23, 5)])
def test_the_kernels_matrix_form_is_the_recurrence(T, chunk):
    """The scan as the fused kernel computes it (the matrix form over
    chunks, the C . B dot split over a cluster's blocks, the state carried
    between chunks) equals the plain step recurrence to f32 rounding."""
    g = torch.Generator().manual_seed(T)
    B, H, P, G, N = 3, 4, 8, 2, 16
    x = torch.randn(B, T, H, P, generator=g)
    dt = torch.rand(B, T, H, generator=g) + 0.05
    A = -torch.rand(H, generator=g) * 2 - 0.1
    Bm, Cm = (torch.randn(B, T, G, N, generator=g) for _ in range(2))
    D = torch.rand(H, generator=g)
    lens = torch.tensor([T, max(T - 7, 1), 1])
    want = mamba2_kernel.ssd_scan_plain(x, dt, A, Bm, Cm, D, lens)
    got = _matrix_form(x, dt, A, Bm, Cm, D, lens, chunk, shares=H // G)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,why", [
    (dict(H=32, G=2), "at most 8 heads a group"),
    (dict(H=6, G=4), "H a multiple of G"),
    (dict(N=12), "N a multiple of H / G"),
    (dict(P=24), "P a power of two"),
    (dict(P=256), "P a power of two"),
    (dict(K=9), "conv taps"),
    (dict(ld=-1), "columns"),
])
def test_the_kernel_refuses_shapes_it_does_not_take(shape, why):
    """``check_shapes`` (the CUDA wrapper's gate, run without a card)
    accepts the published widths and the tiny world's, and refuses H / G
    past the cluster limit, P off the powers of two, and a zxd short of z,
    xBC and dt's columns."""
    cell = dict(H=64, P=64, G=8, N=128, K=4)
    for ok in (cell, dict(H=4, P=16, G=2, N=16, K=4)):
        mamba2_kernel.check_shapes(2 * ok["H"] * ok["P"] + 2 * ok["G"] *
                                   ok["N"] + ok["H"], **ok)
    dims = {**cell, **{k: v for k, v in shape.items() if k != "ld"}}
    ld = 2 * dims["H"] * dims["P"] + 2 * dims["G"] * dims["N"] + dims["H"]
    with pytest.raises(ValueError, match=why):
        mamba2_kernel.check_shapes(ld + shape.get("ld", 0), **dims)


def test_mamba_mixer_matches_the_reference_recurrence(world):
    """The port's mixer (conv, one-chunk scan, gated norm) against the
    reference's token-by-token recurrence, over a Mamba layer of the tiny
    model with dt raised so that the state carries (dt of order 1)."""
    cfg, s, model, params = world
    p = dict(params["layer0"], dt_bias=params["layer0"]["dt_bias"] + 5.0)
    h = torch.randn(3, 8, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(1))
    full = torch.full((3,), 8)
    got = nemotron_h.mamba_mixer(h, p, model.decoder, full)
    want = ref.mamba(h, p, s["decoder"], "float32", torch.arange(3 * 8),
                     [3] * 8)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    p_short = dict(p, dt_bias=params["layer0"]["dt_bias"])
    assert (got - nemotron_h.mamba_mixer(h, p_short, model.decoder, full)
            ).abs().max() > 1e-2


# (c) ----------------------------------------------------------------------

def _per_token(h, p, k, scale, bias_in_weights=False):
    """The MoE's routed sum token by token, in f32."""
    out = torch.zeros(h.shape[0], h.shape[1])
    for m in range(h.shape[0]):
        scores = torch.sigmoid(h[m].float() @ p["router"])
        choice = scores + p["e_bias"]
        top = torch.topk(choice, k).indices
        w = (choice if bias_in_weights else scores)[top]
        w = w / (w.sum() + 1e-20) * scale
        for j, e in enumerate(top.tolist()):
            u = torch.relu(h[m].float() @ p["up"][e].float()) ** 2
            out[m] += w[j] * (u @ p["down"][e].float())
    return out


@pytest.mark.parametrize("path", ["loop", "grouped"])
def test_expert_route_is_the_per_token_loop(world, path, monkeypatch):
    """Sorted by expert, through the CPU's loop or the card's grouped
    products, the routed sum is the token-by-token one; padding tokens get
    0; the correction bias moves the choice and never the weights."""
    cfg, s, model, params = world
    p = params["layer1"]
    dec = model.decoder
    k, scale = dec.num_experts_per_tok, dec.routed_scaling_factor
    h = torch.randn(40, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(2))
    live = torch.ones(40, dtype=torch.bool)
    live[-7:] = False
    if path == "grouped":
        monkeypatch.setattr(moe, "_loop", moe._grouped)
    idx, w = moe.route(h, p["router"], p["e_bias"], k, scale, True)
    got = moe.route_experts(h, idx, w, p["up"], p["down"], live)
    want = _per_token(h, p, k, scale)
    torch.testing.assert_close(got[:-7], want[:-7], rtol=1e-5, atol=1e-5)
    assert float(got[-7:].abs().max()) == 0.0
    wrong = _per_token(h, p, k, scale, bias_in_weights=True)
    assert float((got[:-7] - wrong[:-7]).abs().max()) > 1e-3
    unbiased = moe.route(h, p["router"], torch.zeros_like(p["e_bias"]), k,
                         scale, True)[0]
    assert not torch.equal(idx.sort(1).values, unbiased.sort(1).values)


# (d) ----------------------------------------------------------------------

def test_a_query_ignores_its_padding_and_its_neighbours(world):
    cfg, s, model, params = world
    toks, lens = _queries(Q=6, T=8, seed=3)
    batch = nemotron_h.embed_queries_multi(params, model, toks, lens)
    for i in range(6):
        alone = torch.zeros(1, 13, dtype=toks.dtype)
        alone[0, :8] = toks[i]
        alone[0, int(lens[i]):] = 7            # another padding token
        q = nemotron_h.embed_queries_multi(params, model, alone, lens[i:i + 1])
        torch.testing.assert_close(q[:, 0], batch[:, i], rtol=1e-5,
                                   atol=1e-5)


def test_a_captured_batch_marks_every_block(world, monkeypatch):
    """Captured (the CPU stand-in of ``BatchGraphs``' capture), the batch
    marks its stages: the embedding under ``encode``, each block by its
    mixer, the head under ``encode`` again, then the score and select."""
    cfg, s, model, params = world

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
    index = _common.make_index(s, cfg, SEED, "cpu")
    retrieve = make_retriever(model, index, 5, topk_method="approx")
    toks, lens = _queries()
    retrieve(params, toks, lens)
    names = [n for n, _ in trace.snapshot()["stages"][-1]["stages"]]
    blocks = [nemotron_h.STAGE[c] for c in TINY["hybrid_override_pattern"]]
    assert names == ["encode", *blocks, "encode", "score", "select"]


# (e) ----------------------------------------------------------------------

def _tiny_root(tmp_path, weights, limits):
    """A tiny root with the cell ``tiny-n3nano-batch``: the configuration's
    file with its widths cut (listed in ``reduced``) and ``param_dtype``
    ``weights``."""
    root = _tiny.make_root(str(tmp_path / "root"))
    c = catalog.load_json("configs", "nemotron3_nano")
    c.update(TINY)
    c["decoder"] = dict(TINY)
    c["data"].update(_tiny.CUT_DATA)
    c["model"].update(joint_dim=JOINT, param_dtype=weights)
    c["reduced"] = (list(TINY) + list(_tiny.CUT_DATA)
                    + ["joint_dim", "param_dtype"])
    c["corpus"] = dict(CORPUS)
    _tiny.write(root, "configs", "tiny_n3nano", c)
    _tiny.write(root, "workloads", "tiny-n3nano-batch", {
        "config": "tiny_n3nano", "traffic": "bulk", "chips": 1,
        "why": "a CPU test", "limits": limits})
    return root


def _run(root):
    bench = {"end_to_end": [{"name": "queries_per_s"}, {"name": "setup_s"}],
             "per_layer": []}
    return run.run_cell(catalog.cell("tiny-n3nano-batch", root), SEED, 0.3,
                        False, torch.device("cpu"), time.perf_counter(),
                        bench=bench, root=root)


# bf16 as the cell runs: the port's readings at seeds 2**33 + 7, 5 and 99
# were at most 0.008 / 0 / 0 / 0.0075 (dist, rank, set, lower), the
# reference a precision lower (fp8) at least 0.33 / 0.18 / 0.046 / 0.47
BF16_LIMITS = {"dist_gap": 0.1, "rank_gap": 0.05, "set_gap": 0.005,
               "lower_share": 0.1, "bad": 0}


def test_tiny_cell_runs_correct(tmp_path):
    line = _run(_tiny_root(tmp_path, "bfloat16", BF16_LIMITS))
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"queries_per_s", "setup_s"}


def _no_shared(h, p, prec):
    return torch.zeros_like(h)


def _unscaled(h, p, dec):
    return _ROUTE(h, p, {**dec, "routed_scaling_factor": 1.0})


def _bias_in_weights(h, p, dec):
    scores = torch.sigmoid(h @ p["router"].float())
    choice = scores + p["e_bias"].float()
    idx = torch.topk(choice, dec["num_experts_per_tok"], dim=-1).indices
    w = choice.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * \
        dec["routed_scaling_factor"]


def _decay_without_dt(dt, A):
    return torch.exp(A).expand_as(dt)


_ROUTE = ref.route
FAULTS = {"none": {}, "shared_expert_dropped": {"shared_expert": _no_shared},
          "scaling_dropped": {"route": _unscaled},
          "bias_in_weights": {"route": _bias_in_weights},
          "decay_without_dt": {"decay": _decay_without_dt}}


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

TOWER_MODULES = ("vfr_tpu_torch.models.nemotron_h", "vfr_tpu_torch.ops.moe",
                 "vfr_tpu_torch.ops.mamba2",
                 "vfr_tpu_torch.ops.kernels.mamba2_kernel",
                 "vfrbench.reference.nemotron_h")


def test_an_mcn_retriever_loads_no_module_of_the_tower(tmp_path):
    """In a fresh interpreter, a tiny MCN cell's set-up (the model, its
    retriever, a capture through the CPU stand-in and two replays) and
    window load none of the tower's modules; the tiny Nemotron-H cell's
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
        setup("tiny-n3nano-batch")
        print(json.dumps([mcn, loaded()]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    mcn_path, tower_path = json.loads(out.stdout.strip().splitlines()[-1])
    assert mcn_path == []
    assert tower_path == sorted(TOWER_MODULES)


def test_the_configuration_is_the_published_one():
    """The configuration's file holds the catalog's keys at the top level,
    equal to the preset's decoder (the run refuses a difference), with
    nothing reduced; at its widths the tree holds 31.23 B parameters."""
    c = catalog.load_json("configs", "nemotron3_nano")
    cfg = catalog.experiment(c)
    dec = dataclasses.asdict(cfg.decoder)
    assert c["reduced"] == [] and c["tower"] == "nemotron_h"
    assert {k: c[k] for k in dec} == dec
    nemotron_h.check(cfg.decoder)
    cell = catalog.cell("n3nano-batch")
    s = {**_common.sizes(cell, cfg), **_tower().sizes(cell, cfg)}
    n = sum(int(np.prod(shape)) for _, shape, _, _ in
            _tower().leaf_shapes(s))
    assert round(n / 1e9, 2) == 31.23
    assert [(p, tuple(sh)) for p, sh, _, _ in _tower().leaf_shapes(s)] == \
        nemotron_h.leaf_shapes(cfg.decoder, s["d"])
    bad = dict(c, hidden_size=2048)
    with pytest.raises(ValueError, match="hidden_size"):
        _tower().sizes(catalog.Cell("x", {}, bad, cell.traffic), cfg)
