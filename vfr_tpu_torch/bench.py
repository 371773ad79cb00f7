"""Serving and training throughput of the port on one card: one JSON line.

    python -m vfr_tpu_torch.bench [--device cuda|cpu] [--videos N]
                                  [--iters N] [--base-iters N] [--repeats N]

The counterpart of the JAX package's ``bench.py``, on the port's modules,
with the same inputs (seeded numpy draws in the same order; torch's
``.to(torch.bfloat16)`` rounds to nearest even, as ``ml_dtypes`` does
there) and the same top-level keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``detail``).  Seeded weights differ from ``jax.random``'s.

What it measures, every time by ``utils/timing.py::device_seconds_per_iter``
at its defaults, as the JAX bench does (windows of back-to-back calls
between CUDA events, each call on a different query batch: the tokens
shifted by the call's index; the window grown until it outlasts a 2-call
baseline window by 0.25 s; the median of 3 such differences over the
extra calls):

* ``serving_10k``, the headline: the preset (last pool, bf16 compute and
  index) over V = 10,000 videos x 21 proposals = N = 210,000 rows of two
  streams of d = 128, Q = 128 queries a batch, top-100, through
  ``eval/corpus.py::make_score_topk``.  Its ``"approx"`` is exact here,
  so every batch ends in the long-row top-k of ``ops/topk.py``.
  ``value`` = N / seconds per batch: the rate at which one query's
  proposals are scored (``vs_baseline`` against BASELINE.json's 100k).
* the stage split: encode (``embed_queries_multi``), encode + score (the
  ``fused_corpus_scores`` prefix), the score alone on precomputed queries
  rolled by the call's index (``score_direct``), top-k = full - prefix.
  The roofline counts a bf16 index's bytes (S N d 2 + N 4) and the
  score's 2 S Q N d operations against the H100's peaks; under
  ``carrier_dtype="auto"`` the index rides as f32 and every product
  rounds it back to bf16 (``prep_score_operands``, the JAX package's
  carrier), so the score reads twice that bound's index bytes.
  ``*_tc_*`` keys are the JAX bench's ``*_mxu_*``: shares of the tensor
  cores' bf16 peak.
* ``train_step_ms``: ``didemo_fusion`` at B = 64, forward, backward and
  Adam, the clip features carried in the batch (``train/step.py``, one
  device).
* ``flagship_train``: ``didemo_flagship`` at B = 128 and
  ``charades_flagship`` at B = 64 (InfoNCE, cosine, 8 mined negatives,
  EMA) over banks of 256 videos; Charades-STA's window masks and TEF from
  its synthetic fixture.
* ``flagship_serving``: ``didemo_flagship`` over the same rows
  L2-normalised and rounded to bf16: f32 compute (the preset), bf16
  compute, bf16 at the T = 8 length bucket, and ``--topk-method fused``
  (the distance-select kernel K2; the JAX bench's approx row is the TPU's
  ``approx_max_k``, which the port has no counterpart of).

Every ms is stream time per call, so where the host cannot keep the card
busy the gaps between calls count (the JAX bench's is device time inside
one program; ``detail.timing`` says which, with the headline's window).
On the card a serving call, and each stage prefix, is one CUDA graph
replay (``utils/graphs.py``), as the JAX bench's is one jitted program;
the train rows run eagerly.
A train row steps its optimizer on every call of every window; each
step's loss is kept on the device and all are checked finite after its
timing.  The line is kept under 1,500 bytes.  The
kernels build at first use (``kernels/build.py``).  Without CUDA it
raises unless ``--device cpu`` is given, and then times on the host clock.
``--base-iters`` and ``--repeats`` set the timing's own parameters (the
JAX bench's 2 and 3 by default); with ``--iters 1 --base-iters 0
--repeats 1`` a row makes two calls, one warm and one timed, for a quick
look at the line's shape on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from vfr_tpu_torch.config import get_preset
from vfr_tpu_torch.data.charades import CharadesSTADataset
from vfr_tpu_torch.data.synthetic import make_charades_fixture
from vfr_tpu_torch.device import resolve_device
from vfr_tpu_torch.eval.corpus import (
    MomentIndex,
    make_retriever,
    make_score_topk,
    prep_score_operands,
)
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.models.mcn import (
    embed_queries_multi,
    init_model_params,
    prepare_query_params,
)
from vfr_tpu_torch.ops.topk import topk_lowest_index
from vfr_tpu_torch.parallel.sharding import fused_corpus_scores
from vfr_tpu_torch.train.optim import make_optimizer
from vfr_tpu_torch.train.step import make_train_step
from vfr_tpu_torch.utils.graphs import BatchGraphs
from vfr_tpu_torch.utils.timing import (
    H100_BYTES_PER_S,
    PEAK_FLOPS,
    bound,
    device_seconds_and_window,
    nvidia_smi_line,
)
from vfr_tpu_torch.utils.tree import tree_map

METRIC = "proposals_scored_per_query_per_chip_per_sec"
BASELINE_RATE = 100_000.0   # BASELINE.json's north star
VIDEOS = 10_000
P, D, S = 21, 128, 2        # proposals a video, joint dim, streams
Q = 128                     # queries a batch
K = 100                     # top-k
FEAT = 2048
VOCAB = 4096
B_TRAIN = 64                # didemo_fusion's train step
V_BANK, HARD_NEGS = 256, 8  # the flagship steps' banks and mined negatives


def perturb(i: int, tokens: torch.Tensor, vocab: int = VOCAB):
    """Call i's query batch: every token shifted by i inside the vocab."""
    return 1 + (tokens + i) % (vocab - 1)


def _index(rows32: np.ndarray, weights, V: int, dev) -> MomentIndex:
    """A bf16 index of ``rows32`` [S, N, d] rounded on the device, its
    squared norms those of the rounded rows (exact in f64)."""
    m = torch.from_numpy(rows32).to(dev).to(torch.bfloat16)
    return MomentIndex(
        m=m, m_sq=(m.double() ** 2).sum(-1).float(),
        video_row=np.repeat(np.arange(V, dtype=np.int32), P),
        prop_idx=np.tile(np.arange(P, dtype=np.int32), V),
        spans_sec=np.tile(np.stack([np.arange(P), np.arange(P) + 1], 1)
                          .astype(np.float32), (V, 1)),
        weights=np.asarray(weights, np.float32))


def serving_setup(dev, videos: int = VIDEOS) -> SimpleNamespace:
    """The ``serving_10k`` cell: preset, model, query params (prepared
    once, as ``serve_queries`` does), the bf16 index of ``videos`` x 21
    rows, the base query batch, and the raw f32 rows and GloVe table the
    flagship rows reuse.  Draws in the JAX bench's order from ``rng(0)``."""
    cfg = get_preset("serving_10k")
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    T = int(cfg.data.max_query_len)
    glove = rng.standard_normal((VOCAB, cfg.data.glove_dim)).astype(
        np.float32)
    params = init_model_params(torch.Generator().manual_seed(0), model,
                               glove, FEAT, device=dev)
    m32 = rng.standard_normal((S, videos * P, D)).astype(np.float32)
    tokens = rng.integers(1, VOCAB, size=(Q, T))
    lengths = rng.integers(4, T + 1, Q)
    return SimpleNamespace(
        cfg=cfg, model=model, glove=glove, m32=m32, T=T,
        q_params=prepare_query_params(params, model),
        index=_index(m32, cfg.model.stream_weights, videos, dev),
        tokens=torch.from_numpy(tokens.astype(np.int32)).to(dev),
        lengths=torch.from_numpy(lengths.astype(np.int32)).to(dev))


def warm_select(dev, rows: int, k: int = K) -> float:
    """Seconds of the first call of the long-row top-k at the retrievers'
    shape (Q x ``rows``, top-``k``), over a batch of equal scores (a tie
    at the k-th place and inside the k).  Its kernels load at the first
    call, once per process (on the card the hand-written select's library,
    ``ops/kernels/topk_kernel.py``): set-up, which would otherwise land in
    a timed call."""
    t0 = time.perf_counter()
    topk_lowest_index(torch.ones(Q, rows, device=dev), k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _serving_ms(s, time_fn, prefix_only: bool = False):
    """(seconds of the full batch, stage seconds) of the ``serving_10k``
    retriever and its prefixes: encode, encode + score and the score
    alone, or the encode + score prefix alone."""
    model, index, qp, lens = s.model, s.index, s.q_params, s.lengths
    retr = make_score_topk(model, index, K, topk_method=s.cfg.eval.topk_method,
                           approx_recall=s.cfg.eval.approx_recall)
    m_cat, msq_fused = prep_score_operands(index, model.compute_dtype)

    @torch.no_grad()
    def embed(qp, toks, lens):
        return embed_queries_multi(qp, model, toks, lens, inference=True)

    @torch.no_grad()
    def scores(m_cat, msq_fused, qs):
        # the whole [Q, N] matrix is computed; only its first column is
        # copied out, as the full batch's scores never leave its graph
        return fused_corpus_scores(qs, m_cat, msq_fused, index.weights,
                                   model.compute_dtype)[:, :1]

    @torch.no_grad()
    def prefix(m_cat, msq_fused, qp, toks, lens):
        return scores(m_cat, msq_fused, embed(qp, toks, lens))

    # the stages go through the retriever's own wrapper (one replay a call
    # on the card), so that top-k = full - prefix subtracts like from like
    g_embed = BatchGraphs(embed, (1, 2), "the encode stage")
    g_prefix = BatchGraphs(prefix, (3, 4), "the encode + score prefix")
    g_scores = BatchGraphs(scores, (2,), "the score stage")
    full = time_fn(lambda i, t: retr(qp, perturb(i, t), lens), s.tokens)
    prefix = time_fn(lambda i, t: g_prefix(m_cat, msq_fused, qp,
                                           perturb(i, t), lens), s.tokens)
    if prefix_only:
        return full, dict(prefix=prefix)
    encode = time_fn(lambda i, t: g_embed(qp, perturb(i, t), lens), s.tokens)
    qs = embed(qp, s.tokens, lens)
    direct = time_fn(lambda i, q: g_scores(m_cat, msq_fused,
                                           torch.roll(q, i, dims=1)), qs)
    return full, dict(encode=encode, prefix=prefix, score_direct=direct)


def stages_ms(sec, st):
    """The line's ``stages_ms`` from ``_serving_ms``'s seconds."""
    return {k: round(1e3 * v, 4) for k, v in (
        ("encode", st["encode"]), ("score_direct", st["score_direct"]),
        ("topk", sec - st["prefix"]),
        ("score_prefix_diff", st["prefix"] - st["encode"]))}


def flagship_rows(s, dev):
    """The ``flagship_serving`` rows: ``didemo_flagship`` over the rows of
    ``s`` L2-normalised and rounded to bf16, with f32 compute, bf16
    compute, bf16 at T = 8, and the fused path; each row's name, model,
    index, query params, top-k method and base batch."""
    rows = s.m32 / (np.linalg.norm(s.m32, axis=-1, keepdims=True) + 1e-8)
    fidx = _index(rows, s.cfg.model.stream_weights, s.index.num_videos, dev)
    out = []
    for name, dtype, T, method in (
            ("batch_latency_ms_preset_f32_compute", None, None, "approx"),
            ("batch_latency_ms_bf16_compute", "bfloat16", None, "approx"),
            ("batch_latency_ms_bf16_bucket_T8", "bfloat16", 8, "approx"),
            ("batch_latency_ms_fused", None, None, "fused")):
        fcfg = get_preset("didemo_flagship")
        if dtype:
            fcfg = dataclasses.replace(fcfg, model=dataclasses.replace(
                fcfg.model, compute_dtype=dtype))
        fmodel = build_model(fcfg)
        qp = prepare_query_params(init_model_params(
            torch.Generator().manual_seed(3), fmodel, s.glove, FEAT,
            device=dev), fmodel)
        out.append(SimpleNamespace(
            name=name, model=fmodel, index=fidx, q_params=qp, method=method,
            tokens=s.tokens if T is None else s.tokens[:, :T].contiguous(),
            lengths=s.lengths if T is None else torch.clamp(s.lengths,
                                                            max=T)))
    return out


def _flagship_serving_ms(s, dev, time_fn):
    """ms per batch of each ``flagship_rows`` row."""
    out = {}
    for r in flagship_rows(s, dev):
        retr = make_retriever(r.model, r.index, K, topk_method=r.method,
                              approx_recall=s.cfg.eval.approx_recall)
        out[r.name] = 1e3 * time_fn(
            lambda i, t: retr(r.q_params, perturb(i, t), r.lengths),
            r.tokens)
    return out


def _step_seconds(cfg, model, params, batch, banks, vocab: int, time_fn):
    """Seconds per train step (forward, backward, the optimizer and, where
    the preset keeps one, the Polyak average), the state carried from
    step to step as a trainer does, the tokens shifted every step."""
    opt = make_optimizer(cfg.train)
    step = make_train_step(model, cfg.train, opt, feature_banks=banks)
    state = dict(p=params, s=opt.init(params),
                 e=tree_map(torch.clone, params) if cfg.train.ema_decay > 0
                 else None)

    losses = []

    def body(i, tokens):
        b = dict(batch, tokens=perturb(i, tokens, vocab))
        if state["e"] is None:
            state["p"], state["s"], aux = step(state["p"], state["s"], b)
        else:
            state["p"], state["s"], state["e"], aux = step(
                state["p"], state["s"], b, state["e"])
        losses.append(aux["loss"].detach())
        return aux["loss"]

    sec = time_fn(body, batch["tokens"])
    if not bool(torch.isfinite(torch.stack(losses)).all()):
        raise RuntimeError(f"{cfg.name}: a loss went non-finite over the "
                           f"{len(losses)} timed steps")
    return sec


def _to(dev, arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def _fusion_step_seconds(s, dev, time_fn):
    """``didemo_fusion`` at B = 64, the clip features in the batch."""
    cfg = get_preset("didemo_fusion")
    model = build_model(cfg)
    params = init_model_params(torch.Generator().manual_seed(1), model,
                               s.glove, FEAT, device=dev)
    rng = np.random.default_rng(7)
    T = int(cfg.data.max_query_len)
    batch = _to(dev, {
        "tokens": rng.integers(1, VOCAB, size=(B_TRAIN, T)).astype(np.int32),
        "lengths": rng.integers(4, T + 1, size=(B_TRAIN,)).astype(np.int32),
        "rgb": rng.standard_normal((B_TRAIN, 6, FEAT)).astype(np.float32),
        "flow": rng.standard_normal((B_TRAIN, 6, FEAT)).astype(np.float32),
        "target": rng.integers(0, P, size=(B_TRAIN,)).astype(np.int32),
        "video_idx": np.arange(B_TRAIN, dtype=np.int32)})
    return _step_seconds(cfg, model, params, batch, None, VOCAB, time_fn)


def _flagship_step_seconds(preset: str, dev, time_fn):
    """One flagship recipe step at the preset's batch over banks of 256
    videos, 8 mined negatives per query drawn at random."""
    cfg = get_preset(preset)
    B = int(cfg.train.batch_size)
    rng = np.random.default_rng(11)
    vid = (np.arange(B) % V_BANK).astype(np.int32)
    if cfg.data.dataset == "charades_sta":
        fix = make_charades_fixture(num_videos=V_BANK, num_queries=V_BANK,
                                    feature_dim=FEAT,
                                    glove_dim=cfg.data.glove_dim)
        ds = CharadesSTADataset(fix.annotations, fix.rgb, None, fix.vocab,
                                dataclasses.replace(cfg.data,
                                                    feature_dim=FEAT))
        model = build_model(cfg, dataset=ds)
        n_props, glove = ds.num_proposals, fix.glove
        banks = _to(dev, {"rgb": ds.rgb_feats, "video_tef": ds.video_tef})
        extra = {"window_mask": ds.window_mask[vid],
                 "tef": ds.video_tef[vid]}
    else:
        model = build_model(cfg)
        n_props = P
        banks = _to(dev, {st: rng.standard_normal((V_BANK, 6, FEAT)).astype(
            np.float32) for st in model.streams})
        glove = rng.standard_normal((VOCAB, cfg.data.glove_dim)).astype(
            np.float32)
        extra = {}
    vocab = glove.shape[0]
    params = init_model_params(torch.Generator().manual_seed(2), model,
                               glove, FEAT, device=dev)
    T = int(cfg.data.max_query_len)
    batch = _to(dev, {
        "tokens": rng.integers(1, vocab, size=(B, T)).astype(np.int32),
        "lengths": rng.integers(4, T + 1, size=(B,)).astype(np.int32),
        "target": rng.integers(0, n_props, size=(B,)).astype(np.int32),
        "video_idx": vid,
        "hard_neg_video": rng.integers(0, V_BANK, size=(B, HARD_NEGS)
                                       ).astype(np.int32),
        "hard_neg_prop": rng.integers(0, n_props, size=(B, HARD_NEGS)
                                      ).astype(np.int32),
        **extra})
    return _step_seconds(cfg, model, params, batch, banks, vocab, time_fn), B


def measure(device="cuda", videos: int = VIDEOS, iters: int = 0,
            base_iters: int = 2, repeats: int = 3):
    """(the bench's line as a dict, the ``serving_10k`` set-up).  ``iters``
    0 times every row adaptively (the default); a count fixes each long
    window at that many calls.  ``base_iters`` and ``repeats`` are the
    timing's own (``device_seconds_and_window``); their defaults are the
    JAX bench's."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from vfr_tpu_torch.kernels.build import build_all

        build_all()
        card = nvidia_smi_line()
        clock = "cuda events, a serving call one graph replay"
    else:
        card = "cpu"
        clock = "host clock (cpu)"
    windows = []

    def time_it(body, x):
        sec, n = device_seconds_and_window(body, x, iters, base_iters,
                                           repeats)
        windows.append(n)
        return sec

    def time_inference(body, x):
        with torch.no_grad():
            return time_it(body, x)

    s = serving_setup(dev, videos)
    N = s.index.num_rows
    warm_s = warm_select(dev, N)
    sec, st = _serving_ms(s, time_inference)
    n_head = windows[0]         # the full batch is timed first
    fserve = _flagship_serving_ms(s, dev, time_inference)
    train_s = _fusion_step_seconds(s, dev, time_it)
    fs = {p: _flagship_step_seconds(p, dev, time_it)
          for p in ("didemo_flagship", "charades_flagship")}

    cfg = s.cfg
    T, E, H = s.T, int(cfg.data.glove_dim), int(cfg.model.lstm_hidden)
    dist_flops = 2.0 * S * Q * N * D
    dist_bytes = S * N * D * 2 + N * 4
    enc_flops = 2.0 * T * Q * 4 * H * (E + H)
    bf16 = PEAK_FLOPS["bfloat16"]
    t_score = st["score_direct"]

    def ms(x):
        return round(1e3 * x, 4)

    def pct(x):
        return round(100.0 * x, 2)

    rate = N / sec
    b16 = fserve["batch_latency_ms_bf16_compute"]
    detail = {
        "backend": dev.type,
        "card": card,
        "corpus_videos": s.index.num_videos,
        "index_rows": N,
        "query_batch": Q,
        "topk": K,
        "topk_method": cfg.eval.topk_method,
        "index_dtype": "bfloat16",
        "batch_latency_ms": round(1e3 * sec, 6),
        "per_query_latency_us": round(1e6 * sec / Q, 3),
        "aggregate_scored_per_chip_per_sec": round(Q * N / sec, 1),
        "exact_topk_batch_latency_ms": round(1e3 * sec, 6),
        "select_warmup_ms": ms(warm_s),
        "stages_ms": stages_ms(sec, st),
        "roofline": {
            "hbm_peak_gbps": H100_BYTES_PER_S / 1e9,
            "score_stage_hbm_util_pct": pct(
                dist_bytes / t_score / H100_BYTES_PER_S),
            "score_stage_tc_util_pct_of_bf16_peak": pct(
                dist_flops / t_score / bf16),
            "score_stage_speed_of_light_ms": round(
                bound(dist_bytes, dist_flops, "bfloat16")[0], 4),
            "encode_tc_util_pct_of_bf16_peak": pct(
                enc_flops / st["encode"] / bf16),
        },
        "train_step_ms": ms(train_s),
        "train_queries_per_sec": round(B_TRAIN / train_s, 1),
        "flagship_serving": {
            **{k: round(v, 4) for k, v in fserve.items()},
            "per_query_rate_bf16_compute": round(N / (b16 / 1e3), 1),
            "bucket_T8_speedup": round(
                b16 / fserve["batch_latency_ms_bf16_bucket_T8"], 3),
        },
        "flagship_train": {
            f"{p.split('_')[0]}_flagship_{key}": val
            for p, (t, B) in fs.items()
            for key, val in (("step_ms", ms(t)),
                             ("queries_per_sec", round(B / t, 1)))},
        "timing": (f"{clock}: median of {repeats}, "
                   + ("adaptive n (min_signal 0.25 s)" if not iters
                      else f"n={iters}")
                   + f", base {base_iters} subtracted; headline n={n_head}"),
    }
    line = {"metric": METRIC, "value": round(rate, 1),
            "unit": "proposals/query/s",
            "vs_baseline": round(rate / BASELINE_RATE, 3),
            "detail": detail}
    return line, s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    ap.add_argument("--videos", type=int, default=VIDEOS,
                    help="corpus videos of the serving cells (21 rows each)")
    ap.add_argument("--iters", type=int, default=0,
                    help="calls of each long window: 0 (default) grows it "
                         "until it outlasts the baseline window by 0.25 s, "
                         "as the JAX bench; a count above --base-iters "
                         "fixes it, for quick runs on the CPU")
    ap.add_argument("--base-iters", type=int, default=2,
                    help="calls of the baseline window subtracted from "
                         "each long one (default 2, as the JAX bench)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="measurements whose median is kept (default 3, as "
                         "the JAX bench)")
    args = ap.parse_args(argv)
    line, _ = measure(args.device, args.videos, args.iters, args.base_iters,
                      args.repeats)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
