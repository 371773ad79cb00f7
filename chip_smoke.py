#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vfr_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # every phase, full widths

Phases, one JSON line each:
  device      the card (nvidia-smi name and power limit), torch, CUDA.
  build       nvcc of every kernel source (one process each, in parallel).
  kernel_*    each CUDA kernel against its plain PyTorch version on the
              card at the main path's shapes (max |diff|, kernel / plain /
              library ms by CUDA events).
  flagship    didemo_flagship at full width (E=300, H=1024, F=2048, joint
              128, two streams, cosine, mean pool), seeded weights, a
              synthetic 10,000-video corpus (210,000 index rows): build,
              save and load the index, serve 1024 queries exact, then with
              length buckets (identical results required), and hold the
              results against the same queries served through the
              kernels' plain versions.
  fused       `--topk-method fused` on the same index; recall@10 vs exact.
  serving_10k last pool, bf16 compute, bf16 index, on a 2,000-video corpus.
Every serving phase zeroes the kernels' launch counts just before it runs
and fails unless each kernel of its path launched.  Then one
{"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero with no ok line.
Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0                 # weights, corpus and queries are made from it
VIDEOS = 10_000          # flagship corpus: 210,000 index rows
VIDEOS_10K = 2_000       # serving_10k corpus, cut to keep the run short
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "float32": 67e12}     # f32 outside the tensor cores

KERNEL_SOURCES = {
    "lstm_pooled": ("vfr_tpu_torch/csrc/lstm_recurrence.cu",
                    "vfr_tpu/ops/pallas/lstm_kernel.py:78"),
    "lstm_hs": ("vfr_tpu_torch/csrc/lstm_recurrence.cu",
                "vfr_tpu/ops/pallas/lstm_kernel.py:60"),
    "distance_select": ("vfr_tpu_torch/csrc/distance_select.cu",
                        "vfr_tpu/ops/pallas/select_kernel.py:41"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- kernels

def phase_lstm(results, seed: int):
    import torch

    from vfr_tpu_torch.ops.kernels.lstm_kernel import (
        lstm_layer,
        lstm_recurrence_plain,
    )
    from vfr_tpu_torch.ops.lstm import init_lstm_params

    B, T, E, H = 256, 24, 300, 1024
    rng = np.random.default_rng(seed)
    lengths_np = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths_np[:8] = 1
    lengths_np[8:16] = T
    dev = torch.device("cuda")
    x = torch.from_numpy(
        rng.standard_normal((B, T, E)).astype(np.float32) / np.sqrt(E)).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    p = init_lstm_params(torch.Generator().manual_seed(seed), E, H,
                         device=dev)["layer0"]
    w_ih = p["w_ih"].to(torch.bfloat16)
    w_hh = p["w_hh"].to(torch.bfloat16)
    b = p["b"]
    live_steps = int(lengths_np.sum())
    flops = 2.0 * live_steps * 4 * H * (E + H)
    w_bytes = (E + H) * 4 * H * 2 + 4 * H * 4 + B * 4 + B * T * E * 4
    for name, pool, out_bytes in (
            ("lstm_pooled", "mean", 2 * B * H * 4),
            ("lstm_hs", "none", B * H * 4 + B * T * H * 4)):
        got = lstm_layer(x, lengths, w_ih, w_hh, b, pool=pool)
        ref = lstm_recurrence_plain(x, lengths, w_ih, w_hh, b, pool=pool)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ms = cuda_ms(lambda: lstm_layer(x, lengths, w_ih, w_hh, b, pool=pool))
        plain_ms = cuda_ms(lambda: lstm_recurrence_plain(
            x, lengths, w_ih, w_hh, b, pool=pool))
        # the f32-weight build of the same kernel (parity configurations)
        got32 = lstm_layer(x, lengths, p["w_ih"], p["w_hh"], b, pool=pool,
                           weights_dtype=torch.float32)
        ref32 = lstm_recurrence_plain(x, lengths, p["w_ih"], p["w_hh"], b,
                                      pool=pool, weights_dtype=torch.float32)
        err32 = max(float((g - r).abs().max()) for g, r in zip(got32, ref32))
        bound_ms, bound_by = bound(w_bytes + out_bytes, flops, "bfloat16")
        rec = dict(name=name, shape=dict(B=B, T=T, E=E, H=H,
                                         weights="bfloat16"),
                   max_abs_err=err, max_abs_err_f32_weights=err32, tol=2e-3,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None,
                   live_steps=live_steps)
        emit({"phase": f"kernel_{name}", **rec})
        require(finite, f"{name}: non-finite output")
        require(max(err, err32) <= 2e-3,
                f"{name}: max |diff| {err} (bf16 weights), {err32} (f32 "
                "weights) > 2e-3")
        results[name] = rec


def _k2_library(q, m, m_sq, w, bin_size, block_n):
    """One PyTorch formulation of the same selection (timing yardstick,
    never used by the port): batched matmul, then amin over the strided
    bin view."""
    import torch
    import torch.nn.functional as F

    qm = torch.matmul(q.to(m.dtype), m.transpose(1, 2)).float()   # [S,Q,N]
    D = (w[:, None, None] * (m_sq[:, None, :] + (q * q).sum(-1)[:, :, None]
                             - 2.0 * qm)).sum(0)
    pad = (-D.shape[1]) % block_n
    D = F.pad(D, (0, pad), value=float("inf"))
    return D.view(D.shape[0], -1, bin_size, block_n // bin_size).amin(2)


def phase_select(results, seed: int):
    import torch
    import torch.nn.functional as F

    from vfr_tpu_torch.ops.kernels.select_kernel import (
        distance_select,
        distance_select_plain,
    )

    S, Q, N, d, bin_size, block_n = 2, 256, 210_000, 128, 64, 4096
    rng = np.random.default_rng(seed + 1)
    dev = torch.device("cuda")

    def unit(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-8)

    q = torch.from_numpy(unit(S, Q, d)).to(dev)
    m32 = torch.from_numpy(unit(S, N, d)).to(dev)
    w = [0.5, 0.5]
    w_t = torch.tensor(w, device=dev)
    recs = []
    for dtype_name, m in (("float32", m32),
                          ("bfloat16", m32.to(torch.bfloat16))):
        m_sq = (m.float() * m.float()).sum(-1)
        vals, rows = distance_select(q, m, m_sq, w, bin_size, block_n)
        rv, rr = distance_select_plain(q, m, m_sq, w, bin_size, block_n)
        torch.cuda.synchronize()
        rel = ((vals - rv).abs() / rv.abs().clamp(min=1e-6))
        err = float((vals - rv).abs().max())
        # rows must agree wherever the bin's two smallest distances are
        # further apart than the value tolerance
        mf = F.pad(m.float(), (0, 0, 0, (-N) % block_n))
        msq = F.pad(m_sq, (0, (-N) % block_n), value=1e30)
        qr = q.to(m.dtype).float()
        D = sum(w[s] * (msq[s][None] + (q[s] * q[s]).sum(-1)[:, None]
                        - 2.0 * (qr[s] @ mf[s].T)) for s in range(S))
        two = D.view(Q, -1, bin_size, block_n // bin_size).topk(
            2, dim=2, largest=False).values
        gap = (two[:, :, 1] - two[:, :, 0]).reshape(Q, -1)
        clear = gap > 1e-3 * two[:, :, 0].reshape(Q, -1).abs()
        row_mismatch = int(((rows != rr) & clear).sum())
        ms = cuda_ms(lambda: distance_select(q, m, m_sq, w, bin_size,
                                             block_n))
        plain_ms = cuda_ms(lambda: distance_select_plain(
            q, m, m_sq, w, bin_size, block_n), iters=10)
        library_ms = cuda_ms(lambda: _k2_library(q, m, m_sq, w_t, bin_size,
                                                 block_n), iters=10)
        C = vals.shape[1]
        nbytes = (S * N * d * m.element_size() + S * N * 4 + S * Q * d * 4
                  + Q * C * 8)
        bound_ms, bound_by = bound(nbytes, 2.0 * S * Q * N * d, dtype_name)
        rec = dict(name="distance_select", index_dtype=dtype_name,
                   shape=dict(S=S, Q=Q, N=N, d=d, bin=bin_size,
                              block_n=block_n),
                   max_abs_err=err, max_rel_err=float(rel.max()), tol=1e-3,
                   row_mismatches_outside_ties=row_mismatch, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "kernel_distance_select", **rec})
        require(bool(torch.isfinite(vals).all()), "distance_select: non-finite")
        require(float(rel.max()) <= 1e-3,
                f"distance_select[{dtype_name}]: rel err {float(rel.max())}")
        require(row_mismatch == 0,
                f"distance_select[{dtype_name}]: {row_mismatch} rows differ")
        recs.append(rec)
    results["distance_select"] = recs


def phase_profile(seed: int):
    """Device time by CUDA kernel name (torch.profiler) of one flagship
    encode (K1a), one fused selection (K2) and the exact path's score GEMM
    + top-10 at the main path's shapes — where a batch's time goes.  Not
    part of the default run (``--phases profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vfr_tpu_torch.ops.kernels.lstm_kernel import lstm_layer
    from vfr_tpu_torch.ops.kernels.select_kernel import distance_select
    from vfr_tpu_torch.ops.lstm import init_lstm_params
    from vfr_tpu_torch.ops.topk import top_k_select
    from vfr_tpu_torch.parallel.sharding import fused_corpus_scores

    B, T, E, H = 256, 24, 300, 1024
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, E)).astype(
        np.float32) / np.sqrt(E)).to(dev)
    lengths = torch.from_numpy(
        rng.integers(1, T + 1, size=B).astype(np.int32)).to(dev)
    p = init_lstm_params(torch.Generator().manual_seed(seed), E, H,
                         device=dev)["layer0"]
    w_ih, w_hh = p["w_ih"].to(torch.bfloat16), p["w_hh"].to(torch.bfloat16)
    q = torch.randn(2, 256, 128, device=dev)
    m = torch.randn(2, 210_000, 128, device=dev).to(torch.bfloat16)
    m_sq = (m.float() ** 2).sum(-1)
    # the exact path's score + select stages on the flagship's f32 operands
    m_cat = torch.randn(210_000, 256, device=dev)
    msq_fused = (m_cat * m_cat).sum(-1)

    def work():
        lstm_layer(x, lengths, w_ih, w_hh, p["b"], pool="mean")
        distance_select(q, m, m_sq, [0.5, 0.5])
        scores = fused_corpus_scores(q, m_cat, msq_fused, [0.5, 0.5],
                                     in_dtype=torch.float32)
        top_k_select(scores, 10)

    work()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            work()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us:
            rows.append({"name": ev.key[:80], "calls": ev.count // 5,
                         "device_ms_per_iter": dev_us / 5 / 1e3})
    rows.sort(key=lambda r: -r["device_ms_per_iter"])
    emit({"phase": "profile", "kernels": rows[:12]})


# --------------------------------------------------------------- serving

def reset_counts():
    from vfr_tpu_torch.ops.kernels import lstm_kernel, select_kernel

    for counts in (lstm_kernel.LAUNCHES, select_kernel.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_counts():
    from vfr_tpu_torch.ops.kernels import lstm_kernel, select_kernel

    return {**lstm_kernel.LAUNCHES, **select_kernel.LAUNCHES}


def make_corpus(preset: str, num_videos: int, seed: int):
    """(cfg, dataset, vocab, glove) of a synthetic DiDeMo corpus in which
    every one of ``num_videos`` videos is annotated (so indexed)."""
    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.data.didemo import DidemoDataset
    from vfr_tpu_torch.data.synthetic import make_didemo_fixture

    cfg = get_preset(preset)
    data = dataclasses.replace(cfg.data, synthetic_num_videos=num_videos,
                               synthetic_num_queries=4 * num_videos,
                               synthetic_seed=seed)
    cfg = dataclasses.replace(cfg, data=data)
    fix = make_didemo_fixture(
        num_videos=num_videos, num_queries=4 * num_videos,
        feature_dim=data.feature_dim, glove_dim=data.glove_dim,
        num_clips=data.num_clips, clip_seconds=data.clip_seconds,
        noise=data.synthetic_noise, with_flow=data.use_flow,
        vocab_words=data.synthetic_vocab_words, seed=seed)
    ds = DidemoDataset(fix.annotations, fix.rgb, fix.flow, fix.vocab, data)
    require(len(ds.video_ids) == num_videos,
            f"corpus has {len(ds.video_ids)} videos, wanted {num_videos}")
    return cfg, ds, fix.vocab, fix.glove


def make_queries(vocab, n: int, max_len: int, seed: int):
    """n queries of 1..max_len fixture words (every bucket is used)."""
    rng = np.random.default_rng(seed)
    words = vocab.itos[2:]
    return [" ".join(words[i] for i in rng.integers(0, len(words),
                                                    int(rng.integers(1, max_len + 1))))
            for _ in range(n)]


def encode(vocab, queries, batch: int, max_len: int):
    from vfr_tpu_torch.data.glove import tokenize

    M = -(-len(queries) // batch)
    toks = np.zeros((M, batch, max_len), np.int32)
    lens = np.ones((M, batch), np.int32)
    for j, text in enumerate(queries):
        b, i = divmod(j, batch)
        toks[b, i], lens[b, i] = vocab.encode(tokenize(text), max_len)
    return toks, lens


def compare_to_plain(d_k, r_k, d_p, r_p, tol=1e-3):
    """(#rows differing outside near-ties, max |distance diff|)."""
    diff = float(np.abs(d_k - d_p).max())
    mism = 0
    for dk, rk, dp, rp in zip(d_k.reshape(-1, d_k.shape[-1]),
                              r_k.reshape(-1, r_k.shape[-1]),
                              d_p.reshape(-1, d_p.shape[-1]),
                              r_p.reshape(-1, r_p.shape[-1])):
        for j in np.nonzero(rk != rp)[0]:
            near = [abs(dp[j] - dp[jj]) for jj in (j - 1, j + 1)
                    if 0 <= jj < len(dp)]
            if not near or min(near) > 2 * tol:
                mism += 1
    return mism, diff


def time_batches(fn, repeats: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best.append(time.perf_counter() - t0)
    return float(np.median(best)) * 1e3


def phase_serving(results, seed: int, num_videos: int, workdir: str,
                  k: int = 10, n_queries: int = 1024):
    import torch

    from vfr_tpu_torch.eval.corpus import (
        build_moment_index,
        load_index,
        make_retriever,
        make_stream_retriever,
        save_index,
        serve_queries,
    )
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import init_model_params

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, ds, vocab, glove = make_corpus("didemo_flagship", num_videos, seed)
    setup_s = time.perf_counter() - t0
    model = build_model(cfg)
    params = init_model_params(torch.Generator().manual_seed(seed), model,
                               glove, cfg.data.feature_dim, device=dev)
    T = cfg.data.max_query_len
    batch = cfg.eval.corpus_query_batch

    t0 = time.perf_counter()
    index = build_moment_index(params, model, ds,
                               index_dtype=cfg.eval.index_dtype)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    path = save_index(index, os.path.join(workdir, "flagship_index.npz"))
    loaded = load_index(path, device=dev)
    require(torch.equal(loaded.m, index.m)
            and torch.equal(loaded.m_sq, index.m_sq),
            "index save/load round trip is not bit-exact")
    require(loaded.num_rows == 21 * num_videos,
            f"index rows {loaded.num_rows} != {21 * num_videos}")
    del index

    queries = make_queries(vocab, n_queries, T, seed + 7)
    kw = dict(k=k, batch_size=batch, max_query_len=T, index=loaded)
    reset_counts()
    t0 = time.perf_counter()
    exact = serve_queries(params, model, ds, vocab, queries, **kw)
    serve_s = time.perf_counter() - t0
    counts = read_counts()
    require(counts["lstm_pooled"] > 0, "flagship: K1a (lstm_pooled) never "
            "launched on the serving path")
    bucketed = serve_queries(params, model, ds, vocab, queries,
                             length_buckets="auto", **kw)
    require(bucketed == exact, "flagship: bucketed results differ from "
            "unbucketed")

    toks, lens = encode(vocab, queries, batch, T)
    toks_d = torch.from_numpy(toks).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    r_kernel = make_stream_retriever(model, loaded, k, "exact")
    r_plain = make_stream_retriever(model, loaded, k, "exact",
                                    rnn_kernel="plain")
    d_k, rows_k = (t.cpu().numpy() for t in r_kernel(params, toks_d, lens_d))
    d_p, rows_p = (t.cpu().numpy() for t in r_plain(params, toks_d, lens_d))
    mism, ddiff = compare_to_plain(d_k, rows_k, d_p, rows_p)
    ms_batch = time_batches(lambda: r_kernel(params, toks_d, lens_d)) / len(toks)
    plain_ms_batch = time_batches(
        lambda: r_plain(params, toks_d, lens_d)) / len(toks)
    first = exact[0]["results"]
    rec = dict(phase="flagship", videos=num_videos, rows=loaded.num_rows,
               queries=n_queries, batch=batch, k=k, launches=counts,
               setup_s=setup_s, index_build_s=build_s,
               serve_queries_s=serve_s, ms_per_batch=ms_batch,
               plain_ms_per_batch=plain_ms_batch,
               rows_differing_from_plain=mism,
               max_distance_diff_vs_plain=ddiff,
               bucketed_identical=True)
    emit(rec)
    require(all(np.isfinite(r["distance"]) for r in first)
            and len(first) == k, "flagship: malformed results")
    require(all(a["distance"] <= b["distance"]
                for a, b in zip(first, first[1:])),
            "flagship: distances not ascending")
    require(mism == 0 and ddiff <= 1e-3,
            f"flagship: kernel vs plain: {mism} rows differ, "
            f"max |d diff| {ddiff}")
    results["flagship"] = rec

    # --topk-method fused on the same index
    reset_counts()
    fused = serve_queries(params, model, ds, vocab, queries,
                          topk_method="fused", **kw)
    counts = read_counts()
    require(counts["distance_select"] > 0,
            "fused: K2 (distance_select) never launched")
    require(counts["lstm_pooled"] > 0, "fused: K1a never launched")
    hit = 0
    for a, b in zip(exact, fused):
        ea = {(r["video"], r["start"], r["end"]) for r in a["results"]}
        fb = {(r["video"], r["start"], r["end"]) for r in b["results"]}
        hit += len(ea & fb)
    recall = hit / (k * len(exact))
    r_fused = make_retriever(model, loaded, k, "fused")
    fused_ms = time_batches(
        lambda: [r_fused(params, toks_d[b], lens_d[b])
                 for b in range(len(toks))]) / len(toks)
    rec = dict(phase="fused", launches=counts, recall_at_10_vs_exact=recall,
               ms_per_batch=fused_ms)
    emit(rec)
    require(recall >= 0.9, f"fused: recall@{k} vs exact {recall} < 0.9")
    results["fused"] = rec
    del loaded


def phase_serving_10k(results, seed: int, num_videos: int):
    import torch

    from vfr_tpu_torch.eval.corpus import (
        build_moment_index,
        make_stream_retriever,
        serve_queries,
    )
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import init_model_params

    dev = torch.device("cuda")
    cfg, ds, vocab, glove = make_corpus("serving_10k", num_videos, seed + 3)
    model = build_model(cfg)
    params = init_model_params(torch.Generator().manual_seed(seed + 3),
                               model, glove, cfg.data.feature_dim, device=dev)
    T = cfg.data.max_query_len
    batch = cfg.eval.corpus_query_batch
    k = cfg.eval.corpus_topk
    index = build_moment_index(params, model, ds,
                               index_dtype=cfg.eval.index_dtype)
    require(index.m.dtype == torch.bfloat16, "serving_10k: index not bf16")
    queries = make_queries(vocab, 1024, T, seed + 11)
    reset_counts()
    out = serve_queries(params, model, ds, vocab, queries, k=k,
                        batch_size=batch, max_query_len=T,
                        topk_method=cfg.eval.topk_method, index=index)
    counts = read_counts()
    require(counts["lstm_hs"] > 0, "serving_10k: K1b (lstm_hs) never "
            "launched on the serving path")
    toks, lens = encode(vocab, queries, batch, T)
    toks_d = torch.from_numpy(toks).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    r_kernel = make_stream_retriever(model, index, k, cfg.eval.topk_method)
    r_plain = make_stream_retriever(model, index, k, cfg.eval.topk_method,
                                    rnn_kernel="plain")
    d_k, rows_k = (t.cpu().numpy() for t in r_kernel(params, toks_d, lens_d))
    d_p, rows_p = (t.cpu().numpy() for t in r_plain(params, toks_d, lens_d))
    mism, ddiff = compare_to_plain(d_k, rows_k, d_p, rows_p)
    ms_batch = time_batches(lambda: r_kernel(params, toks_d, lens_d)) / len(toks)
    rec = dict(phase="serving_10k", videos=num_videos, rows=index.num_rows,
               queries=len(queries), k=k, launches=counts,
               ms_per_batch=ms_batch, rows_differing_from_plain=mism,
               max_distance_diff_vs_plain=ddiff)
    emit(rec)
    require(len(out) == len(queries) and len(out[0]["results"]) == k,
            "serving_10k: malformed results")
    require(mism == 0 and ddiff <= 1e-3,
            f"serving_10k: kernel vs plain: {mism} rows differ, "
            f"max |d diff| {ddiff}")
    results["serving_10k"] = rec


def kernels_line(results):
    """The {"kernels": [...]} summary: launches from the serving run of
    each kernel's path, times and errors from the kernel phase."""
    launches = {
        "lstm_pooled": results.get("flagship", {}).get("launches", {})
        .get("lstm_pooled", 0),
        "lstm_hs": results.get("serving_10k", {}).get("launches", {})
        .get("lstm_hs", 0),
        "distance_select": results.get("fused", {}).get("launches", {})
        .get("distance_select", 0),
    }
    out = []
    for name in ("lstm_pooled", "lstm_hs"):
        r = results[name]
        src, rep = KERNEL_SOURCES[name]
        out.append(dict(name=name, route="cuda", source=src, replaces=rep,
                        launches=launches[name],
                        max_abs_err=r["max_abs_err"], ms=r["ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None))
    # the fused cell's index is f32 (the flagship preset); the bf16-index
    # build of the same kernel is reported beside it
    src, rep = KERNEL_SOURCES["distance_select"]
    r = {x["index_dtype"]: x for x in results["distance_select"]}
    f32, b16 = r["float32"], r["bfloat16"]
    out.append(dict(name="distance_select", route="cuda", source=src,
                    replaces=rep, launches=launches["distance_select"],
                    max_abs_err=f32["max_abs_err"], ms=f32["ms"],
                    plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
                    bound_by=f32["bound_by"], library_ms=f32["library_ms"],
                    bf16_index=dict((k, b16[k]) for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"))))
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,flagship,serving_10k",
                    help="comma list of kernels, flagship, serving_10k and "
                         "profile; the default runs all but profile and is "
                         "the only one that ends with the ok line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vfr_tpu_torch.kernels.build import build_all

    phases = set(args.phases.split(","))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    results = {}
    if "profile" in phases:
        phase_profile(SEED)
    if "kernels" in phases:
        phase_lstm(results, SEED)
        phase_select(results, SEED)
    with tempfile.TemporaryDirectory() as workdir:
        if "flagship" in phases:
            phase_serving(results, SEED, VIDEOS, workdir)
    if "serving_10k" in phases:
        phase_serving_10k(results, SEED, VIDEOS_10K)
    if not {"kernels", "flagship", "serving_10k"} <= phases:
        emit({"partial": sorted(phases)})
        return 0
    emit(kernels_line(results))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
