#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vfr_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # every phase, full widths

Phases, one JSON line each:
  device      the card (nvidia-smi name and power limit), torch, CUDA.
  build       nvcc of every kernel source (one process each, in parallel).
  kernel_*    each CUDA kernel against its plain PyTorch version on the
              card at the main path's shapes (max |diff|, kernel / plain /
              library ms by CUDA events), both variants of each (LSTM / GRU:
              persistent, stepwise; distance-select / coarse block-max: mma,
              simt), timed in turns, and at ragged shapes.
  flagship    didemo_flagship at full width (E=300, H=1024, F=2048, joint
              128, two streams, cosine, mean pool), seeded weights, a
              synthetic 10,000-video corpus (210,000 index rows): build,
              save and load the index, serve 1024 queries exact, then with
              length buckets (identical results required), and hold the
              results against the same queries served through the
              kernels' plain versions.
  fused       `--topk-method fused` on the same index; recall@10 vs exact.
  coarse      the coarse-to-fine prefilter (d_coarse 32) built on the same
              index, save/load round trip, 1024 queries served with stage 1
              blockmax (K4) and centroid at C=2048, blockmax held against
              the same retriever with K4's plain version; recall@10 vs
              exact.
  follow      daemon serving (`serve_follow`) on the same index: 50
              isolated requests (one in flight) and a backlog of 200 at
              micro-batch 8 (pipeline depth 1 and 2) and 64 (depth 1), exact
              (K1a) and fused (K1a, K2), and coarse blockmax (K1a, K4) once;
              p50 / p95 request ms, requests/s, time to first result; each
              run beside its plain-version run and held to `serve_queries`'
              records (moments equal outside near-ties, distances within
              1e-3); depth 1 against 2 at micro-batch 8 in turns; host
              syncs per pack by line; K2 at one pack of 8 queries; one
              `cli serve --follow` subprocess on stdin.
  eval        per-video and corpus eval of didemo_flagship on the flagship
              corpus (40,000 queries): `evaluate` under both protocols on the
              preset's f32 scan twin, then with rnn_kernel="pallas" (K1a);
              `corpus_evaluate` (official protocol, GT ranker on) exact on
              the scan twin, then exact (K1a), fused (K1a + K2) and coarse
              blockmax d_coarse 32, C=2048 (K1a + K4); each kernel run held
              against the same run through the kernels' plain versions
              (metrics within 0.1% of the queries); keys as the JAX
              package's; seconds and queries/s per run.
  eval_charades charades_flagship at full width (F=2048, H=1024, joint 128,
              one stream, cosine, last pool) on a synthetic 2,000-video
              Charades-STA corpus (T=40 rows, W=64 windows: 128,000 index
              rows, 4,000 queries): per-video eval (scan; K1b held against
              plain), corpus eval exact and fused (K1b; K1b + K2 at S=1 over
              1e30 sentinel rows) held against plain, per-video eval with
              pooling="max" (the direct form) and its peak memory; no
              invalid window may be retrieved; K2 timed at this shape.
  serving_10k last pool, bf16 compute, bf16 index, on a 2,000-video corpus.
  coarse_2m   a 2.1M-row bf16 index (100,000 videos, S=2, d=128) drawn on
              the card from a seeded normal, serving_10k weights: coarse
              build seconds, ms per 256-query batch of the exact full scan
              and of blockmax / centroid at C in {1024, 2048}.
  gru         didemo_flagship with rnn_cell="gru" on a 2,000-video corpus:
              mean pool (K3a) and last pool (K3b), each held against the
              kernels' plain versions.
  train       `cli train` of didemo_flagship at full width (B=128, InfoNCE,
              EMA 0.999, 8 mined negatives from epoch 3) on a synthetic
              2,000-video fixture, 4 epochs of 20 steps; then `cli corpus
              --checkpoint-dir` on what it wrote, exact (K1a) and fused
              (K1a + K2), each held against the kernels' plain versions.
              Fails on a non-finite loss, an EMA tree equal to the raw
              params, a checkpoint that does not reload bit for bit, or
              fused-layer gradients (the hand-written BPTT) more than
              GRAD_TOL of max |grad| per leaf from autograd through the
              scan twin on one flagship batch.  Reports step ms (median of
              the chunks), the step's forward / backward / optimizer / EMA
              split by CUDA events, the device's busy share of a step,
              mining refresh and eval seconds; a step that synchronises
              with the host fails it.
  packed      the synthetic didemo_flagship fixture (2,000 videos) written
              in the real layout, `cli pack` of both streams, `cli corpus`
              on the npz and on the .vfrf-only directory (equal metric
              dicts); the native reader must serve the store; gather GB/s
              of the native and the memmap reader.
  live        the live index of serving_10k: 10,000 videos in a 20,000-video
              arena (420,000 rows), 4 appends of 128 videos, a removal of
              500, compact, grow to 25,000, save -> load (bit-exact); after
              each, the live retriever held to a from-scratch index over the
              same corpus; the arena written in place until the grow; K1b
              must launch; seconds of each operation, retrieve ms before and
              after, the arena's bytes; a `cli serve --follow
              --live-capacity-videos` subprocess running a script of queries
              and control lines, and a second booted from its `!save`.
Every serving and eval run zeroes the kernels' launch counts just before
it runs and fails unless each kernel of its path launched.  Then one
{"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero with no ok line.
Without a CUDA device it exits 2 and prints no result.

Not in the default run (``--phases``): ``rnn`` (the K1 / K3 checks alone),
``select`` (K2's), ``coarse_kernel`` (K4's),
``profile`` (device time by kernel name), ``steps`` (the persistent
kernels' per-step time split), ``wgmma_rate`` (the tensor cores' own time
for a step's products).
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
VIDEOS_10K = 2_000       # serving_10k and gru corpora, cut to keep the run
                         # short
VIDEOS_2M = 100_000      # coarse_2m: 2.1M index rows
VIDEOS_CHARADES = 2_000  # eval_charades: 128,000 index rows (64 windows)
VIDEOS_TRAIN = 2_000     # train: synthetic didemo_flagship fixture
TRAIN_STEPS_PER_EPOCH = 20
TRAIN_EPOCHS = 4         # the preset mines from epoch 3: one refresh
TRAIN_STEPS_PER_CALL = 5
FOLLOW_REQUESTS = 200    # follow: a backlog of 200 requests
FOLLOW_ISOLATED = 50     # and 50 isolated ones (one in flight)
FOLLOW_CLI = 20          # requests of the `cli serve --follow` subprocess
LIVE_VIDEOS = 10_000     # live: serving_10k, 10,000 videos in an arena of
LIVE_CAPACITY = 20_000   # 20,000 (420,000 rows), the JAX package's
LIVE_GROW = 25_000       # scripts/probe_live.py set-up; then grown
LIVE_APPENDS = 4         # appends of
LIVE_DELTA = 128         # videos each,
LIVE_REMOVE = 500        # one removal of 500 videos
LIVE_FOLLOW_SEGMENT = 24  # live daemon: 4 runs of 24 queries between
LIVE_FOLLOW_ADD = 64      # !add of 64 videos, !remove of
LIVE_FOLLOW_REMOVE = 64   # 64 (8 of them just added) and !compact
PACKED_VIDEOS = 2_000    # packed: the fixture written in the real layout
GRAD_TOL = 1e-3          # fused BPTT vs scan autograd, of max |grad| per leaf
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "tf32": 495e12,       # dense tensor-core rate
              "float32": 67e12}     # f32 outside the tensor cores

KERNEL_SOURCES = {
    "lstm_pooled": ("vfr_tpu_torch/csrc/lstm_recurrence.cu",
                    "vfr_tpu/ops/pallas/lstm_kernel.py:78"),
    "lstm_hs": ("vfr_tpu_torch/csrc/lstm_recurrence.cu",
                "vfr_tpu/ops/pallas/lstm_kernel.py:60"),
    "distance_select": ("vfr_tpu_torch/csrc/distance_select.cu",
                        "vfr_tpu/ops/pallas/select_kernel.py:41"),
    "gru_pooled": ("vfr_tpu_torch/csrc/gru_recurrence.cu",
                   "vfr_tpu/ops/pallas/gru_kernel.py:79"),
    "gru_hs": ("vfr_tpu_torch/csrc/gru_recurrence.cu",
               "vfr_tpu/ops/pallas/gru_kernel.py:62"),
    "coarse_blockmax": ("vfr_tpu_torch/csrc/coarse_blockmax.cu",
                        "vfr_tpu/ops/pallas/coarse_kernel.py:63"),
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
    """(ms, "bytes" | "operations").  f32 products can run as f32 FMAs or,
    to the same accuracy, as three TF32 tensor-core products of hi/lo
    splits: the operations time of "float32" is the lesser of the two."""
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    if dtype == "float32":
        t_ops = min(t_ops, 3.0 * flops / PEAK_FLOPS["tf32"])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- kernels

def _cudnn_rnn(cell: str, p, dtype, dev):
    """torch.nn.LSTM / nn.GRU (cuDNN) holding the kernel's weights: the
    library yardstick, never used by the port.  torch keeps the (i, f, g,
    o) and (r, z, n) gate orders and b_hn inside r * (...), as the kernels
    do; the LSTM's single bias goes to bias_ih."""
    import torch

    E, H = p["w_ih"].shape[0], p["w_hh"].shape[0]
    mod = (torch.nn.GRU if cell == "gru" else torch.nn.LSTM)(
        E, H, batch_first=True)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(p["w_ih"].float().T)
        mod.weight_hh_l0.copy_(p["w_hh"].float().T)
        if cell == "gru":
            mod.bias_ih_l0.copy_(p["b_ih"])
            mod.bias_hh_l0.copy_(p["b_hh"])
        else:
            mod.bias_ih_l0.copy_(p["b"])
            mod.bias_hh_l0.zero_()
    return mod.to(device=dev, dtype=dtype)


def _rnn_case(cell: str, seed: int, B: int, T: int, E: int, H: int):
    """Seeded inputs of one K1 / K3 layer call: (layer, plain, p, args16,
    args32, lengths_np)."""
    import torch

    from vfr_tpu_torch.ops import lstm as rnn_ops

    if cell == "gru":
        from vfr_tpu_torch.ops.kernels.gru_kernel import (
            gru_layer as layer,
            gru_recurrence_plain as plain,
        )
        p_init, bias_keys = rnn_ops.init_gru_params, ("b_ih", "b_hh")
    else:
        from vfr_tpu_torch.ops.kernels.lstm_kernel import (
            lstm_layer as layer,
            lstm_recurrence_plain as plain,
        )
        p_init, bias_keys = rnn_ops.init_lstm_params, ("b",)
    rng = np.random.default_rng(seed)
    lengths_np = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths_np[:8] = 1
    lengths_np[8:16] = T
    dev = torch.device("cuda")
    x = torch.from_numpy((rng.standard_normal((B, T, E))
                          / np.sqrt(E)).astype(np.float32)).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    p = p_init(torch.Generator().manual_seed(seed), E, H,
               device=dev)["layer0"]
    biases = tuple(p[key] for key in bias_keys)
    args16 = (x, lengths, p["w_ih"].to(torch.bfloat16),
              p["w_hh"].to(torch.bfloat16), *biases)
    args32 = (x, lengths, p["w_ih"], p["w_hh"], *biases)
    return layer, plain, p, args16, args32, lengths_np


def _max_diff(got, ref) -> float:
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def phase_rnn(results, seed: int, cell: str):
    """K1 (cell="lstm") or K3 (cell="gru"), pooled and hs modes: both
    kernel variants (persistent, stepwise) against the plain version with
    bf16 weights, the f32-weight build (stepwise), a ragged shape with
    zero-length rows, and the times taken in turns (stepwise, persistent,
    persistent, stepwise) beside cuDNN over a packed batch of the same
    weights (fp16 operands, the 2-byte type cuDNN's RNN takes, and f32).
    The persistent variant is also timed with its input product unfused
    and on the same batch sorted by length (whole 64-row tiles then go
    dead early and skip their products)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    from vfr_tpu_torch.ops.kernels import gru_kernel, lstm_kernel

    mod_k = gru_kernel if cell == "gru" else lstm_kernel
    gates = 3 if cell == "gru" else 4
    B, T, E, H = 256, 24, 300, 1024
    layer, plain, p, args16, args32, lengths_np = _rnn_case(
        cell, seed, B, T, E, H)
    x = args16[0]
    dev = x.device
    n_bias = len(args16) - 4
    live_steps = int(lengths_np.sum())
    flops = 2.0 * live_steps * gates * H * (E + H)
    w_bytes = ((E + H) * gates * H * 2 + n_bias * gates * H * 4 + B * 4
               + B * T * E * 4)
    lens_cpu = torch.as_tensor(lengths_np, dtype=torch.int64)
    order = torch.argsort(args16[1], descending=True, stable=True)
    sorted16 = (x[order].contiguous(), args16[1][order].contiguous(),
                *args16[2:])
    lib = {}
    with torch.inference_mode():
        for tag, dtype in (("", torch.float16), ("_f32", torch.float32)):
            mod = _cudnn_rnn(cell, p, dtype, dev)
            packed = pack_padded_sequence(x.to(dtype), lens_cpu,
                                          batch_first=True,
                                          enforce_sorted=False)
            h_n = mod(packed)[1]
            h_n = (h_n[0] if cell == "lstm" else h_n)[0].float()
            lib[f"library{tag}_ms"] = cuda_ms(lambda: mod(packed))
            lib[f"library{tag}_h_last"] = h_n
            lib[f"library{tag}_cudnn"] = bool(
                torch.backends.cudnn.is_acceptable(packed.data))
    # a ragged shape: B, H off the tile sizes, rows of length 0, T = 7;
    # then T = 1
    ragged = {}
    for rb, rt, re_, rh in ((200, 7, 52, 1000), (70, 1, 300, 1024)):
        r_layer, r_plain, _, r16, _, _ = _rnn_case(cell, seed + 2, rb, rt,
                                                   re_, rh)
        r_len = r16[1].clone()
        r_len[3:40:5] = 0
        r16 = (r16[0], r_len, *r16[2:])
        for pool in ("mean", "none"):
            ref = r_plain(*r16, pool=pool)
            for variant in ("persistent", "stepwise"):
                got = r_layer(*r16, pool=pool, variant=variant)
                torch.cuda.synchronize()
                ragged[f"B{rb}_T{rt}_E{re_}_H{rh}_{pool}_{variant}"] = \
                    _max_diff(got, ref)
    ragged_err = max(ragged.values())
    for name, pool, out_bytes in (
            (f"{cell}_pooled", "mean", 2 * B * H * 4),
            (f"{cell}_hs", "none", B * H * 4 + B * T * H * 4)):
        ref = plain(*args16, pool=pool)
        errs, plans = {}, {}
        for variant in ("persistent", "stepwise"):
            got = layer(*args16, pool=pool, variant=variant)
            torch.cuda.synchronize()
            errs[variant] = _max_diff(got, ref)
            plans[variant] = mod_k.LAST_PLAN
            require(plans[variant].variant == variant,
                    f"{name}: asked for {variant}, ran "
                    f"{plans[variant].variant}")
            require(all(bool(torch.isfinite(g).all()) for g in got),
                    f"{name}[{variant}]: non-finite output")
        # the persistent variant's other forms
        got = layer(*args16, pool=pool, variant="persistent",
                    fuse_input=False)
        torch.cuda.synchronize()
        errs["persistent_unfused"] = _max_diff(got, ref)
        got = layer(*sorted16, pool=pool, variant="persistent")
        torch.cuda.synchronize()
        errs["persistent_sorted_rows"] = _max_diff(
            got, tuple(r[order] for r in ref))
        got = layer(*args16, pool=pool)
        torch.cuda.synchronize()
        auto_plan = mod_k.LAST_PLAN
        lib_diff = {tag: float((got[0] - lib[f"library{tag}_h_last"])
                               .abs().max()) for tag in ("", "_f32")}
        turns = []
        for variant in ("stepwise", "persistent", "persistent", "stepwise"):
            turns.append(cuda_ms(lambda: layer(*args16, pool=pool,
                                               variant=variant)))
        stepwise_ms = (turns[0] + turns[3]) / 2
        ms = (turns[1] + turns[2]) / 2
        unfused_ms = cuda_ms(lambda: layer(*args16, pool=pool,
                                           variant="persistent",
                                           fuse_input=False))
        sorted_ms = cuda_ms(lambda: layer(*sorted16, pool=pool,
                                          variant="persistent"))
        plain_ms = cuda_ms(lambda: plain(*args16, pool=pool))
        # the f32-weight build of the same kernel (parity configurations)
        got32 = layer(*args32, pool=pool, weights_dtype=torch.float32)
        plan32 = mod_k.LAST_PLAN
        ref32 = plain(*args32, pool=pool, weights_dtype=torch.float32)
        err32 = _max_diff(got32, ref32)
        bound_ms, bound_by = bound(w_bytes + out_bytes, flops, "bfloat16")
        pp = plans["persistent"]
        rec = dict(name=name, shape=dict(B=B, T=T, E=E, H=H,
                                         weights="bfloat16"),
                   variant=auto_plan.variant,
                   plan=dict(u=pp.u, batch_group=pp.batch_group,
                             grid=list(pp.grid), smem_bytes=pp.smem_bytes,
                             fuse_input=pp.fuse_input),
                   f32_weights_variant=plan32.variant,
                   max_abs_err=errs["persistent"],
                   max_abs_err_stepwise=errs["stepwise"],
                   max_abs_err_unfused=errs["persistent_unfused"],
                   max_abs_err_sorted_rows=errs["persistent_sorted_rows"],
                   max_abs_err_f32_weights=err32,
                   max_abs_err_ragged=ragged_err, ragged=ragged, tol=2e-3,
                   ms=ms, stepwise_ms=stepwise_ms, turns_ms=turns,
                   persistent_unfused_ms=unfused_ms,
                   persistent_sorted_rows_ms=sorted_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=lib["library_ms"],
                   library="cudnn fp16", library_f32_ms=lib["library_f32_ms"],
                   library_is_cudnn=lib["library_cudnn"],
                   library_h_last_max_abs_diff=lib_diff[""],
                   library_f32_h_last_max_abs_diff=lib_diff["_f32"],
                   live_steps=live_steps)
        emit({"phase": f"kernel_{name}", **rec})
        require(auto_plan.variant == "persistent",
                f"{name}: the plan chose {auto_plan.variant} at the "
                f"flagship shape ({auto_plan.reason})")
        worst = max(*errs.values(), err32, ragged_err)
        require(worst <= 2e-3,
                f"{name}: max |diff| vs plain {errs}, f32 weights {err32}, "
                f"ragged {ragged} > 2e-3")
        results[name] = rec


def phase_steps(seed: int):
    """Where a persistent step's time goes (``--phases steps``; not part of
    the default run): the kernel's own nanosecond stamps from one thread of
    block (0, 0), K1a and K3a at the flagship shape with the input product
    fused and unfused.  Medians over steps 1..T-2, in microseconds."""
    import torch

    B, T, E, H = 256, 24, 300, 1024
    names = ("recurrent_product", "cell_update", "store_and_arrive",
             "next_input_part", "barrier_wait")
    for cell in ("lstm", "gru"):
        layer, _, _, args16, _, _ = _rnn_case(cell, seed, B, T, E, H)
        for fuse in (True, False):
            kw = dict(pool="mean", variant="persistent", fuse_input=fuse)
            for _ in range(3):
                layer(*args16, **kw)
            tl = torch.zeros(T, 5, dtype=torch.int64, device="cuda")
            layer(*args16, timeline=tl, **kw)
            torch.cuda.synchronize()
            st = tl.cpu().numpy().astype(np.float64) / 1e3
            mid = slice(1, T - 1)
            spans = [st[mid, i + 1] - st[mid, i] for i in range(4)]
            spans.append(st[2:T, 0] - st[1:T - 1, 4])
            emit({"phase": "steps", "kernel": f"{cell}_pooled",
                  "fuse_input": fuse,
                  "median_us": {n: float(np.median(s))
                                for n, s in zip(names, spans)},
                  "step_us": float(np.median(st[2:T, 0] - st[1:T - 1, 0])),
                  "steps_total_ms": float(st[T - 1, 2] - st[0, 0]) / 1e3,
                  "kernel_ms": cuda_ms(lambda: layer(*args16, **kw))})


def phase_wgmma_rate():
    """The tensor cores' own time for one persistent step's products
    (``--phases wgmma_rate``; not part of the default run): builds the
    stand-alone ``csrc/tools/wgmma_rate.cu`` and prints its lines."""
    from vfr_tpu_torch.kernels import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    exe = os.path.join(build.BUILD_DIR, "wgmma_rate")
    src = os.path.join(build.CSRC, "tools", "wgmma_rate.cu")
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build.nvcc_path(), *flags, "-o", exe, src], check=True,
                   capture_output=True, text=True, timeout=600)
    out = subprocess.run([exe], check=True, capture_output=True, text=True,
                         timeout=120)
    for line in out.stdout.splitlines():
        emit({"phase": "wgmma_rate", **json.loads(line)})


def _turns(fn_by_variant, order=("simt", "mma", "mma", "simt"), **kw):
    """Times of the two variants taken in turns inside one call: (mma ms,
    simt ms, the four turns)."""
    turns = [cuda_ms(fn_by_variant(v), **kw) for v in order]
    by = {v: [t for o, t in zip(order, turns) if o == v] for v in set(order)}
    return (sum(by["mma"]) / len(by["mma"]),
            sum(by["simt"]) / len(by["simt"]), turns)


def unit_rows(x):
    return x / (x.norm(dim=-1, keepdim=True) + 1e-8)


def _coarse_check(q, m, msq, B, variant, top=16):
    """One K4 call of ``variant`` against the plain version: (plan, max
    |diff|, max diff relative to max(|value|, 1), top-16 block sets that
    differ outside ties)."""
    import torch

    from vfr_tpu_torch.ops.kernels import coarse_kernel

    got = coarse_kernel.coarse_blockmax(q, m, msq, B, variant=variant)
    plan = coarse_kernel.LAST_PLAN
    ref = coarse_kernel.coarse_blockmax_plain(q, m, msq, B)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
            f"coarse_blockmax[{variant}]: non-finite or misshapen")
    rel = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
    top = min(top, ref.shape[1] - 1)
    pv, pi = ref.topk(top + 1, dim=1)
    ki = got.topk(top, dim=1).indices
    same = (ki.sort(1).values == pi[:, :top].sort(1).values).all(1)
    clear = (pv[:, top - 1] - pv[:, top]) > 1e-5 * pv[:, top - 1] \
        .abs().clamp(min=1.0)
    return (plan, float((got - ref).abs().max()), rel,
            int((~same & clear).sum()))


def phase_coarse_kernel(results, seed: int):
    """K4, both variants (mma, simt) against the plain version.  At the
    coarse path's shapes (Q=256, d_c 32 and 64, 210,000 and 2,100,000 bf16
    rows padded to the 16384-row alignment with msq = 1e30) the variants
    are also timed in turns (simt, mma, mma, simt).  Ragged shapes (Q =
    200, block_rows 32 and 64, N not a multiple of anything, d_c 16 and 48,
    and f32 rows or d_c 24, which the plan gives to simt) are checked only.
    Relative diff is taken against max(|value|, 1): the rounding level is
    set by msq ~ d_c, so values near 0 are held absolutely.  Queries are
    unit vectors, as the serving path's are (cosine distance; q_low is a
    projection of them), held to 1e-5.  The tensor cores sum a k-step's
    products with truncation, ~6 ulp of the sum where the f32 FMA order of
    simt and the plain matmul agree exactly, so with unnormalised normal
    queries (|q| ~ sqrt(d_c), sums of ~14 against results near 0) the mma
    variant is off by ~1e-5 and is held to 1e-4 there (``stress``)."""
    import torch

    from vfr_tpu_torch.ops.kernels.coarse_kernel import (
        KERNEL_BLOCK_N,
        coarse_blockmax,
        coarse_blockmax_plain,
    )

    Q, B = 256, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    ragged = {}
    for rq, rn, rd, rb, rdt, want in (
            (200, 209_999, 32, 128, torch.bfloat16, "mma"),
            (200, 209_999, 64, 32, torch.bfloat16, "mma"),
            (200, 50_001, 48, 64, torch.bfloat16, "mma"),
            (300, 5_000, 16, 32, torch.bfloat16, "mma"),
            (37, 100, 32, 128, torch.bfloat16, "mma"),
            (1_000, 5_000, 32, 128, torch.bfloat16, "mma"),
            (1, 300, 64, 64, torch.bfloat16, "mma"),
            (200, 50_001, 24, 64, torch.bfloat16, "simt"),
            (200, 50_001, 32, 128, torch.float32, "simt")):
        m = torch.randn(rn, rd, generator=gen, device=dev).to(rdt)
        msq = (m.float() ** 2).sum(-1)
        msq[rn - 3:] = 1e30                   # invalid rows inside N
        q = unit_rows(torch.randn(rq, rd, generator=gen, device=dev))
        for variant in ("auto", "simt"):
            plan, _, rel, mism = _coarse_check(q, m, msq, rb, variant)
            key = (f"Q{rq}_N{rn}_d{rd}_B{rb}_"
                   f"{str(rdt).replace('torch.', '')}_{variant}")
            ragged[key] = dict(variant=plan.variant, max_rel_err=rel,
                               top16_set_mismatches_outside_ties=mism)
            if variant == "auto":
                require(plan.variant == want, f"coarse_blockmax {key}: the "
                        f"plan chose {plan.variant} ({plan.reason})")
            require(rel <= 1e-5 and mism == 0,
                    f"coarse_blockmax ragged {key}: rel err {rel}, {mism} "
                    "block sets differ")
        del m, msq, q
    emit({"phase": "kernel_coarse_blockmax_ragged", "tol": 1e-5,
          "cases": ragged})
    recs = []
    for N in (210_000, 2_100_000):
        n_pad = (-N) % KERNEL_BLOCK_N
        for d in (32, 64):
            m = torch.randn(N + n_pad, d, generator=gen, device=dev).to(
                torch.bfloat16)
            m[N:] = 0
            msq = (m.float() ** 2).sum(-1)
            msq[N:] = 1e30
            q_raw = torch.randn(Q, d, generator=gen, device=dev)
            q = unit_rows(q_raw)
            checks = {v: _coarse_check(q, m, msq, B, v)
                      for v in ("mma", "simt")}
            stress = {v: _coarse_check(q_raw, m, msq, B, v)[2]
                      for v in ("mma", "simt")}
            del q_raw
            auto_plan = _coarse_check(q, m, msq, B, "auto")[0]
            plan, err, rel, set_mism = checks["mma"]
            ms, simt_ms, turns = _turns(lambda v: (
                lambda: coarse_blockmax(q, m, msq, B, variant=v)))
            plain_ms = cuda_ms(lambda: coarse_blockmax_plain(q, m, msq, B),
                               iters=5)
            q_r, m_f, neg = q.to(torch.bfloat16).float(), m.float(), -msq
            library_ms = cuda_ms(lambda: torch.addmm(
                neg[None, :], q_r, m_f.T, alpha=2.0).view(Q, -1, B).amax(-1),
                iters=5)
            del q_r, m_f, neg
            Np, G = m.shape[0], -(-m.shape[0] // B)
            bound_ms, bound_by = bound(
                Np * d * 2 + Np * 4 + Q * d * 4 + Q * G * 4,
                2.0 * Q * Np * d, "bfloat16")
            rec = dict(name="coarse_blockmax",
                       shape=dict(Q=Q, N=N, Npad=Np, d_c=d, block_rows=B),
                       variant=auto_plan.variant,
                       plan=dict(stages_per_cta=plan.stages_per_cta,
                                 grid=list(plan.grid),
                                 ctas_per_sm=plan.ctas_per_sm,
                                 smem_bytes=plan.smem_bytes),
                       max_abs_err=err, max_rel_err=rel,
                       max_rel_err_simt=checks["simt"][2], tol=1e-5,
                       stress_max_rel_err=stress["mma"],
                       stress_max_rel_err_simt=stress["simt"],
                       stress_tol=1e-4,
                       top16_set_mismatches_outside_ties=set_mism,
                       top16_set_mismatches_simt=checks["simt"][3], ms=ms,
                       simt_ms=simt_ms, turns_ms=turns,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library="addmm f32 + amax", bound_ms=bound_ms,
                       bound_by=bound_by)
            emit({"phase": "kernel_coarse_blockmax", **rec})
            require(auto_plan.variant == "mma",
                    f"coarse_blockmax[N={N}, d={d}]: the plan chose "
                    f"{auto_plan.variant} ({auto_plan.reason})")
            require(max(stress.values()) <= 1e-4,
                    f"coarse_blockmax[N={N}, d={d}]: rel err {stress} with "
                    "unnormalised queries")
            for v, (_, _, v_rel, v_mism) in checks.items():
                require(v_rel <= 1e-5, f"coarse_blockmax[{v}, N={N}, "
                        f"d={d}]: rel err {v_rel}")
                require(v_mism == 0, f"coarse_blockmax[{v}, N={N}, d={d}]: "
                        f"{v_mism} top-16 block sets differ")
            recs.append(rec)
            del m, msq
    results["coarse_blockmax"] = recs


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


def _select_check(q, m, m_sq, w, bin_size, block_n, variant, **kw):
    """One K2 call of ``variant`` against the plain version: (plan, max
    |diff|, max relative diff, rows differing where the bin's two smallest
    distances are more than 1e-3 (relative) apart)."""
    import torch
    import torch.nn.functional as F

    from vfr_tpu_torch.ops.kernels import select_kernel

    S, Q, _ = q.shape
    N = m.shape[1]
    vals, rows = select_kernel.distance_select(q, m, m_sq, w, bin_size,
                                               block_n, variant=variant, **kw)
    plan = select_kernel.LAST_PLAN
    rv, rr = select_kernel.distance_select_plain(q, m, m_sq, w, bin_size,
                                                 block_n)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(vals).all()) and vals.shape == rv.shape,
            f"distance_select[{variant}]: non-finite or misshapen")
    rel = float(((vals - rv).abs() / rv.abs().clamp(min=1e-6)).max())
    # finite rows only: a bin of padding holds 1e30 in both
    live = rv < 1e29
    err = float(((vals - rv).abs() * live).max())
    mf = F.pad(m.float(), (0, 0, 0, (-N) % block_n))
    msq = F.pad(m_sq, (0, (-N) % block_n), value=1e30)
    qr = q.to(m.dtype).float()
    D = sum(w[s] * (msq[s][None] + (q[s] * q[s]).sum(-1)[:, None]
                    - 2.0 * (qr[s] @ mf[s].T)) for s in range(S))
    two = D.view(Q, -1, bin_size, block_n // bin_size).topk(
        min(2, bin_size), dim=2, largest=False).values
    if bin_size > 1:
        gap = (two[:, :, 1] - two[:, :, 0]).reshape(Q, -1)
        clear = gap > 1e-3 * two[:, :, 0].reshape(Q, -1).abs()
    else:
        clear = torch.ones_like(rows, dtype=torch.bool)
    return plan, err, rel, int(((rows != rr) & clear).sum())


def phase_select(results, seed: int):
    """K2, both variants (mma, simt) against the plain version, for an f32
    and a bf16 index.  At the fused cell's shape (S=2, Q=256, N=210,000,
    d=128, bin 64) the variants are also timed in turns (simt, mma, mma,
    simt) and the mma variant with other splits of the a range.  Ragged
    shapes (N = 209,999 and 5,000, Q = 200, bin 16 and 32, S = 1, weights
    (0.3, 0.7) and (0.7, 0.3), eight query tiles, a zero weight, a single
    query, and a bin or width the plan gives to simt) are checked only."""
    import torch

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
    ragged = {}
    for rs, rq, rn, rd, rbin, rw, want in (
            (2, 200, 209_999, 128, 64, [0.3, 0.7], "mma"),
            (2, 200, 5_000, 128, 32, [0.7, 0.3], "mma"),
            (1, 200, 5_000, 128, 16, [0.7], "mma"),
            (2, 37, 9_000, 48, 8, [0.5, 0.5], "mma"),
            (2, 1_000, 3_000, 128, 64, [1.0, 0.0], "mma"),
            (1, 1, 100, 64, 64, [0.5], "mma"),
            (2, 200, 5_000, 128, 128, [0.3, 0.7], "simt"),
            (1, 100, 5_000, 40, 64, [1.0], "simt")):
        rq_t = torch.from_numpy(unit(rs, rq, rd)).to(dev)
        rm32 = torch.from_numpy(unit(rs, rn, rd)).to(dev)
        for dtype_name, rm in (("float32", rm32),
                               ("bfloat16", rm32.to(torch.bfloat16))):
            rm_sq = (rm.float() * rm.float()).sum(-1)
            for variant in ("auto", "simt"):
                plan, err, rel, mism = _select_check(
                    rq_t, rm, rm_sq, rw, rbin, block_n, variant)
                key = (f"S{rs}_Q{rq}_N{rn}_d{rd}_bin{rbin}_w{rw[0]}_"
                       f"{dtype_name}_{variant}")
                ragged[key] = dict(variant=plan.variant, max_abs_err=err,
                                   max_rel_err=rel,
                                   row_mismatches_outside_ties=mism)
                if variant == "auto":
                    require(plan.variant == want, f"distance_select {key}: "
                            f"the plan chose {plan.variant} ({plan.reason})")
                require(rel <= 1e-3 and mism == 0,
                        f"distance_select ragged {key}: rel err {rel}, "
                        f"{mism} rows differ")
        del rq_t, rm32, rm, rm_sq
    emit({"phase": "kernel_distance_select_ragged", "tol": 1e-3,
          "cases": ragged})
    w = [0.5, 0.5]
    w_t = torch.tensor(w, device=dev)
    recs = []
    for dtype_name, m in (("float32", m32),
                          ("bfloat16", m32.to(torch.bfloat16))):
        m_sq = (m.float() * m.float()).sum(-1)
        checks = {v: _select_check(q, m, m_sq, w, bin_size, block_n, v)
                  for v in ("mma", "simt")}
        auto_plan = _select_check(q, m, m_sq, w, bin_size, block_n,
                                  "auto")[0]
        plan, err, rel, row_mismatch = checks["mma"]
        ms, simt_ms, turns = _turns(lambda v: (
            lambda: distance_select(q, m, m_sq, w, bin_size, block_n,
                                    variant=v)))
        splits_ms = {}
        for p in (1, 2, 3, 4, 5, 6, 8):
            p_plan, _, p_rel, p_mism = _select_check(
                q, m, m_sq, w, bin_size, block_n, "mma", a_splits=p)
            require(p_rel <= 1e-3 and p_mism == 0,
                    f"distance_select[{dtype_name}, a_splits={p}]: rel err "
                    f"{p_rel}, {p_mism} rows differ")
            splits_ms[str(p_plan.a_splits)] = cuda_ms(
                lambda: distance_select(q, m, m_sq, w, bin_size, block_n,
                                        variant="mma", a_splits=p))
        plain_ms = cuda_ms(lambda: distance_select_plain(
            q, m, m_sq, w, bin_size, block_n), iters=10)
        library_ms = cuda_ms(lambda: _k2_library(q, m, m_sq, w_t, bin_size,
                                                 block_n), iters=10)
        C = -(-N // block_n) * (block_n // bin_size)
        nbytes = (S * N * d * m.element_size() + S * N * 4 + S * Q * d * 4
                  + Q * C * 8)
        bound_ms, bound_by = bound(nbytes, 2.0 * S * Q * N * d, dtype_name)
        rec = dict(name="distance_select", index_dtype=dtype_name,
                   shape=dict(S=S, Q=Q, N=N, d=d, bin=bin_size,
                              block_n=block_n),
                   variant=auto_plan.variant,
                   plan=dict(a_splits=plan.a_splits,
                             a_per_split=plan.a_per_split, grid=plan.grid,
                             smem_bytes=plan.smem_bytes),
                   max_abs_err=err, max_rel_err=rel,
                   max_abs_err_simt=checks["simt"][1], tol=1e-3,
                   row_mismatches_outside_ties=row_mismatch,
                   row_mismatches_simt=checks["simt"][3], ms=ms,
                   simt_ms=simt_ms, turns_ms=turns,
                   ms_by_a_splits=splits_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit({"phase": "kernel_distance_select", **rec})
        require(auto_plan.variant == "mma",
                f"distance_select[{dtype_name}]: the plan chose "
                f"{auto_plan.variant} ({auto_plan.reason})")
        for v, (_, _, v_rel, v_mism) in checks.items():
            require(v_rel <= 1e-3,
                    f"distance_select[{dtype_name}, {v}]: rel err {v_rel}")
            require(v_mism == 0, f"distance_select[{dtype_name}, {v}]: "
                    f"{v_mism} rows differ")
        recs.append(rec)
    results["distance_select"] = recs


def _device_profile(what: str, work, iters: int = 5):
    """One JSON line: device time by CUDA kernel name (torch.profiler) of
    ``work`` per iteration, their sum, the host wall time per iteration
    and the device's busy share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    work()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us:
            rows.append({"name": ev.key[:80], "calls": ev.count // iters,
                         "device_ms_per_iter": dev_us / iters / 1e3})
    rows.sort(key=lambda r: -r["device_ms_per_iter"])
    busy = sum(r["device_ms_per_iter"] for r in rows)
    emit({"phase": "profile", "what": what, "wall_ms_per_iter": wall_ms,
          "device_ms_per_iter": busy, "device_busy_share": busy / wall_ms,
          "kernels": rows[:12]})


def phase_profile(seed: int):
    """Where a batch's time goes, by CUDA kernel name: one flagship encode
    (K1a), one fused selection (K2) and the exact path's score GEMM +
    top-10 at the main path's shapes; one GRU encode (K3a); and one
    256-query batch at 2.1M rows through the exact full scan and the
    coarse retriever (blockmax, centroid; C=2048).  Not part of the
    default run (``--phases profile``)."""
    import torch

    from vfr_tpu_torch.eval.coarse import make_coarse_score_topk
    from vfr_tpu_torch.eval.corpus import make_score_topk
    from vfr_tpu_torch.ops.kernels.gru_kernel import gru_layer
    from vfr_tpu_torch.ops.kernels.lstm_kernel import lstm_layer
    from vfr_tpu_torch.ops.kernels.select_kernel import distance_select
    from vfr_tpu_torch.ops.lstm import init_gru_params, init_lstm_params
    from vfr_tpu_torch.ops.topk import top_k_select
    from vfr_tpu_torch.parallel.sharding import fused_corpus_scores

    B, T, E, H = 256, 24, 300, 1024
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((B, T, E)) / np.sqrt(E)).astype(
        np.float32)).to(dev)
    lengths = torch.from_numpy(
        rng.integers(1, T + 1, size=B).astype(np.int32)).to(dev)
    p = init_lstm_params(torch.Generator().manual_seed(seed), E, H,
                         device=dev)["layer0"]
    w_ih, w_hh = p["w_ih"].to(torch.bfloat16), p["w_hh"].to(torch.bfloat16)
    pg = init_gru_params(torch.Generator().manual_seed(seed), E, H,
                         device=dev)["layer0"]
    q = torch.randn(2, 256, 128, device=dev)
    m = torch.randn(2, 210_000, 128, device=dev).to(torch.bfloat16)
    m_sq = (m.float() ** 2).sum(-1)
    # the exact path's score + select stages on the flagship's f32 operands
    m_cat = torch.randn(210_000, 256, device=dev)
    msq_fused = (m_cat * m_cat).sum(-1)

    # the fused cell's index is f32; the bf16 build of K2 runs beside it
    m32 = torch.randn(2, 210_000, 128, device=dev)
    m32_sq = (m32 ** 2).sum(-1)

    def work():
        lstm_layer(x, lengths, w_ih, w_hh, p["b"], pool="mean")
        distance_select(q, m32, m32_sq, [0.5, 0.5])
        distance_select(q, m, m_sq, [0.5, 0.5])
        scores = fused_corpus_scores(q, m_cat, msq_fused, [0.5, 0.5],
                                     in_dtype=torch.float32)
        top_k_select(scores, 10)

    _device_profile("flagship_stages", work)
    del m, m_sq, m32, m32_sq, m_cat, msq_fused
    gw_ih, gw_hh = (pg["w_ih"].to(torch.bfloat16),
                    pg["w_hh"].to(torch.bfloat16))
    _device_profile("gru_pooled", lambda: gru_layer(
        x, lengths, gw_ih, gw_hh, pg["b_ih"], pg["b_hh"], pool="mean"))
    for variant in ("stepwise", "persistent"):
        _device_profile(f"lstm_pooled_{variant}", lambda: lstm_layer(
            x, lengths, w_ih, w_hh, p["b"], pool="mean", variant=variant))
    w = _coarse_2m_setup(seed, VIDEOS_2M)
    args = (w["params"], w["toks"], w["lens"])
    full = make_score_topk(w["model"], w["index"], w["k"],
                           w["cfg"].eval.topk_method)
    _device_profile("2m_full_scan", lambda: full(*args))
    del full
    for mode in ("blockmax", "centroid"):
        fn = make_coarse_score_topk(w["model"], w["coarse"], w["k"],
                                    num_candidates=2048, mode=mode)
        _device_profile(f"2m_coarse_{mode}_C2048", lambda: fn(*args))


# --------------------------------------------------------------- serving

def _count_dicts():
    from vfr_tpu_torch.ops.kernels import (
        coarse_kernel,
        gru_kernel,
        lstm_kernel,
        select_kernel,
    )

    return (lstm_kernel.LAUNCHES, gru_kernel.LAUNCHES, select_kernel.LAUNCHES,
            coarse_kernel.LAUNCHES)


def _variant_dicts():
    from vfr_tpu_torch.ops.kernels import (
        coarse_kernel,
        gru_kernel,
        lstm_kernel,
        select_kernel,
    )

    return {"lstm": lstm_kernel.VARIANT_LAUNCHES,
            "gru": gru_kernel.VARIANT_LAUNCHES,
            "select": select_kernel.VARIANT_LAUNCHES,
            "coarse": coarse_kernel.VARIANT_LAUNCHES}


def reset_counts():
    for counts in (*_count_dicts(), *_variant_dicts().values()):
        for k in counts:
            counts[k] = 0


def read_counts():
    """Launches by kernel since ``reset_counts``, and under "variants" the
    launches of each kernel family by kernel variant."""
    out = {}
    for counts in _count_dicts():
        out.update(counts)
    out["variants"] = {cell: dict(v) for cell, v in _variant_dicts().items()}
    return out


def require_persistent(counts, cell: str, what: str) -> None:
    v = counts["variants"][cell]
    require(v["persistent"] > 0 and v["stepwise"] == 0,
            f"{what}: the {cell} recurrence ran {v}, expected the "
            "persistent variant only")


def require_mma(counts, family: str, what: str) -> None:
    v = counts["variants"][family]
    require(v["mma"] > 0 and v["simt"] == 0,
            f"{what}: the {family} kernel ran {v}, expected the mma variant "
            "only")


def held_to(module, name: str, variant: str):
    """Context: ``module.name`` (a kernel wrapper looked up at call time by
    a retriever) held to one kernel variant, to time a cell on the earlier
    kernel and the new one in turns."""
    import functools
    from unittest import mock

    return mock.patch.object(
        module, name, functools.partial(getattr(module, name),
                                        variant=variant))


def cell_turns(module, name: str, fn):
    """ms of ``fn`` with the kernel held to simt, mma, mma, simt."""
    turns = []
    for variant in ("simt", "mma", "mma", "simt"):
        with held_to(module, name, variant):
            turns.append(time_batches(fn))
    return turns


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
    """(#rows differing outside near-ties, max |distance diff|).  A near-tie
    is a position whose plain distance lies within 2*tol of a neighbour's;
    at the last position the tie partner is the first row left out, so
    another row there at the plain distance (within tol) is one too."""
    diff = float(np.abs(d_k - d_p).max())
    mism = 0
    for dk, rk, dp, rp in zip(d_k.reshape(-1, d_k.shape[-1]),
                              r_k.reshape(-1, r_k.shape[-1]),
                              d_p.reshape(-1, d_p.shape[-1]),
                              r_p.reshape(-1, r_p.shape[-1])):
        for j in np.nonzero(rk != rp)[0]:
            near = [abs(dp[j] - dp[jj]) for jj in (j - 1, j + 1)
                    if 0 <= jj < len(dp)]
            if j == len(dp) - 1:
                near.append(2 * abs(dk[j] - dp[j]))
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
    from unittest import mock

    import torch

    from vfr_tpu_torch.eval import corpus as corpus_mod
    from vfr_tpu_torch.eval.corpus import (
        build_moment_index,
        load_index,
        make_retriever,
        make_stream_retriever,
        save_index,
        serve_queries,
    )
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import (
        init_model_params,
        prepare_query_params,
    )
    from vfr_tpu_torch.ops.kernels.select_kernel import distance_select_plain

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
    require_persistent(counts, "lstm", "flagship")
    bucketed = serve_queries(params, model, ds, vocab, queries,
                             length_buckets="auto", **kw)
    require(bucketed == exact, "flagship: bucketed results differ from "
            "unbucketed")

    toks, lens = encode(vocab, queries, batch, T)
    toks_d = torch.from_numpy(toks).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    q_params = prepare_query_params(params, model)  # as serve_queries does
    r_kernel = make_stream_retriever(model, loaded, k, "exact")
    r_plain = make_stream_retriever(model, loaded, k, "exact",
                                    rnn_kernel="plain")
    d_k, rows_k = (t.cpu().numpy()
                   for t in r_kernel(q_params, toks_d, lens_d))
    d_p, rows_p = (t.cpu().numpy()
                   for t in r_plain(q_params, toks_d, lens_d))
    mism, ddiff = compare_to_plain(d_k, rows_k, d_p, rows_p)
    ms_batch = time_batches(
        lambda: r_kernel(q_params, toks_d, lens_d)) / len(toks)
    plain_ms_batch = time_batches(
        lambda: r_plain(q_params, toks_d, lens_d)) / len(toks)
    topk = _topk_cost(model, loaded, q_params, toks_d[0], lens_d[0], k)
    first = exact[0]["results"]
    rec = dict(phase="flagship", videos=num_videos, rows=loaded.num_rows,
               queries=n_queries, batch=batch, k=k, launches=counts,
               setup_s=setup_s, index_build_s=build_s,
               serve_queries_s=serve_s, ms_per_batch=ms_batch,
               plain_ms_per_batch=plain_ms_batch, topk=topk,
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
    require_mma(counts, "select", "fused")
    r_fused = make_retriever(model, loaded, k, "fused")

    def fused_batches():
        return [r_fused(q_params, toks_d[b], lens_d[b])
                for b in range(len(toks))]

    fused_ms = time_batches(fused_batches) / len(toks)
    # the same retriever with K2's plain version, and on each kernel variant
    # in turns
    d_f, rows_f = (torch.stack(t).cpu().numpy()
                   for t in zip(*fused_batches()))
    with mock.patch.object(corpus_mod, "distance_select",
                           distance_select_plain):
        d_fp, rows_fp = (torch.stack(t).cpu().numpy()
                         for t in zip(*fused_batches()))
    f_mism, f_ddiff = compare_to_plain(d_f, rows_f, d_fp, rows_fp)
    turns = [t / len(toks) for t in cell_turns(corpus_mod, "distance_select",
                                               fused_batches)]
    rec = dict(phase="fused", launches=counts, recall_at_10_vs_exact=recall,
               ms_per_batch=fused_ms, variant="mma",
               ms_per_batch_simt_mma_mma_simt=turns,
               rows_differing_from_plain=f_mism,
               max_distance_diff_vs_plain=f_ddiff)
    emit(rec)
    require(recall >= 0.9, f"fused: recall@{k} vs exact {recall} < 0.9")
    require(f_mism == 0 and f_ddiff <= 1e-3,
            f"fused: K2 vs its plain version: {f_mism} rows differ, "
            f"max |d diff| {f_ddiff}")
    results["fused"] = rec
    return dict(cfg=cfg, params=params, q_params=q_params, model=model, ds=ds,
                vocab=vocab, index=loaded, queries=queries, toks=toks_d, lens=lens_d,
                exact_rows=rows_k, k=k, batch=batch, T=T)


def _topk_cost(model, index, params, toks, lens, k):
    """ms of the exact path's top-k on one batch's score matrix [Q, N]:
    the tie-ordered ``top_k_select`` against a bare ``torch.topk`` (which
    must select the same values), and how many rows tie at the k-th
    place (where the tie search runs)."""
    import torch

    from vfr_tpu_torch.eval.corpus import (
        _embed_query_streams,
        prep_score_operands,
    )
    from vfr_tpu_torch.ops.topk import top_k_select
    from vfr_tpu_torch.parallel.sharding import fused_corpus_scores

    m_cat, msq, in_dtype = prep_score_operands(index, model.compute_dtype)
    with torch.no_grad():
        qs = _embed_query_streams(params, model, toks, lens)
        scores = fused_corpus_scores(qs, m_cat, msq, index.weights,
                                     in_dtype=in_dtype)
    ordered = cuda_ms(lambda: top_k_select(scores, k))
    bare = cuda_ms(lambda: torch.topk(scores, k, dim=-1, sorted=True))
    same = torch.equal(top_k_select(scores, k)[0],
                       torch.topk(scores, k, dim=-1)[0])
    require(same, "tie-ordered top-k selected other values than torch.topk")
    top = torch.topk(scores, k + 1, dim=-1).values
    return dict(shape=list(scores.shape), k=k, tie_ordered_ms=ordered,
                torch_topk_ms=bare, extra_ms=ordered - bare,
                rows_with_tie_at_k=int((top[:, k] == top[:, k - 1]).sum()))


def _served_ok(out, n, k, what):
    first = out[0]["results"]
    require(len(out) == n and len(first) == k
            and all(np.isfinite(r["distance"]) for r in first)
            and all(a["distance"] <= b["distance"]
                    for a, b in zip(first, first[1:])),
            f"{what}: malformed results")


def _recall(rows, ref_rows):
    rows = rows.reshape(-1, rows.shape[-1])
    ref_rows = ref_rows.reshape(-1, ref_rows.shape[-1])
    k = ref_rows.shape[1]
    return float(np.mean([len(set(a[:k]) & set(b)) / k
                          for a, b in zip(rows, ref_rows)]))


def phase_coarse(results, ctx, workdir: str, d_coarse: int = 32,
                 C: int = 2048):
    """The coarse prefilter on the flagship index: build, save/load, serve
    with blockmax (K4) and centroid, blockmax against its plain stage 1."""
    from unittest import mock

    import torch

    from vfr_tpu_torch.eval import coarse as coarse_mod
    from vfr_tpu_torch.eval.corpus import serve_queries
    from vfr_tpu_torch.ops.kernels.coarse_kernel import coarse_blockmax_plain

    params, model, index, k = (ctx["params"], ctx["model"], ctx["index"],
                               ctx["k"])
    toks, lens, q_params = ctx["toks"], ctx["lens"], ctx["q_params"]
    t0 = time.perf_counter()
    coarse = coarse_mod.build_coarse_index(index, d_coarse=d_coarse)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    back = coarse_mod.load_coarse(coarse_mod.save_coarse(
        coarse, os.path.join(workdir, "flagship.coarse.npz")), index)

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    require(all(torch.equal(bits(getattr(back, f)), bits(getattr(coarse, f)))
                for f in ("proj", "m_low", "msq_low", "m_blk", "msq_blk",
                          "c_low", "csq", "perm")),
            "coarse save/load round trip is not bit-exact")
    kw = dict(k=k, batch_size=ctx["batch"], max_query_len=ctx["T"],
              index=index, coarse=coarse, coarse_candidates=C)
    rec = dict(phase="coarse", rows=index.num_rows, d_coarse=d_coarse,
               candidates=C, blocks=coarse.num_blocks, build_s=build_s,
               round_trip_bit_exact=True)
    outs = {}
    for mode in ("blockmax", "centroid"):
        reset_counts()
        out = serve_queries(params, model, ctx["ds"], ctx["vocab"],
                            ctx["queries"], coarse_mode=mode, **kw)
        counts = read_counts()
        _served_ok(out, len(ctx["queries"]), k, f"coarse[{mode}]")
        r = coarse_mod.make_coarse_stream_retriever(
            model, coarse, k, num_candidates=C, mode=mode)
        d_m, rows_m = (t.cpu().numpy() for t in r(q_params, toks, lens))
        outs[mode] = (d_m, rows_m)
        rec[mode] = dict(
            launches=counts,
            ms_per_batch=time_batches(lambda: r(q_params, toks, lens))
            / len(toks),
            recall_at_10_vs_exact=_recall(rows_m, ctx["exact_rows"]))
    # the same retriever with K4's plain version as its stage 1
    with mock.patch.object(coarse_mod, "coarse_blockmax",
                           coarse_blockmax_plain):
        r = coarse_mod.make_coarse_stream_retriever(
            model, coarse, k, num_candidates=C, mode="blockmax")
        d_p, rows_p = (t.cpu().numpy() for t in r(q_params, toks, lens))
        rec["blockmax"]["plain_ms_per_batch"] = time_batches(
            lambda: r(q_params, toks, lens)) / len(toks)
    mism, ddiff = compare_to_plain(*outs["blockmax"], d_p, rows_p)
    r = coarse_mod.make_coarse_stream_retriever(
        model, coarse, k, num_candidates=C, mode="blockmax")
    rec["blockmax"]["variant"] = "mma"
    rec["blockmax"]["ms_per_batch_simt_mma_mma_simt"] = [
        t / len(toks) for t in cell_turns(
            coarse_mod, "coarse_blockmax", lambda: r(q_params, toks, lens))]
    rec.update(rows_differing_from_plain=mism,
               max_distance_diff_vs_plain=ddiff)
    emit(rec)
    ctx["coarse"] = coarse
    require_mma(rec["blockmax"]["launches"], "coarse", "coarse[blockmax]")
    require(rec["blockmax"]["launches"]["coarse_blockmax"] > 0,
            "coarse: K4 (coarse_blockmax) never launched under blockmax")
    require(rec["centroid"]["launches"]["coarse_blockmax"] == 0,
            "coarse: K4 launched under centroid")
    require(rec["blockmax"]["launches"]["lstm_pooled"] > 0,
            "coarse: K1a never launched")
    require(mism == 0 and ddiff <= 1e-3,
            f"coarse: blockmax vs plain stage 1: {mism} rows differ, "
            f"max |d diff| {ddiff}")
    results["coarse"] = rec


# ------------------------------------------------------------------ eval

def eval_keys(ecfg):
    """The keys, in order, of the JAX package's ``evaluate`` dict for
    ``ecfg`` (eval/moment_eval.py builds them so)."""
    keys = [f"R@{k}_tiou{t}" for k in ecfg.recall_ks
            for t in ecfg.tiou_thresholds] + ["mIoU", "num_queries"]
    if ecfg.protocol == "didemo_official":
        keys += [f"R@{k}_official" for k in ecfg.recall_ks]
        keys.append("mIoU_official")
    return keys


def corpus_keys(ecfg, dataset):
    """The keys, in order, of the JAX package's ``corpus_evaluate`` dict
    (eval/corpus.py builds them so)."""
    keys = ["corpus_num_rows"]
    for k in ecfg.recall_ks:
        keys += [f"corpus_R@{k}_tiou{t}" for t in ecfg.tiou_thresholds]
        keys.append(f"corpus_video_R@{k}")
    keys.append("num_queries")
    if ecfg.protocol == "didemo_official" and hasattr(dataset,
                                                      "num_proposals"):
        keys += [f"corpus_R@{k}_official" for k in ecfg.recall_ks]
    return keys


def metrics_close(got, ref, what, tol=1e-3):
    """Kernel-path metrics held to their plain-version run: the same keys
    and counts, every rate within ``tol`` (0.1% of the queries)."""
    require(list(got) == list(ref), f"{what}: keys {list(got)} != "
            f"{list(ref)}")
    worst = 0.0
    for key, v in got.items():
        if key in ("num_queries", "corpus_num_rows"):
            require(v == ref[key], f"{what}: {key} {v} != {ref[key]}")
        else:
            worst = max(worst, abs(v - ref[key]))
    require(worst <= tol + 1e-12, f"{what}: metrics differ from the plain "
            f"version's by {worst} > {tol}")
    return worst


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class EvalRuns:
    """Runs of ``evaluate`` / ``corpus_evaluate`` on one corpus: seconds,
    queries/s, metrics and kernel launches (counts zeroed just before each
    run), optionally with kernel wrappers patched to their plain versions."""

    def __init__(self, n_queries: int):
        self.n = n_queries
        self.runs = {}

    def __call__(self, tag, fn, patches=()):
        import contextlib

        reset_counts()
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            metrics, secs = _timed(fn)
        counts = read_counts()
        launched = {k: v for k, v in counts.items() if k != "variants" and v}
        launched["variants"] = {
            fam: {v: c for v, c in by.items() if c}
            for fam, by in counts["variants"].items() if any(by.values())}
        self.runs[tag] = dict(seconds=secs, queries_per_s=self.n / secs,
                              metrics=metrics, launches=launched)
        return metrics, counts


def _plain_patches(kernels):
    """Patches that route the eval retrievers' kernel wrappers to their
    plain versions (the recurrence goes plain through rnn_kernel)."""
    from unittest import mock

    from vfr_tpu_torch.eval import coarse as coarse_mod
    from vfr_tpu_torch.eval import corpus as corpus_mod
    from vfr_tpu_torch.ops.kernels.coarse_kernel import coarse_blockmax_plain
    from vfr_tpu_torch.ops.kernels.select_kernel import distance_select_plain

    out = []
    if "distance_select" in kernels:
        out.append(mock.patch.object(corpus_mod, "distance_select",
                                     distance_select_plain))
    if "coarse_blockmax" in kernels:
        out.append(mock.patch.object(coarse_mod, "coarse_blockmax",
                                     coarse_blockmax_plain))
    return out


def phase_eval(results, ctx, d_coarse: int = 32, C: int = 2048):
    """Per-video and corpus eval of didemo_flagship on the flagship corpus
    (10,000 videos, 40,000 queries): both protocols on the preset's scan
    twin, then the kernel paths (K1a; K1a + K2 fused; K1a + K4 coarse) each
    held against the same run through the kernels' plain versions."""
    import torch

    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.eval.corpus import corpus_evaluate
    from vfr_tpu_torch.eval.moment_eval import evaluate

    cfg, params, model, ds = ctx["cfg"], ctx["params"], ctx["model"], \
        ctx["ds"]
    base = dataclasses.replace(cfg.eval, protocol="didemo_official")
    banks, banks_s = _timed(lambda: banks_to_device(
        ds.feature_banks(), base.bank_dtype, device=torch.device("cuda")))
    runs = EvalRuns(ds.num_queries)

    def ev(**kw):
        e = dataclasses.replace(base, **kw)
        return lambda: evaluate(params, model, ds, e, feature_banks=banks)

    def corpus(**kw):
        e = dataclasses.replace(base, **kw)
        return lambda: corpus_evaluate(params, model, ds, e,
                                       feature_banks=banks)

    thr, _ = runs("per_video_threshold_scan", ev(protocol="threshold"))
    off, _ = runs("per_video_official_scan", ev())
    require(list(thr) == eval_keys(dataclasses.replace(
        base, protocol="threshold")) and list(off) == eval_keys(base),
        f"eval: per-video keys {list(thr)} / {list(off)}")
    k_m, k_counts = runs("per_video_official_pallas", ev(rnn_kernel="pallas"))
    p_m, _ = runs("per_video_official_plain", ev(rnn_kernel="plain"))
    diffs = {"per_video": metrics_close(k_m, p_m, "eval[per-video]")}
    require(k_counts["lstm_pooled"] > 0,
            "eval[per-video]: K1a (lstm_pooled) never launched")
    variants = {"per_video_K1": k_counts["variants"]["lstm"]}

    ex, _ = runs("corpus_exact_scan", corpus())
    require(list(ex) == corpus_keys(base, ds),
            f"eval: corpus keys {list(ex)}")
    for tag, kw, kernels in (
            ("exact", {}, ()),
            ("fused", dict(topk_method="fused"), ("distance_select",)),
            ("coarse", dict(coarse_dim=d_coarse, coarse_candidates=C,
                            coarse_mode="blockmax"), ("coarse_blockmax",))):
        k_m, k_counts = runs(f"corpus_{tag}_pallas",
                             corpus(rnn_kernel="pallas", **kw))
        p_m, _ = runs(f"corpus_{tag}_plain", corpus(rnn_kernel="plain", **kw),
                      patches=_plain_patches(kernels))
        diffs[f"corpus_{tag}"] = metrics_close(k_m, p_m, f"eval[{tag}]")
        for name in ("lstm_pooled", *kernels):
            require(k_counts[name] > 0,
                    f"eval[corpus {tag}]: {name} never launched")
        variants[f"corpus_{tag}_K1"] = k_counts["variants"]["lstm"]
        if kernels == ("distance_select",):
            require_mma(k_counts, "select", "eval[fused]")
            variants["corpus_fused_K2"] = k_counts["variants"]["select"]
        if kernels == ("coarse_blockmax",):
            require_mma(k_counts, "coarse", "eval[coarse]")
            variants["corpus_coarse_K4"] = k_counts["variants"]["coarse"]
    _profile_eval_batches("eval", params, model, ds, ctx["index"], banks,
                          base)
    rec = dict(phase="eval", preset="didemo_flagship",
               videos=len(ds.video_ids), rows=ctx["index"].num_rows,
               queries=ds.num_queries, eval_batch=base.eval_batch_size,
               corpus_batch=base.corpus_query_batch, banks_s=banks_s,
               max_metric_diff_vs_plain=diffs, variants=variants,
               runs=runs.runs)
    emit(rec)
    results["eval"] = rec


def _profile_eval_batches(what, params, model, ds, index, banks, ecfg):
    """Device time by kernel name of one batch of each eval path with the
    kernels on: the per-video scorer (eval batch) and the corpus
    retriever + official GT ranker (corpus batch; for a dataset without GT
    proposal indices the retriever alone)."""
    import torch

    from vfr_tpu_torch.eval.corpus import make_gt_ranker, make_retriever
    from vfr_tpu_torch.eval.moment_eval import make_scorer
    from vfr_tpu_torch.models.mcn import prepare_query_params

    dev = torch.device("cuda")
    q_params = prepare_query_params(params, model, "pallas")
    scorer = make_scorer(model, banks, rnn_kernel="pallas")
    pb = next(ds.eval_batches(ecfg.eval_batch_size, with_features=False))
    _device_profile(f"{what}_per_video_batch", lambda: scorer(q_params, pb))
    b = next(ds.eval_batches(ecfg.corpus_query_batch, with_features=False))
    toks = torch.from_numpy(b["tokens"]).to(dev)
    lens = torch.from_numpy(b["lengths"]).to(dev)
    retrieve = make_retriever(model, index, 10, "exact", rnn_kernel="pallas")
    if "gt_prop_idx" in b:
        ranker = make_gt_ranker(model, index, "pallas")
        gt = torch.from_numpy((b["video_idx"][:, None] * ds.num_proposals
                               + np.maximum(b["gt_prop_idx"], 0)).astype(
                                   np.int64)).to(dev)
        _device_profile(f"{what}_corpus_exact_batch", lambda: (
            retrieve(q_params, toks, lens), ranker(q_params, toks, lens, gt)))
    else:
        _device_profile(f"{what}_corpus_exact_batch",
                        lambda: retrieve(q_params, toks, lens))


def make_charades_corpus(num_videos: int, seed: int):
    """(cfg, dataset, vocab, glove): charades_flagship over a synthetic
    Charades-STA corpus of ``num_videos`` videos with 2 planted moments and
    one query per moment."""
    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.data.charades import CharadesSTADataset
    from vfr_tpu_torch.data.synthetic import make_charades_fixture

    cfg = get_preset("charades_flagship")
    data = dataclasses.replace(cfg.data, synthetic_num_videos=num_videos,
                               synthetic_num_queries=2 * num_videos,
                               synthetic_moments_per_video=2,
                               synthetic_seed=seed)
    cfg = dataclasses.replace(cfg, data=data)
    fix = make_charades_fixture(
        num_videos=num_videos, num_queries=2 * num_videos,
        feature_dim=data.feature_dim, glove_dim=data.glove_dim,
        max_duration=data.max_duration, feature_seconds=data.feature_seconds,
        noise=data.synthetic_noise, with_flow=False,
        vocab_words=data.synthetic_vocab_words, moments_per_video=2,
        seed=seed)
    ds = CharadesSTADataset(fix.annotations, fix.rgb, None, fix.vocab, data)
    require(len(ds.video_ids) == num_videos,
            f"charades corpus has {len(ds.video_ids)} videos, wanted "
            f"{num_videos}")
    return cfg, ds, fix.vocab, fix.glove


def phase_eval_charades(results, seed: int, num_videos: int):
    """charades_flagship at full width (F=2048, H=1024, joint 128, one
    stream, cosine, last pool) on a synthetic corpus (T=40, W=64): per-video
    eval (scan; K1b held against plain), corpus eval exact and fused (K1b;
    K1b + K2 at S=1 over the 1e30 sentinel rows), each held against its
    plain-version run, max pooling (the direct form) with its peak memory;
    no invalid window may be retrieved.  K2 at this index's shape is timed
    against its plain version and a library formulation."""
    import torch

    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.eval.corpus import (
        _embed_query_streams,
        build_moment_index,
        corpus_evaluate,
        fused_bin_size,
        make_retriever,
    )
    from vfr_tpu_torch.eval.moment_eval import evaluate
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import (
        init_model_params,
        prepare_query_params,
    )
    from vfr_tpu_torch.ops.kernels import select_kernel

    dev = torch.device("cuda")
    (cfg, ds, _, glove), setup_s = _timed(
        lambda: make_charades_corpus(num_videos, seed))
    model = build_model(cfg, dataset=ds)
    params = init_model_params(torch.Generator().manual_seed(seed), model,
                               glove, cfg.data.feature_dim, device=dev)
    base = cfg.eval
    banks = banks_to_device({**ds.feature_banks(), "video_tef": ds.video_tef},
                            base.bank_dtype, device=dev)
    runs = EvalRuns(ds.num_queries)

    def ev(e_model=model, **kw):
        e = dataclasses.replace(base, **kw)
        return lambda: evaluate(params, e_model, ds, e, feature_banks=banks)

    def corpus(**kw):
        e = dataclasses.replace(base, **kw)
        return lambda: corpus_evaluate(params, model, ds, e,
                                       feature_banks=banks)

    torch.cuda.reset_peak_memory_stats()
    pv, _ = runs("per_video_scan", ev())
    mean_peak = torch.cuda.max_memory_allocated()
    require(list(pv) == eval_keys(base), f"eval_charades: keys {list(pv)}")
    k_m, k_counts = runs("per_video_pallas", ev(rnn_kernel="pallas"))
    p_m, _ = runs("per_video_plain", ev(rnn_kernel="plain"))
    diffs = {"per_video": metrics_close(k_m, p_m, "eval_charades[per-video]")}
    require(k_counts["lstm_hs"] > 0,
            "eval_charades[per-video]: K1b (lstm_hs) never launched")
    variants = {"per_video_K1": k_counts["variants"]["lstm"]}

    ex, _ = runs("corpus_exact_scan", corpus())
    require(list(ex) == corpus_keys(base, ds),
            f"eval_charades: corpus keys {list(ex)}")
    for tag, kw, kernels in (
            ("exact", {}, ()),
            ("fused", dict(topk_method="fused"), ("distance_select",))):
        k_m, k_counts = runs(f"corpus_{tag}_pallas",
                             corpus(rnn_kernel="pallas", **kw))
        p_m, _ = runs(f"corpus_{tag}_plain", corpus(rnn_kernel="plain", **kw),
                      patches=_plain_patches(kernels))
        diffs[f"corpus_{tag}"] = metrics_close(k_m, p_m,
                                               f"eval_charades[{tag}]")
        for name in ("lstm_hs", *kernels):
            require(k_counts[name] > 0,
                    f"eval_charades[corpus {tag}]: {name} never launched")
        variants[f"corpus_{tag}_K1"] = k_counts["variants"]["lstm"]
        if kernels:
            variants["corpus_fused_K2"] = k_counts["variants"]["select"]
            variants["corpus_fused_K2_plan"] = str(select_kernel.LAST_PLAN)

    # max pooling: the direct form over [B, W, T, F] chunks
    max_model = build_model(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, pooling="max")), dataset=ds)
    torch.cuda.reset_peak_memory_stats()
    mx, _ = runs("per_video_max_pool_scan", ev(e_model=max_model))
    max_peak = torch.cuda.max_memory_allocated()
    require(list(mx) == eval_keys(base) and all(
        np.isfinite(v) for v in mx.values()), f"eval_charades[max]: {mx}")

    # no invalid window is ever retrieved, through either retriever
    index = build_moment_index(params, model, ds, feature_banks=banks,
                               with_fingerprint=False)
    q_params = prepare_query_params(params, model, "pallas")
    valid = ds.window_mask.reshape(-1)
    k = min(max(max(base.recall_ks), 10), index.num_rows)
    retrieved_invalid = {}
    for method in ("exact", "fused"):
        r = make_retriever(model, index, k, method, rnn_kernel="pallas")
        bad = 0
        for b in ds.eval_batches(base.corpus_query_batch, with_features=False):
            d, rows = r(q_params, torch.from_numpy(b["tokens"]).to(dev),
                        torch.from_numpy(b["lengths"]).to(dev))
            rows = rows.cpu().numpy()[b["valid"]]
            bad += int((~valid[rows]).sum())
            require(bool((d < 1e29).all()), f"eval_charades[{method}]: "
                    "a sentinel distance was returned")
        retrieved_invalid[method] = bad
    require(not any(retrieved_invalid.values()),
            f"eval_charades: invalid windows retrieved {retrieved_invalid}")

    # K2 at the Charades index's shape: S=1, N=V*64 with 1e30 sentinel rows
    b = next(ds.eval_batches(base.corpus_query_batch, with_features=False))
    qs = _embed_query_streams(q_params, model,
                              torch.from_numpy(b["tokens"]).to(dev),
                              torch.from_numpy(b["lengths"]).to(dev),
                              "pallas")
    w = [float(x) for x in index.weights]
    bin_size, block_n = fused_bin_size(index.num_rows, k), 4096
    plan, err, rel, mism = _select_check(qs, index.m, index.m_sq, w,
                                         bin_size, block_n, "auto")
    S, Q, d = qs.shape
    N = index.num_rows
    C = -(-N // block_n) * (block_n // bin_size)
    bound_ms, bound_by = bound(S * N * d * 4 + S * N * 4 + S * Q * d * 4
                               + Q * C * 8, 2.0 * S * Q * N * d, "float32")
    k2 = dict(shape=dict(S=S, Q=Q, N=N, d=d, bin=bin_size, block_n=block_n,
                         sentinel_rows=int((~valid).sum())),
              variant=plan.variant, a_splits=plan.a_splits,
              max_abs_err=err, max_rel_err=rel,
              row_mismatches_outside_ties=mism,
              ms=cuda_ms(lambda: select_kernel.distance_select(
                  qs, index.m, index.m_sq, w, bin_size, block_n)),
              plain_ms=cuda_ms(lambda: select_kernel.distance_select_plain(
                  qs, index.m, index.m_sq, w, bin_size, block_n), iters=10),
              library_ms=cuda_ms(lambda: _k2_library(
                  qs, index.m, index.m_sq, torch.tensor(w, device=dev),
                  bin_size, block_n), iters=10),
              bound_ms=bound_ms, bound_by=bound_by)
    require(rel <= 1e-3 and mism == 0,
            f"eval_charades: K2 vs plain rel err {rel}, {mism} rows differ")
    _profile_eval_batches("eval_charades", params, model, ds, index, banks,
                          base)
    rec = dict(phase="eval_charades", preset="charades_flagship",
               videos=num_videos, rows=index.num_rows,
               valid_rows=int(valid.sum()), queries=ds.num_queries,
               eval_batch=base.eval_batch_size,
               corpus_batch=base.corpus_query_batch, setup_s=setup_s,
               max_metric_diff_vs_plain=diffs, variants=variants,
               invalid_windows_retrieved=retrieved_invalid,
               peak_memory_bytes=dict(mean_pool=mean_peak,
                                      max_pool=max_peak),
               kernel_distance_select_s1=k2, runs=runs.runs)
    emit(rec)
    results["eval_charades"] = rec


def _coarse_2m_setup(seed: int, num_videos: int, d_coarse: int = 32):
    """Seeded serving_10k weights, a bf16 index of ``num_videos`` x 21 rows
    (S=2, d=128) drawn on the card from a seeded normal (speed does not
    depend on the data), its coarse prefilter, and one 256-query batch of
    random tokens."""
    import torch

    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.eval.coarse import build_coarse_index
    from vfr_tpu_torch.eval.corpus import MomentIndex
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import (
        init_model_params,
        prepare_query_params,
    )

    dev = torch.device("cuda")
    cfg = get_preset("serving_10k")
    model = build_model(cfg)
    rng = np.random.default_rng(seed)
    vocab = 4096
    glove = rng.standard_normal((vocab, cfg.data.glove_dim)).astype(
        np.float32)
    params = prepare_query_params(
        init_model_params(torch.Generator().manual_seed(seed), model, glove,
                          cfg.data.feature_dim, device=dev), model)
    P, S, d = 21, len(model.streams), cfg.model.joint_dim
    N = num_videos * P
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn(S, N, d, generator=gen, device=dev).to(torch.bfloat16)
    index = MomentIndex(
        m=m, m_sq=(m.float() ** 2).sum(-1),
        video_row=np.repeat(np.arange(num_videos, dtype=np.int32), P),
        prop_idx=np.tile(np.arange(P, dtype=np.int32), num_videos),
        spans_sec=np.tile(np.stack([np.arange(P), np.arange(P) + 1],
                                   1).astype(np.float32), (num_videos, 1)),
        weights=np.asarray(cfg.model.stream_weights, np.float32))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    coarse = build_coarse_index(index, d_coarse=d_coarse)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    Q, T = cfg.eval.corpus_query_batch, cfg.data.max_query_len
    toks = torch.from_numpy(rng.integers(1, vocab, size=(Q, T)).astype(
        np.int32)).to(dev)
    lens = torch.from_numpy(rng.integers(4, T + 1, size=Q).astype(
        np.int32)).to(dev)
    return dict(cfg=cfg, model=model, params=params, index=index,
                coarse=coarse, toks=toks, lens=lens, k=cfg.eval.corpus_topk,
                setup_s=setup_s, build_s=build_s)


def phase_coarse_2m(results, seed: int, num_videos: int):
    """2.1M-row serving: exact full scan vs the coarse retriever."""
    import torch

    from vfr_tpu_torch.eval import coarse as coarse_mod
    from vfr_tpu_torch.eval.coarse import make_coarse_score_topk
    from vfr_tpu_torch.eval.corpus import make_score_topk

    w = _coarse_2m_setup(seed, num_videos)
    model, coarse, k = w["model"], w["coarse"], w["k"]
    args = (w["params"], w["toks"], w["lens"])
    Q, N = w["toks"].shape[0], w["index"].num_rows
    full = make_score_topk(model, w["index"], k, w["cfg"].eval.topk_method)
    _, rows_full = full(*args)
    rec = dict(phase="coarse_2m", rows=N, videos=num_videos,
               S=w["index"].m.shape[0], d=w["index"].m.shape[2],
               queries_per_batch=Q, k=k, d_coarse=coarse.d_coarse,
               blocks=coarse.num_blocks, setup_s=w["setup_s"],
               coarse_build_s=w["build_s"],
               full_scan_ms_per_batch=time_batches(lambda: full(*args)))
    rows_full = rows_full.cpu().numpy()
    del full
    rec["topk"] = _topk_cost(model, w["index"], *args, k)
    for mode in ("blockmax", "centroid"):
        for C in (1024, 2048):
            fn = make_coarse_score_topk(model, coarse, k, num_candidates=C,
                                        mode=mode)
            reset_counts()
            d_c, rows_c = fn(*args)
            counts = read_counts()
            require(bool(torch.isfinite(d_c).all())
                    and tuple(d_c.shape) == (Q, k)
                    and int(rows_c.max()) < N,
                    f"coarse_2m[{mode}, C={C}]: malformed results")
            rec[f"{mode}_C{C}"] = dict(
                launches=counts,
                ms_per_batch=time_batches(lambda: fn(*args)),
                recall_at_k_vs_full_scan=_recall(rows_c.cpu().numpy(),
                                                 rows_full))
            if mode == "blockmax":
                require(counts["coarse_blockmax"] > 0,
                        f"coarse_2m[C={C}]: K4 never launched")
                require_mma(counts, "coarse", f"coarse_2m[C={C}]")
                rec[f"{mode}_C{C}"].update(
                    variant="mma",
                    ms_per_batch_simt_mma_mma_simt=cell_turns(
                        coarse_mod, "coarse_blockmax", lambda: fn(*args)))
    emit(rec)
    results["coarse_2m"] = rec


def phase_gru(results, seed: int, num_videos: int):
    """didemo_flagship with the GRU query cell: mean pool (K3a) and last
    pool (K3b) served and held against the kernels' plain versions."""
    import torch

    from vfr_tpu_torch.eval.corpus import (
        build_moment_index,
        make_stream_retriever,
        serve_queries,
    )
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import (
        init_model_params,
        prepare_query_params,
    )

    dev = torch.device("cuda")
    cfg, ds, vocab, glove = make_corpus("didemo_flagship", num_videos,
                                        seed + 5)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rnn_cell="gru"))
    model = build_model(cfg)
    params = init_model_params(torch.Generator().manual_seed(seed + 5),
                               model, glove, cfg.data.feature_dim, device=dev)
    require(params["lstm"]["layer0"]["w_hh"].shape[1]
            == 3 * cfg.model.lstm_hidden, "gru: params are not a GRU's")
    q_params = prepare_query_params(params, model)
    T = cfg.data.max_query_len
    batch = cfg.eval.corpus_query_batch
    k = 10
    index = build_moment_index(params, model, ds,
                               index_dtype=cfg.eval.index_dtype,
                               with_fingerprint=False)
    queries = make_queries(vocab, 1024, T, seed + 13)
    toks, lens = encode(vocab, queries, batch, T)
    toks_d = torch.from_numpy(toks).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    rec = dict(phase="gru", videos=num_videos, rows=index.num_rows,
               queries=len(queries), k=k)
    for pool, kname in (("mean", "gru_pooled"), ("last", "gru_hs")):
        pool_model = build_model(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, query_pool=pool)))
        reset_counts()
        out = serve_queries(params, pool_model, ds, vocab, queries, k=k,
                            batch_size=batch, max_query_len=T, index=index)
        counts = read_counts()
        _served_ok(out, len(queries), k, f"gru[{pool}]")
        r_kernel = make_stream_retriever(pool_model, index, k, "exact")
        r_plain = make_stream_retriever(pool_model, index, k, "exact",
                                        rnn_kernel="plain")
        d_k, rows_k = (t.cpu().numpy() for t in r_kernel(q_params, toks_d,
                                                         lens_d))
        d_p, rows_p = (t.cpu().numpy() for t in r_plain(q_params, toks_d,
                                                        lens_d))
        mism, ddiff = compare_to_plain(d_k, rows_k, d_p, rows_p)
        rec[pool] = dict(
            launches=counts,
            ms_per_batch=time_batches(lambda: r_kernel(q_params, toks_d,
                                                       lens_d)) / len(toks),
            plain_ms_per_batch=time_batches(lambda: r_plain(
                q_params, toks_d, lens_d)) / len(toks),
            rows_differing_from_plain=mism, max_distance_diff_vs_plain=ddiff)
        require(counts[kname] > 0, f"gru[{pool}]: {kname} never launched "
                "on the serving path")
        require_persistent(counts, "gru", f"gru[{pool}]")
        require(mism == 0 and ddiff <= 1e-3,
                f"gru[{pool}]: kernel vs plain: {mism} rows differ, "
                f"max |d diff| {ddiff}")
    emit(rec)
    results["gru"] = rec


def phase_serving_10k(results, seed: int, num_videos: int):
    import torch

    from vfr_tpu_torch.eval.corpus import (
        build_moment_index,
        make_stream_retriever,
        serve_queries,
    )
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import (
        init_model_params,
        prepare_query_params,
    )

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
    q_params = prepare_query_params(params, model)
    queries = make_queries(vocab, 1024, T, seed + 11)
    reset_counts()
    out = serve_queries(params, model, ds, vocab, queries, k=k,
                        batch_size=batch, max_query_len=T,
                        topk_method=cfg.eval.topk_method, index=index)
    counts = read_counts()
    require(counts["lstm_hs"] > 0, "serving_10k: K1b (lstm_hs) never "
            "launched on the serving path")
    require_persistent(counts, "lstm", "serving_10k")
    toks, lens = encode(vocab, queries, batch, T)
    toks_d = torch.from_numpy(toks).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    r_kernel = make_stream_retriever(model, index, k, cfg.eval.topk_method)
    r_plain = make_stream_retriever(model, index, k, cfg.eval.topk_method,
                                    rnn_kernel="plain")
    d_k, rows_k = (t.cpu().numpy()
                   for t in r_kernel(q_params, toks_d, lens_d))
    d_p, rows_p = (t.cpu().numpy()
                   for t in r_plain(q_params, toks_d, lens_d))
    mism, ddiff = compare_to_plain(d_k, rows_k, d_p, rows_p)
    ms_batch = time_batches(
        lambda: r_kernel(q_params, toks_d, lens_d)) / len(toks)
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


# ----------------------------------------------------------------- train

def _memo_datasets():
    """``load_datasets`` memoized by DataConfig: the train phase's CLI runs
    build the synthetic corpus once, not once per run."""
    from vfr_tpu_torch.data.loaders import load_datasets

    cache = {}

    def load(dcfg):
        if dcfg not in cache:
            cache[dcfg] = load_datasets(dcfg)
        return cache[dcfg]
    return load


def _train_preset(nodata: str, seed: int, rnn_kernel: str = "scan"):
    """didemo_flagship unchanged but for the fixture's size, the epoch's
    length and the eval's recurrence (the CLI has no flag for these)."""
    from vfr_tpu_torch.config import get_preset

    cfg = get_preset("didemo_flagship")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, data_dir=nodata,
                                 synthetic_num_videos=VIDEOS_TRAIN,
                                 synthetic_num_queries=4 * VIDEOS_TRAIN,
                                 synthetic_seed=seed),
        train=dataclasses.replace(cfg.train,
                                  steps_per_epoch=TRAIN_STEPS_PER_EPOCH),
        eval=dataclasses.replace(cfg.eval, rnn_kernel=rnn_kernel))


def _cli(argv, preset, load):
    """Run ``vfr_tpu_torch.cli.main(argv)`` with ``get_preset`` returning
    ``preset`` and datasets memoized; the last printed line as a dict."""
    import ast
    import contextlib
    import io
    from unittest import mock

    import vfr_tpu_torch.checkpoint as ckpt_mod
    import vfr_tpu_torch.cli as cli_mod
    import vfr_tpu_torch.train.loop as loop_mod

    out = io.StringIO()
    with mock.patch.object(cli_mod, "get_preset", lambda name: preset), \
            mock.patch.object(ckpt_mod, "load_datasets", load), \
            mock.patch.object(loop_mod, "load_datasets", load), \
            contextlib.redirect_stdout(out):
        rc = cli_mod.main(argv)
    require(rc == 0, f"cli {argv[0]} exited {rc}")
    return ast.literal_eval(out.getvalue().strip().splitlines()[-1])


def _leaf_rel_errors(got, ref):
    """max |got - ref| / max |ref| for each leaf of two params trees."""
    from vfr_tpu_torch.utils.tree import flatten

    paths, a = flatten(got)
    _, b = flatten(ref)
    out = {}
    for p, x, y in zip(paths, a, b):
        if x is None:
            continue
        scale = float(y.abs().max())
        out["/".join(p)] = float((x - y).abs().max()) / max(scale, 1e-30)
    return out


def _bitwise_equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


def _step_split(model, tcfg, opt, params, opt_state, ema, batch, banks,
                iters: int = 10, warmup: int = 3):
    """Median ms by CUDA events of one train step's forward (loss), backward
    (autograd, the fused layers' BPTT), optimizer update and EMA."""
    import torch

    from vfr_tpu_torch.train.optim import apply_updates
    from vfr_tpu_torch.train.step import _ema_update, loss_from_batch
    from vfr_tpu_torch.utils.tree import flatten, unflatten

    split = {k: [] for k in ("forward", "backward", "optimizer", "ema",
                             "step")}
    for it in range(warmup + iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        paths, leaves = flatten(params)
        frozen = [p == ("embeddings",) for p in paths]
        req = [l if f else l.detach().requires_grad_(True)
               for l, f in zip(leaves, frozen)]
        ev[0].record()
        with torch.enable_grad():
            loss, _ = loss_from_batch(unflatten(paths, req), model, tcfg,
                                      batch, feature_banks=banks)
            ev[1].record()
            got = iter(torch.autograd.grad(
                loss, [r for r, f in zip(req, frozen) if not f]))
        ev[2].record()
        grads = unflatten(paths, [None if f else next(got) for f in frozen])
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        ev[3].record()
        ema = _ema_update(ema, params, tcfg.ema_decay)
        ev[4].record()
        torch.cuda.synchronize()
        if it >= warmup:
            for key, (a, b) in zip(("forward", "backward", "optimizer",
                                    "ema", "step"),
                                   ((0, 1), (1, 2), (2, 3), (3, 4), (0, 4))):
                split[key].append(ev[a].elapsed_time(ev[b]))
    return {k: float(np.median(v)) for k, v in split.items()}


def phase_train(results, seed: int, workdir: str):
    """``cli train`` of didemo_flagship at full width on a synthetic
    2,000-video fixture (4 epochs of 20 steps, B=128; mining from the
    preset's epoch 3, EMA 0.999), then ``cli corpus --checkpoint-dir`` on
    what it wrote, exact (K1a) and fused (K1a + K2), each held against the
    kernels' plain versions.  Checks: finite loss, an EMA tree that moved
    away from the raw params, a checkpoint that reloads bit for bit, and
    the fused layers' BPTT against autograd through the scan twin on one
    flagship batch (per leaf, relative to max |grad|).  Reports step ms
    (median of the chunks), the step split by CUDA events, the device's
    busy share of a step, mining refresh and eval seconds."""
    from unittest import mock

    import torch

    from vfr_tpu_torch.checkpoint import load_for_eval
    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.eval import corpus as corpus_mod
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.ops.kernels.select_kernel import distance_select_plain
    from vfr_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_payload,
        restore_checkpoint,
        restore_ema,
        save_checkpoint,
    )
    from vfr_tpu_torch.train.hard_negatives import mine_hard_negatives
    from vfr_tpu_torch.train.optim import make_optimizer
    from vfr_tpu_torch.train.step import _grads, make_train_multi_step
    from vfr_tpu_torch.utils.tree import flatten, tree_map

    dev = torch.device("cuda")
    nodata = os.path.join(workdir, "train_nodata")
    ck = os.path.join(workdir, "train_ck")
    load = _memo_datasets()
    preset = _train_preset(nodata, seed)
    bundle, setup_s = _timed(lambda: load(preset.data))
    common = ["--preset", "didemo_flagship", "--data-dir", nodata,
              "--checkpoint-dir", ck]
    epochs = TRAIN_EPOCHS
    import vfr_tpu_torch.train.loop as loop_mod

    fed = {"chunks": 0, "on_side_stream": 0}

    class CountingPrefetcher(loop_mod.Prefetcher):
        """The loop's prefetcher, counting the chunks it hands out."""

        def __iter__(self):
            for chunk in super().__iter__():
                fed["chunks"] += 1
                fed["on_side_stream"] += int(self._stream is not None)
                yield chunk

    with mock.patch.object(loop_mod, "Prefetcher", CountingPrefetcher):
        final, train_s = _timed(lambda: _cli(
            ["train", *common, "--epochs", str(epochs), "--steps-per-call",
             str(TRAIN_STEPS_PER_CALL)], preset, load))
    want_chunks = epochs * -(-TRAIN_STEPS_PER_EPOCH // TRAIN_STEPS_PER_CALL)
    require(fed["chunks"] == fed["on_side_stream"] == want_chunks,
            f"train: the prefetcher fed {fed} chunks, wanted {want_chunks} "
            "copied on its side stream")
    recs = [json.loads(line) for line in
            open(os.path.join(ck, "metrics.jsonl"), encoding="utf-8")]
    tr = [r for r in recs if r["tag"] == "train"]
    require(tr and all(np.isfinite(r["loss"]) for r in tr),
            "train: non-finite loss")
    mine = [r["refresh_s"] for r in recs if r["tag"] == "mine"]
    require(mine, "train: mining never ran")
    eval_s = [r["eval_s"] for r in recs if r["tag"] == "eval"]

    # the checkpoint: bit-exact reload, an EMA that is not the raw params
    ckpt = latest_checkpoint(ck)
    payload = load_payload(ckpt)
    step, params, opt_state, cfg_ck = restore_checkpoint(
        ckpt, payload=payload, device=dev)
    ema = restore_ema(ckpt, payload=payload, device=dev)
    again = save_checkpoint(os.path.join(workdir, "train_ck2"), step,
                            params, opt_state, cfg_ck, ema=ema)
    require(_bitwise_equal(payload, load_payload(again)),
            "train: the checkpoint does not reload bit for bit")
    served, model, _ = load_for_eval(dataclasses.replace(
        preset, train=dataclasses.replace(preset.train, checkpoint_dir=ck)),
        bundle=bundle, device=dev)
    _, e_leaves = flatten(ema)
    require(all(torch.equal(a, b) for a, b in
                zip(flatten(served)[1], e_leaves)),
            "train: load_for_eval does not serve the EMA tree")
    moved = [not torch.equal(a, b) for (p, a), b in
             zip(zip(*flatten(params)), e_leaves) if p != ("embeddings",)]
    require(all(moved), "train: the EMA tree equals the raw params")

    # one flagship batch (B=128, mined negatives): step split, busy share,
    # the fused BPTT against autograd through the scan twin
    tcfg = preset.train
    ds = bundle.train
    banks = banks_to_device(dict(ds.feature_banks()), preset.data.bank_dtype,
                            device=dev)
    mined, mine_s = _timed(lambda: mine_hard_negatives(
        params, model, ds, tcfg.hard_negative_count, feature_banks=banks))
    b = next(ds.train_batches(tcfg.batch_size, 1, seed=seed,
                              with_features=False))
    b["hard_neg_video"] = mined[0][b["query_idx"]]
    b["hard_neg_prop"] = mined[1][b["query_idx"]]
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
             b.items()}
    opt = make_optimizer(tcfg, TRAIN_STEPS_PER_EPOCH * epochs)
    split = _step_split(model, tcfg, opt, params, opt_state,
                        tree_map(torch.clone, ema), batch, banks)
    multi = make_train_multi_step(model, tcfg, opt, feature_banks=banks)
    chunk = {k: v[None] for k, v in batch.items()}
    state = {"p": params, "s": opt_state, "e": ema}

    def one_step():
        state["p"], state["s"], state["e"], _ = multi(
            state["p"], state["s"], chunk, state["e"])
    _device_profile("train_step_B128", one_step)
    # no host sync inside a chunk: any synchronising call raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one_step()
        sync_free = True
    except RuntimeError as e:
        sync_free = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(sync_free is True, f"train: a step synchronised with the host: "
            f"{sync_free}")
    scan_model = model._replace(cfg=dataclasses.replace(
        model.cfg, train_rnn_impl="scan"))
    _, g_fused = _grads(params, model, tcfg, batch, banks)
    _, g_scan = _grads(params, scan_model, tcfg, batch, banks)
    errs = _leaf_rel_errors(g_fused, g_scan)
    worst = max(errs.values())
    require(worst <= GRAD_TOL, f"train: fused BPTT gradients differ from "
            f"autograd through the scan twin by {worst} of max |grad| "
            f"(> {GRAD_TOL})")

    # cli corpus on the trained checkpoint: K1a (exact) and K1a + K2
    # (fused), each beside the same run through the plain versions
    runs = EvalRuns(bundle.val.num_queries)
    diffs = {}
    for method, kernels in (("exact", ("lstm_pooled",)),
                            ("fused", ("lstm_pooled", "distance_select"))):
        argv = ["corpus", *common, "--topk-method", method]
        k_m, k_counts = runs(f"corpus_{method}_pallas", lambda: _cli(
            argv, _train_preset(nodata, seed, "pallas"), load))
        patches = ([mock.patch.object(corpus_mod, "distance_select",
                                      distance_select_plain)]
                   if method == "fused" else [])
        p_m, _ = runs(f"corpus_{method}_plain", lambda: _cli(
            argv, _train_preset(nodata, seed, "plain"), load),
            patches=patches)
        diffs[method] = metrics_close(k_m, p_m, f"train[corpus {method}]")
        for name in kernels:
            require(k_counts[name] > 0,
                    f"train[corpus {method}]: {name} never launched")
        require_persistent(k_counts, "lstm", f"train[corpus {method}]")
        if method == "fused":
            require_mma(k_counts, "select", "train[corpus fused]")
    chunk_ms = [r["step_ms"] for r in tr]
    rec = dict(phase="train", preset="didemo_flagship",
               videos=VIDEOS_TRAIN, train_queries=ds.num_queries,
               val_queries=bundle.val.num_queries,
               batch=tcfg.batch_size, epochs=epochs,
               steps=step, steps_per_call=TRAIN_STEPS_PER_CALL,
               fixture_s=setup_s, train_cli_s=train_s,
               step_ms_median=float(np.median(chunk_ms)),
               step_ms_chunks=chunk_ms, step_split_ms=split,
               step_sync_free=sync_free, prefetched_chunks=fed["chunks"],
               mining_refresh_s=mine, mining_refresh_s_again=mine_s,
               eval_s=eval_s, final_metrics=final,
               final_loss=tr[-1]["loss"],
               grad_check=dict(tol=GRAD_TOL, worst=worst, per_leaf=errs),
               max_metric_diff_vs_plain=diffs, runs=runs.runs)
    emit(rec)
    results["train"] = rec


# ---------------------------------------------------------- follow, live

def _plain_everything():
    """Patches that send K1 (through ``cuda_lstm``), K2 and K4 to their
    plain versions wherever a serving path looks them up at call time."""
    import functools
    from unittest import mock

    from vfr_tpu_torch.ops.kernels import lstm_kernel

    return _plain_patches(("distance_select", "coarse_blockmax")) + [
        mock.patch.object(lstm_kernel, "cuda_lstm", functools.partial(
            lstm_kernel.cuda_lstm,
            layer_fn=lstm_kernel.lstm_recurrence_plain))]


def _drive_follow(serve, queries, isolated: bool, patches=()):
    """(records, stats, launches) of one ``serve(lines)`` run.  A request's
    ms runs from its line being read off the input to its record coming
    back; ``isolated`` sends each line only after the previous record came
    back (one request in flight).  Counts are zeroed just before the run
    and read just after."""
    import contextlib
    import threading

    import torch

    read_at, back = [], threading.Event()

    def lines():
        for j, text in enumerate(queries):
            if isolated and j:
                back.wait()
                back.clear()
            read_at.append(time.perf_counter())
            yield text

    recs, lat = [], []
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        first = None
        for rec in serve(lines()):
            now = time.perf_counter()
            lat.append((now - read_at[len(recs)]) * 1e3)
            recs.append(rec)
            first = now - t0 if first is None else first
            back.set()
        total = time.perf_counter() - t0
        counts = read_counts()
    # startup (index validation, the retriever) ends when the reader takes
    # the first line; the rate and the first result count from there
    start = read_at[0] - t0
    stats = dict(requests=len(recs), seconds=total, startup_ms=start * 1e3,
                 requests_per_s=len(recs) / (total - start),
                 first_result_ms=(first - start) * 1e3,
                 p50_ms=float(np.percentile(lat, 50)),
                 p95_ms=float(np.percentile(lat, 95)))
    return recs, stats, counts


def compare_records(got, ref, tol=1e-3):
    """``compare_to_plain`` over result records: moments (video, start,
    end) in place of rows."""
    keys = {}

    def arrays(recs):
        d = np.array([[r["distance"] for r in q["results"]] for q in recs])
        m = np.array([[keys.setdefault((r["video"], r["start"], r["end"]),
                                       len(keys))
                       for r in q["results"]] for q in recs])
        return d, m

    require([r["query"] for r in got] == [r["query"] for r in ref],
            "records out of order")
    (d_k, m_k), (d_p, m_p) = arrays(got), arrays(ref)
    return compare_to_plain(d_k, m_k, d_p, m_p, tol)


def _k2_at(q, index, k, what):
    """K2 at the follow path's shape (one pack of queries over the flagship
    index): max |err| vs its plain version, ms, plain ms, library ms and
    the bound, from this run's inputs."""
    import torch

    from vfr_tpu_torch.eval.corpus import fused_bin_size
    from vfr_tpu_torch.ops.kernels.select_kernel import (
        distance_select,
        distance_select_plain,
    )

    m, m_sq = index.m, index.m_sq
    w = [float(x) for x in index.weights]
    S, Q, d = q.shape
    N = m.shape[1]
    bin_size, block_n = fused_bin_size(N, k), 4096
    plan, err, rel, mism = _select_check(q, m, m_sq, w, bin_size, block_n,
                                         "auto")
    require(rel <= 1e-3 and mism == 0,
            f"{what}: K2 at Q={Q} vs plain: rel {rel}, {mism} rows differ")
    C = -(-N // block_n) * (block_n // bin_size)
    nbytes = (S * N * d * m.element_size() + S * N * 4 + S * Q * d * 4
              + Q * C * 8)
    bound_ms, bound_by = bound(nbytes, 2.0 * S * Q * N * d,
                               str(m.dtype).split(".")[-1])
    w_t = torch.tensor(w, device=q.device)
    return dict(shape=dict(S=S, Q=Q, N=N, d=d, bin=bin_size),
                variant=plan.variant, max_abs_err=err, max_rel_err=rel,
                ms=cuda_ms(lambda: distance_select(q, m, m_sq, w, bin_size,
                                                   block_n)),
                plain_ms=cuda_ms(lambda: distance_select_plain(
                    q, m, m_sq, w, bin_size, block_n), iters=10),
                library_ms=cuda_ms(lambda: _k2_library(
                    q, m, m_sq, w_t, bin_size, block_n), iters=10),
                bound_ms=bound_ms, bound_by=bound_by)


def phase_follow(results, ctx, workdir: str, d_coarse: int = 32,
                 C: int = 2048):
    """Daemon serving (``serve_follow``) on the flagship index: isolated
    requests and a backlog at micro-batch 8 (depth 1 and 2) and 64 (depth
    1), exact (K1a) and fused (K1a, K2), and coarse blockmax (K1a, K4)
    once; each run beside the same run through the kernels' plain
    versions, its records held to ``serve_queries``' for the same queries.
    Then one ``cli serve --follow`` subprocess on stdin."""
    import torch

    from vfr_tpu_torch.eval.coarse import build_coarse_index
    from vfr_tpu_torch.eval.corpus import serve_follow, serve_queries

    params, model, ds, vocab = (ctx["params"], ctx["model"], ctx["ds"],
                                ctx["vocab"])
    index, k, T = ctx["index"], ctx["k"], ctx["T"]
    queries = ctx["queries"][:FOLLOW_REQUESTS]
    coarse = ctx.get("coarse")
    if coarse is None:
        coarse = build_coarse_index(index, d_coarse=d_coarse)
    modes = {"exact": {}, "fused": {"topk_method": "fused"},
             "coarse": {"coarse": coarse, "coarse_candidates": C}}
    kernels = {"exact": ("lstm_pooled",),
               "fused": ("lstm_pooled", "distance_select"),
               "coarse": ("lstm_pooled", "coarse_blockmax")}
    refs = {mode: serve_queries(params, model, ds, vocab, queries, k=k,
                                batch_size=ctx["batch"], max_query_len=T,
                                index=index, **kw)
            for mode, kw in modes.items()}
    plan = [(mode, run, mb, depth)
            for mode in ("exact", "fused")
            for run, mb, depth in (("isolated", 8, 1), ("mb8_depth1", 8, 1),
                                   ("mb8_depth2", 8, 2),
                                   ("mb64_depth1", 64, 1))]
    plan.append(("coarse", "mb8_depth2", 8, 2))
    runs = {}
    for mode, run, mb, depth in plan:
        iso = run == "isolated"
        qs = queries[:FOLLOW_ISOLATED] if iso else queries

        def serve(lines, mb=mb, depth=depth, kw=modes[mode]):
            return serve_follow(params, model, ds, vocab, lines, k=k,
                                max_query_len=T, index=index,
                                micro_batch=mb, pipeline_depth=depth, **kw)

        list(serve(iter(qs[:mb])))                   # warm the pack shape
        recs, stats, counts = _drive_follow(serve, qs, iso)
        p_recs, p_stats, _ = _drive_follow(serve, qs, iso,
                                           _plain_everything())
        tag = f"{mode}_{run}"
        _served_ok(recs, len(qs), k, f"follow[{tag}]")
        mism, ddiff = compare_records(recs, refs[mode][:len(qs)])
        p_mism, p_ddiff = compare_records(recs, p_recs)
        runs[tag] = dict(micro_batch=mb, pipeline_depth=depth, **stats,
                         plain=p_stats, launches=counts,
                         rows_differing_from_serve_queries=mism,
                         max_distance_diff_vs_serve_queries=ddiff,
                         rows_differing_from_plain=p_mism,
                         max_distance_diff_vs_plain=p_ddiff)
        for name in kernels[mode]:
            require(counts[name] > 0,
                    f"follow[{tag}]: {name} never launched")
        require(mism == 0 and ddiff <= 1e-3,
                f"follow[{tag}]: vs serve_queries: {mism} moments differ, "
                f"max |d diff| {ddiff}")
        require(p_mism == 0 and p_ddiff <= 1e-3,
                f"follow[{tag}]: vs plain: {p_mism} moments differ, "
                f"max |d diff| {p_ddiff}")
    # pipeline depth 1 against 2 at micro-batch 8, in turns in this call
    # (the host's speed moves between calls): requests/s of the backlog
    turns = {}
    for mode in ("exact", "fused"):
        order = (1, 2, 2, 1) * 2
        rates = []
        for depth in order:
            _, stats, _ = _drive_follow(
                lambda lines, depth=depth, kw=modes[mode]: serve_follow(
                    params, model, ds, vocab, lines, k=k, max_query_len=T,
                    index=index, micro_batch=8, pipeline_depth=depth, **kw),
                queries, False)
            rates.append(stats["requests_per_s"])
        turns[mode] = dict(depths=list(order), requests_per_s=rates)
    # host syncs of one pack's dispatch + fetch, by mode (the exact top-k
    # of a row longer than ops.topk.KEY_MAX syncs once, by design)
    syncs = {f"{mode}_{n // 8}_packs": _sync_warnings(
        lambda kw=kw, n=n: list(serve_follow(
            params, model, ds, vocab, queries[:n], k=k, max_query_len=T,
            index=index, micro_batch=8, pipeline_depth=2, **kw)))
        for mode, kw in modes.items() for n in (8, 16)}
    # K2 at one pack of 8 queries, as the fused follow path runs it
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q8 = torch.randn(2, 8, index.m.shape[-1], device="cuda", generator=gen)
    q8 = q8 / (q8.norm(dim=-1, keepdim=True) + 1e-8)
    k2_q8 = _k2_at(q8, index, k, "follow")
    # the CLI: one subprocess, queries on stdin
    cli_q = "\n".join(queries[:FOLLOW_CLI]) + "\n"
    out, cli_s = _cli_subprocess(
        ["serve", "--preset", "didemo_flagship", "--data-dir",
         os.path.join(workdir, "follow_nodata"), "--queries", "-",
         "--follow", "--topk", str(k)], cli_q)
    cli_recs = [json.loads(line) for line in out.splitlines()
                if line.startswith("{")]
    _served_ok(cli_recs, FOLLOW_CLI, k, "follow[cli]")
    require([r["query"] for r in cli_recs] == queries[:FOLLOW_CLI],
            "follow[cli]: records out of order")
    rec = dict(phase="follow", rows=index.num_rows, k=k,
               requests=FOLLOW_REQUESTS, isolated_requests=FOLLOW_ISOLATED,
               runs=runs, depth_turns_mb8=turns, host_syncs_per_pack=syncs,
               kernel_distance_select_q8=k2_q8,
               cli=dict(requests=FOLLOW_CLI, seconds=cli_s))
    emit(rec)
    results["follow"] = rec


def _sync_warnings(fn) -> dict:
    """Host syncs torch reports (``set_sync_debug_mode("warn")``) while
    ``fn`` runs, by the Python line that made each."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)))


def _cli_subprocess(argv, stdin_text: str, timeout: int = 300):
    """(stdout, seconds) of ``python -m vfr_tpu_torch.cli <argv>`` run from
    the checkout with ``stdin_text`` on its standard input."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "vfr_tpu_torch.cli", *argv],
                       input=stdin_text, capture_output=True, text=True,
                       timeout=timeout, cwd=os.path.dirname(
                           os.path.abspath(__file__)))
    require(r.returncode == 0, f"cli {' '.join(argv[:2])} exited "
            f"{r.returncode}: {r.stderr[-2000:]}")
    return r.stdout, time.perf_counter() - t0


def _moment_keys(order, ids, video_row, prop_idx, rows):
    """Rows -> ints naming (video, proposal), by the global ``order`` of
    video ids, so two indexes' results compare by moment."""
    return np.vectorize(lambda r: order[ids[video_row[r]]] * 1000
                        + int(prop_idx[r]))(rows)


def _records(texts, d, rows, ids, video_row, spans):
    """``serve_follow``'s result records of ``rows`` over the tables
    (ids, video_row, spans) of an index or arena."""
    return [{"query": text, "results": [
        {"video": ids[int(video_row[r])], "start": float(spans[r, 0]),
         "end": float(spans[r, 1]), "distance": float(d[i, j])}
        for j, r in enumerate(rows[i])]} for i, text in enumerate(texts)]


def _add_counts(total, counts):
    """Add ``read_counts()`` to ``total`` in place."""
    for name, v in counts.items():
        if name != "variants":
            total[name] = total.get(name, 0) + v
            continue
        for fam, by in v.items():
            f = total.setdefault("variants", {}).setdefault(fam, {})
            for var, c in by.items():
                f[var] = f.get(var, 0) + c


def phase_live(results, seed: int, workdir: str):
    """The live index of preset ``serving_10k`` (bf16 index, last pool,
    top-100): 10,000 videos in a 20,000-video arena (420,000 rows), 4
    appends of 128 videos, a removal of 500, compact, grow to 25,000,
    save -> load; after each, the live retriever at packs of 8 and 256
    held to itself through K1b's plain version and to a from-scratch
    ``build_moment_index`` + ``make_retriever`` through the plain version
    over the same corpus.  Then ``serve_follow`` over that arena (packs of
    8, depth 2) with queries between ``!add``, ``!remove`` and
    ``!compact``, each run of queries held to a shadow arena taken
    through the same operations and to a rebuild at the same point.
    Launch counts are zeroed just before each live retrieval and each
    daemon run and read just after; the references run outside those
    windows.  Then one ``cli serve --follow --live-capacity-videos``
    subprocess and a second booted from its ``!save``
    (``--live-arena``)."""
    import types

    import torch

    from vfr_tpu_torch.eval import live as L
    from vfr_tpu_torch.eval.corpus import (
        build_moment_index,
        make_retriever,
        serve_follow,
    )
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import (
        init_model_params,
        prepare_query_params,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, ds, vocab, glove = make_corpus("serving_10k", LIVE_VIDEOS, seed + 3)
    n_new = LIVE_APPENDS * LIVE_DELTA
    _, dds, _, _ = make_corpus("serving_10k", n_new, seed + 29)
    new_ids = [f"new{v}" for v in dds.video_ids]
    _, fds, _, _ = make_corpus("serving_10k", LIVE_FOLLOW_ADD, seed + 41)
    add_ids = [f"live{v}" for v in fds.video_ids]
    setup_s = time.perf_counter() - t0
    model = build_model(cfg)
    params = init_model_params(torch.Generator().manual_seed(seed + 3),
                               model, glove, cfg.data.feature_dim, device=dev)
    q_params = prepare_query_params(params, model)
    T, k = cfg.data.max_query_len, cfg.eval.corpus_topk
    method, idx_dtype = cfg.eval.topk_method, cfg.eval.index_dtype
    toks, lens = encode(vocab, make_queries(vocab, 256, T, seed + 13), 256, T)
    toks = torch.from_numpy(toks[0]).to(dev)
    lens = torch.from_numpy(lens[0]).to(dev)
    feats = {v: (ds.rgb_feats[i], ds.flow_feats[i])
             for i, v in enumerate(ds.video_ids)}
    for ids, src in ((new_ids, dds), (add_ids, fds)):
        feats.update({v: (src.rgb_feats[i], src.flow_feats[i])
                      for i, v in enumerate(ids)})
    order = {v: i for i, v in enumerate(feats)}
    launches = {}        # the live path's launches, counted windows only

    def counted(fn):
        """(fn(), its launches): counts zeroed just before, read just
        after, and added to ``launches``."""
        reset_counts()
        out = fn()
        counts = read_counts()
        _add_counts(launches, counts)
        return out, counts

    def rebuild(alive):
        """A from-scratch index over ``alive`` and its retriever through
        K1b's plain version."""
        corpus = types.SimpleNamespace(
            video_ids=alive,
            rgb_feats=np.stack([feats[v][0] for v in alive]),
            flow_feats=np.stack([feats[v][1] for v in alive]),
            num_proposals=ds.num_proposals, span_seconds=ds.span_seconds)
        ref = build_moment_index(params, model, corpus, index_dtype=idx_dtype,
                                 with_fingerprint=False)
        return ref, make_retriever(model, ref, k, topk_method=method,
                                   rnn_kernel="plain")

    def host(pair):
        return tuple(t.cpu().numpy() for t in pair)

    live, build_s = _timed(lambda: L.make_live_index(
        params, model, ds, capacity_videos=LIVE_CAPACITY,
        index_dtype=idx_dtype))
    retrieve = L.make_live_retriever(model, live, k, topk_method=method)
    ptr = live.m_cat.data_ptr()
    timings, checks = {}, {}

    held = list(ds.video_ids)          # the corpus the arena should hold

    def check(label):
        """Live retrieval (counted) at a pack of 8 and a batch of 256, vs
        the live retriever through K1b's plain version and vs a rebuild
        over ``held``; retrieve ms of both."""
        alive = list(held)
        ref, ref_fn = rebuild(alive)
        d_r, r_r = host(ref_fn(q_params, toks, lens))
        key_r = _moment_keys(order, alive, ref.video_row, ref.prop_idx, r_r)
        del ref, ref_fn
        plain = L.make_live_retriever(model, live, k, topk_method=method,
                                      rnn_kernel="plain")
        rec = dict(videos=len(alive))
        for Q in (8, 256):
            tq, lq = toks[:Q], lens[:Q]
            (d_l, r_l), _ = counted(lambda: host(retrieve(q_params, tq, lq)))
            d_p, r_p = host(plain(q_params, tq, lq))
            p_mism, p_ddiff = compare_to_plain(d_l, r_l, d_p, r_p)
            key_l = _moment_keys(order, live.video_ids, live.video_row,
                                 live.prop_idx, r_l)
            mism, ddiff = compare_to_plain(d_l, key_l, d_r[:Q], key_r[:Q])
            rec[f"q{Q}"] = dict(
                rows_differing_from_plain=p_mism,
                max_distance_diff_vs_plain=p_ddiff,
                rows_differing_from_rebuild=mism,
                max_distance_diff_vs_rebuild=ddiff,
                retrieve_ms=time_batches(lambda: retrieve(q_params, tq, lq)))
            require(p_mism == 0 and p_ddiff <= 1e-3,
                    f"live[{label}] Q={Q}: vs plain K1b: {p_mism} rows "
                    f"differ, max |d diff| {p_ddiff}")
            require(mism == 0 and ddiff <= 1e-3,
                    f"live[{label}] Q={Q}: vs rebuild: {mism} moments "
                    f"differ, max |d diff| {ddiff}")
        checks[label] = rec

    check("build")
    appends = []
    for a in range(LIVE_APPENDS):
        lo = a * LIVE_DELTA
        ids = new_ids[lo:lo + LIVE_DELTA]
        n, secs = _timed(lambda: L.live_append(
            live, params, model, ds, ids, dds.rgb_feats[lo:lo + LIVE_DELTA],
            dds.flow_feats[lo:lo + LIVE_DELTA]))
        require(n == LIVE_DELTA * ds.num_proposals, "live: append rows")
        held.extend(ids)
        appends.append(secs)
        check(f"append{a}")
    rng = np.random.default_rng(seed + 5)
    gone = [str(v) for v in rng.choice(live.video_ids, LIVE_REMOVE,
                                       replace=False)]
    n_rm, timings["remove_s"] = _timed(lambda: L.live_remove(live, gone))
    held = [v for v in held if v not in set(gone)]
    check("remove")
    n_cp, timings["compact_s"] = _timed(lambda: L.live_compact(live))
    require(n_rm == n_cp == LIVE_REMOVE * ds.num_proposals,
            f"live: removed {n_rm}, reclaimed {n_cp} rows")
    check("compact")
    in_place = live.m_cat.data_ptr() == ptr
    require(in_place, "live: append / remove / compact reallocated the arena")
    _, timings["grow_s"] = _timed(lambda: L.live_grow(live, LIVE_GROW))
    require(live.capacity == LIVE_GROW * ds.num_proposals
            and live.m_cat.data_ptr() != ptr, "live: grow")
    check("grow")
    path = os.path.join(workdir, "live_arena.npz")
    _, timings["save_s"] = _timed(lambda: L.save_arena(live, path,
                                                       params=params,
                                                       model=model))
    back, timings["load_s"] = _timed(lambda: L.load_arena(
        path, params=params, model=model))
    require(torch.equal(back.m_cat, live.m_cat)
            and torch.equal(back.msq_fused, live.msq_fused)
            and back.video_ids == live.video_ids
            and all(np.array_equal(getattr(back, f), getattr(live, f))
                    for f in ("video_row", "prop_idx", "spans_sec")),
            "live: save_arena -> load_arena is not bit-exact")
    live, retrieve = back, L.make_live_retriever(model, back, k,
                                                 topk_method=method)
    check("reload")
    arena_bytes = live.m_cat.numel() * 4 + live.msq_fused.numel() * 4
    bf16_bytes = live.m_cat.numel() * 2 + live.msq_fused.numel() * 4

    # the daemon over this arena: queries between !add, !remove, !compact
    delta = os.path.join(workdir, "live_follow_delta.npz")
    np.savez(delta, video_ids=np.asarray(add_ids), rgb=fds.rgb_feats,
             flow=fds.flow_feats)
    drop = [str(v) for v in rng.choice(held, LIVE_FOLLOW_REMOVE - 8,
                                       replace=False)] + add_ids[:8]
    segments = [make_queries(vocab, LIVE_FOLLOW_SEGMENT, T, seed + 43 + s)
                for s in range(4)]
    ops = [f"!add {delta}", "!remove " + " ".join(drop), "!compact"]
    script = segments[0]
    for op, seg in zip(ops, segments[1:]):
        script = script + [op] + seg
    shadow = L.load_arena(path, params=params, model=model)
    ptr = live.m_cat.data_ptr()
    (recs, daemon_s), daemon_counts = counted(lambda: _timed(lambda: list(
        serve_follow(params, model, ds, vocab, iter(script), k=k,
                     max_query_len=T, topk_method=method, live=live,
                     micro_batch=8, pipeline_depth=2))))
    require(live.m_cat.data_ptr() == ptr,
            "live[follow]: !add / !remove / !compact reallocated the arena")
    require(daemon_counts["lstm_hs"] > 0,
            "live[follow]: K1b (lstm_hs) never launched")
    acks = [r for r in recs if "command" in r]
    answered = [r for r in recs if "query" in r]
    require(len(acks) == 3 and len(answered) == 4 * LIVE_FOLLOW_SEGMENT
            and acks[0].get("added_rows") == LIVE_FOLLOW_ADD
            * ds.num_proposals
            and acks[1].get("removed_rows") == LIVE_FOLLOW_REMOVE
            * ds.num_proposals
            and acks[2].get("reclaimed_rows") == LIVE_FOLLOW_REMOVE
            * ds.num_proposals,
            f"live[follow]: control records {acks}")
    _served_ok(answered, len(answered), k, "live[follow]")
    shadow_fn = L.make_live_retriever(model, shadow, k, topk_method=method,
                                      rnn_kernel="plain")
    follow_checks = []
    for s, texts in enumerate(segments):
        if s == 1:
            L.live_append(shadow, params, model, ds, add_ids, fds.rgb_feats,
                          fds.flow_feats)
            held.extend(add_ids)
        elif s == 2:
            L.live_remove(shadow, drop)
            held = [v for v in held if v not in set(drop)]
        elif s == 3:
            L.live_compact(shadow)
        t_s, l_s = encode(vocab, texts, len(texts), T)
        t_s = torch.from_numpy(t_s[0]).to(dev)
        l_s = torch.from_numpy(l_s[0]).to(dev)
        d_a, r_a = host(shadow_fn(q_params, t_s, l_s))
        ref, ref_fn = rebuild(list(held))
        d_b, r_b = host(ref_fn(q_params, t_s, l_s))
        got = answered[s * LIVE_FOLLOW_SEGMENT:(s + 1) * LIVE_FOLLOW_SEGMENT]
        a_mism, a_ddiff = compare_records(got, _records(
            texts, d_a, r_a, shadow.video_ids, shadow.video_row,
            shadow.spans_sec))
        b_mism, b_ddiff = compare_records(got, _records(
            texts, d_b, r_b, list(held), ref.video_row, ref.spans_sec))
        del ref, ref_fn
        follow_checks.append(dict(
            videos=len(held), rows_differing_from_shadow_arena=a_mism,
            max_distance_diff_vs_shadow_arena=a_ddiff,
            rows_differing_from_rebuild=b_mism,
            max_distance_diff_vs_rebuild=b_ddiff))
        require(a_mism == 0 and a_ddiff <= 1e-3 and b_mism == 0
                and b_ddiff <= 1e-3,
                f"live[follow] segment {s}: {follow_checks[-1]}")
    del shadow
    require(launches["lstm_hs"] > 0, "live: K1b (lstm_hs) never launched")
    cli = _live_cli(workdir)
    rec = dict(phase="live", preset="serving_10k", videos=LIVE_VIDEOS,
               capacity_videos=LIVE_CAPACITY, grown_to=LIVE_GROW, k=k,
               setup_s=setup_s, arena_build_s=build_s,
               append_s=appends, append_first_s=appends[0],
               append_steady_s=float(np.median(appends[1:])),
               **timings, arena_in_place=in_place, reload_bit_exact=True,
               arena_bytes=arena_bytes, arena_bytes_bf16_carrier=bf16_bytes,
               launches=launches, checks=checks,
               follow=dict(micro_batch=8, pipeline_depth=2,
                           requests=len(answered), controls=len(acks),
                           seconds=daemon_s,
                           requests_per_s=len(answered) / daemon_s,
                           launches=daemon_counts, segments=follow_checks),
               cli=cli)
    emit(rec)
    results["live"] = rec


def _live_cli(workdir: str):
    """``cli serve --follow --live-capacity-videos`` on the synthetic
    didemo_flagship fixture (64 videos): queries, !add, a duplicate !add,
    !remove, !stats, !compact, !grow, !save; then a second process booted
    from the snapshot with ``--live-arena``."""
    from vfr_tpu_torch.config import get_preset

    data = get_preset("didemo_flagship").data
    rng = np.random.default_rng(SEED + 31)
    delta = os.path.join(workdir, "live_delta.npz")
    np.savez(delta, video_ids=np.asarray([f"fresh{i}" for i in range(4)]),
             rgb=rng.standard_normal((4, data.num_clips, data.feature_dim))
             .astype(np.float32),
             flow=rng.standard_normal((4, data.num_clips, data.feature_dim))
             .astype(np.float32))
    arena = os.path.join(workdir, "cli_arena.npz")
    common = ["serve", "--preset", "didemo_flagship", "--data-dir",
              os.path.join(workdir, "live_nodata"), "--queries", "-",
              "--follow", "--topk", "5"]
    script = ("w0001 w0002\n"
              f"!add {delta}\n"
              "w0003 w0004\n"
              f"!add {delta}\n"
              "!remove fresh1\n"
              "!stats\n"
              "!compact\n"
              "!grow 90\n"
              f"!save {arena}\n"
              "w0005 w0006\n")
    out, secs = _cli_subprocess(common + ["--live-capacity-videos", "70"],
                                script)
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    require(len(recs) == 10, f"live[cli]: {len(recs)} records, wanted 10")
    q1, add, q2, dup, rm, stats, cp, grow, save, q3 = recs
    require(add.get("added_rows") == 4 * 21
            and "already in the corpus" in dup.get("error", "")
            and rm.get("removed_rows") == 21
            and stats.get("tombstoned_rows") == 21
            and cp.get("reclaimed_rows") == 21
            and grow.get("capacity_rows") == 90 * 21
            and save.get("saved") == arena,
            f"live[cli]: control records {recs[1:9]}")
    for q in (q1, q2, q3):
        _served_ok([q], 1, 5, "live[cli]")
    require(all(r["video"] != "fresh1" for r in q3["results"]),
            "live[cli]: a removed video was retrieved")
    out2, secs2 = _cli_subprocess(common + ["--live-arena", arena],
                                  "w0005 w0006\n!stats\n")
    boot = [json.loads(line) for line in out2.splitlines()
            if line.startswith("{")]
    b_mism, b_ddiff = compare_records(boot[:1], [q3])
    require(len(boot) == 2 and b_mism == 0 and b_ddiff <= 1e-3
            and boot[1]["num_videos"] == stats["num_videos"] - 1
            and boot[1]["capacity_rows"] == 90 * 21,
            f"live[cli]: the reboot from --live-arena differs: {boot}")
    return dict(records=len(recs), seconds=secs, reboot_seconds=secs2,
                num_videos=boot[1]["num_videos"])


def phase_packed(results, seed: int, workdir: str):
    """The packed feature store: the synthetic didemo_flagship fixture
    (PACKED_VIDEOS videos) written in the real layout (split JSONs,
    features_rgb.npz, features_flow.npz), packed with ``cli pack``, then
    ``cli corpus`` on the npz directory and on the .vfrf-only one: equal
    metric dicts; the native reader must serve the store; its gather
    rate beside the memmap reader's."""
    import shutil

    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.data import packed as packed_mod
    from vfr_tpu_torch.data.loaders import load_datasets
    from vfr_tpu_torch.data.synthetic import make_didemo_fixture

    cfg = get_preset("didemo_flagship")
    data = cfg.data
    fix = make_didemo_fixture(
        num_videos=PACKED_VIDEOS, num_queries=4 * PACKED_VIDEOS,
        feature_dim=data.feature_dim, glove_dim=data.glove_dim,
        num_clips=data.num_clips, clip_seconds=data.clip_seconds,
        noise=data.synthetic_noise, with_flow=True,
        vocab_words=data.synthetic_vocab_words, seed=seed + 41)
    npz_dir = os.path.join(workdir, "packed_npz")
    vfrf_dir = os.path.join(workdir, "packed_vfrf")
    os.makedirs(npz_dir)
    os.makedirs(vfrf_dir)
    n_val = len(fix.annotations) // 5
    for d in (npz_dir, vfrf_dir):
        for name, anns in (("train_data.json", fix.annotations[:-n_val]),
                           ("val_data.json", fix.annotations[-n_val:])):
            with open(os.path.join(d, name), "w", encoding="utf-8") as f:
                json.dump(anns, f)
    for stream, store in (("rgb", fix.rgb), ("flow", fix.flow)):
        np.savez(os.path.join(npz_dir, f"features_{stream}.npz"),
                 **{v: store[v] for v in store.ids()})
    import contextlib
    import io

    import vfr_tpu_torch.cli as cli_mod

    pack_s = {}
    for stream in ("rgb", "flow"):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_mod.main(["pack", "--npz", os.path.join(
                npz_dir, f"features_{stream}.npz"), "--out", os.path.join(
                vfrf_dir, f"features_{stream}.vfrf")])
        pack_s[stream] = time.perf_counter() - t0
        require(rc == 0 and "packed" in out.getvalue(),
                f"packed: cli pack {stream} exited {rc}")
    metrics, load_s = {}, {}
    for form, d in (("npz", npz_dir), ("vfrf", vfrf_dir)):
        preset = dataclasses.replace(cfg, data=dataclasses.replace(
            data, data_dir=d))
        t0 = time.perf_counter()
        load_datasets(preset.data)
        load_s[form] = time.perf_counter() - t0
        metrics[form] = _cli(["corpus", "--preset", "didemo_flagship",
                              "--data-dir", d], preset, load_datasets)
    require(metrics["npz"] == metrics["vfrf"],
            f"packed: cli corpus differs between the npz and the vfrf "
            f"store: {metrics}")
    path = os.path.join(vfrf_dir, "features_rgb.vfrf")
    store = packed_mod.PackedFeatureStore(path)
    require(store.native and packed_mod._lib is not None,
            "packed: the native reader did not serve the store")
    idx = np.random.default_rng(seed).permutation(store.num_videos)
    rates = {}
    for name, s in (("native", store),
                    ("memmap", packed_mod.PackedFeatureStore(
                        path, prefer_native=False))):
        s.gather(idx)                                  # page cache warm
        t0 = time.perf_counter()
        for _ in range(5):
            got = s.gather(idx)
        rates[name] = 5 * got.nbytes / (time.perf_counter() - t0) / 1e9
    shutil.rmtree(npz_dir)
    rec = dict(phase="packed", videos=PACKED_VIDEOS,
               file_bytes=os.path.getsize(path), pack_s=pack_s,
               load_datasets_s=load_s, reader="native",
               gather_gb_per_s=rates, metrics=metrics["vfrf"],
               metrics_equal=True)
    emit(rec)
    results["packed"] = rec


def kernels_line(results):
    """The {"kernels": [...]} summary: launches from the serving run of
    each kernel's path, times and errors from the kernel phase."""
    def served(phase, *path):
        r = results.get(phase, {})
        for key in path:
            r = r.get(key, {})
        return r or 0

    launches = {
        "lstm_pooled": served("flagship", "launches", "lstm_pooled"),
        "lstm_hs": served("serving_10k", "launches", "lstm_hs"),
        "distance_select": served("fused", "launches", "distance_select"),
        "gru_pooled": served("gru", "mean", "launches", "gru_pooled"),
        "gru_hs": served("gru", "last", "launches", "gru_hs"),
        "coarse_blockmax": served("coarse", "blockmax", "launches",
                                  "coarse_blockmax"),
    }
    def eval_launches(name, phases=("eval", "eval_charades")):
        """Launches of ``name`` over the kernel runs of ``phases``."""
        return sum(run["launches"].get(name, 0)
                   for phase in phases
                   for run in results.get(phase, {}).get("runs", {}).values())

    def train_launches(name):
        """Launches of ``name`` in the train phase's corpus runs on the
        trained checkpoint."""
        return eval_launches(name, ("train",))

    def follow_launches(name):
        """Launches of ``name`` over the follow phase's kernel runs."""
        return sum(run["launches"].get(name, 0) for run in
                   results.get("follow", {}).get("runs", {}).values())

    def live_launches(name):
        return results.get("live", {}).get("launches", {}).get(name, 0)

    def new_paths(name):
        return dict(follow=follow_launches(name), live=live_launches(name))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    out = []
    for name in ("lstm_pooled", "lstm_hs", "gru_pooled", "gru_hs"):
        r = results[name]
        src, rep = KERNEL_SOURCES[name]
        out.append(dict(name=name, route="cuda", source=src, replaces=rep,
                        launches=launches[name],
                        eval_launches=eval_launches(name),
                        train_launches=train_launches(name),
                        **new_paths(name),
                        **{key: r[key] for key in keys},
                        variant=r["variant"], stepwise_ms=r["stepwise_ms"]))
    # the fused cell's index is f32 (the flagship preset); the bf16-index
    # build of the same kernel is reported beside it
    src, rep = KERNEL_SOURCES["distance_select"]
    r = {x["index_dtype"]: x for x in results["distance_select"]}
    f32, b16 = r["float32"], r["bfloat16"]
    keys_v = keys + ("variant", "simt_ms")
    s1 = results.get("eval_charades", {}).get("kernel_distance_select_s1")
    out.append(dict(name="distance_select", route="cuda", source=src,
                    replaces=rep, launches=launches["distance_select"],
                    eval_launches=eval_launches("distance_select"),
                    train_launches=train_launches("distance_select"),
                    **new_paths("distance_select"),
                    **{key: f32[key] for key in keys_v},
                    bf16_index={key: b16[key] for key in keys_v},
                    follow_q8=results.get("follow", {}).get(
                        "kernel_distance_select_q8"),
                    charades_s1={key: s1[key] for key in keys_v
                                 if key in s1} if s1 else None))
    # the coarse cell's shape (210,000 rows, d_c 32) first, the others beside
    src, rep = KERNEL_SOURCES["coarse_blockmax"]
    main_shape, *others = results["coarse_blockmax"]
    out.append(dict(name="coarse_blockmax", route="cuda", source=src,
                    replaces=rep, launches=launches["coarse_blockmax"],
                    eval_launches=eval_launches("coarse_blockmax"),
                    train_launches=train_launches("coarse_blockmax"),
                    **new_paths("coarse_blockmax"),
                    **{key: main_shape[key] for key in keys_v},
                    other_shapes=[dict(shape=o["shape"],
                                       **{key: o[key] for key in keys_v})
                                  for o in others]))
    return {"kernels": out}


ALL_PHASES = ("kernels", "flagship", "coarse", "follow", "eval", "train",
              "packed", "eval_charades", "serving_10k", "live", "gru",
              "coarse_2m")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of " + ", ".join(ALL_PHASES)
                         + " and profile (coarse, follow and eval need "
                           "flagship); the "
                           "default runs all but profile and is the only "
                           "one that ends with the ok line; rnn runs the "
                           "K1 / K3 kernel checks alone, select the K2 and "
                           "coarse_kernel the K4 checks, steps prints the "
                           "persistent kernels' per-step time split, "
                           "wgmma_rate the tensor cores' own time for it")
    ap.add_argument("--resource-usage", action="store_true",
                    help="print ptxas's registers, shared memory and spills "
                         "of every kernel after the build")
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
    t_start = time.perf_counter()
    logs = build_all(resource_usage=args.resource_usage)
    emit({"phase": "build", "seconds": time.perf_counter() - t_start})
    if args.resource_usage:
        for name, log in logs.items():
            print(f"--- {name}\n{log}", flush=True)

    def settle():
        # each phase starts on an idle card with an empty allocator cache
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    results = {}
    if "profile" in phases:
        phase_profile(SEED)
        settle()
    if "steps" in phases:
        phase_steps(SEED)
        settle()
    if "wgmma_rate" in phases:
        phase_wgmma_rate()
    if phases & {"kernels", "rnn"}:
        phase_rnn(results, SEED, "lstm")
        phase_rnn(results, SEED, "gru")
    if phases & {"kernels", "select"}:
        phase_select(results, SEED)
        settle()
    if phases & {"kernels", "coarse_kernel"}:
        phase_coarse_kernel(results, SEED)
        settle()
    with tempfile.TemporaryDirectory() as workdir:
        if "flagship" in phases:
            ctx = phase_serving(results, SEED, VIDEOS, workdir)
            if "coarse" in phases:
                phase_coarse(results, ctx, workdir)
                settle()
            if "follow" in phases:
                phase_follow(results, ctx, workdir)
                settle()
            if "eval" in phases:
                phase_eval(results, ctx)
            del ctx
            settle()
        if "train" in phases:
            phase_train(results, SEED, workdir)
            settle()
        if "packed" in phases:
            phase_packed(results, SEED, workdir)
            settle()
        if "live" in phases:
            phase_live(results, SEED, workdir)
            settle()
    if "eval_charades" in phases:
        phase_eval_charades(results, SEED + 17, VIDEOS_CHARADES)
        settle()
    if "serving_10k" in phases:
        phase_serving_10k(results, SEED, VIDEOS_10K)
        settle()
    if "gru" in phases:
        phase_gru(results, SEED, VIDEOS_10K)
        settle()
    if "coarse_2m" in phases:
        phase_coarse_2m(results, SEED, VIDEOS_2M)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    if not set(ALL_PHASES) <= phases:
        emit({"partial": sorted(phases)})
        return 0
    emit(kernels_line(results))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
