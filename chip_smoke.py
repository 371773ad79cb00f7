#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vfr_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # every phase, full widths

Phases, one JSON line each:
  device      the card (nvidia-smi name and power limit), torch, CUDA.
  build       nvcc of every kernel source (one process each, in parallel).
  kernel_*    each CUDA kernel against its plain PyTorch version on the
              card at the main path's shapes (max |diff|, kernel / plain /
              library ms by CUDA events), every variant of each (LSTM:
              persistent_bulk, persistent, stepwise, the first on more
              seeds and at the packs' batches; GRU: persistent, stepwise;
              distance-select / coarse block-max: mma, simt), timed in
              turns, and at ragged shapes.  K1 / K3 also
              at B=512 and a ragged B=300 through cuda_lstm / cuda_gru:
              batch chunks (the reference's rule; 256 and 152 rows), one
              persistent launch a chunk and none stepwise, the first
              chunk bit-equal to a run alone; B=512 chunked against
              stepwise in turns.  The long-row top-k (row_topk) against
              its plain version and the library select, bit for bit, on
              six kinds of rows at four lengths, four k and three
              batches; timed at the cells' and a pack's shapes beside
              its bound and the library select; a retriever's graph
              replays counting its launches.  The f32 score GEMM
              (score_gemm, 3 x TF32) at [Q, 256] x [210,000, 256], Q = 1,
              8, 64, 256: its worst error against an f64 product beside
              torch.matmul's in f32 (TF32 off; the kernel's at most 4x),
              its device ms beside its bound, its plain version's and
              torch.matmul's ms, one launch a call; with two cards or
              more a 52,500-row shard on cuda:1 (cuda:0 current), eager
              and as a captured graph's replay, bit-equal, launched on
              cuda:1 only.
  flagship    didemo_flagship at full width (E=300, H=1024, F=2048, joint
              128, two streams, cosine, mean pool), seeded weights, a
              synthetic 10,000-video corpus (210,000 index rows): build,
              save and load the index, serve 1024 queries exact, then with
              length buckets (identical results required), and hold the
              results against the same queries served through the
              kernels' plain versions; a batch of 256 (top-10) as one
              graph replay against the eager batch over five token sets
              (distances bit for bit, rows, launches per replay = per
              eager call), each graphed answer held to the plain
              distances (``_exact_rows_vs_plain``); the same index under
              bf16 compute (K1a, the f32 operand rounded in each
              product), one batch at full length and one at the T = 8
              bucket, its queries within QUERY_TOL of the plain
              recurrence's and each answer held to the plain distances.
  fused       `--topk-method fused` on the same index; recall@10 vs exact;
              the graphed batch against the eager one, as flagship's.
  coarse      the coarse-to-fine prefilter (d_coarse 32) built on the same
              index, save/load round trip, 1024 queries served with stage 1
              blockmax (K4) and centroid at C=2048, blockmax held against
              the same retriever with K4's plain version; recall@10 vs
              exact.
  devices     with two cards or more: one flagship batch served with the
              params and index on cuda:1 while cuda:0 stays current, exact
              (K1a, the long-row top-k, the score GEMM), fused (K1a + K2)
              and coarse blockmax (K1a + K4), each
              held to the same batch on cuda:0, every kernel launched on
              cuda:1 only; `cli serve --device cuda:1` as a subprocess.
              With one card a line says it did not run and why.
  follow      daemon serving (`serve_follow`) on the same index: 50
              isolated requests (one in flight) and a backlog of 200 at
              micro-batch 8 (pipeline depth 1 and 2) and 64 (depth 1), exact
              (K1a) and fused (K1a, K2), and coarse blockmax (K1a, K4) once;
              p50 / p95 request ms, requests/s, time to first result; each
              run beside its plain-version run and held to `serve_queries`'
              records (moments equal outside near-ties, distances within
              1e-3); depth 1 against 2 at micro-batch 8 in turns, and the
              exact daemon eager (E) against graphed (G) in turns E G G E,
              50 isolated requests and a backlog of 384 at micro-batch 8
              and 64, depth 1 and 2, records bit-equal; each run's first
              request goes alone first (the daemon's graph capture) and is
              not counted; host syncs per pack by
              line, none allowed from ops/topk.py on the exact path; K2 at
              one pack of 8 queries; one
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
  serving_10k last pool, bf16 compute, bf16 index, on a 2,000-video corpus;
              its eight batches graphed against eager and held to the
              plain distances, one capture for the stream.
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
              with the host fails it.  Then didemo_fusion at full width
              (rgb + flow, the margin loss, B=64) on a 256-video fixture,
              the clip features in the batch and no feature banks: 40
              steps, every loss finite, and one batch's fused-layer
              gradients held to the scan twin's as above.
  train_charades `cli train --preset charades_flagship` at full width (B=64,
              InfoNCE tau 0.02, EMA 0.999, 8 mined negatives from epoch
              3) on eval_charades' 2,000-video fixture (one val query per
              video), 4 epochs of 20 steps, the loop's per-video eval at
              batch 512 through K1b in chunks; then `cli eval` (K1b,
              persistent only) and `cli corpus` exact (K1b) and fused
              (K1b + K2 at S=1), each held against the plain versions.
              Fails as train does; reports step ms, refresh and eval s.
  train_dp    data-parallel training of the train phase's recipe over a
              "data" mesh of 4 (distinct cards when visible, else the first
              card 4 times; a line names the devices): one flagship batch
              (mined negatives, a per-step tau, a dropout mask) through the
              DP step and the one-device step from the same params (loss
              within 1e-5 relative, each gradient leaf within DP_GRAD_TOL of
              its max |grad|), every replica equal to the lead after a
              chunk, one host sync a chunk; the sharded mining refresh beside
              the one-device one (pairs equal outside near-ties, seconds of
              each); `train(cfg, mesh=)` beside the same run on one device
              (first chunk's loss within 1e-4, every chunk within
              DP_CHUNK_TOL, final metrics of both, every chunk through the
              prefetcher's side streams); `cli corpus --checkpoint-dir` on
              the DP checkpoint, exact (K1a) and fused (K1a + K2), held to
              the plain versions; `cli train --data-parallel` for one epoch
              (one card: its warning, one device; more: the mesh).  Reports
              ms per step at n = 1, 2, 4 (CUDA events, median of chunks),
              the DP step's split (shards' forward, gather + loss,
              backward, reduction, update + EMA, broadcast) and its device
              busy share.
  packed      the synthetic didemo_flagship fixture (2,000 videos) written
              in the real layout, `cli pack` of both streams, `cli corpus`
              on the npz and on the .vfrf-only directory (equal metric
              dicts); the native reader must serve the store; gather GB/s
              of the native and the memmap reader.
  live        first a fixed index of serving_10k over 10,000 videos
              (210,000 rows): one batch of 256 through make_retriever as
              the benchmark's s10k-batch cell runs it, the replay
              bit-equal to the eager batch on the library select (the
              long-row select on real scores), the replay and the eager
              batch under torch's sync debug mode "error" (any host sync
              fails it), the bf16 product held to mm_f32 at the per-stream
              shape (K = 128).  Then the live index of serving_10k: the
              same 10,000 videos in a 20,000-video
              arena (420,000 rows), 4 appends of 128 videos, a removal of
              500, compact, grow to 25,000, save -> load (bit-exact); after
              each, the live retriever held to a from-scratch index over the
              same corpus; the arena written in place until the grow; K1b
              must launch; each retrieval one graph replay, bit-equal to
              the eager call, no new capture after an append, a removal or
              a compaction (and rows of the appended videos returned), one
              a shape after the grow; seconds of each operation, retrieve
              ms before and after; the arena bf16 [420,000, 256] + f32 norms, its bytes
              read from the tensors, memory allocated before and after the
              build; the bf16-operand score GEMM against its plain version
              (mm_f32) on the arena at packs of 8 and 256 (rows equal
              outside near-ties, distances within 1e-3, ms of both and the
              bound); the arena upcast to f32 under the same bf16 compute
              (rounded in each product) giving the bf16 arena's answers
              bit for bit; a `cli serve --follow
              --live-capacity-videos` subprocess running a script of queries
              and control lines, and a second booted from its `!save`.
  sharded     the corpus index row-sharded over a "corpus" mesh of n
              shards (n distinct cards when visible, else the first card n
              times; a line names the mesh's devices): flagship exact at
              n = 4 and 8 (K1a; held to the unsharded results and to K1a's
              plain version; ms per batch beside unsharded; host syncs per
              batch: none, at 52,500 rows a shard as at 26,250), coarse at
              n = 4 (blockmax: K4 on every shard, held to its plain version;
              centroid; recall@10; the full quota equal to exact), corpus
              eval at n = 4 (official protocol, GT ranker; exact and coarse
              held to the unsharded runs within 0.1% of the queries, coarse
              also to its plain-version run);
              riding on the phases it needs: eval_charades corpus exact at
              n = 4 (K1b), live (a second, sharded arena through the same
              operations, held to the unsharded arena and the rebuild, its
              snapshot on one device, the daemon's script over a sharded
              arena; K1b), coarse_2m at n = 4 (full scan held to the
              unsharded one, no host sync a batch; blockmax K4).
A serving batch on one card is one CUDA graph replay (utils/graphs.py);
a replay adds the launches its capture counted, so every count below is
of what ran on the card.  A check that patches a kernel's plain version
in runs the eager batch (a replay would not see the patch), or a new
retriever captured under the patch.
Every serving and eval run zeroes the kernels' launch counts just before
it runs and fails unless each kernel of its path launched; a per-video
eval at batch 512 fails if K1 ran stepwise.  The sharded coarse runs
(flagship, coarse_2m) fail unless K4 launched on every shard's device.
Then one {"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero with no ok line.
Without a CUDA device it exits 2 and prints no result.

Not in the default run (``--phases``): ``rnn`` (the K1 / K3 checks alone),
``select`` (K2's), ``coarse_kernel`` (K4's), ``row_topk`` (the top-k's),
``score_gemm`` (the score GEMM's),
``profile`` (device time by kernel name), ``steps`` (the persistent
kernels' per-step time split), ``wgmma_rate`` (the tensor cores' own time
for a step's products), ``trace`` (with ``coarse_2m`` and ``train_dp``,
whose mesh runs it turns on: a host and device trace of one sharded
``coarse_2m`` blockmax batch beside the unsharded one, and of one
data-parallel step beside a one-card step).
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

from vfr_tpu_torch.utils.timing import bound, cuda_ms, nvidia_smi_line

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
FUSION_VIDEOS = 256      # train: didemo_fusion's fixture (rgb + flow, B=64)
FUSION_STEPS = 40        # its steps, one batch each
FOLLOW_REQUESTS = 200    # follow: a backlog of 200 requests
FOLLOW_ISOLATED = 50     # and 50 isolated ones (one in flight)
FOLLOW_CLI = 20          # requests of the `cli serve --follow` subprocess
FOLLOW_EG = 384          # follow: eager / graphed backlogs (6 packs of 64)
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
TRAIN_DP_SHARDS = 4      # train_dp: the "data" mesh of the step and refresh
DP_LOSS_TOL = 1e-5       # DP vs one-device loss of one batch, relative
DP_GRAD_TOL = 1e-5       # DP vs one-device gradients, of max |grad| per leaf:
                         # only the order of the shards' partial sums
                         # differs (1.5e-6 measured on an H100, PERF.md)
DP_CHUNK_TOL = 5e-3      # DP vs one-device chunk losses over the cut run:
                         # the trajectories part at f32 rounding and the
                         # refresh may mine other near-ties (9.2e-4 measured)
REFRESH_GAP_TOL = 1e-4   # sharded vs one-device mined distance profiles
CHUNK_BATCHES = (512, 300)  # rnn: batches one persistent grid cannot hold
RNN_SEEDS = 4            # rnn: more seeds for K1's bulk variant
RNN_PACKS = (1, 8, 64, 128)  # rnn: K1 at the daemon packs' batches and more
SHARDS = (4, 8)          # sharded: 52,500 flagship rows a shard (over the
                         # top-k's KEY_MAX), and 26,250 (under it)
QUERY_TOL = 2e-3         # flagship bf16 compute: queries through K1a vs
                         # plain, the kernel checks' tolerance (recheck_rows)

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


def _same_floats(got, ref) -> bool:
    """f32 tensors pairwise equal bit for bit."""
    import torch

    return all(torch.equal(g.view(torch.int32), r.view(torch.int32))
               for g, r in zip(got, ref))


def phase_rnn(results, seed: int, cell: str):
    """K1 (cell="lstm") or K3 (cell="gru"), pooled and hs modes: every
    kernel variant (K1: persistent_bulk, persistent, stepwise; K3:
    persistent, stepwise) against the plain version with bf16 weights, the
    f32-weight build (stepwise), ragged shapes with zero-length rows, and
    the newest variant's time taken in turns beside the one before it
    (K1: persistent, persistent_bulk, persistent_bulk, persistent; K3:
    stepwise, persistent, persistent, stepwise) beside cuDNN over a packed
    batch of the same weights (fp16 operands, the 2-byte type cuDNN's RNN
    takes, and f32).  The persistent variant is also timed with its input
    product unfused and on the same batch sorted by length (whole 64-row
    tiles then go dead early and skip their products).  K1's bulk variant
    is held to ``persistent`` bit for bit and to the plain version on
    RNN_SEEDS more seeds, also with every row cut to T // 3 (a step that
    read a stale h would show), and timed
    with ``persistent`` in turns at the daemon packs' batches and more
    (``RNN_PACKS``)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    from vfr_tpu_torch.ops.kernels import gru_kernel, lstm_kernel

    mod_k = gru_kernel if cell == "gru" else lstm_kernel
    gates = 3 if cell == "gru" else 4
    variants = (("persistent", "stepwise") if cell == "gru"
                else ("persistent_bulk", "persistent", "stepwise"))
    new, earlier = variants[0], variants[1]
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
    # then T = 1.  K1's two persistent variants sum in the same order, so
    # their outputs are held equal bit for bit (same_bits)
    ragged, same_bits = {}, {}
    for rb, rt, re_, rh in ((200, 7, 52, 1000), (70, 1, 300, 1024)):
        r_layer, r_plain, _, r16, _, _ = _rnn_case(cell, seed + 2, rb, rt,
                                                   re_, rh)
        r_len = r16[1].clone()
        r_len[3:40:5] = 0
        r16 = (r16[0], r_len, *r16[2:])
        for pool in ("mean", "none"):
            ref = r_plain(*r16, pool=pool)
            r_outs = {}
            for variant in variants:
                got = r_outs[variant] = r_layer(*r16, pool=pool,
                                                variant=variant)
                torch.cuda.synchronize()
                ragged[f"B{rb}_T{rt}_E{re_}_H{rh}_{pool}_{variant}"] = \
                    _max_diff(got, ref)
            if cell == "lstm":
                same_bits[f"B{rb}_T{rt}_{pool}"] = _same_floats(
                    r_outs["persistent_bulk"], r_outs["persistent"])
    ragged_err = max(ragged.values())
    # the newest variant on more seeds, and (K1) at the packs' batches
    seeds, packs = {}, {}
    if cell == "lstm":
        for s in range(1, RNN_SEEDS + 1):
            s_layer, s_plain, _, s16, _, _ = _rnn_case(cell, seed + 100 * s,
                                                       B, T, E, H)
            # and the same rows cut to T // 3: every step past the longest
            # is one the batch groups skip
            short = (s16[0], s16[1].clamp(max=T // 3), *s16[2:])
            for tag, a16 in (("", s16), ("_short", short)):
                for pool in ("mean", "none"):
                    got = s_layer(*a16, pool=pool, variant=new)
                    torch.cuda.synchronize()
                    key = f"seed{seed + 100 * s}{tag}_{pool}"
                    seeds[key] = _max_diff(got, s_plain(*a16, pool=pool))
                    same_bits[key] = _same_floats(
                        got, s_layer(*a16, pool=pool, variant=earlier))
        for pb in RNN_PACKS:
            k_layer, k_plain, _, k16, _, _ = _rnn_case(cell, seed + 3, pb,
                                                       T, E, H)
            ref = k_plain(*k16, pool="mean")
            rec, k_outs = {"auto": None}, {}
            for variant in (earlier, new):
                k_outs[variant] = k_layer(*k16, pool="mean", variant=variant)
                rec[f"max_abs_err_{variant}"] = _max_diff(k_outs[variant],
                                                          ref)
            same_bits[f"B{pb}"] = _same_floats(k_outs[new], k_outs[earlier])
            k_layer(*k16, pool="mean")
            rec["auto"] = mod_k.LAST_PLAN.variant
            turns = [cuda_ms(lambda: k_layer(*k16, pool="mean",
                                             variant=v))
                     for v in (earlier, new, new, earlier)]
            rec.update({f"{earlier}_ms": (turns[0] + turns[3]) / 2,
                        f"{new}_ms": (turns[1] + turns[2]) / 2,
                        "turns_ms": turns})
            packs[f"B{pb}"] = rec
    for name, pool, out_bytes in (
            (f"{cell}_pooled", "mean", 2 * B * H * 4),
            (f"{cell}_hs", "none", B * H * 4 + B * T * H * 4)):
        ref = plain(*args16, pool=pool)
        errs, plans, outs = {}, {}, {}
        for variant in variants:
            got = outs[variant] = layer(*args16, pool=pool, variant=variant)
            torch.cuda.synchronize()
            errs[variant] = _max_diff(got, ref)
            plans[variant] = mod_k.LAST_PLAN
            require(plans[variant].variant == variant,
                    f"{name}: asked for {variant}, ran "
                    f"{plans[variant].variant}")
            require(all(bool(torch.isfinite(g).all()) for g in got),
                    f"{name}[{variant}]: non-finite output")
        if cell == "lstm":
            same_bits[name] = _same_floats(outs["persistent_bulk"],
                                           outs["persistent"])
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
        for variant in (earlier, new, new, earlier):
            turns.append(cuda_ms(lambda: layer(*args16, pool=pool,
                                               variant=variant)))
        earlier_ms = (turns[0] + turns[3]) / 2
        ms = (turns[1] + turns[2]) / 2
        stepwise_ms = (earlier_ms if earlier == "stepwise" else
                       cuda_ms(lambda: layer(*args16, pool=pool,
                                             variant="stepwise")))
        persistent_ms = (ms if new == "persistent" else earlier_ms)
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
        pp = plans[new]
        rec = dict(name=name, shape=dict(B=B, T=T, E=E, H=H,
                                         weights="bfloat16"),
                   variant=auto_plan.variant,
                   plan=dict(u=pp.u, batch_group=pp.batch_group,
                             grid=list(pp.grid), smem_bytes=pp.smem_bytes,
                             fuse_input=pp.fuse_input),
                   f32_weights_variant=plan32.variant,
                   max_abs_err=errs[new],
                   max_abs_err_by_variant={v: errs[v] for v in variants},
                   max_abs_err_unfused=errs["persistent_unfused"],
                   max_abs_err_sorted_rows=errs["persistent_sorted_rows"],
                   max_abs_err_f32_weights=err32,
                   max_abs_err_ragged=ragged_err, ragged=ragged,
                   max_abs_err_seeds=max(seeds.values(), default=0.0),
                   seeds=seeds, tol=2e-3, same_bits=same_bits,
                   ms=ms, earlier_variant=earlier, earlier_ms=earlier_ms,
                   persistent_ms=persistent_ms, stepwise_ms=stepwise_ms,
                   turns_ms=turns,
                   persistent_unfused_ms=unfused_ms,
                   persistent_sorted_rows_ms=sorted_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=lib["library_ms"],
                   library="cudnn fp16", library_f32_ms=lib["library_f32_ms"],
                   library_is_cudnn=lib["library_cudnn"],
                   library_h_last_max_abs_diff=lib_diff[""],
                   library_f32_h_last_max_abs_diff=lib_diff["_f32"],
                   live_steps=live_steps, packs=packs)
        emit({"phase": f"kernel_{name}", **rec})
        require(auto_plan.variant == new,
                f"{name}: the plan chose {auto_plan.variant} at the "
                f"flagship shape ({auto_plan.reason})")
        worst = max(*errs.values(), err32, ragged_err,
                    *seeds.values(),
                    *(e for r in packs.values() for k_, e in r.items()
                      if k_.startswith("max_abs_err")))
        require(worst <= 2e-3,
                f"{name}: max |diff| vs plain {errs}, f32 weights {err32}, "
                f"ragged {ragged}, seeds {seeds}, packs {packs} > 2e-3")
        require(all(same_bits.values()),
                f"{name}: persistent_bulk is not persistent bit for bit: "
                f"{same_bits}")
        results[name] = rec


def phase_rnn_chunks(results, seed: int, cell: str):
    """K1 (cell="lstm") or K3 (cell="gru") at batches one persistent grid
    cannot hold (``CHUNK_BATCHES``: 512, and a ragged 300) through
    ``cuda_lstm`` / ``cuda_gru`` under variant="auto": the reference's
    batch chunks (``rnn_plan.device_chunk``), one persistent launch a
    chunk (K1: ``persistent_bulk``, K3: ``persistent``) and no other, held
    against the plain version over the whole batch (2e-3, as ``phase_rnn``),
    the first chunk's rows equal bit for bit to that chunk run alone.
    B=512 is timed chunked against
    ``stepwise`` in turns (stepwise, chunked, chunked, stepwise)."""
    import torch

    from vfr_tpu_torch.ops.kernels import gru_kernel, lstm_kernel
    from vfr_tpu_torch.ops.kernels.rnn_plan import device_chunk

    if cell == "gru":
        chain, gates, bias_keys = gru_kernel.cuda_gru, 3, ("b_ih", "b_hh")
    else:
        chain, gates, bias_keys = lstm_kernel.cuda_lstm, 4, ("b",)
    T, E, H = 24, 300, 1024
    for pool, name in (("mean", f"{cell}_pooled"), ("none", f"{cell}_hs")):
        out = {}
        for B in CHUNK_BATCHES:
            layer, plain, _, args16, _, _ = _rnn_case(cell, seed + B, B, T,
                                                      E, H)
            x, lengths = args16[:2]
            params = {"layer0": dict(zip(("w_ih", "w_hh", *bias_keys),
                                         args16[2:]))}
            chunk = device_chunk(x.device, B, [(E, H)], gates, True)
            require(chunk is not None and chunk < B,
                    f"{name}: B={B} plans chunk {chunk}")
            n_chunks = -(-B // chunk)
            reset_counts()
            got = chain(params, x, lengths, pool=pool)
            torch.cuda.synchronize()
            counts = read_counts()
            variants = counts["variants"][cell]
            want = "persistent" if cell == "gru" else "persistent_bulk"
            require(variants == {**{v: 0 for v in variants},
                                 want: n_chunks}
                    and counts[name] == n_chunks,
                    f"{name}: B={B} in chunks of {chunk} launched "
                    f"{counts[name]} ({variants}), wanted {n_chunks} "
                    f"{want}")
            err = _max_diff(got, plain(*args16, pool=pool))
            alone = layer(x[:chunk], lengths[:chunk], *args16[2:],
                          pool=pool, variant=want)
            torch.cuda.synchronize()
            bit_equal = all(torch.equal(g[:chunk], a)
                            for g, a in zip(got, alone))
            rec = dict(B=B, chunk=chunk, chunks=n_chunks,
                       variants=variants, max_abs_err=err, tol=2e-3,
                       first_chunk_bit_equal=bit_equal)
            if B == CHUNK_BATCHES[0]:
                turns = [cuda_ms(lambda: chain(params, x, lengths,
                                               pool=pool, variant=v))
                         for v in ("stepwise", "auto", "auto", "stepwise")]
                rec.update(ms=(turns[1] + turns[2]) / 2,
                           stepwise_ms=(turns[0] + turns[3]) / 2,
                           turns_ms=turns)
            out[f"B{B}"] = rec
            require(err <= 2e-3 and bit_equal,
                    f"{name}: B={B} chunked vs plain {err} (> 2e-3) or "
                    f"first chunk not bit-equal to a run alone "
                    f"({bit_equal})")
        emit({"phase": f"kernel_{name}_chunks", **out})
        results[name]["chunks"] = out


def phase_steps(seed: int):
    """Where a persistent step's time goes (``--phases steps``; not part of
    the default run): the kernel's own nanosecond stamps from one thread of
    block (0, 0), K1a (persistent_bulk; persistent) and K3a (persistent) at
    the flagship shape, persistent with the input product fused and
    unfused.  Medians over steps 1..T-2, in microseconds.  In the bulk
    variant the next step's input part is its x chunks' products, issued
    before the grid barrier, and the barrier wait runs until h's first
    chunk has landed."""
    import torch

    B, T, E, H = 256, 24, 300, 1024
    names = ("recurrent_product", "cell_update", "store_and_arrive",
             "next_input_part", "barrier_wait")
    forms = {"lstm": (("persistent_bulk", True), ("persistent", True),
                      ("persistent", False)),
             "gru": (("persistent", True), ("persistent", False))}
    for cell in ("lstm", "gru"):
        layer, _, _, args16, _, _ = _rnn_case(cell, seed, B, T, E, H)
        for variant, fuse in forms[cell]:
            kw = dict(pool="mean", variant=variant, fuse_input=fuse)
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
                  "variant": variant, "fuse_input": fuse,
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


# row_topk: the rows the checks select over (KEY_MAX + 1, a shard of four
# cards, the cells' rows, a ragged row), k and batches
ROW_TOPK_NS = (32_769, 52_500, 210_000, 210_003)
ROW_TOPK_KS = (1, 10, 100, 256)
ROW_TOPK_QS = (1, 8, 256)
ROW_TOPK_KINDS = ("gauss", "repeated", "slice_ties", "specials", "ascending",
                  "descending")
# f32 bits: +-0, +-inf, NaNs of both signs (two payloads), +-1
ROW_TOPK_SPECIALS = (0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                     0x7FC00000, 0xFFC00000, 0x7FC00001, 0x3F800000,
                     0xBF800000)


def _row_topk_rows(kind: str, Q: int, N: int, k: int, plan, gen, dev):
    """[Q, N] f32 rows of one kind: normals; one repeated value; normals
    with a tie of 9.0 over 2 (k // 2 + 1) columns straddling every slice
    boundary of ``plan`` (the row's middle with one slice), so the k-th
    place falls inside the ties; the specials mixed with 30% normals;
    ascending (every value passes the filter) or descending integers."""
    import torch

    if kind == "gauss":
        return torch.randn(Q, N, generator=gen, device=dev)
    if kind == "repeated":
        return torch.full((Q, N), 0.25, device=dev)
    if kind in ("ascending", "descending"):
        x = torch.arange(N, dtype=torch.float32, device=dev)
        return (x if kind == "ascending" else x.flip(0)).repeat(Q, 1)
    if kind == "slice_ties":
        x = torch.randn(Q, N, generator=gen, device=dev)
        w = k // 2 + 1
        edges = [s * plan.slice_len for s in range(1, plan.slices)]
        for e in edges or [N // 2]:
            x[:, max(0, e - w):e + w] = 9.0
        return x
    pool = torch.from_numpy(np.asarray(ROW_TOPK_SPECIALS, np.uint32)
                            .view(np.float32)).to(dev)
    x = pool[torch.randint(len(pool), (Q, N), generator=gen, device=dev)]
    mix = torch.rand(Q, N, generator=gen, device=dev) < 0.3
    return torch.where(mix, torch.randn(Q, N, generator=gen, device=dev), x)


def _library_topk(x, k):
    """The library select these rows take off the kernel's route: the
    64-bit key for a batch of at most ``KEY_BATCH * KEY_MAX`` values, else
    the 32-bit order and the tie pass."""
    from vfr_tpu_torch.ops import topk

    if x.numel() <= topk.KEY_BATCH * topk.KEY_MAX:
        return topk._key_topk(x, k)
    return topk._tie_topk(x, k)


def _same_bits(a, b) -> bool:
    import torch

    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def _row_topk_graph(seed: int, Q: int = 256, k: int = 100,
                    videos: int = 10_000, replays: int = 5):
    """A flagship-shaped exact retriever over a seeded unit-row index of
    ``videos`` x 21 rows: its graph replays count one ``select.kernel`` a
    batch, the kernel's launches under ``topk_kernel.launches`` and no
    ``select.order32_tie``; the replayed answers equal, bit for bit, the
    eager batch with the kernel route turned off (the library select)."""
    from unittest import mock

    import torch

    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.eval.corpus import MomentIndex, make_retriever
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import (
        init_model_params,
        prepare_query_params,
    )
    from vfr_tpu_torch.ops import topk
    from vfr_tpu_torch.utils import trace

    dev = torch.device("cuda")
    cfg = get_preset("didemo_flagship")
    model = build_model(cfg)
    rng = np.random.default_rng(seed)
    glove = rng.standard_normal((1000, cfg.data.glove_dim)).astype(np.float32)
    params = init_model_params(torch.Generator().manual_seed(seed), model,
                               glove, cfg.data.feature_dim, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    P, S, d = 21, 2, cfg.model.joint_dim
    m = torch.randn(S, videos * P, d, generator=gen, device=dev)
    m = m / (m.norm(dim=-1, keepdim=True) + 1e-8)
    index = MomentIndex(
        m=m, m_sq=(m * m).sum(-1),
        video_row=np.repeat(np.arange(videos, dtype=np.int32), P),
        prop_idx=np.tile(np.arange(P, dtype=np.int32), videos),
        spans_sec=np.zeros((videos * P, 2), np.float32),
        weights=np.ones(S, np.float32))
    T = cfg.data.max_query_len
    toks = torch.randint(2, 1000, (Q, T), generator=gen, device=dev,
                         dtype=torch.int32)
    lens = torch.randint(1, T + 1, (Q,), generator=gen, device=dev,
                         dtype=torch.int32)
    qp = prepare_query_params(params, model)
    retrieve = make_retriever(model, index, k, "exact")
    retrieve(qp, toks, lens)                  # the capture
    torch.cuda.synchronize()
    before = trace.counters()
    for _ in range(replays):
        got = retrieve(qp, toks, lens)
    torch.cuda.synchronize()
    delta = {n: c - before.get(n, 0) for n, c in trace.counters().items()
             if c != before.get(n, 0)}
    real = topk.select_route
    with mock.patch.object(topk, "select_route",
                           lambda device_type, *a: real("none", *a)):
        ref = retrieve.eager(qp, toks, lens)     # the library select
    torch.cuda.synchronize()
    rec = dict(Q=Q, N=videos * P, k=k, replays=replays, counted=delta,
               bit_equal_to_library_route=_same_bits(got, ref))
    require(delta.get("graphs.replays") == replays
            and delta.get("select.kernel") == replays
            and "select.order32_tie" not in delta
            and delta.get("topk_kernel.launches.row_topk_filter") == replays
            and delta.get("topk_kernel.launches.row_topk_merge") == replays,
            f"row_topk graph: counted {delta}")
    require(rec["bit_equal_to_library_route"], "row_topk graph: replayed "
            "answers differ from the library select")
    return rec


def phase_row_topk(results, seed: int):
    """The long-row top-k kernel (``csrc/row_topk.cu``) against its plain
    version (``row_topk_plain``, the same slices) and against the library
    select (``_library_topk``), bit for bit, over every kind of
    ``_row_topk_rows`` x ``ROW_TOPK_NS`` x ``ROW_TOPK_KS`` x
    ``ROW_TOPK_QS``.  Then its time at the cells' shapes ([256, 210,000],
    k = 100 and 10) and a daemon pack's (Q = 8 and 1, k = 100 and 10):
    stream ms through the wrapper (``cuda_ms``: host-bound at a pack) and
    the kernels' own device ms (torch.profiler), beside its bound (the
    rows read once, the k values and rows written once), the plain version
    and the library select (the yardstick); then a retriever's graph
    replays (``_row_topk_graph``)."""
    import torch

    from vfr_tpu_torch.ops.kernels import topk_kernel
    from vfr_tpu_torch.ops.kernels.select_plan import device_limits

    dev = torch.device("cuda")
    sms = device_limits(dev)[1]
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    failures, n_cases = [], 0
    for N in ROW_TOPK_NS:
        for Q in ROW_TOPK_QS:
            for k in ROW_TOPK_KS:
                plan = topk_kernel.plan_row_topk(Q, N, k, sms)
                for kind in ROW_TOPK_KINDS:
                    x = _row_topk_rows(kind, Q, N, k, plan, gen, dev)
                    got = topk_kernel.row_topk(x, k)
                    torch.cuda.synchronize()
                    plain = topk_kernel.row_topk_plain(x, k, plan)
                    library = _library_topk(x, k)
                    n_cases += 1
                    for what, ref in (("plain", plain), ("library", library)):
                        if not _same_bits(got, ref):
                            bad = (got[1] != ref[1]).any(-1).nonzero()
                            failures.append(dict(
                                kind=kind, Q=Q, N=N, k=k, against=what,
                                slices=plan.slices, rows_differing=len(bad),
                                first_row=int(bad[0]) if len(bad) else None))
                    del x, got, plain, library
    emit({"phase": "kernel_row_topk_checks", "cases": n_cases,
          "failures": failures[:20], "n_failures": len(failures)})
    require(not failures, f"row_topk: {len(failures)} of {n_cases} cases "
            "differ (kernel_row_topk_checks)")
    recs = []
    N = 210_000
    for Q, k in ((256, 100), (256, 10), (8, 100), (8, 10), (1, 100),
                 (1, 10)):
        x = torch.randn(Q, N, generator=gen, device=dev)
        plan = topk_kernel.plan_row_topk(Q, N, k, sms)
        ms = cuda_ms(lambda: topk_kernel.row_topk(x, k))
        device_ms = _device_profile(
            f"row_topk_Q{Q}_k{k}", lambda: topk_kernel.row_topk(x, k),
            iters=20)["device_ms_per_iter"]
        plain_ms = cuda_ms(lambda: topk_kernel.row_topk_plain(x, k, plan),
                           iters=5)
        library_ms = cuda_ms(lambda: _library_topk(x, k), iters=5)
        bound_ms, bound_by = bound(Q * N * 4 + Q * k * (4 + 8), 0.0,
                                   "float32")
        rec = dict(name="row_topk", shape=dict(Q=Q, N=N, k=k),
                   slices=plan.slices, slice_len=plan.slice_len, ms=ms,
                   device_ms=device_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   library=("torch.topk 32-bit + tie pass"
                            if Q * N > 512 * 32768 else "torch.topk key64"),
                   bound_ms=bound_ms, bound_by=bound_by,
                   roofline=bound_ms / device_ms)
        emit({"phase": "kernel_row_topk", **rec})
        recs.append(rec)
        del x
    graph = _row_topk_graph(seed)
    emit({"phase": "kernel_row_topk_graph", **graph})
    results["row_topk"] = dict(times=recs, graph=graph, cases=n_cases)


# score_gemm: the queries of a batch, a pack and a one-query call against
# the flagship's rows, and a shard of four cards
SCORE_QS = (1, 8, 64, 256)
SCORE_N = 210_000
SCORE_SHARD = 52_500
SCORE_ERR_RATIO = 4.0    # the kernel's worst error / torch.matmul's, at most


def _score_operands(Q: int, N: int, gen, dev, K: int = 256):
    """The flagship's score operands in shape: unit-norm rows of two
    128-wide streams, concatenated (the queries of query_cat_scaled at
    weights 0.5, the index's m_cat)."""
    import torch

    def unit(n):
        x = torch.randn(2, n, K // 2, generator=gen, device=dev)
        x = x / x.norm(dim=-1, keepdim=True)
        return torch.cat([x[0], x[1]], -1).contiguous()

    return unit(Q), unit(N)


def _score_case(a, m, what: str):
    """The score kernel on ``a [Q, K]`` x ``m [N, K]`` (on their card):
    its worst difference from its plain version, its worst error against
    an f64 product beside torch.matmul's (f32, TF32 off) and the plain
    version's, one launch a call; its stream ms
    (CUDA events) and device ms (torch.profiler) beside the bound, the
    plain version's and torch.matmul's ms."""
    import torch

    from vfr_tpu_torch.ops.kernels import score_kernel

    Q, K = a.shape
    N = m.shape[0]
    with torch.cuda.device(a.device):
        before = score_kernel.LAUNCHES["score_gemm"]
        got = score_kernel.score_gemm(a, m)
        torch.cuda.synchronize()
        launches = score_kernel.LAUNCHES["score_gemm"] - before
        exact = a.double() @ m.double().T
        err = (got.double() - exact).abs().max().item()
        plain = score_kernel.score_gemm_plain(a, m)
        err_plain = (plain.double() - exact).abs().max().item()
        diff_plain = (got - plain).abs().max().item()
        lib = torch.matmul(a, m.T)
        err_library = (lib.double() - exact).abs().max().item()
        del exact, plain, lib
        ms = cuda_ms(lambda: score_kernel.score_gemm(a, m))
        device_ms = _device_profile(
            f"score_gemm_{what}", lambda: score_kernel.score_gemm(a, m),
            iters=20)["device_ms_per_iter"]
        plain_ms = cuda_ms(lambda: score_kernel.score_gemm_plain(a, m),
                           iters=10)
        library_ms = cuda_ms(lambda: torch.matmul(a, m.T), iters=10)
    bound_ms, bound_by = bound(N * K * 4 + Q * K * 4 + Q * N * 4,
                               2.0 * Q * N * K, "float32")
    rec = dict(name="score_gemm", what=what, shape=dict(Q=Q, N=N, K=K),
               device=str(a.device), launches_per_call=launches,
               max_abs_err_vs_f64=err, max_abs_diff_vs_plain=diff_plain,
               plain_err_vs_f64=err_plain,
               library_err_vs_f64=err_library,
               err_ratio=err / err_library, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, roofline=bound_ms / device_ms)
    emit({"phase": "kernel_score_gemm", **rec})
    require(launches == 1, f"score_gemm {what}: {launches} launches a call")
    require(err <= SCORE_ERR_RATIO * err_library,
            f"score_gemm {what}: worst error {err} against f64, more than "
            f"{SCORE_ERR_RATIO} x torch.matmul's {err_library}")
    return rec, got


def _score_second_card(gen0):
    """A 52,500-row shard on cuda:1 while cuda:0 stays current: the
    kernel eager and as a captured graph's replay (on a side stream of
    cuda:1), bit-equal, launched on cuda:1 only."""
    import torch

    from vfr_tpu_torch.ops.kernels import score_kernel

    dev1 = torch.device("cuda", 1)
    gen = torch.Generator(device=dev1).manual_seed(int(gen0.initial_seed()))
    a, m = _score_operands(256, SCORE_SHARD, gen, dev1)
    before = dict(score_kernel.DEVICE_LAUNCHES)
    rec, eager = _score_case(a, m, "shard_cuda1")
    with torch.cuda.device(dev1):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            score_kernel.score_gemm(a, m)           # the warm-up
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = score_kernel.score_gemm(a, m)
        graph.replay()
        torch.cuda.synchronize()
    grown = {d: n - before.get(d, 0)
             for d, n in score_kernel.DEVICE_LAUNCHES.items()
             if n != before.get(d, 0)}
    rec.update(graph_bit_equal=bool(torch.equal(out, eager)),
               launches_by_device=grown)
    require(rec["graph_bit_equal"], "score_gemm on cuda:1: the graph's "
            "replay differs from the eager call")
    require(set(grown) == {"cuda:1"}, f"score_gemm on cuda:1 launched on "
            f"{grown}")
    return rec


def phase_score_gemm(results, seed: int):
    """The f32 score GEMM (``csrc/score_gemm.cu``) on the flagship's
    operands at Q = 1, 8, 64 and 256 (``_score_case``: held to an f64
    product, its error at most ``SCORE_ERR_RATIO`` x torch.matmul's), and
    with two cards or more a shard on cuda:1 (``_score_second_card``)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    recs = []
    for Q in SCORE_QS:
        a, m = _score_operands(Q, SCORE_N, gen, dev)
        recs.append(_score_case(a, m, f"Q{Q}")[0])
        del a, m
    if torch.cuda.device_count() > 1:
        second = _score_second_card(gen)
    else:
        second = dict(ran=False, why="one card: the cuda:1 shard needs two")
        emit({"phase": "kernel_score_gemm_second_card", **second})
    results["score_gemm"] = dict(times=recs, second_card=second)


# (B, T, H, P, G, N, largest dt, zxd's dtype): the published widths at a
# short and a long decay and at the bulk cells' batch, then other head and
# state widths: a group's share of B and C too narrow for 16-byte loads, the
# tiny test world (rows not 16-byte aligned), T past the kernel's chunk of
# 32 (one and two carries of the state), and f32
MAMBA2_CASES = (
    (64, 24, 64, 64, 8, 128, 0.1, "bfloat16"),
    (64, 24, 64, 64, 8, 128, 1.0, "bfloat16"),
    (256, 24, 64, 64, 8, 128, 0.1, "bfloat16"),
    (5, 40, 8, 16, 2, 16, 1.0, "bfloat16"),
    (6, 8, 4, 16, 2, 16, 1.0, "bfloat16"),
    (3, 7, 4, 32, 2, 32, 1.0, "bfloat16"),
    (4, 70, 4, 128, 1, 64, 0.5, "bfloat16"),
    (16, 24, 64, 64, 8, 128, 1.0, "float32"),
)
# of the largest |y|, against the f32 chain: the kernel rounds each element
# once to its dtype (bf16: at most half an ulp of the largest element, 2^-8
# of it; 2.4e-3 to 3.1e-3 seen on the CPU's plain chain), and its f32 sums
# in another order add ~1e-6; 2^-7 is one bf16 ulp of the output's scale
MAMBA2_TOL = 2.0 ** -7


def _mamba2_inputs(Bsz, T, H, P, G, N, dt_max, dtype, gen, dev, lo=0):
    """zxd [Bsz, T, 2 H P + 2 G N + H] and a Mamba-2 layer's leaves: dt
    after its softplus in (1e-3, dt_max) through dt_bias, A in -1..-16, D in
    0.5..1.5, lengths in [lo, T]."""
    import torch

    di, conv = H * P, H * P + 2 * G * N
    zxd = torch.randn(Bsz, T, di + conv + H, generator=gen, device=dev)
    zxd[..., di + conv:] *= 0.5
    dt0 = 1e-3 + (dt_max - 1e-3) * torch.rand(H, generator=gen, device=dev)
    leaves = dict(
        conv_w=(0.5 * torch.randn(conv, 4, generator=gen, device=dev)
                ).to(dtype),
        conv_b=(0.1 * torch.randn(conv, generator=gen, device=dev)).to(dtype),
        dt_bias=dt0 + torch.log(-torch.expm1(-dt0)),
        A_log=torch.log(1.0 + 15.0 * torch.rand(H, generator=gen,
                                                device=dev)),
        D=0.5 + torch.rand(H, generator=gen, device=dev),
        norm_w=(1.0 + 0.1 * torch.randn(di, generator=gen, device=dev)
                ).to(dtype))
    lens = torch.randint(lo, T + 1, (Bsz,), generator=gen, device=dev)
    return zxd.to(dtype), lens, leaves


def phase_mamba2_scan(results, seed: int):
    """The fused Mamba-2 kernel (``csrc/mamba2_scan.cu``, the Nemotron-H
    tower's: conv, SiLU, dt, the scan, the D skip and the gated norm)
    against the chain's plain version in f32 (``mamba2_chain_plain``) over
    ``MAMBA2_CASES`` at random lengths (0 included), to ``MAMBA2_TOL``,
    rows past each length exactly 0; a CUDA graph's replay bit-equal to
    the eager call; then its time at the cell's shape (256 queries of 4-24
    tokens, 64 heads of 64, 8 groups of 128) beside its bound (zxd's live
    rows read once, y written once; the matrix form's f32 operations), the
    PyTorch passes it replaced (conv, SiLU, softplus, gated norm; the
    scan-only kernel of before is not among them) and the plain chain."""
    import torch
    import torch.nn.functional as F

    from vfr_tpu_torch.ops.kernels import mamba2_kernel as mk
    from vfr_tpu_torch.ops.mamba2 import causal_conv, gated_rmsnorm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    eps = 1e-5

    def run(zxd, lens, p, G, fn=mk.mamba2_chain, norm_w=None):
        return fn(zxd, lens, p["conv_w"], p["conv_b"], p["dt_bias"],
                  p["A_log"], p["D"], p["norm_w"] if norm_w is None
                  else norm_w, G, eps)

    checks = []
    for Bsz, T, H, P, G, N, dt_max, dtype in MAMBA2_CASES:
        zxd, lens, p = _mamba2_inputs(Bsz, T, H, P, G, N, dt_max,
                                      getattr(torch, dtype), gen, dev)
        got = run(zxd, lens, p, G).float()
        want = run(zxd, lens, p, G, mk.mamba2_chain_plain,
                   p["norm_w"].float())
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        dead = torch.arange(T, device=dev)[None, :] >= lens[:, None]
        checks.append(dict(shape=[Bsz, T, H, P, G, N], dt_max=dt_max,
                           dtype=dtype, rel_err=err,
                           dead_rows=int(dead.sum()),
                           dead_zero=not bool(got[dead].any())))
        require(err <= MAMBA2_TOL and checks[-1]["dead_zero"],
                f"mamba2_rnn_scan {checks[-1]}")
    emit({"phase": "kernel_mamba2_scan_checks", "cases": checks})

    Bsz, T, H, P, G, N = 256, 24, 64, 64, 8, 128
    zxd, lens, p = _mamba2_inputs(Bsz, T, H, P, G, N, 0.1, torch.bfloat16,
                                  gen, dev, lo=4)
    eager = run(zxd, lens, p, G)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(zxd, lens, p, G)                        # the warm-up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = run(zxd, lens, p, G)
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(out, eager), "mamba2_rnn_scan: the graph's replay "
            "differs from the eager call")

    di, conv = H * P, H * P + 2 * G * N
    y32 = torch.randn(Bsz, T, di, generator=gen, device=dev)

    def passes():
        F.silu(causal_conv(zxd[..., di:di + conv], p["conv_w"], p["conv_b"]))
        F.softplus(zxd[..., di + conv:].float() + p["dt_bias"]).contiguous()
        return gated_rmsnorm(y32, zxd[..., :di], p["norm_w"], di // G, eps)

    n = lens.double()
    live = float(n.sum())
    pairs = float((n * (n + 1) / 2).sum())
    flops = 2.0 * live * conv * 4 + 2.0 * pairs * (G * N + H * P)
    nbytes = (live * (2 * di + 2 * G * N + H) + Bsz * T * di) * 2
    bound_ms, bound_by = bound(nbytes, flops, "float32")
    rec = dict(
        name="mamba2_rnn_scan", shape=[Bsz, T, H, P, G, N],
        ms=cuda_ms(lambda: run(zxd, lens, p, G)),
        passes_ms=cuda_ms(passes),
        plain_ms=cuda_ms(lambda: run(zxd, lens, p, G, mk.mamba2_chain_plain),
                         iters=3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by,
        recurrent_ops_ms=bound(0.0, 5.0 * P * N * H * live, "float32")[0],
        graph_bit_equal=True)
    emit({"phase": "kernel_mamba2_scan_time", **rec})
    results["mamba2_scan"] = dict(checks=checks, time=rec)


# (B, T, H, D, qkv's dtype, shortest length): the Kimi Linear cell's shape
# (256 queries of 4-24 tokens, 32 heads of 128) at bf16 and f32, then one
# whole chunk of 64 tokens, a single token, and the other head widths the
# kernel takes (lengths from 0)
KDA_CASES = (
    (256, 24, 32, 128, "bfloat16", 4),
    (64, 24, 32, 128, "float32", 4),
    (5, 64, 4, 128, "bfloat16", 0),
    (3, 1, 2, 32, "bfloat16", 0),
    (7, 37, 3, 64, "float32", 0),
    (2, 17, 1, 96, "bfloat16", 0),
)
# of the largest |o|, against the plain recurrence in f32 from the same
# rounded inputs: both f32 throughout, the kernel's sums (the pairs' dots,
# the solve, the read-out) in another order than the step recurrence's
KDA_TOL = 1e-4


def _kda_inputs(B, T, H, D, dtype, lo, gen, dev):
    """qkv [B, T, 3 H D + 5] (spare columns past v), per-channel log decays
    -exp(U(-7, 2)) (some channels keep the state, some forget it within a
    token), beta in (0, 1) and lengths in [lo, T]."""
    import torch

    HD = H * D
    qkv = torch.randn(B, T, 3 * HD + 5, generator=gen, device=dev).to(dtype)
    g = -torch.exp(torch.empty(B, T, HD, device=dev).uniform_(
        -7.0, 2.0, generator=gen))
    beta = torch.rand(B, T, H, generator=gen, device=dev)
    lens = torch.randint(lo, T + 1, (B,), generator=gen, device=dev)
    return qkv, g, beta, lens


def phase_kda_chunk(results, seed: int):
    """The KDA kernel (``csrc/kda_chunk.cu``, the Kimi Linear tower's: the
    gated delta rule of one chunk in its matrix form, q and k L2-normed in
    it) against the plain recurrence in f32 (``kda_recurrence_plain``)
    over ``KDA_CASES`` at random lengths, to ``KDA_TOL``, rows past each
    length exactly 0; a CUDA graph's replay bit-equal to the eager call; a
    sequence past one chunk refused; then its time at the cell's shape
    beside its bound (q, k, v's live rows, g and beta read once, o written
    once; the form's f32 operations, as ``vfrbench/towers/kimi_linear.py``
    counts them) and the plain recurrence's."""
    import torch

    from vfr_tpu_torch.ops.kernels import kda_kernel as kk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 37)
    eps = 1e-6

    def plain(qkv, g, beta, lens, H, fn=kk.kda_recurrence_plain):
        B, T, _ = qkv.shape
        HD = g.shape[-1]
        q, k, v = (qkv[..., i * HD:(i + 1) * HD].float().reshape(
            B, T, H, HD // H) for i in range(3))
        return fn(q, k, v, g.reshape(B, T, H, HD // H), beta, lens,
                  (HD // H) ** -0.5, eps)

    checks = []
    for B, T, H, D, dtype, lo in KDA_CASES:
        qkv, g, beta, lens = _kda_inputs(B, T, H, D, getattr(torch, dtype),
                                         lo, gen, dev)
        got = kk.kda_attend(qkv, g, beta, lens, H, D ** -0.5, eps)
        want = plain(qkv, g, beta, lens, H)
        chunk = plain(qkv, g, beta, lens, H, kk.kda_chunk_plain)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        dead = torch.arange(T, device=dev)[None, :] >= lens[:, None]
        checks.append(dict(
            shape=[B, T, H, D], dtype=dtype, rel_err=err,
            chunk_form_rel_err=float((chunk - want).abs().max()) / scale,
            dead_rows=int(dead.sum()), dead_zero=not bool(got[dead].any())))
        require(err <= KDA_TOL and checks[-1]["dead_zero"],
                f"kda_rnn_chunk {checks[-1]}")
    emit({"phase": "kernel_kda_chunk_checks", "cases": checks})

    qkv, g, beta, lens = _kda_inputs(2, kk.CHUNK + 1, 2, 32, torch.bfloat16,
                                     0, gen, dev)
    try:
        kk.kda_attend(qkv, g, beta, lens, 2, 32 ** -0.5, eps)
        require(False, "kda_rnn_chunk took a sequence past one chunk")
    except ValueError:
        pass

    B, T, H, D = 256, 24, 32, 128
    qkv, g, beta, lens = _kda_inputs(B, T, H, D, torch.bfloat16, 4, gen,
                                     dev)

    def run():
        return kk.kda_attend(qkv, g, beta, lens, H, D ** -0.5, eps)

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                                       # the warm-up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = run()
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(out, eager), "kda_rnn_chunk: the graph's replay "
            "differs from the eager call")

    n = lens.double()
    live = float(n.sum())
    pairs = float((n * (n + 1) / 2).sum())
    HD = H * D
    flops = HD * (7.0 * pairs + 2.0 * (pairs - live) + 2.0 * pairs
                  + 4.0 * live)
    nbytes = live * (3 * HD * 2 + HD * 4 + H * 4) + B * T * HD * 4
    bound_ms, bound_by = bound(nbytes, flops, "float32")
    rec = dict(
        name="kda_rnn_chunk", shape=[B, T, H, D],
        ms=cuda_ms(run),
        plain_ms=cuda_ms(lambda: plain(qkv, g, beta, lens, H), iters=3,
                         warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, graph_bit_equal=True)
    emit({"phase": "kernel_kda_chunk_time", **rec})
    results["kda_chunk"] = dict(checks=checks, time=rec)


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


def _device_profile(what: str, work, iters: int = 5, host: bool = False):
    """One JSON line (also returned): device time by CUDA kernel name
    (torch.profiler) of ``work`` per iteration, their sum, the host wall
    time per iteration and the device's busy share of it.  With ``host``
    the host is traced too: its busiest operations and CUDA runtime calls
    by self time, every copy and fill by kind, and the device time by
    card (the wall then includes the host trace's own cost)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    work()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            work()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows, copies, host_rows = [], [], []
    for ev in prof.key_averages():
        # with the host traced, its operations carry their kernels' time
        # too: only the card's own events count as device time
        on_card = getattr(ev, "device_type", None) == DeviceType.CUDA
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and (on_card or not host):
            row = {"name": ev.key[:80], "calls": ev.count // iters,
                   "device_ms_per_iter": dev_us / iters / 1e3}
            rows.append(row)
            if ev.key.startswith(("Memcpy", "Memset")):
                copies.append(row)
        elif host and not on_card and ev.self_cpu_time_total:
            host_rows.append({
                "name": ev.key[:80], "calls": ev.count / iters,
                "self_host_ms_per_iter": ev.self_cpu_time_total / iters
                / 1e3})
    rows.sort(key=lambda r: -r["device_ms_per_iter"])
    busy = sum(r["device_ms_per_iter"] for r in rows)
    rec = {"phase": "profile", "what": what, "wall_ms_per_iter": wall_ms,
           "device_ms_per_iter": busy, "device_busy_share": busy / wall_ms,
           "kernels": rows[:12]}
    if host:
        by_card = {}
        for ev in prof.events():
            if getattr(ev, "device_type", None) == DeviceType.CUDA:
                key = f"cuda:{ev.device_index}"
                by_card[key] = (by_card.get(key, 0.0)
                                + ev.time_range.elapsed_us() / iters / 1e3)
        host_rows.sort(key=lambda r: -r["self_host_ms_per_iter"])
        rec.update(copies=copies, device_ms_per_iter_by_card=by_card,
                   host_self_ms_per_iter=sum(
                       r["self_host_ms_per_iter"] for r in host_rows),
                   host_ops=host_rows[:16])
    emit(rec)
    return rec


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
        scores = fused_corpus_scores(q, m_cat, msq_fused, [0.5, 0.5])
        top_k_select(scores, 10)

    _device_profile("flagship_stages", work)
    del m, m_sq, m32, m32_sq, m_cat, msq_fused
    gw_ih, gw_hh = (pg["w_ih"].to(torch.bfloat16),
                    pg["w_hh"].to(torch.bfloat16))
    _device_profile("gru_pooled", lambda: gru_layer(
        x, lengths, gw_ih, gw_hh, pg["b_ih"], pg["b_hh"], pool="mean"))
    for variant in ("stepwise", "persistent", "persistent_bulk"):
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
        score_kernel,
        select_kernel,
        topk_kernel,
    )

    return (lstm_kernel.LAUNCHES, gru_kernel.LAUNCHES, select_kernel.LAUNCHES,
            coarse_kernel.LAUNCHES, topk_kernel.LAUNCHES,
            score_kernel.LAUNCHES)


ROUTES = ("select.", "score.")


def _route_counts():
    """The recorder's own counters, where ``ops/topk.py`` counts each
    select's route (``select.kernel``, ``select.key64``,
    ``select.order32_tie``) and ``parallel/sharding.py`` each score
    product's off the CPU (``score.kernel``, ``score.library``)."""
    from vfr_tpu_torch.utils import trace

    return trace.counter_dicts()[0]


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


def _device_dicts():
    from vfr_tpu_torch.ops.kernels import (
        coarse_kernel,
        gru_kernel,
        lstm_kernel,
        score_kernel,
        select_kernel,
        topk_kernel,
    )

    return {"lstm": lstm_kernel.DEVICE_LAUNCHES,
            "gru": gru_kernel.DEVICE_LAUNCHES,
            "select": select_kernel.DEVICE_LAUNCHES,
            "coarse": coarse_kernel.DEVICE_LAUNCHES,
            "row_topk": topk_kernel.DEVICE_LAUNCHES,
            "score": score_kernel.DEVICE_LAUNCHES}


def reset_counts():
    for counts in (*_count_dicts(), *_variant_dicts().values()):
        for k in counts:
            counts[k] = 0
    for counts in _device_dicts().values():
        counts.clear()
    routes = _route_counts()
    for k in routes:
        if k.startswith(ROUTES):
            routes[k] = 0


def read_device_counts():
    """Launches of each kernel family by device since ``reset_counts``."""
    return {fam: dict(v) for fam, v in _device_dicts().items()}


def read_counts():
    """Launches by kernel since ``reset_counts``, the selects and score
    products by route (``select.*``, ``score.*``), and under "variants" the
    launches of each kernel family by kernel variant."""
    out = {}
    for counts in _count_dicts():
        out.update(counts)
    out.update((k, n) for k, n in _route_counts().items()
               if k.startswith(ROUTES) and n)
    out["variants"] = {cell: dict(v) for cell, v in _variant_dicts().items()}
    return out


def capture_seconds(g) -> list:
    """Seconds of each capture the ``BatchGraphs`` ``g`` made: its
    ``graphs.capture`` set-up spans in the port's recorder."""
    from vfr_tpu_torch.utils import trace

    return [(b - a) / 1e9 for name, sid, _, a, b in trace.snapshot()["setup"]
            if name == "graphs.capture" and sid == g.id]


def require_persistent(counts, cell: str, what: str,
                       want: str = "persistent", only: bool = False) -> None:
    """The ``cell`` recurrence ran ``want`` (K1 at Q > 64:
    ``persistent_bulk``), never stepwise, and with ``only`` no other
    variant."""
    v = counts["variants"][cell]
    require(v[want] > 0 and v["stepwise"] == 0
            and (not only or sum(v.values()) == v[want]),
            f"{what}: the {cell} recurrence ran {v}, expected {want}"
            f"{' only' if only else ''} and never stepwise")


def require_row_topk(counts, selects, what: str) -> None:
    """The long-row select ran on the kernel ``selects`` times since
    ``reset_counts`` (None: any number but 0): as many ``select.kernel``
    routes, one filter and one merge launch each, and never the 32-bit
    order and its tie pass."""
    n = counts["row_topk_filter"]
    require((n > 0 if selects is None else n == selects)
            and counts["row_topk_merge"] == n
            and counts.get("select.kernel", 0) == n
            and not counts.get("select.order32_tie"),
            f"{what}: wanted {selects or 'some'} long-row selects on the "
            f"kernel, counted filter {n}, merge {counts['row_topk_merge']}, "
            f"routes { {k: c for k, c in counts.items() if k[:7] == 'select.'} }")


def require_score_gemm(counts, products, what: str) -> None:
    """The f32 score product ran on the kernel ``products`` times since
    ``reset_counts`` (None: any number but 0): as many ``score.kernel``
    routes and launches, and none on the library's route."""
    n = counts["score_gemm"]
    require((n > 0 if products is None else n == products)
            and counts.get("score.kernel", 0) == n
            and not counts.get("score.library"),
            f"{what}: wanted {products or 'some'} f32 score products on the "
            f"kernel, counted {n} launches, routes "
            f"{ {k: c for k, c in counts.items() if k[:6] == 'score.'} }")


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


def graph_vs_eager(graphed, eager, batches, what: str, graphs=None):
    """A graphed batch function (``utils/graphs.py``) held to its eager
    one over ``batches`` (argument tuples of different tokens): the
    distances bit for bit and the rows equal on every batch, and each
    kernel's launches per replay equal to its launches per eager call
    (counts zeroed around each call).  The first call captures, outside
    the counted ones.  Returns (the graphed outputs, a record: batches,
    launches per replay, the wrapper's captures, capture seconds and pool
    bytes; ``graphs``, the ``BatchGraphs``, defaults to ``graphed``'s)."""
    import torch

    g = graphs if graphs is not None else graphed.graphs
    graphed(*batches[0])
    torch.cuda.synchronize()
    outs, per_replay = [], None
    for i, args in enumerate(batches):
        reset_counts()
        got = graphed(*args)
        torch.cuda.synchronize()
        c_g = read_counts()
        reset_counts()
        ref = eager(*args)
        torch.cuda.synchronize()
        c_e = read_counts()
        same = (torch.equal(got[0].view(torch.int32),
                            ref[0].view(torch.int32))
                and torch.equal(got[1], ref[1]))
        require(same, f"{what}: the graphed batch {i} is not bit-equal to "
                "the eager one")
        require(c_g == c_e, f"{what}: launches per replay {c_g} != per "
                f"eager call {c_e}")
        per_replay = c_g
        outs.append(got)
    return outs, dict(batches=len(batches), bit_equal=True,
                      launches_per_replay=per_replay, captures=g.captures,
                      capture_s=capture_seconds(g),
                      pool_bytes=g.pool_bytes())


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
    require_persistent(counts, "lstm", "flagship", "persistent_bulk",
                       only=True)
    # one select and one f32 score product a batch, as one K1a a batch
    require_row_topk(counts, counts["lstm_pooled"], "flagship")
    require_score_gemm(counts, counts["lstm_pooled"], "flagship")
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
    # one replay a batch (Q=256) against the eager batch, over five token
    # sets (the four batches and the first one rolled by a query), and each
    # graphed answer held to the plain path's distances
    r_exact = make_retriever(model, loaded, k, "exact")
    batches = [(q_params, toks_d[b], lens_d[b]) for b in range(len(toks))]
    batches.append((q_params, toks_d[0].roll(1, 0), lens_d[0].roll(1, 0)))
    g_outs, graphed = graph_vs_eager(r_exact, r_exact.eager, batches,
                                     "flagship[graph]")
    graphed["vs_plain"] = [
        _exact_rows_vs_plain(model, loaded, *(corpus_mod._embed_query_streams(
            q_params, model, a[1], a[2], rnn_kernel=kern)
            for kern in (None, "plain")), *out)
        for a, out in zip(batches, g_outs)]
    graphed["ms_per_batch"] = time_batches(lambda: r_exact(*batches[1]))
    graphed["eager_ms_per_batch"] = time_batches(
        lambda: r_exact.eager(*batches[1]))
    del r_exact, g_outs
    bf16_compute, bf16_counts = _bf16_compute_rows(cfg, params, loaded,
                                                   toks_d[0], lens_d[0], k)
    first = exact[0]["results"]
    rec = dict(phase="flagship", videos=num_videos, rows=loaded.num_rows,
               queries=n_queries, batch=batch, k=k, launches=counts,
               setup_s=setup_s, index_build_s=build_s,
               serve_queries_s=serve_s, ms_per_batch=ms_batch,
               plain_ms_per_batch=plain_ms_batch, topk=topk,
               rows_differing_from_plain=mism,
               max_distance_diff_vs_plain=ddiff,
               bucketed_identical=True, graph=graphed,
               bf16_compute=bf16_compute)
    emit(rec)
    require(all(np.isfinite(r["distance"]) for r in first)
            and len(first) == k, "flagship: malformed results")
    require(all(a["distance"] <= b["distance"]
                for a, b in zip(first, first[1:])),
            "flagship: distances not ascending")
    require(mism == 0 and ddiff <= 1e-3,
            f"flagship: kernel vs plain: {mism} rows differ, "
            f"max |d diff| {ddiff}")
    require(all(_right_answer(c) for c in graphed["vs_plain"]),
            f"flagship: a graphed batch is not a right answer for the "
            f"plain distances: {graphed['vs_plain']}")
    require_persistent(bf16_counts, "lstm", "flagship[bf16 compute]",
                       "persistent_bulk")
    require(all(_right_answer(c) and c["max_query_diff_vs_plain"] <= QUERY_TOL
                for c in bf16_compute.values()),
            f"flagship[bf16 compute]: not a right answer for the plain "
            f"path: {bf16_compute}")
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
    _, f_graphed = graph_vs_eager(r_fused, r_fused.eager, batches,
                                  "fused[graph]")

    def fused_batches(fn=r_fused):
        return [fn(q_params, toks_d[b], lens_d[b]) for b in range(len(toks))]

    fused_ms = time_batches(fused_batches) / len(toks)
    f_graphed["eager_ms_per_batch"] = time_batches(
        lambda: fused_batches(r_fused.eager)) / len(toks)
    # the same batches eagerly with K2's plain version, and on each kernel
    # variant in turns (eager: a patch reaches the launch, not a replay)
    d_f, rows_f = (torch.stack(t).cpu().numpy()
                   for t in zip(*fused_batches()))
    with mock.patch.object(corpus_mod, "distance_select",
                           distance_select_plain):
        d_fp, rows_fp = (torch.stack(t).cpu().numpy()
                         for t in zip(*fused_batches(r_fused.eager)))
    f_mism, f_ddiff = compare_to_plain(d_f, rows_f, d_fp, rows_fp)
    turns = [t / len(toks) for t in cell_turns(
        corpus_mod, "distance_select", lambda: fused_batches(r_fused.eager))]
    rec = dict(phase="fused", launches=counts, recall_at_10_vs_exact=recall,
               ms_per_batch=fused_ms, graph=f_graphed, variant="mma",
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
                exact_rows=rows_k, exact_d=d_k, k=k, batch=batch, T=T)


def _bf16_compute_rows(cfg, params, index, toks, lens, k):
    """The flagship index under bf16 compute (K1a; the f32 operand
    rounded to bf16 in each product), one graphed batch at full length
    and one at the T = 8 length bucket: the queries through K1a against
    the plain recurrence's (max |diff|) and the answer held to the plain
    path's distances (``_exact_rows_vs_plain``).  Returns the records by
    length and the launch counts of the two batches and their
    embeddings."""
    import torch

    from vfr_tpu_torch.eval.corpus import _embed_query_streams, make_retriever
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import prepare_query_params

    model = build_model(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16")))
    q_params = prepare_query_params(params, model)
    retrieve = make_retriever(model, index, k, "exact")
    out = {}
    reset_counts()
    with torch.no_grad():
        for T in (toks.shape[1], 8):
            t, n = toks[:, :T].contiguous(), torch.clamp(lens, max=T)
            d, r = retrieve(q_params, t, n)
            q_k, q_p = (_embed_query_streams(q_params, model, t, n,
                                             rnn_kernel=kern)
                        for kern in (None, "plain"))
            out[f"T{T}"] = dict(
                max_query_diff_vs_plain=float((q_k - q_p).abs().max()),
                **_exact_rows_vs_plain(model, index, q_k, q_p, d, r))
    return out, read_counts()


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

    m_cat, msq = prep_score_operands(index)
    with torch.no_grad():
        qs = _embed_query_streams(params, model, toks, lens)
        scores = fused_corpus_scores(qs, m_cat, msq, index.weights,
                                     model.compute_dtype)
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


RECHECK_REL_TOL = 1e-5   # |d - d'| over the distance's terms (f32 sums)


def recheck_rows(model, q_params, index, toks, lens, d, rows):
    """Checks of a prefilter's run over batches ``toks [M, Q, T]`` (``d``,
    ``rows`` [M, Q, k] on the host) that a plain run cannot give row for
    row (a query moved by the kernel's rounding may pick another block at
    a near-tie of stage 1, and so another candidate set):
    (max |q - q_plain|: the query streams through the recurrence kernel,
    as the retriever ran it, against its plain version, held to the
    kernel checks' 2e-3; max |d - d'| / scale: d' the fused distance
    recomputed from ``index``'s own rows at the reported global ids with
    those queries, scale = sum_s w_s (|q_s|^2 + |m_s|^2), the terms the
    two f32 orders of summation round, held to ``RECHECK_REL_TOL``; a
    wrong global row is off by the distance's spread instead)."""
    import torch

    from vfr_tpu_torch.eval.corpus import _embed_query_streams

    w = [float(x) for x in np.asarray(index.weights, np.float32)]
    q_err = rel = 0.0
    for b in range(toks.shape[0]):
        qs = _embed_query_streams(q_params, model, toks[b], lens[b])
        qp = _embed_query_streams(q_params, model, toks[b], lens[b],
                                  "plain")                        # [S, Q, d]
        q_err = max(q_err, float((qs - qp).abs().max()))
        r = torch.as_tensor(rows[b], device=qs.device).long()     # [Q, k]
        dd = scale = 0.0
        for s_, q in enumerate(qs):
            qm = (index.m[s_][r].float() * q[:, None, :]).sum(-1)
            terms = (q * q).sum(-1)[:, None] + index.m_sq[s_][r]
            dd = dd + w[s_] * (terms - 2.0 * qm)
            scale = scale + w[s_] * terms
        got = torch.as_tensor(d[b], device=qs.device)
        rel = max(rel, float(((got - dd).abs() / scale).max()))
    return q_err, rel


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


# --------------------------------------------------------------- devices

def _time_on(fn, dev, repeats: int = 5) -> float:
    """Median host ms of ``fn`` ended by a sync of ``dev`` (not of the
    current device, which stays cuda:0)."""
    import torch

    fn()
    torch.cuda.synchronize(dev)
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        out.append(time.perf_counter() - t0)
    return float(np.median(out)) * 1e3


def phase_devices(results, ctx, workdir: str, d_coarse: int = 32,
                  C: int = 2048):
    """The kernels on a card other than the current one.  With two or
    more cards: one flagship batch (256 queries, top-10) served with the
    params and the index on cuda:1 while cuda:0 stays current, exact
    (K1a), fused (K1a + K2) and coarse blockmax (K1a + K4), each held to
    the same batch on cuda:0 (rows equal outside near-ties, distances
    within 1e-3); each kernel (the exact select's ``row_topk`` too) must
    have launched on cuda:1 and on no other card; then ``cli serve --device cuda:1`` as a subprocess.  With one
    card it prints one line saying it did not run and why."""
    import torch

    from vfr_tpu_torch.eval import coarse as coarse_mod
    from vfr_tpu_torch.eval.corpus import load_index, make_retriever
    from vfr_tpu_torch.models.mcn import prepare_query_params
    from vfr_tpu_torch.utils.tree import tree_map

    n = torch.cuda.device_count()
    if n < 2:
        rec = dict(phase="devices", ran=False, cards=n,
                   reason=f"{n} CUDA device visible: serving on a second "
                          "card needs two")
        emit(rec)
        results["devices"] = rec
        return
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    require(torch.cuda.current_device() == 0,
            f"devices: the current device is {torch.cuda.current_device()}")
    model, k = ctx["model"], ctx["k"]
    index0 = ctx["index"]
    index1 = load_index(os.path.join(workdir, "flagship_index.npz"),
                        device=d1)
    coarse0 = ctx.get("coarse") or coarse_mod.build_coarse_index(
        index0, d_coarse=d_coarse)
    coarse1 = coarse_mod.load_coarse(coarse_mod.save_coarse(
        coarse0, os.path.join(workdir, "devices.coarse.npz")), index1)
    q0 = ctx["q_params"]
    q1 = prepare_query_params(tree_map(lambda t: t.to(d1), ctx["params"]),
                              model)
    toks0, lens0 = ctx["toks"][0], ctx["lens"][0]
    toks1, lens1 = toks0.to(d1), lens0.to(d1)
    cells = (
        ("exact", ("lstm", "row_topk", "score"),
         lambda idx, crs: make_retriever(model, idx, k, "exact")),
        ("fused", ("lstm", "select"), lambda idx, crs: make_retriever(
            model, idx, k, "fused")),
        ("coarse_blockmax", ("lstm", "coarse"),
         lambda idx, crs: coarse_mod.make_coarse_retriever(
             model, crs, k, num_candidates=C, mode="blockmax")))
    rec = dict(phase="devices", ran=True, cards=n, batch=toks0.shape[0],
               k=k, rows=index0.num_rows)
    launches = {}
    for tag, families, make in cells:
        r0, r1 = make(index0, coarse0), make(index1, coarse1)
        d_ref, rows_ref = (t.cpu().numpy() for t in r0(q0, toks0, lens0))
        reset_counts()
        out = r1(q1, toks1, lens1)
        torch.cuda.synchronize(d1)
        counts, by_dev = read_counts(), read_device_counts()
        require(all(t.device == d1 for t in out),
                f"devices[{tag}]: results on {[t.device for t in out]}")
        d_1, rows_1 = (t.cpu().numpy() for t in out)
        mism, ddiff = compare_to_plain(d_1, rows_1, d_ref, rows_ref)
        _add_counts(launches, counts)
        rec[tag] = dict(
            launches_by_device={f: by_dev[f] for f in families},
            rows_differing_from_cuda0=mism,
            max_distance_diff_vs_cuda0=ddiff,
            bit_equal_to_cuda0=bool(np.array_equal(d_1, d_ref)
                                    and np.array_equal(rows_1, rows_ref)),
            ms_per_batch_cuda1=_time_on(lambda: r1(q1, toks1, lens1), d1),
            ms_per_batch_cuda0=_time_on(lambda: r0(q0, toks0, lens0), d0))
        for fam in families:
            require(by_dev[fam].get(str(d1), 0) > 0
                    and set(by_dev[fam]) == {str(d1)},
                    f"devices[{tag}]: {fam} launched {by_dev[fam]}, wanted "
                    "cuda:1 only")
        require(mism == 0 and ddiff <= 1e-3,
                f"devices[{tag}]: cuda:1 vs cuda:0: {mism} rows differ, "
                f"max |d diff| {ddiff}")
    # the CLI on the second card, in a process of its own
    queries = make_queries(ctx["vocab"], 8, ctx["T"], SEED + 29)
    out, cli_s = _cli_subprocess(
        ["serve", "--preset", "didemo_flagship", "--data-dir",
         os.path.join(workdir, "devices_nodata"), "--queries", "-",
         "--topk", "5", "--device", "cuda:1"], "\n".join(queries) + "\n")
    lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    require(len(lines) == len(queries) and all(
        len(x["results"]) == 5
        and all(np.isfinite(r["distance"]) for r in x["results"])
        and all(a["distance"] <= b["distance"]
                for a, b in zip(x["results"], x["results"][1:]))
        for x in lines), f"devices: cli serve --device cuda:1 answered "
        f"{out[-2000:]}")
    rec.update(cli_serve_cuda1=dict(queries=len(queries), seconds=cli_s),
               launches=launches)
    emit(rec)
    results["devices"] = rec


# --------------------------------------------------------------- sharded

def corpus_mesh(n: int, axis: str = "corpus", phase: str = "sharded_mesh"):
    """A mesh of ``n`` devices on ``axis``: ``n`` distinct cards when that
    many are visible, else the first card ``n`` times; its devices and how
    many cards are distinct go out on a line of their own."""
    import torch

    from vfr_tpu_torch.parallel.mesh import make_mesh

    devices = ([torch.device("cuda", i) for i in range(n)]
               if torch.cuda.device_count() >= n
               else [torch.device("cuda", 0)] * n)
    emit({"phase": phase, "shards": n,
          "devices": [str(d) for d in devices],
          "distinct_cards": len(set(devices))})
    return make_mesh((axis,), devices=devices)


def _sharded_record(results, part: str, counts, rec: dict):
    """Emit one part of the sharded phase, keep it, and add its launches
    (counted around its own runs only) to the phase's."""
    out = results.setdefault("sharded", {"launches": {}})
    _add_counts(out["launches"], counts)
    out[part] = dict(launches=counts, **rec)
    emit({"phase": "sharded", "part": part, "launches": counts, **rec})


def phase_sharded(results, ctx, d_coarse: int = 32, C: int = 2048):
    """The flagship index (210,000 rows) row-sharded over a "corpus" mesh
    (``corpus_mesh``): exact serving at SHARDS (K1a; each run held to the
    unsharded retriever's results and to itself through K1a's plain
    version; host syncs per batch), coarse at 4 shards (blockmax: K4 on
    every shard, held to itself through K4's plain version; centroid; in
    both modes K1a's queries held to its plain version and every returned
    row's distance to the one recomputed from the index
    (``recheck_rows``); recall@10
    vs exact; the full quota held to exact) and corpus eval at 4 shards (official protocol, GT ranker;
    exact and coarse blockmax, held to the unsharded runs within 0.1% of
    the queries)."""
    from unittest import mock

    import torch

    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.eval import coarse as coarse_mod
    from vfr_tpu_torch.eval.corpus import (
        corpus_evaluate,
        make_retriever,
        make_stream_retriever,
    )
    from vfr_tpu_torch.ops.kernels.coarse_kernel import coarse_blockmax_plain
    from vfr_tpu_torch.ops.topk import KEY_MAX

    q_params, model, index, k = (ctx["q_params"], ctx["model"],
                                 ctx["index"], ctx["k"])
    toks, lens = ctx["toks"], ctx["lens"]
    M = toks.shape[0]
    d_ref, r_ref = ctx["exact_d"], ctx["exact_rows"]

    def batches(r, Q=None):
        return [r(q_params, toks[b, :Q], lens[b, :Q]) for b in range(M)]

    def host(outs):
        return tuple(torch.stack(t).cpu().numpy() for t in zip(*outs))

    unsharded = make_stream_retriever(model, index, k, "exact")
    unsharded_ms = time_batches(lambda: unsharded(q_params, toks, lens)) / M
    del unsharded
    meshes = {}
    for n in SHARDS:
        mesh = meshes[n] = corpus_mesh(n)
        r = make_retriever(model, index, k, mesh=mesh)
        reset_counts()
        d_s, r_s = host(batches(r))
        counts = read_counts()
        require(counts["lstm_pooled"] > 0,
                f"sharded[exact n={n}]: K1a never launched")
        require_persistent(counts, "lstm", f"sharded[exact n={n}]",
                           "persistent_bulk")
        # a shard's rows past KEY_MAX select on the kernel, once a batch on
        # its own card; shorter shards take the 64-bit key
        devs = [str(d) for d in mesh.axis_devices("corpus")]
        on_kernel = -(-index.num_rows // n) > KEY_MAX
        require_score_gemm(counts, n * M, f"sharded[exact n={n}]")
        if on_kernel:
            require_row_topk(counts, n * M, f"sharded[exact n={n}]")
        else:
            require(counts["row_topk_filter"] == 0,
                    f"sharded[exact n={n}]: the kernel ran on short shards")
        by_dev = read_device_counts()["row_topk"]
        want = {d: M * devs.count(d) for d in set(devs)} if on_kernel else {}
        require(by_dev == want, f"sharded[exact n={n}]: row_topk launched "
                f"{by_dev} by device, wanted {want}")
        mism, ddiff = compare_to_plain(d_s, r_s, d_ref, r_ref)
        plain = make_retriever(model, index, k, rnn_kernel="plain",
                               mesh=mesh)
        d_p, r_p = host(batches(plain))
        del plain
        p_mism, p_ddiff = compare_to_plain(d_s, r_s, d_p, r_p)
        syncs = _steady_syncs(lambda: r(q_params, toks[0], lens[0]))
        n_loc = -(-index.num_rows // n)
        _sharded_record(results, f"exact_n{n}", counts, dict(
            shards=n, rows_per_shard=n_loc, batch=toks.shape[1], k=k,
            ms_per_batch=time_batches(lambda: batches(r)) / M,
            unsharded_ms_per_batch=unsharded_ms,
            host_syncs_per_batch=sum(syncs.values()),
            host_syncs_by_line=syncs,
            rows_differing_from_unsharded=mism,
            max_distance_diff_vs_unsharded=ddiff,
            rows_differing_from_plain=p_mism,
            max_distance_diff_vs_plain=p_ddiff))
        del r
        require(mism == 0 and ddiff <= 1e-3,
                f"sharded[exact n={n}] vs unsharded: {mism} rows differ, "
                f"max |d diff| {ddiff}")
        require(p_mism == 0 and p_ddiff <= 1e-3,
                f"sharded[exact n={n}] vs plain K1a: {p_mism} rows differ, "
                f"max |d diff| {p_ddiff}")
        require(sum(syncs.values()) == 0,
                f"sharded[exact n={n}]: host syncs {syncs}")

    mesh = meshes[4]
    coarse = ctx.get("coarse") or coarse_mod.build_coarse_index(
        index, d_coarse=d_coarse)
    # the full quota (every block of every shard): exact, on 16 queries
    # (stage 2 gathers a shard's whole rows per query)
    full = coarse_mod.make_sharded_coarse_retriever(
        model, coarse, k, mesh,
        num_candidates=coarse.num_blocks * coarse.block_rows)
    d_f, r_f = host(batches(full, 16))
    del full
    f_mism, f_ddiff = compare_to_plain(d_f, r_f, d_ref[:, :16],
                                       r_ref[:, :16])
    rec = dict(shards=4, d_coarse=coarse.d_coarse, candidates=C,
               blocks_per_shard=-(-coarse.num_blocks // 4),
               full_quota_rows_differing_from_exact=f_mism,
               full_quota_max_distance_diff_vs_exact=f_ddiff)
    require(f_mism == 0 and f_ddiff <= 1e-3,
            f"sharded[coarse] full quota vs exact: {f_mism} rows differ, "
            f"max |d diff| {f_ddiff}")
    counts = {}
    for mode in ("blockmax", "centroid"):
        r = coarse_mod.make_sharded_coarse_retriever(
            model, coarse, k, mesh, num_candidates=C, mode=mode)
        reset_counts()
        d_m, r_m = host(batches(r))
        counts[mode] = read_counts()
        by_dev = read_device_counts()
        require(bool(np.isfinite(d_m).all())
                and d_m.shape == (M, toks.shape[1], k)
                and 0 <= r_m.min() and r_m.max() < index.num_rows,
                f"sharded[coarse {mode}]: malformed results")
        q_err, rel = recheck_rows(model, q_params, index, toks, lens, d_m,
                                  r_m)
        rec[mode] = dict(
            launches=counts[mode],
            ms_per_batch=time_batches(lambda: batches(r)) / M,
            recall_at_10_vs_exact=_recall(r_m, r_ref),
            max_query_diff_vs_plain_k1a=q_err,
            max_rel_distance_diff_vs_recomputed=rel)
        require(counts[mode]["lstm_pooled"] > 0,
                f"sharded[coarse {mode}]: K1a never launched")
        require(q_err <= 2e-3 and rel <= RECHECK_REL_TOL,
                f"sharded[coarse {mode}]: queries vs plain K1a {q_err}, "
                f"returned distances vs recomputed (relative) {rel}")
        if mode == "blockmax":
            with mock.patch.object(coarse_mod, "coarse_blockmax",
                                   coarse_blockmax_plain):
                d_p, r_p = host(batches(r))
            mism, ddiff = compare_to_plain(d_m, r_m, d_p, r_p)
            rec[mode].update(variant="mma", rows_differing_from_plain=mism,
                             max_distance_diff_vs_plain=ddiff,
                             k4_launches_by_device=by_dev["coarse"])
            require(counts[mode]["coarse_blockmax"] > 0,
                    "sharded[coarse]: K4 never launched under blockmax")
            shard_devs = {str(d) for d in mesh.axis_devices("corpus")}
            require(set(by_dev["coarse"]) == shard_devs,
                    f"sharded[coarse]: K4 launched on {by_dev['coarse']}, "
                    f"the shards live on {sorted(shard_devs)}")
            require_mma(counts[mode], "coarse", "sharded[coarse]")
            require(mism == 0 and ddiff <= 1e-3,
                    f"sharded[coarse] vs plain K4: {mism} rows differ, "
                    f"max |d diff| {ddiff}")
    both = {}
    for c in counts.values():
        _add_counts(both, c)
    _sharded_record(results, "coarse", both, rec)

    # corpus eval at 4 shards, each held to the unsharded run of the eval
    # phase (run here when it did not run); coarse blockmax also to itself
    # through the plain versions (its per-shard quotas pick another
    # candidate set than the unsharded retriever, as in the JAX package)
    cfg, params, ds = ctx["cfg"], ctx["params"], ctx["ds"]
    base = dataclasses.replace(cfg.eval, protocol="didemo_official",
                               rnn_kernel="pallas")
    banks = ctx.get("banks")
    if banks is None:
        banks = banks_to_device(ds.feature_banks(), base.bank_dtype,
                                device=torch.device("cuda"))
    runs = EvalRuns(ds.num_queries)
    diffs, counts = {}, {}

    def corpus(e, **kw):
        return lambda: corpus_evaluate(params, model, ds, e,
                                       feature_banks=banks, **kw)

    for tag, kw, kernels in (
            ("exact", {}, ("lstm_pooled",)),
            ("coarse", dict(coarse_dim=d_coarse, coarse_candidates=C,
                            coarse_mode="blockmax"),
             ("lstm_pooled", "coarse_blockmax"))):
        e = dataclasses.replace(base, **kw)
        unsharded = results.get("eval", {}).get("runs", {}).get(
            f"corpus_{tag}_pallas", {}).get("metrics")
        if unsharded is None:
            unsharded, _ = runs(f"corpus_{tag}_unsharded", corpus(e))
        got, counts[tag] = runs(f"corpus_{tag}_sharded4", corpus(e, mesh=mesh))
        require(list(got) == corpus_keys(base, ds),
                f"sharded[eval {tag}]: keys {list(got)}")
        for name in kernels:
            require(counts[tag][name] > 0,
                    f"sharded[eval {tag}]: {name} never launched")
        diffs[tag] = metrics_close(got, unsharded, f"sharded[eval {tag}]")
        if tag == "coarse":
            plain, _ = runs(f"corpus_{tag}_sharded4_plain",
                            corpus(dataclasses.replace(e, rnn_kernel="plain"),
                                   mesh=mesh),
                            patches=_plain_patches(kernels))
            diffs["coarse_vs_plain"] = metrics_close(
                got, plain, "sharded[eval coarse] vs plain")
    require_mma(counts["coarse"], "coarse", "sharded[eval coarse]")
    both = {}
    for c in counts.values():
        _add_counts(both, c)
    _sharded_record(results, "eval", both, dict(
        shards=4, queries=ds.num_queries, max_metric_diff_vs_unsharded=diffs,
        runs={t: {x: v for x, v in r.items() if x != "launches"}
              for t, r in runs.runs.items()}))


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
    ctx["banks"] = banks
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
    require_persistent(k_counts, "lstm", "eval[per-video, batch "
                       f"{base.eval_batch_size}]", "persistent_bulk")
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


_CHARADES_FIXTURES = {}


def _charades_fixture(num_videos: int, seed: int):
    """(cfg, fixture): charades_flagship over a synthetic Charades-STA
    corpus of ``num_videos`` videos with 2 planted moments and one query
    per moment; built once per (size, seed) for the phases that share it
    (eval_charades, train_charades)."""
    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.data.synthetic import make_charades_fixture

    key = (num_videos, seed)
    if key not in _CHARADES_FIXTURES:
        cfg = get_preset("charades_flagship")
        data = dataclasses.replace(cfg.data, synthetic_num_videos=num_videos,
                                   synthetic_num_queries=2 * num_videos,
                                   synthetic_moments_per_video=2,
                                   synthetic_seed=seed)
        cfg = dataclasses.replace(cfg, data=data)
        fix = make_charades_fixture(
            num_videos=num_videos, num_queries=2 * num_videos,
            feature_dim=data.feature_dim, glove_dim=data.glove_dim,
            max_duration=data.max_duration,
            feature_seconds=data.feature_seconds,
            noise=data.synthetic_noise, with_flow=False,
            vocab_words=data.synthetic_vocab_words, moments_per_video=2,
            seed=seed)
        _CHARADES_FIXTURES[key] = (cfg, fix)
    return _CHARADES_FIXTURES[key]


def make_charades_corpus(num_videos: int, seed: int):
    """(cfg, dataset, vocab, glove): charades_flagship over the synthetic
    corpus of ``_charades_fixture``, every query in one dataset."""
    from vfr_tpu_torch.data.charades import CharadesSTADataset

    cfg, fix = _charades_fixture(num_videos, seed)
    ds = CharadesSTADataset(fix.annotations, fix.rgb, None, fix.vocab,
                            cfg.data)
    require(len(ds.video_ids) == num_videos,
            f"charades corpus has {len(ds.video_ids)} videos, wanted "
            f"{num_videos}")
    return cfg, ds, fix.vocab, fix.glove


def phase_eval_charades(results, seed: int, num_videos: int,
                        shards: int = 0):
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
    require_persistent(k_counts, "lstm", "eval_charades[per-video, batch "
                       f"{base.eval_batch_size}]", "persistent_bulk")
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
    if shards:
        # corpus exact over a "corpus" mesh, held to the unsharded run
        mesh = corpus_mesh(shards)
        sruns = EvalRuns(ds.num_queries)
        e = dataclasses.replace(base, rnn_kernel="pallas")
        s_m, s_counts = sruns("corpus_exact_sharded", lambda: corpus_evaluate(
            params, model, ds, e, feature_banks=banks, mesh=mesh))
        s_diff = metrics_close(s_m, runs.runs["corpus_exact_pallas"][
            "metrics"], "sharded[eval_charades]")
        require(s_counts["lstm_hs"] > 0,
                "sharded[eval_charades]: K1b never launched")
        run = sruns.runs["corpus_exact_sharded"]
        _sharded_record(results, "eval_charades", s_counts, dict(
            shards=shards, queries=ds.num_queries,
            max_metric_diff_vs_unsharded=s_diff, seconds=run["seconds"],
            queries_per_s=run["queries_per_s"], metrics=s_m,
            unsharded_seconds=runs.runs["corpus_exact_pallas"]["seconds"]))

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


def phase_coarse_2m(results, seed: int, num_videos: int, shards: int = 0,
                    trace: bool = False):
    """2.1M-row serving: exact full scan vs the coarse retriever; with
    ``shards``, both again over a "corpus" mesh (the full scan held to the
    unsharded one, blockmax C=2048 with K4 on every shard)."""
    import torch

    from vfr_tpu_torch.eval import coarse as coarse_mod
    from vfr_tpu_torch.eval.coarse import make_coarse_score_topk
    from vfr_tpu_torch.eval.corpus import make_score_topk

    w = _coarse_2m_setup(seed, num_videos)
    model, coarse, k = w["model"], w["coarse"], w["k"]
    args = (w["params"], w["toks"], w["lens"])
    Q, N = w["toks"].shape[0], w["index"].num_rows
    full = make_score_topk(model, w["index"], k, w["cfg"].eval.topk_method)
    d_full, rows_full = full(*args)
    d_full = d_full.cpu().numpy()
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
    if shards:
        _coarse_2m_sharded(results, w, shards, d_full, rows_full,
                           trace=trace)


def _coarse_2m_sharded(results, w, n: int, d_full, rows_full,
                       C: int = 2048, trace: bool = False):
    """The 2.1M-row index over ``n`` shards: the exact full scan (held to
    the unsharded one) and blockmax at C (K4 on every shard, ``mma``; its
    results checked for shape, finiteness and row range, held to the same
    retriever through K4's plain version; K1b's queries held to its plain
    version and every returned row's distance to the one recomputed from
    the index, ``recheck_rows``)."""
    from unittest import mock

    import torch

    from vfr_tpu_torch.eval import coarse as coarse_mod
    from vfr_tpu_torch.eval.coarse import (
        make_coarse_score_topk,
        make_sharded_coarse_retriever,
    )
    from vfr_tpu_torch.eval.corpus import make_retriever
    from vfr_tpu_torch.ops.kernels.coarse_kernel import coarse_blockmax_plain

    model, index, coarse, k = w["model"], w["index"], w["coarse"], w["k"]
    args = (w["params"], w["toks"], w["lens"])
    mesh = corpus_mesh(n)
    full = make_retriever(model, index, k, w["cfg"].eval.topk_method,
                          mesh=mesh)
    reset_counts()
    d_s, r_s = (t.cpu().numpy() for t in full(*args))
    counts = read_counts()
    mism, ddiff = compare_to_plain(d_s, r_s, d_full, rows_full)
    rec = dict(shards=n, rows=index.num_rows, k=k, candidates=C,
               full_scan_ms_per_batch=time_batches(lambda: full(*args)),
               full_scan_unsharded_ms_per_batch=results["coarse_2m"][
                   "full_scan_ms_per_batch"],
               full_scan_host_syncs=sum(_steady_syncs(
                   lambda: full(*args)).values()),
               full_scan_rows_differing_from_unsharded=mism,
               full_scan_max_distance_diff_vs_unsharded=ddiff)
    del full
    require(mism == 0 and ddiff <= 1e-3,
            f"sharded[coarse_2m] full scan vs unsharded: {mism} rows "
            f"differ, max |d diff| {ddiff}")
    require(rec["full_scan_host_syncs"] == 0,
            f"sharded[coarse_2m] full scan: {rec['full_scan_host_syncs']} "
            f"host syncs a batch")
    fn = make_sharded_coarse_retriever(model, coarse, k, mesh,
                                       num_candidates=C, mode="blockmax")
    reset_counts()
    d_c, rows_c = fn(*args)
    c_counts = read_counts()
    by_dev = read_device_counts()
    _add_counts(counts, c_counts)
    Q, N = w["toks"].shape[0], index.num_rows
    require(bool(torch.isfinite(d_c).all()) and tuple(d_c.shape) == (Q, k)
            and tuple(rows_c.shape) == (Q, k)
            and 0 <= int(rows_c.min()) and int(rows_c.max()) < N,
            "sharded[coarse_2m]: malformed blockmax results")
    with mock.patch.object(coarse_mod, "coarse_blockmax",
                           coarse_blockmax_plain):
        d_p, r_p = (t.cpu().numpy() for t in fn(*args))
    d_c, rows_c = d_c.cpu().numpy(), rows_c.cpu().numpy()
    p_mism, p_ddiff = compare_to_plain(d_c, rows_c, d_p, r_p)
    q_err, rel = recheck_rows(model, w["params"], index, w["toks"][None],
                              w["lens"][None], d_c[None], rows_c[None])
    rec["blockmax"] = dict(
        launches=c_counts, ms_per_batch=time_batches(lambda: fn(*args)),
        unsharded_ms_per_batch=results["coarse_2m"][f"blockmax_C{C}"][
            "ms_per_batch"],
        recall_at_k_vs_full_scan=_recall(rows_c, rows_full),
        rows_differing_from_plain=p_mism,
        max_distance_diff_vs_plain=p_ddiff,
        max_query_diff_vs_plain_k1b=q_err,
        max_rel_distance_diff_vs_recomputed=rel,
        k4_launches_by_device=by_dev["coarse"])
    require(c_counts["coarse_blockmax"] > 0,
            "sharded[coarse_2m]: K4 never launched")
    shard_devs = {str(d) for d in mesh.axis_devices("corpus")}
    require(set(by_dev["coarse"]) == shard_devs,
            f"sharded[coarse_2m]: K4 launched on {by_dev['coarse']}, the "
            f"shards live on {sorted(shard_devs)}")
    require(p_mism == 0 and p_ddiff <= 1e-3,
            f"sharded[coarse_2m] blockmax vs plain K4: {p_mism} rows "
            f"differ, max |d diff| {p_ddiff}")
    require(q_err <= 2e-3 and rel <= RECHECK_REL_TOL,
            f"sharded[coarse_2m]: queries vs plain K1b {q_err}, returned "
            f"distances vs recomputed (relative) {rel}")
    require_mma(c_counts, "coarse", "sharded[coarse_2m]")
    require(counts["lstm_hs"] > 0, "sharded[coarse_2m]: K1b never launched")
    if trace:
        # where a sharded batch's time goes, beside the unsharded one
        _device_profile(f"coarse_2m_blockmax_C{C}_n{n}_host",
                        lambda: fn(*args), host=True)
        one = make_coarse_score_topk(model, coarse, k, num_candidates=C,
                                     mode="blockmax")
        _device_profile(f"coarse_2m_blockmax_C{C}_host",
                        lambda: one(*args), host=True)
    _sharded_record(results, "coarse_2m", counts, rec)


def phase_gru(results, seed: int, num_videos: int):
    """didemo_flagship with the GRU query cell: mean pool (K3a) and last
    pool (K3b) served and held against the kernels' plain versions."""
    import torch

    from vfr_tpu_torch.eval.corpus import (
        build_moment_index,
        make_score_topk,
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
        body = make_score_topk(pool_model, index, k, "exact")
        _, graphed = graph_vs_eager(
            body, body.eager, [(q_params, toks_d[b], lens_d[b])
                               for b in range(len(toks))], f"gru[{pool}]")
        del body
        rec[pool] = dict(
            launches=counts, graph=graphed,
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
        _embed_query_streams,
        build_moment_index,
        make_score_topk,
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
    require_persistent(counts, "lstm", "serving_10k", "persistent_bulk",
                       only=True)
    require_row_topk(counts, None, "serving_10k")
    # bf16 operands: the library's bf16 GEMM, never the f32 kernel
    require(counts["score_gemm"] == 0 and not counts.get("score.kernel")
            and counts.get("score.library", 0) > 0,
            f"serving_10k: the bf16 score products took "
            f"{ {n: c for n, c in counts.items() if n[:6] == 'score.'} }, "
            f"{counts['score_gemm']} f32 kernel launches")
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
    # the stream's batch body: one replay against the eager batch over the
    # eight batches, each graphed answer held to the plain distances
    body = make_score_topk(model, index, k, cfg.eval.topk_method)
    batches = [(q_params, toks_d[b], lens_d[b]) for b in range(len(toks))]
    g_outs, graphed = graph_vs_eager(body, body.eager, batches,
                                     "serving_10k[graph]")
    graphed["vs_plain"] = [
        _exact_rows_vs_plain(model, index, *(_embed_query_streams(
            q_params, model, a[1], a[2], rnn_kernel=kern)
            for kern in (None, "plain")), *o)
        for a, o in zip(batches, g_outs)]
    del body, g_outs
    rec = dict(phase="serving_10k", videos=num_videos, rows=index.num_rows,
               queries=len(queries), k=k, launches=counts,
               ms_per_batch=ms_batch, rows_differing_from_plain=mism,
               max_distance_diff_vs_plain=ddiff, graph=graphed,
               stream_captures=r_kernel.graphs.captures)
    emit(rec)
    require(all(_right_answer(c) for c in graphed["vs_plain"]),
            f"serving_10k: a graphed batch is not a right answer for the "
            f"plain distances: {graphed['vs_plain']}")
    require(r_kernel.graphs.captures == 1, f"serving_10k: the stream "
            f"retriever captured {r_kernel.graphs.captures} graphs for one "
            "batch shape")
    require(len(out) == len(queries) and len(out[0]["results"]) == k,
            "serving_10k: malformed results")
    require(mism == 0 and ddiff <= 1e-3,
            f"serving_10k: kernel vs plain: {mism} rows differ, "
            f"max |d diff| {ddiff}")
    results["serving_10k"] = rec


def _exact_rows_vs_plain(model, index, q_k, q_p, d_k, r_k):
    """The exact path's answer ``d_k``, ``r_k`` [Q, k] on the kernel's
    queries ``q_k`` held to the plain path's distances ``D_p`` [Q, N] of
    every row on its queries ``q_p`` [S, Q, d]: the index's stored-dtype
    operands (``make_retriever``'s) through the plain product
    (``device.mm_f32``), never the route under test.  Per query, delta
    bounds how far any row's distance moves between the two query sets:
    sum_j |the change of round(2 w q)_j| x max_n |m_cat[n, j]| + |the
    change of sum_s w_s |q_s|^2| (the score rounds the scaled queries to
    its product dtype); eps =
    RECHECK_REL_TOL x (sum_s w_s |q_p,s|^2 + max msq) covers the f32 sums.
    The queries are held to each other at a fixed tolerance by the caller,
    so delta is that of a correct kernel.  A right answer then has: no
    returned row whose plain distance lies more than 2 delta + 4 eps above
    the plain k-th (``rows_out_of_band``); every row more than that below
    it returned (``rows_missing``); each returned distance within delta +
    2 eps of its row's plain one (``max_distance_excess`` <= 0); no row
    twice, distances ascending."""
    import torch

    from vfr_tpu_torch.device import mm_f32
    from vfr_tpu_torch.parallel.sharding import (
        fuse_index_cat,
        query_cat_scaled,
        query_sq_const,
    )

    w = index.weights
    m_cat, msq = fuse_index_cat(index.m, index.m_sq, w)
    # the product dtype: the operand's when it is bf16, else the compute
    # dtype (parallel.sharding.fused_corpus_scores)
    in_dtype = (torch.bfloat16 if m_cat.dtype == torch.bfloat16
                else model.compute_dtype)

    def rounded(q):
        return query_cat_scaled(q, w).to(in_dtype).float()

    sq_p = query_sq_const(q_p, w)
    D_p = (sq_p[:, None] + msq[None, :]
           - mm_f32(query_cat_scaled(q_p, w), m_cat.T, in_dtype))

    delta = ((rounded(q_k) - rounded(q_p)).abs()
             @ m_cat.abs().amax(0).float()
             + (query_sq_const(q_k, w) - sq_p).abs())
    eps = RECHECK_REL_TOL * (sq_p.abs() + msq.abs().max())
    r_k = r_k.long()
    p_k = D_p.kthvalue(r_k.shape[1], dim=1).values[:, None]
    band = (2 * delta + 4 * eps)[:, None]
    d_pk = D_p.gather(1, r_k)
    below = p_k - band
    return dict(
        max_query_shift=float(delta.max()),
        rows_out_of_band=int((d_pk > p_k + band).sum()),
        rows_missing=int(((D_p < below).sum(1)
                          - (d_pk < below).sum(1)).sum()),
        max_distance_excess=float(((d_k - d_pk).abs()
                                   - (delta + 2 * eps)[:, None]).max()),
        duplicate_rows=int((r_k.sort(1).values.diff(dim=1) == 0).sum()),
        unsorted=int((d_k.diff(dim=1) < 0).sum()))


def _right_answer(rec) -> bool:
    """``_exact_rows_vs_plain``'s record of a right answer."""
    return (rec["rows_out_of_band"] == rec["rows_missing"]
            == rec["duplicate_rows"] == rec["unsorted"] == 0
            and rec["max_distance_excess"] <= 0)


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


def _corpus_on_checkpoint(common, preset_for, load, n_queries: int,
                          what: str, k1: str = "lstm_pooled"):
    """``cli corpus`` on a trained checkpoint (``common``: its flags;
    ``preset_for(rnn_kernel)``: the preset each run sees), exact (K1:
    ``k1``) and fused (K1 + K2), each beside the same run through the
    kernels' plain versions; fails unless each kernel launched (``mma`` /
    ``persistent``) and the metrics agree.  (runs, max metric diffs)."""
    from unittest import mock

    from vfr_tpu_torch.eval import corpus as corpus_mod
    from vfr_tpu_torch.ops.kernels.select_kernel import distance_select_plain

    runs = EvalRuns(n_queries)
    diffs = {}
    for method, kernels in (("exact", (k1,)),
                            ("fused", (k1, "distance_select"))):
        argv = ["corpus", *common, "--topk-method", method]
        k_m, k_counts = runs(f"corpus_{method}_pallas", lambda: _cli(
            argv, preset_for("pallas"), load))
        patches = ([mock.patch.object(corpus_mod, "distance_select",
                                      distance_select_plain)]
                   if method == "fused" else [])
        p_m, _ = runs(f"corpus_{method}_plain", lambda: _cli(
            argv, preset_for("plain"), load), patches=patches)
        diffs[method] = metrics_close(k_m, p_m, f"{what}[corpus {method}]")
        for name in kernels:
            require(k_counts[name] > 0,
                    f"{what}[corpus {method}]: {name} never launched")
        require_persistent(k_counts, "lstm", f"{what}[corpus {method}]",
                           "persistent_bulk")
        if method == "fused":
            require_mma(k_counts, "select", f"{what}[corpus fused]")
    return runs, diffs


def _cli_train(common, preset, load, epochs: int, what: str):
    """``cli train`` through the loop's prefetcher, counting the chunks it
    hands out: (final metrics, seconds, kernel launches during the run,
    the metrics log's records).  Fails unless every chunk came through the
    prefetcher's side stream, a loss is non-finite or mining never ran."""
    from unittest import mock

    import vfr_tpu_torch.train.loop as loop_mod

    fed = {"chunks": 0, "on_side_stream": 0}

    class CountingPrefetcher(loop_mod.Prefetcher):
        """The loop's prefetcher, counting the chunks it hands out."""

        def __iter__(self):
            for chunk in super().__iter__():
                fed["chunks"] += 1
                fed["on_side_stream"] += int(bool(self._streams))
                yield chunk

    reset_counts()
    with mock.patch.object(loop_mod, "Prefetcher", CountingPrefetcher):
        final, train_s = _timed(lambda: _cli(
            ["train", *common, "--epochs", str(epochs), "--steps-per-call",
             str(TRAIN_STEPS_PER_CALL)], preset, load))
    counts = read_counts()
    steps = preset.train.steps_per_epoch
    want_chunks = epochs * -(-steps // TRAIN_STEPS_PER_CALL)
    require(fed["chunks"] == fed["on_side_stream"] == want_chunks,
            f"{what}: the prefetcher fed {fed} chunks, wanted {want_chunks} "
            "copied on its side stream")
    ck = common[common.index("--checkpoint-dir") + 1]
    recs = [json.loads(line) for line in
            open(os.path.join(ck, "metrics.jsonl"), encoding="utf-8")]
    tr = [r for r in recs if r["tag"] == "train"]
    require(tr and all(np.isfinite(r["loss"]) for r in tr),
            f"{what}: non-finite loss")
    require(any(r["tag"] == "mine" for r in recs),
            f"{what}: mining never ran")
    return final, train_s, counts, recs, fed["chunks"]


def _checkpoint_checks(ck: str, workdir: str, preset, bundle, what: str):
    """The newest checkpoint under ``ck``: it reloads bit for bit,
    ``load_for_eval`` serves its EMA tree, and that tree moved away from
    the raw params.  Returns (step, params, opt_state, ema, model)."""
    import torch

    from vfr_tpu_torch.checkpoint import load_for_eval
    from vfr_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_payload,
        peek_config,
        restore_checkpoint,
        restore_ema,
        save_checkpoint,
    )
    from vfr_tpu_torch.utils.tree import flatten

    dev = torch.device("cuda")
    ckpt = latest_checkpoint(ck)
    payload = load_payload(ckpt)
    step, params, opt_state, cfg_ck = restore_checkpoint(
        ckpt, payload=payload, device=dev)
    require(peek_config(ckpt) == cfg_ck,
            f"{what}: peek_config differs from the restored config")
    ema = restore_ema(ckpt, payload=payload, device=dev)
    again = save_checkpoint(os.path.join(workdir, f"{what}_ck2"), step,
                            params, opt_state, cfg_ck, ema=ema)
    require(_bitwise_equal(payload, load_payload(again)),
            f"{what}: the checkpoint does not reload bit for bit")
    served, model, _ = load_for_eval(dataclasses.replace(
        preset, train=dataclasses.replace(preset.train, checkpoint_dir=ck)),
        bundle=bundle, device=dev)
    _, e_leaves = flatten(ema)
    require(all(torch.equal(a, b) for a, b in
                zip(flatten(served)[1], e_leaves)),
            f"{what}: load_for_eval does not serve the EMA tree")
    moved = [not torch.equal(a, b) for (p, a), b in
             zip(zip(*flatten(params)), e_leaves) if p != ("embeddings",)]
    require(all(moved), f"{what}: the EMA tree equals the raw params")
    return step, params, opt_state, ema, model


def _mined_batch(params, model, ds, tcfg, banks, seed: int):
    """One train batch (B = the recipe's) with its mined negatives, on
    the card, and the refresh's seconds."""
    import torch

    from vfr_tpu_torch.train.hard_negatives import mine_hard_negatives

    mined, mine_s = _timed(lambda: mine_hard_negatives(
        params, model, ds, tcfg.hard_negative_count, feature_banks=banks))
    b = next(ds.train_batches(tcfg.batch_size, 1, seed=seed,
                              with_features=False))
    b["hard_neg_video"] = mined[0][b["query_idx"]]
    b["hard_neg_prop"] = mined[1][b["query_idx"]]
    return ({k: torch.from_numpy(np.asarray(v)).to(torch.device("cuda"))
             for k, v in b.items()}, mine_s)


def _one_step_checks(model, tcfg, opt, params, opt_state, ema, batch,
                     banks, what: str, profile: str):
    """One K-step of one chunk: its device profile, then the same step
    under torch's sync debug mode, where any host sync raises.  Returns
    True or fails."""
    import torch

    from vfr_tpu_torch.train.step import make_train_multi_step

    multi = make_train_multi_step(model, tcfg, opt, feature_banks=banks)
    chunk = {k: v[None] for k, v in batch.items()}
    state = {"p": params, "s": opt_state, "e": ema}

    def one_step():
        state["p"], state["s"], state["e"], _ = multi(
            state["p"], state["s"], chunk, state["e"])
    _device_profile(profile, one_step)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one_step()
        sync_free = True
    except RuntimeError as e:
        sync_free = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(sync_free is True, f"{what}: a step synchronised with the host: "
            f"{sync_free}")
    return sync_free


def _fusion_steps(seed: int, workdir: str):
    """didemo_fusion at full width (F=2048, rgb + flow, TEF, the margin
    loss) at its B=64 on a synthetic FUSION_VIDEOS-video fixture, the clip
    features carried in the batch (no feature banks): FUSION_STEPS steps
    of ``make_train_step``, one batch each.  Fails on a non-finite loss,
    on any recurrence launched stepwise, or on fused-layer gradients more
    than GRAD_TOL of max |grad| per leaf from autograd through the scan
    twin on the first batch.  The phase's record of it."""
    import torch

    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.data.loaders import load_datasets
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import init_model_params
    from vfr_tpu_torch.train.optim import make_optimizer
    from vfr_tpu_torch.train.step import _grads, make_train_step

    dev = torch.device("cuda")
    cfg = get_preset("didemo_fusion")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, data_dir=os.path.join(workdir, "fusion_nodata"),
        synthetic_num_videos=FUSION_VIDEOS,
        synthetic_num_queries=4 * FUSION_VIDEOS, synthetic_seed=seed))
    tcfg = cfg.train
    require(tcfg.ema_decay == 0 and tcfg.loss_type == "triplet",
            "train[didemo_fusion]: the preset keeps an EMA or left the "
            "margin loss")
    bundle = load_datasets(cfg.data)
    model = build_model(cfg)
    params = init_model_params(torch.Generator().manual_seed(seed + 5),
                               model, bundle.glove, cfg.data.feature_dim,
                               device=dev)
    batches = [{k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in b.items()}
               for b in bundle.train.train_batches(
                   tcfg.batch_size, FUSION_STEPS, seed=seed,
                   with_features=True)]
    require(tuple(batches[0]["rgb"].shape[::2]) == (tcfg.batch_size, 2048)
            and "flow" in batches[0],
            f"train[didemo_fusion]: batch rgb "
            f"{tuple(batches[0]['rgb'].shape)}, keys {sorted(batches[0])}")
    scan_model = model._replace(cfg=dataclasses.replace(
        model.cfg, train_rnn_impl="scan"))
    _, g_fused = _grads(params, model, tcfg, batches[0], None)
    _, g_scan = _grads(params, scan_model, tcfg, batches[0], None)
    errs = _leaf_rel_errors(g_fused, g_scan)
    worst = max(errs.values())
    opt = make_optimizer(tcfg, FUSION_STEPS)
    step = make_train_step(model, tcfg, opt)
    opt_state = opt.init(params)
    losses = []
    reset_counts()
    for b in batches:
        params, opt_state, aux = step(params, opt_state, b)
        losses.append(aux["loss"].detach())
    losses = torch.stack(losses).float().cpu().numpy()
    counts = read_counts()
    rec = dict(preset="didemo_fusion", videos=FUSION_VIDEOS,
               batch=tcfg.batch_size, steps=len(losses),
               first_loss=float(losses[0]), last_loss=float(losses[-1]),
               launches=counts,
               grad_check=dict(tol=GRAD_TOL, worst=worst, per_leaf=errs))
    require(bool(np.isfinite(losses).all()), f"train[didemo_fusion]: a loss "
            f"went non-finite over {len(losses)} steps: {losses.tolist()}")
    for cell in ("lstm", "gru"):
        require(counts["variants"][cell]["stepwise"] == 0,
                f"train[didemo_fusion]: the {cell} recurrence ran "
                f"{counts['variants'][cell]}")
    require(worst <= GRAD_TOL, f"train[didemo_fusion]: fused BPTT gradients "
            f"differ from autograd through the scan twin by {worst} of max "
            f"|grad| (> {GRAD_TOL})")
    return rec


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
    import torch

    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.train.optim import make_optimizer
    from vfr_tpu_torch.train.step import _grads
    from vfr_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda")
    nodata = os.path.join(workdir, "train_nodata")
    ck = os.path.join(workdir, "train_ck")
    load = _memo_datasets()
    preset = _train_preset(nodata, seed)
    bundle, setup_s = _timed(lambda: load(preset.data))
    common = ["--preset", "didemo_flagship", "--data-dir", nodata,
              "--checkpoint-dir", ck]
    epochs = TRAIN_EPOCHS
    final, train_s, _, recs, fed = _cli_train(common, preset, load, epochs,
                                              "train")
    tr = [r for r in recs if r["tag"] == "train"]
    mine = [r["refresh_s"] for r in recs if r["tag"] == "mine"]
    eval_s = [r["eval_s"] for r in recs if r["tag"] == "eval"]
    step, params, opt_state, ema, model = _checkpoint_checks(
        ck, workdir, preset, bundle, "train")

    # one flagship batch (B=128, mined negatives): step split, busy share,
    # no host sync, the fused BPTT against autograd through the scan twin
    tcfg = preset.train
    ds = bundle.train
    banks = banks_to_device(dict(ds.feature_banks()), preset.data.bank_dtype,
                            device=dev)
    batch, mine_s = _mined_batch(params, model, ds, tcfg, banks, seed)
    opt = make_optimizer(tcfg, TRAIN_STEPS_PER_EPOCH * epochs)
    split = _step_split(model, tcfg, opt, params, opt_state,
                        tree_map(torch.clone, ema), batch, banks)
    sync_free = _one_step_checks(model, tcfg, opt, params, opt_state, ema,
                                 batch, banks, "train", "train_step_B128")
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
    runs, diffs = _corpus_on_checkpoint(
        common, lambda kern: _train_preset(nodata, seed, kern), load,
        bundle.val.num_queries, "train")
    fusion = _fusion_steps(seed, workdir)
    chunk_ms = [r["step_ms"] for r in tr]
    rec = dict(phase="train", preset="didemo_flagship",
               videos=VIDEOS_TRAIN, train_queries=ds.num_queries,
               val_queries=bundle.val.num_queries,
               batch=tcfg.batch_size, epochs=epochs,
               steps=step, steps_per_call=TRAIN_STEPS_PER_CALL,
               fixture_s=setup_s, train_cli_s=train_s,
               step_ms_median=float(np.median(chunk_ms)),
               step_ms_chunks=chunk_ms, step_split_ms=split,
               step_sync_free=sync_free, prefetched_chunks=fed,
               mining_refresh_s=mine, mining_refresh_s_again=mine_s,
               eval_s=eval_s, final_metrics=final,
               final_loss=tr[-1]["loss"],
               grad_check=dict(tol=GRAD_TOL, worst=worst, per_leaf=errs),
               max_metric_diff_vs_plain=diffs, runs=runs.runs,
               fusion=fusion)
    emit(rec)
    results["train"] = rec


def phase_train_charades(results, seed: int, workdir: str,
                         num_videos: int):
    """``cli train --preset charades_flagship`` at full width (F=2048,
    H=1024, joint 128, one stream, cosine, last pool, B=64, InfoNCE tau
    0.02, EMA 0.999, 8 mined negatives from epoch 3) on the synthetic
    ``num_videos``-video Charades-STA fixture of eval_charades (one val
    query per video, so the val index holds every video's 64 windows),
    cut to 4 epochs of 20 steps (one mining refresh; the loop's eval every
    epoch at batch 512 through K1b in chunks).  Then ``cli eval`` on what
    it wrote (per-video, batch 512: K1b chunked, ``persistent`` only) and
    ``cli corpus``, exact (K1b) and fused (K1b + K2 at S=1), each held
    against the same run through the kernels' plain versions (within 0.1%
    of the queries).  Fails on a non-finite loss, an EMA tree equal to the
    raw params, a checkpoint that does not reload bit for bit, or a host
    sync inside a step.  Reports step ms at B=64, refresh and eval
    seconds."""
    from collections import defaultdict

    import torch

    from vfr_tpu_torch.data.charades import CharadesSTADataset
    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.data.loaders import DataBundle
    from vfr_tpu_torch.train.optim import make_optimizer

    dev = torch.device("cuda")
    (cfg, fix), setup_s = _timed(lambda: _charades_fixture(num_videos,
                                                           seed))
    by_video = defaultdict(list)
    for a in fix.annotations:
        by_video[a["video"]].append(a)
    train_anns = [a for v in sorted(by_video) for a in by_video[v][:-1]]
    val_anns = [by_video[v][-1] for v in sorted(by_video)]
    bundle = DataBundle(
        CharadesSTADataset(train_anns, fix.rgb, None, fix.vocab, cfg.data),
        CharadesSTADataset(val_anns, fix.rgb, None, fix.vocab, cfg.data),
        fix.vocab, fix.glove, cfg.data.feature_dim, "synthetic")

    def load(dcfg):
        return bundle

    def preset_for(rnn_kernel):
        return dataclasses.replace(
            cfg,
            train=dataclasses.replace(cfg.train,
                                      steps_per_epoch=TRAIN_STEPS_PER_EPOCH),
            eval=dataclasses.replace(cfg.eval, rnn_kernel=rnn_kernel))

    what = "train_charades"
    ck = os.path.join(workdir, "train_charades_ck")
    common = ["--preset", "charades_flagship", "--data-dir",
              os.path.join(workdir, "charades_nodata"),
              "--checkpoint-dir", ck]
    epochs = TRAIN_EPOCHS
    preset = preset_for("pallas")
    final, train_s, loop_counts, recs, fed = _cli_train(
        common, preset, load, epochs, what)
    require(loop_counts["lstm_hs"] > 0,
            f"{what}: the loop's eval never launched K1b")
    require_persistent(loop_counts, "lstm", f"{what}[loop eval, batch "
                       f"{preset.eval.eval_batch_size}]", "persistent_bulk")
    tr = [r for r in recs if r["tag"] == "train"]
    mine = [r["refresh_s"] for r in recs if r["tag"] == "mine"]
    eval_s = [r["eval_s"] for r in recs if r["tag"] == "eval"]
    step, params, opt_state, ema, model = _checkpoint_checks(
        ck, workdir, preset, bundle, what)

    # one Charades batch (B=64, mined negatives re-embedded with their
    # video's TEF): no host sync inside a step
    tcfg, ds = preset.train, bundle.train
    banks = banks_to_device({**ds.feature_banks(), "video_tef": ds.video_tef},
                            preset.data.bank_dtype, device=dev)
    batch, mine_s = _mined_batch(params, model, ds, tcfg, banks, seed)
    opt = make_optimizer(tcfg, TRAIN_STEPS_PER_EPOCH * epochs)
    sync_free = _one_step_checks(model, tcfg, opt, params, opt_state, ema,
                                 batch, banks, what, "train_step_charades_B64")

    # cli eval (per-video, batch 512: K1b in chunks) and cli corpus (K1b;
    # K1b + K2 at S=1), each beside its plain-version run
    n_val = bundle.val.num_queries
    runs = EvalRuns(n_val)
    k_m, k_counts = runs("per_video_pallas", lambda: _cli(
        ["eval", *common], preset, load))
    p_m, _ = runs("per_video_plain", lambda: _cli(
        ["eval", *common], preset_for("plain"), load))
    diffs = {"per_video": metrics_close(k_m, p_m, f"{what}[eval]")}
    require(list(k_m) == eval_keys(preset.eval),
            f"{what}: eval keys {list(k_m)}")
    require(k_counts["lstm_hs"] > 0, f"{what}[eval]: K1b never launched")
    require_persistent(k_counts, "lstm", f"{what}[eval, batch "
                       f"{preset.eval.eval_batch_size}]", "persistent_bulk")
    c_runs, c_diffs = _corpus_on_checkpoint(common, preset_for, load, n_val,
                                            what, k1="lstm_hs")
    diffs.update({f"corpus_{k}": v for k, v in c_diffs.items()})
    chunk_ms = [r["step_ms"] for r in tr]
    rec = dict(phase=what, preset="charades_flagship", videos=num_videos,
               rows=num_videos * cfg.data.max_windows,
               train_queries=ds.num_queries, val_queries=n_val,
               batch=tcfg.batch_size, epochs=epochs, steps=step,
               steps_per_call=TRAIN_STEPS_PER_CALL, fixture_s=setup_s,
               train_cli_s=train_s,
               step_ms_median=float(np.median(chunk_ms)),
               step_ms_chunks=chunk_ms, step_sync_free=sync_free,
               prefetched_chunks=fed, loop_launches=loop_counts,
               mining_refresh_s=mine, mining_refresh_s_again=mine_s,
               eval_s=eval_s, final_metrics=final,
               final_loss=tr[-1]["loss"], max_metric_diff_vs_plain=diffs,
               runs={**runs.runs, **c_runs.runs})
    emit(rec)
    results[what] = rec


# -------------------------------------------------------------- train_dp

def _mined_gap(params, model, ds, banks, a, b):
    """(queries whose mined pairs differ between refreshes ``a`` and ``b``,
    the largest difference between their sorted mined distances relative
    to the largest): pairs that differ only at near-ties keep the same
    distance profile."""
    import torch

    from vfr_tpu_torch.eval.corpus import (
        _embed_query_streams,
        build_moment_index,
    )

    diff = np.nonzero((a[0] != b[0]).any(1) | (a[1] != b[1]).any(1))[0]
    if len(diff) == 0:
        return 0, 0.0
    index = build_moment_index(params, model, ds, with_fingerprint=False,
                               feature_banks=banks)
    inv = {(int(v), int(p)): r
           for r, (v, p) in enumerate(zip(index.video_row, index.prop_idx))}
    dev = index.m.device
    q = _embed_query_streams(params, model,
                             torch.from_numpy(ds.tokens[diff]).to(dev),
                             torch.from_numpy(ds.lengths[diff]).to(dev),
                             "scan")                          # [S, Q, d]
    w = [float(x) for x in model.cfg.stream_weights]
    worst = 0.0
    for j, qi in enumerate(diff):
        prof = []
        for vids, props in ((a[0][qi], a[1][qi]), (b[0][qi], b[1][qi])):
            rows = torch.tensor([inv[(int(v), int(p))] for v, p in
                                 zip(vids, props) if v >= 0],
                                dtype=torch.long, device=dev)
            d = sum(w[s] * ((q[s, j][None] - index.m[s, rows].float()) ** 2
                            ).sum(-1) for s in range(len(w)))
            prof.append(torch.sort(d).values.cpu().numpy())
        require(len(prof[0]) == len(prof[1]),
                f"train_dp[refresh]: query {qi} mined {len(prof[0])} and "
                f"{len(prof[1])} pairs")
        scale = max(float(np.abs(prof[0]).max(initial=0.0)), 1e-30)
        if len(prof[0]):
            worst = max(worst, float(np.abs(prof[0] - prof[1]).max()) / scale)
    return len(diff), worst


def _dp_step_split(model, tcfg, opt, params, opt_state, ema, placed, banks,
                   devices, iters: int = 10, warmup: int = 3):
    """Median ms by CUDA events of one data-parallel step's parts, the
    step's own functions between events: the shards' forward, the gather
    to the lead + loss, backward, the ordered reduction, update + EMA and
    the broadcast.  Events on the lead's stream: exact on a one-card mesh;
    across cards they see the lead's share."""
    import torch

    from vfr_tpu_torch.train.optim import apply_updates
    from vfr_tpu_torch.train.step import (
        _device_model,
        _ema_update,
        _gather_loss,
        _reduce,
        _Replicas,
        _shard_forward,
    )

    keys = ("forward", "gather_loss", "backward", "reduce", "update_ema",
            "broadcast")
    split = {k: [] for k in keys + ("step",)}
    on = _device_model(model)
    reps = _Replicas(model, devices)
    for it in range(warmup + iters):
        reps.sync(params)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        req = [[t.detach().requires_grad_(True) for t in leaves]
               for leaves in reps.leaves]
        ev[0].record()
        with torch.enable_grad():
            outs = _shard_forward(reps, on, placed, banks, req)
            ev[1].record()
            loss, _ = _gather_loss(reps, on, tcfg, placed, outs, req)
            ev[2].record()
            got = torch.autograd.grad(loss, [t for r in req for t in r],
                                      allow_unused=True)
        ev[3].record()
        grads = _reduce(reps, got, req)
        ev[4].record()
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        ema = _ema_update(ema, params, tcfg.ema_decay)
        ev[5].record()
        reps.broadcast(params)
        ev[6].record()
        torch.cuda.synchronize()
        if it >= warmup:
            for i, key in enumerate(keys):
                split[key].append(ev[i].elapsed_time(ev[i + 1]))
            split["step"].append(ev[0].elapsed_time(ev[6]))
    return {k: float(np.median(v)) for k, v in split.items()}


def _chunk_ms(fn, state, chunk, k: int, chunks: int = 5):
    """Median over ``chunks`` calls of a K-step chunk, each ended by its
    loss fetch (the loop's one sync): ms per step by CUDA events on the
    lead and by the host clock."""
    import torch

    def call():
        state["p"], state["s"], state["e"], aux = fn(
            state["p"], state["s"], chunk, state["e"])
        return float(aux["loss"])
    call()
    dev_ms, wall_ms = [], []
    for _ in range(chunks):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        call()
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3 / k)
        dev_ms.append(start.elapsed_time(end) / k)
    return float(np.median(dev_ms)), float(np.median(wall_ms))


def phase_train_dp(results, seed: int, workdir: str, trace: bool = False):
    """Data-parallel training of didemo_flagship at full width (B=128) on
    the train phase's 2,000-video fixture over a "data" mesh of
    ``TRAIN_DP_SHARDS`` positions (distinct cards when visible, else the
    first card n times).  One flagship batch (mined negatives, a per-step
    tau, a dropout mask) through the DP step and the one-device step from
    the same params: loss within DP_LOSS_TOL relative, every gradient leaf
    within DP_GRAD_TOL of its max |grad|, every replica equal to the lead
    after a chunk, one host sync a chunk (the loss fetch).  The sharded
    mining refresh beside the one-device refresh (pairs equal outside
    near-ties).  ``train(cfg, mesh=)`` for the train phase's recipe beside
    the same run on one device (first chunk's loss within 1e-4, every
    chunk within DP_CHUNK_TOL, every chunk through the prefetcher's side
    streams); ``cli corpus`` on the DP checkpoint, exact (K1a) and fused
    (K1a + K2), held to the plain versions; ``cli train --data-parallel``
    for one epoch (one card: the warning and one device; more: the mesh).
    Times: ms per step at n = 1, 2, 4, the DP step's split and its
    device busy share."""
    import contextlib
    import io
    from unittest import mock

    import torch

    import vfr_tpu_torch.parallel.mesh as mesh_mod
    import vfr_tpu_torch.train.loop as loop_mod
    from vfr_tpu_torch.checkpoint import init_train_params
    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.parallel.mesh import distinct
    from vfr_tpu_torch.train.hard_negatives import mine_hard_negatives
    from vfr_tpu_torch.train.loop import dropout_keep_mask
    from vfr_tpu_torch.train.optim import make_optimizer
    from vfr_tpu_torch.train.step import (
        _device_model,
        _dp_grads,
        _grads,
        _Replicas,
        make_train_multi_step,
        place_batch,
    )
    from vfr_tpu_torch.utils.tree import flatten, tree_map

    n = TRAIN_DP_SHARDS
    mesh = corpus_mesh(n, "data", "train_dp_mesh")
    devices = mesh.axis_devices("data")
    dev = devices[0]
    n_distinct = len(distinct(devices))
    nodata = os.path.join(workdir, "train_nodata")
    load = _memo_datasets()
    preset = _train_preset(nodata, seed)
    bundle, setup_s = _timed(lambda: load(preset.data))
    ds, tcfg = bundle.train, preset.train
    model = build_model(preset, dataset=ds)
    params = init_train_params(torch.Generator().manual_seed(seed), model,
                               bundle.glove, bundle.feature_dim, tcfg, dev)
    arrays = dict(ds.feature_banks())
    banks = banks_to_device(arrays, preset.data.bank_dtype, mesh=mesh)
    require(list(banks) == distinct(devices),
            f"train_dp: banks placed on {list(banks)}")
    lead_banks = banks[dev]

    # the refresh: sharded over the mesh's "data" axis beside one device;
    # seconds of warm calls in turns (one, dp, dp, one)
    def mine(m_):
        return mine_hard_negatives(params, model, ds,
                                   tcfg.hard_negative_count,
                                   feature_banks=lead_banks, mesh=m_)
    single, sharded = mine(None), mine(mesh)
    mine_s = {"one": [], "dp": []}
    for tag in ("one", "dp", "dp", "one"):
        mine_s[tag].append(_timed(lambda: mine(
            mesh if tag == "dp" else None))[1])
    n_diff, gap = _mined_gap(params, model, ds, lead_banks, single, sharded)
    require(gap <= REFRESH_GAP_TOL,
            f"train_dp[refresh]: {n_diff} queries mined other pairs, "
            f"distance profiles {gap} apart (> {REFRESH_GAP_TOL})")

    # one flagship batch: mined negatives, a per-step tau, a dropout mask
    drop_model = model._replace(cfg=dataclasses.replace(
        model.cfg, query_dropout=0.1))
    K = TRAIN_STEPS_PER_CALL
    host = []
    for i, b in enumerate(ds.train_batches(tcfg.batch_size, K, seed=seed,
                                           with_features=False)):
        b["hard_neg_video"] = single[0][b["query_idx"]]
        b["hard_neg_prop"] = single[1][b["query_idx"]]
        b["tau_now"] = np.float32(tcfg.temperature * (1.0 + 0.1 * i))
        b["dropout_keep"] = dropout_keep_mask(
            seed, i, (tcfg.batch_size, preset.model.lstm_hidden), 0.1)
        host.append(b)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in host[0].items()}
    on = _device_model(drop_model)
    aux_1, g_1 = _grads(params, on(dev), tcfg, batch, lead_banks)
    reps = _Replicas(drop_model, devices)
    reps.sync(params)
    aux_n, g_n = _dp_grads(reps, on, tcfg, place_batch(host[0], devices),
                           banks)
    loss_rel = abs(float(aux_n["loss"]) - float(aux_1["loss"])) / abs(
        float(aux_1["loss"]))
    require(loss_rel <= DP_LOSS_TOL, f"train_dp: DP loss {aux_n['loss']} "
            f"vs one device {aux_1['loss']} ({loss_rel} > {DP_LOSS_TOL})")
    errs = _leaf_rel_errors(g_n, g_1)
    worst = max(errs.values())
    require(worst <= DP_GRAD_TOL, f"train_dp: DP gradients differ from one "
            f"device's by {worst} of max |grad| (> {DP_GRAD_TOL})")

    # a chunk of K steps: replicas equal the lead after it, one host sync
    opt = make_optimizer(tcfg, TRAIN_STEPS_PER_EPOCH * TRAIN_EPOCHS)
    chunk_host = {k: np.stack([b[k] for b in host]) for k in host[0]}
    multi = make_train_multi_step(drop_model, tcfg, opt, mesh=mesh,
                                  feature_banks=banks)
    placed = place_batch(chunk_host, devices, axis=1)
    state = {"p": params, "s": opt.init(params),
             "e": tree_map(torch.clone, params)}

    def chunk_and_fetch():
        state["p"], state["s"], state["e"], aux = multi(
            state["p"], state["s"], placed, state["e"])
        return float(aux["loss"])
    syncs = _steady_syncs(chunk_and_fetch)
    require(sum(syncs.values()) == 1, f"train_dp: a chunk of {K} steps "
            f"synchronised {syncs}, wanted the loss fetch alone")
    lead_leaves = flatten(state["p"])[1]
    reps_ok = all(torch.equal(a, b.to(a.device)) for r in multi.replicas()
                  for a, b in zip(flatten(r)[1], lead_leaves))
    require(reps_ok and len(multi.replicas()) == n,
            "train_dp: a replica differs from the lead after a chunk")

    # ms per step at n = 1, 2, 4 (chunks placed beforehand, as the
    # prefetcher places them), the split, the busy share
    step_ms, wall_ms, fns = {}, {}, {}
    for n_i in (1, 2, n):
        if n_i == 1:
            fn = make_train_multi_step(model, tcfg, opt,
                                       feature_banks=lead_banks)
            ch = {k: torch.from_numpy(v).to(dev)
                  for k, v in chunk_host.items()}
        else:
            m_i = mesh if n_i == n else corpus_mesh(n_i, "data",
                                                    "train_dp_mesh")
            fn = make_train_multi_step(model, tcfg, opt, mesh=m_i,
                                       feature_banks=lead_banks)
            ch = place_batch(chunk_host, m_i.axis_devices("data"), axis=1)
        st = {"p": params, "s": opt.init(params),
              "e": tree_map(torch.clone, params)}
        step_ms[n_i], wall_ms[n_i] = _chunk_ms(fn, st, ch, K)
        fns[n_i] = fn
    split = _dp_step_split(model, tcfg, opt, params, opt.init(params),
                           tree_map(torch.clone, params),
                           place_batch(host[0], devices), banks, devices)
    one = fns[n]
    prof_state = {"p": params, "s": opt.init(params),
                  "e": tree_map(torch.clone, params)}
    one_chunk = place_batch({k: v[:1] for k, v in chunk_host.items()},
                            devices, axis=1)

    def one_step():
        prof_state["p"], prof_state["s"], prof_state["e"], _ = one(
            prof_state["p"], prof_state["s"], one_chunk, prof_state["e"])
    prof = _device_profile(f"train_dp_step_B128_n{n}", one_step)
    if trace:
        # where the host's time goes: one step on the mesh, one on a card
        _device_profile(f"train_dp_step_B128_n{n}_host", one_step,
                        host=True)
        one_dev_chunk = {k: torch.from_numpy(v[:1]).to(dev)
                         for k, v in chunk_host.items()}

        def one_dev_step():
            prof_state["p"], prof_state["s"], prof_state["e"], _ = fns[1](
                prof_state["p"], prof_state["s"], one_dev_chunk,
                prof_state["e"])
        _device_profile("train_dp_step_B128_n1_host", one_dev_step,
                        host=True)

    # the loop: train(mesh=) beside one device, same recipe and seed
    fed = {}

    class CountingPrefetcher(loop_mod.Prefetcher):
        def __iter__(self):
            for chunk in super().__iter__():
                rec = fed.setdefault(self._tag, [0, 0])
                rec[0] += 1
                rec[1] += int(len(self._streams) >= self._want)
                yield chunk

    loops = {}
    for tag, m_ in (("dp", mesh), ("one", None)):
        ck = os.path.join(workdir, f"train_dp_{tag}_ck")
        cfg = dataclasses.replace(preset, train=dataclasses.replace(
            tcfg, checkpoint_dir=ck, num_epochs=TRAIN_EPOCHS,
            steps_per_call=TRAIN_STEPS_PER_CALL))
        CountingPrefetcher._tag = tag
        CountingPrefetcher._want = n_distinct if m_ is not None else 1
        with mock.patch.object(loop_mod, "Prefetcher", CountingPrefetcher):
            (_, metrics), secs = _timed(lambda: loop_mod.train(
                cfg, bundle=bundle, mesh=m_, device=dev))
        recs = [json.loads(line) for line in
                open(os.path.join(ck, "metrics.jsonl"), encoding="utf-8")]
        loops[tag] = dict(metrics=metrics, seconds=secs, ck=ck,
                          losses=[r["loss"] for r in recs
                                  if r["tag"] == "train"],
                          step_ms=[r["step_ms"] for r in recs
                                   if r["tag"] == "train"],
                          refresh_s=[r["refresh_s"] for r in recs
                                     if r["tag"] == "mine"],
                          eval_s=[r["eval_s"] for r in recs
                                  if r["tag"] == "eval"])
    want = TRAIN_EPOCHS * -(-TRAIN_STEPS_PER_EPOCH // TRAIN_STEPS_PER_CALL)
    require(all(fed.get(t) == [want, want] for t in loops),
            f"train_dp: the prefetcher fed {fed} chunks, wanted {want} "
            "each copied on its side streams")
    la, lb = np.asarray(loops["dp"]["losses"]), np.asarray(
        loops["one"]["losses"])
    require(len(la) == len(lb) == want and np.isfinite(la).all(),
            f"train_dp: chunk losses {la}")
    chunk_rel = np.abs(la - lb) / np.abs(lb)
    require(chunk_rel[0] <= 1e-4, f"train_dp: the first chunk's loss "
            f"{la[0]} vs one device {lb[0]}")
    require(chunk_rel.max() <= DP_CHUNK_TOL, f"train_dp: chunk losses "
            f"{chunk_rel.max()} apart (> {DP_CHUNK_TOL})")

    # cli corpus on the DP run's checkpoint: K1a, K1a + K2
    common = ["--preset", "didemo_flagship", "--data-dir", nodata,
              "--checkpoint-dir", loops["dp"]["ck"]]
    runs, diffs = _corpus_on_checkpoint(
        common, lambda kern: _train_preset(nodata, seed, kern), load,
        bundle.val.num_queries, "train_dp")

    # cli train --data-parallel, one epoch
    built, err = [], io.StringIO()
    real = mesh_mod.make_mesh

    def spy(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]
    with mock.patch.object(mesh_mod, "make_mesh", spy), \
            contextlib.redirect_stderr(err):
        cli_metrics, cli_s = _timed(lambda: _cli(
            ["train", "--preset", "didemo_flagship", "--data-dir", nodata,
             "--checkpoint-dir", os.path.join(workdir, "train_dp_cli"),
             "--epochs", "1", "--data-parallel"], preset, load))
    cards = torch.cuda.device_count()
    warned = "--data-parallel requested but only 1 device" in err.getvalue()
    if cards > 1:
        require(not warned and [m.shape for m in built] == [{"data": cards}],
                f"train_dp[cli]: {cards} cards, meshes {built}")
    else:
        require(warned and not built, "train_dp[cli]: one card, but no "
                "warning or a mesh was built")
    rec = dict(phase="train_dp", preset="didemo_flagship", shards=n,
               devices=[str(d) for d in devices], distinct_cards=n_distinct,
               videos=VIDEOS_TRAIN, batch=tcfg.batch_size,
               fixture_s=setup_s,
               one_step=dict(loss_rel=loss_rel, loss_tol=DP_LOSS_TOL,
                             grad_worst=worst, grad_tol=DP_GRAD_TOL,
                             per_leaf=errs),
               chunk_syncs=syncs, replicas_equal=reps_ok,
               refresh=dict(seconds_one=mine_s["one"],
                            seconds_dp=mine_s["dp"],
                            queries_differing=n_diff, profile_gap=gap,
                            gap_tol=REFRESH_GAP_TOL),
               step_ms={str(k): v for k, v in step_ms.items()},
               wall_ms_per_step={str(k): v for k, v in wall_ms.items()},
               step_split_ms=split,
               device_busy_share=prof["device_busy_share"],
               loop=dict(
                   chunk_loss_rel_first=float(chunk_rel[0]),
                   chunk_loss_rel_max=float(chunk_rel.max()),
                   chunk_tol=DP_CHUNK_TOL,
                   **{f"{t}_{key}": loops[t][key] for t in loops
                      for key in ("metrics", "seconds", "refresh_s",
                                  "eval_s")},
                   dp_step_ms_median=float(np.median(loops["dp"]["step_ms"])),
                   one_step_ms_median=float(np.median(
                       loops["one"]["step_ms"]))),
               prefetched_chunks=fed,
               cli=dict(cards=cards, warned=warned, seconds=cli_s,
                        metrics=cli_metrics),
               max_metric_diff_vs_plain=diffs, runs=runs.runs)
    emit(rec)
    results["train_dp"] = rec


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


def _drive_follow(serve, queries, isolated: bool, patches=(), warm=1):
    """(records, stats, launches) of one ``serve(lines)`` run.  A request's
    ms runs from its line being read off the input to its record coming
    back; ``isolated`` sends each line only after the previous record came
    back (one request in flight).  The first ``warm`` queries go through
    the same daemon first, alone, and are not counted: the daemon's first
    pack captures its graph, as a long-lived daemon does once.  Counts are
    zeroed just after the warm records and read just after the run."""
    import contextlib
    import threading

    import torch

    read_at, back, warmed = [], threading.Event(), threading.Event()

    def lines():
        for text in queries[:warm]:
            yield text
        if warm:
            warmed.wait()
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
        first, n_warm = None, 0
        for rec in serve(lines()):
            if n_warm < warm:
                n_warm += 1
                if n_warm == warm:
                    torch.cuda.synchronize()
                    reset_counts()
                    t0 = time.perf_counter()
                    warmed.set()
                continue
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


def eager_packs():
    """Context: every ``BatchGraphs`` runs its eager function, on the card
    too: the eager side of an eager / graphed comparison."""
    from unittest import mock

    from vfr_tpu_torch.utils.graphs import BatchGraphs

    return mock.patch.object(BatchGraphs, "_on_card", lambda self, args: False)


def _follow_eg(params, model, ds, vocab, ctx, modes):
    """The exact daemon eager (E) and graphed (G) in turns E G G E: 50
    isolated requests (p50 / p95 ms) and a backlog of ``FOLLOW_EG``
    requests at micro-batch 8 and 64, depth 1 and 2 (requests/s); every
    run's records equal to the first E run's, bit for bit."""
    from vfr_tpu_torch.eval.corpus import serve_follow

    queries = ctx["queries"][:FOLLOW_EG]
    out = {}
    for run, mb, depth in (("isolated", 8, 1), ("mb8_depth1", 8, 1),
                           ("mb8_depth2", 8, 2), ("mb64_depth1", 64, 1),
                           ("mb64_depth2", 64, 2)):
        iso = run == "isolated"
        qs = queries[:FOLLOW_ISOLATED] if iso else queries

        def serve(lines, mb=mb, depth=depth):
            return serve_follow(params, model, ds, vocab, lines, k=ctx["k"],
                                max_query_len=ctx["T"], index=ctx["index"],
                                micro_batch=mb, pipeline_depth=depth,
                                **modes["exact"])

        rec = {"order": "EGGE", "E": [], "G": []}
        ref = None
        for side in "EGGE":
            recs, stats, counts = _drive_follow(
                serve, qs, iso, [eager_packs()] if side == "E" else ())
            ref = recs if ref is None else ref
            require(recs == ref, f"follow[{run}]: the {side} run's records "
                    "differ from the eager run's")
            require(counts["lstm_pooled"] > 0,
                    f"follow[{run}] {side}: K1a never launched")
            rec[side].append({key: stats[key] for key in (
                "requests_per_s", "p50_ms", "p95_ms", "first_result_ms")})
        out[run] = rec
    return out


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
    from vfr_tpu_torch.ops.kernels.rnn_plan import PACK_ROWS

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
        # a pack of at most PACK_ROWS queries keeps K1's persistent
        # variant, a larger one takes the bulk variant
        require_persistent(counts, "lstm", f"follow[{tag}]",
                           "persistent" if mb <= PACK_ROWS
                           else "persistent_bulk", only=mb <= PACK_ROWS)
        if mode == "exact":
            # one select and one f32 score product a pack, as one K1a a pack
            require_row_topk(counts, counts["lstm_pooled"], f"follow[{tag}]")
            require_score_gemm(counts, counts["lstm_pooled"],
                               f"follow[{tag}]")
        require(mism == 0 and ddiff <= 1e-3,
                f"follow[{tag}]: vs serve_queries: {mism} moments differ, "
                f"max |d diff| {ddiff}")
        require(p_mism == 0 and p_ddiff <= 1e-3,
                f"follow[{tag}]: vs plain: {p_mism} moments differ, "
                f"max |d diff| {p_ddiff}")
    # pipeline depth 1 against 2 at micro-batch 8, in turns in this call
    # (the host's speed moves between calls): requests/s of the backlog
    def backlog_rate(mode, depth):
        _, stats, _ = _drive_follow(
            lambda lines: serve_follow(
                params, model, ds, vocab, lines, k=k, max_query_len=T,
                index=index, micro_batch=8, pipeline_depth=depth,
                **modes[mode]),
            queries, False)
        return stats["requests_per_s"]

    order = (1, 2, 2, 1) * 2
    turns = {mode: dict(depths=list(order), requests_per_s=[
        backlog_rate(mode, depth) for depth in order])
        for mode in ("exact", "fused")}
    eager_vs_graphed = _follow_eg(params, model, ds, vocab, ctx, modes)
    # host syncs of one pack's dispatch + fetch, by mode and line; the
    # exact top-k over the 210,000 rows may make none
    syncs = {f"{mode}_{n // 8}_packs": _sync_warnings(
        lambda kw=kw, n=n: list(serve_follow(
            params, model, ds, vocab, queries[:n], k=k, max_query_len=T,
            index=index, micro_batch=8, pipeline_depth=2, **kw)))
        for mode, kw in modes.items() for n in (8, 16)}
    topk_syncs = {run: line for run, by in syncs.items()
                  if run.startswith("exact") for line in by
                  if line.startswith(os.path.join("vfr_tpu_torch", "ops",
                                                  "topk.py"))}
    require(not topk_syncs, f"follow: the exact top-k synchronised with "
            f"the host: {topk_syncs}")
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
               runs=runs, depth_turns_mb8=turns,
               eager_vs_graphed=eager_vs_graphed, host_syncs_per_pack=syncs,
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


def _steady_syncs(fn) -> dict:
    """``_sync_warnings`` of a second call of ``fn``: the first call under
    the debug mode also reports a one-time sync inside torch.cuda."""
    _sync_warnings(fn)
    return _sync_warnings(fn)


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


def _fixed_batch_checks(model, index, q_params, toks, lens, k: int,
                        method: str):
    """One batch (``toks``, ``lens`` on the card) through ``make_retriever``
    over the fixed ``index``, as the benchmark's batch cells run it: the
    replay bit-equal to the eager batch on the library select (the
    long-row select on real scores); the replay and the eager batch under
    torch's sync debug mode "error" (any host sync fails it); the bf16
    product held to mm_f32 at the per-stream shape (K = 128,
    ``fused_corpus_distances``).  Fails or returns the record."""
    from unittest import mock

    import torch

    from vfr_tpu_torch.eval.corpus import _embed_query_streams, make_retriever
    from vfr_tpu_torch.ops import topk

    body = make_retriever(model, index, k, topk_method=method)
    args = (q_params, toks, lens)
    body(*args)                 # the capture
    got = body(*args)
    real = topk.select_route
    # eager: the patch reaches the route, not a replay
    with mock.patch.object(topk, "select_route",
                           lambda device_type, *a: real("none", *a)):
        ref = body.eager(*args)
    rec = dict(rows=index.num_rows, queries=int(toks.shape[0]), k=k,
               bit_equal_to_library_select=_same_bits(got, ref))
    sync_free = {}
    with torch.no_grad():
        for name, fn in (("replay", body), ("eager", body.eager)):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(*args)
                sync_free[name] = True
            except RuntimeError as e:
                sync_free[name] = str(e).splitlines()[0]
            finally:
                torch.cuda.set_sync_debug_mode("default")
        qs = _embed_query_streams(q_params, model, toks, lens)
        rec["bf16_product_per_stream"] = _product_vs_plain(
            2.0 * qs[0], index.m[0], index.m_sq[0],
            (qs[0] * qs[0]).sum(-1)[:, None], k, "per-stream")
    rec["batch_sync_free"] = sync_free
    require(rec["bit_equal_to_library_select"], "live[fixed index]: the "
            "replayed answers differ from the library select's")
    require(sync_free == {"replay": True, "eager": True},
            f"live[fixed index]: a batch synchronised with the host: "
            f"{sync_free}")
    return rec


def phase_live(results, seed: int, workdir: str, shards: int = 0):
    """``_fixed_batch_checks`` on a fixed index of the corpus below; then
    the live index of preset ``serving_10k`` (bf16 index, last pool,
    top-100): 10,000 videos in a 20,000-video arena (420,000 rows), 4
    appends of 128 videos, a removal of 500, compact, grow to 25,000,
    save -> load; after each, the live retriever at packs of 8 and 256
    held to itself through K1b's plain version and to a from-scratch
    ``build_moment_index`` + ``make_retriever`` through the plain version
    over the same corpus.  Then ``serve_follow`` over that arena (packs of
    8, depth 2) with queries between ``!add``, ``!remove`` and
    ``!compact``, each run of queries held to a shadow arena taken
    through the same operations and to a rebuild at the same point.
    The arena must be bf16 ``[cap, 256]`` + f32 norms, its bytes read from
    the tensors, with ``memory_allocated`` before and after the build; the
    bf16-operand score GEMM is held to its plain version on it
    (``_bf16_product_check``).
    Launch counts are zeroed just before each live retrieval and each
    daemon run and read just after; the references run outside those
    windows.  Then one ``cli serve --follow --live-capacity-videos``
    subprocess and a second booted from its ``!save``
    (``--live-arena``).

    With ``shards``, a second arena row-sharded over a "corpus" mesh takes
    the same operations: after each, its retrievals (counted apart, as the
    sharded phase's) are held to the unsharded arena's and to the rebuild;
    its snapshot loads on one device with equal results; and the daemon
    runs the same script over a sharded arena booted from the unsharded
    snapshot, held to the same shadow arena and rebuilds."""
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
    fixed = build_moment_index(params, model, ds, index_dtype=idx_dtype)
    fixed_batch = _fixed_batch_checks(model, fixed, q_params, toks, lens, k,
                                      method)
    del fixed
    torch.cuda.empty_cache()
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

    def arena_bytes(x):
        """The arena's bytes of rows and of norms, from its tensors."""
        return {part: sum(t.numel() * t.element_size() for t in shards)
                for part, shards in zip(("rows", "norms"), L._shards(x))}

    torch.cuda.synchronize()
    allocated = {"before_build": torch.cuda.memory_allocated(dev)}
    live, build_s = _timed(lambda: L.make_live_index(
        params, model, ds, capacity_videos=LIVE_CAPACITY,
        index_dtype=idx_dtype))
    allocated["after_build"] = torch.cuda.memory_allocated(dev)
    cap, width = LIVE_CAPACITY * ds.num_proposals, \
        len(model.streams) * cfg.model.joint_dim
    bytes_build = arena_bytes(live)
    require(live.m_cat.dtype == torch.bfloat16
            and tuple(live.m_cat.shape) == (cap, width)
            and live.msq_fused.dtype == torch.float32
            and tuple(live.msq_fused.shape) == (cap,)
            and bytes_build == {"rows": cap * width * 2, "norms": cap * 4},
            f"live: the arena is {live.m_cat.dtype} "
            f"{tuple(live.m_cat.shape)} + {live.msq_fused.dtype} norms "
            f"({bytes_build} bytes), not bf16 [{cap}, {width}] + f32")
    product = _bf16_product_check(model, q_params, live.m_cat,
                                  live.msq_fused, live.weights, toks, lens, k)
    retrieve = L.make_live_retriever(model, live, k, topk_method=method)
    ptr = live.m_cat.data_ptr()
    timings, checks = {}, {}
    live_s, launches_s, checks_s, timings_s = None, {}, {}, {}
    if shards:
        mesh = corpus_mesh(shards)
        live_s, timings_s["build_s"] = _timed(lambda: L.make_live_index(
            params, model, ds, capacity_videos=LIVE_CAPACITY,
            index_dtype=idx_dtype, mesh=mesh))
        retrieve_s = L.make_live_retriever(model, live_s, k,
                                           topk_method=method)
        require({t.dtype for t in live_s.m_cat} == {torch.bfloat16},
                "live[sharded]: the arena's shards are not bf16")

    def live_op(name, fn):
        """``fn(arena)`` on the live arena (timed under ``name``) and on the
        sharded one (timed apart); the unsharded result."""
        out, timings[name] = _timed(lambda: fn(live))
        if live_s is not None:
            out_s, timings_s[name] = _timed(lambda: fn(live_s))
            require(out_s == out, f"live[sharded] {name}: {out_s} != {out}")
        return out

    held = list(ds.video_ids)          # the corpus the arena should hold
    graphs = {}                        # the live retriever's graphs

    def check(label, new_captures, added=()):
        """Live retrieval (counted) at a pack of 8 and a batch of 256, vs
        the live retriever through K1b's plain version and vs a rebuild
        over ``held``; retrieve ms of both.  Each retrieval is one replay,
        bit-equal to the eager call; ``new_captures`` the graphs it must
        capture (none after an in-place write, one a shape after a grow;
        None: at most one a shape); ``added`` the videos just appended, of
        which some rows must come back."""
        alive = list(held)
        ref, ref_fn = rebuild(alive)
        d_r, r_r = host(ref_fn(q_params, toks, lens))
        key_r = _moment_keys(order, alive, ref.video_row, ref.prop_idx, r_r)
        del ref, ref_fn
        plain = L.make_live_retriever(model, live, k, topk_method=method,
                                      rnn_kernel="plain")
        before = retrieve.current().graphs.captures
        rec = dict(videos=len(alive))
        for Q in (8, 256):
            tq, lq = toks[:Q], lens[:Q]
            (d_l, r_l), _ = counted(lambda: host(retrieve(q_params, tq, lq)))
            _, rec[f"graph_q{Q}"] = graph_vs_eager(
                retrieve, retrieve.eager, [(q_params, tq, lq)],
                f"live[{label}] Q={Q}", retrieve.current().graphs)
            if added:
                found = {live.video_ids[v]
                         for v in live.video_row[r_l].ravel()}
                rec[f"q{Q}_added_videos_returned"] = len(found & set(added))
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
            if live_s is None:
                continue
            reset_counts()
            d_s, r_s = host(retrieve_s(q_params, tq, lq))
            _add_counts(launches_s, read_counts())
            key_s = _moment_keys(order, live_s.video_ids, live_s.video_row,
                                 live_s.prop_idx, r_s)
            u_mism, u_ddiff = compare_to_plain(d_s, key_s, d_l, key_l)
            b_mism, b_ddiff = compare_to_plain(d_s, key_s, d_r[:Q],
                                               key_r[:Q])
            checks_s.setdefault(label, {})[f"q{Q}"] = dict(
                rows_differing_from_unsharded=u_mism,
                max_distance_diff_vs_unsharded=u_ddiff,
                rows_differing_from_rebuild=b_mism,
                max_distance_diff_vs_rebuild=b_ddiff,
                retrieve_ms=time_batches(
                    lambda: retrieve_s(q_params, tq, lq)))
            require(u_mism == 0 and u_ddiff <= 1e-3 and b_mism == 0
                    and b_ddiff <= 1e-3, f"live[sharded {label}] Q={Q}: "
                    f"{checks_s[label][f'q{Q}']}")
        g = retrieve.current().graphs
        rec["captures"] = g.captures - before
        graphs[label] = dict(captures=g.captures - before,
                             capture_s=capture_seconds(g)[-rec["captures"]:]
                             if rec["captures"] else [],
                             pool_bytes=g.pool_bytes())
        require(rec["captures"] == new_captures if new_captures is not None
                else rec["captures"] <= 2, f"live[{label}]: "
                f"{rec['captures']} new captures, expected {new_captures}")
        require(not added or rec["q256_added_videos_returned"] > 0,
                f"live[{label}]: no row of the appended videos came back")
        checks[label] = rec

    check("build", 2)
    appends = []
    for a in range(LIVE_APPENDS):
        lo = a * LIVE_DELTA
        ids = new_ids[lo:lo + LIVE_DELTA]
        n = live_op("append_s", lambda x: L.live_append(
            x, params, model, ds, ids, dds.rgb_feats[lo:lo + LIVE_DELTA],
            dds.flow_feats[lo:lo + LIVE_DELTA]))
        require(n == LIVE_DELTA * ds.num_proposals, "live: append rows")
        held.extend(ids)
        appends.append(timings.pop("append_s"))
        if live_s is not None:
            timings_s.setdefault("appends_s", []).append(
                timings_s.pop("append_s"))
        check(f"append{a}", 0, added=ids)
    rng = np.random.default_rng(seed + 5)
    gone = [str(v) for v in rng.choice(live.video_ids, LIVE_REMOVE,
                                       replace=False)]
    n_rm = live_op("remove_s", lambda x: L.live_remove(x, gone))
    held = [v for v in held if v not in set(gone)]
    check("remove", 0)
    n_cp = live_op("compact_s", L.live_compact)
    require(n_rm == n_cp == LIVE_REMOVE * ds.num_proposals,
            f"live: removed {n_rm}, reclaimed {n_cp} rows")
    check("compact", 0)
    in_place = live.m_cat.data_ptr() == ptr
    require(in_place, "live: append / remove / compact reallocated the arena")
    live_op("grow_s", lambda x: L.live_grow(x, LIVE_GROW))
    require(live.capacity == LIVE_GROW * ds.num_proposals
            and live.m_cat.data_ptr() != ptr, "live: grow")
    check("grow", 2)
    path = os.path.join(workdir, "live_arena.npz")
    _, timings["save_s"] = _timed(lambda: L.save_arena(live, path,
                                                       params=params,
                                                       model=model))
    back, timings["load_s"] = _timed(lambda: L.load_arena(
        path, params=params, model=model))
    require(back.m_cat.dtype == torch.bfloat16
            and torch.equal(back.m_cat, live.m_cat)
            and torch.equal(back.msq_fused, live.msq_fused)
            and back.video_ids == live.video_ids
            and all(np.array_equal(getattr(back, f), getattr(live, f))
                    for f in ("video_row", "prop_idx", "spans_sec")),
            "live: save_arena -> load_arena is not bit-exact")
    live, retrieve = back, L.make_live_retriever(model, back, k,
                                                 topk_method=method)
    if live_s is not None:
        # the sharded snapshot on one device: the unsharded arena's results
        path_s = os.path.join(workdir, "live_arena_sharded.npz")
        _, timings_s["save_s"] = _timed(lambda: L.save_arena(
            live_s, path_s, params=params, model=model))
        one, timings_s["load_one_device_s"] = _timed(lambda: L.load_arena(
            path_s, params=params, model=model))
        d_o, r_o = host(L.make_live_retriever(model, one, k,
                                              topk_method=method)(
            q_params, toks, lens))
        d_b, r_b = host(retrieve(q_params, toks, lens))
        o_mism, o_ddiff = compare_to_plain(d_o, r_o, d_b, r_b)
        checks_s["sharded_snapshot_on_one_device"] = dict(
            rows_differing_from_unsharded=o_mism,
            max_distance_diff_vs_unsharded=o_ddiff,
            arena_bit_equal_to_unsharded=bool(
                torch.equal(one.m_cat, back.m_cat)
                and torch.equal(one.msq_fused, back.msq_fused)))
        require(o_mism == 0 and o_ddiff <= 1e-3,
                f"live[sharded] snapshot on one device: {o_mism} rows "
                f"differ, max |d diff| {o_ddiff}")
        del one
    # a new retriever: one capture a shape, less any the sharded snapshot's
    # comparison above made
    check("reload", None)
    bytes_reload = arena_bytes(live)

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
    if live_s is not None:
        # the same script over a sharded arena booted from the snapshot
        del live_s
        live_sd = L.load_arena(path, params=params, model=model, mesh=mesh)
        reset_counts()
        recs_s, daemon_s_s = _timed(lambda: list(serve_follow(
            params, model, ds, vocab, iter(script), k=k, max_query_len=T,
            topk_method=method, live=live_sd, mesh=mesh, micro_batch=8,
            pipeline_depth=2)))
        daemon_counts_s = read_counts()
        _add_counts(launches_s, daemon_counts_s)
        del live_sd
        require(daemon_counts_s["lstm_hs"] > 0,
                "live[sharded follow]: K1b (lstm_hs) never launched")
        require([r for r in recs_s if "command" in r]
                == [r for r in recs if "command" in r],
                "live[sharded follow]: control records differ")
        answered_s = [r for r in recs_s if "query" in r]
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
    if not shards:
        answered_s = None
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
        seg = slice(s * LIVE_FOLLOW_SEGMENT, (s + 1) * LIVE_FOLLOW_SEGMENT)
        ref_a = _records(texts, d_a, r_a, shadow.video_ids,
                         shadow.video_row, shadow.spans_sec)
        ref_b = _records(texts, d_b, r_b, list(held), ref.video_row,
                         ref.spans_sec)
        del ref, ref_fn
        for what, got in (("", answered), ("sharded ", answered_s)):
            if got is None:
                continue
            a_mism, a_ddiff = compare_records(got[seg], ref_a)
            b_mism, b_ddiff = compare_records(got[seg], ref_b)
            follow_checks.append(dict(
                daemon=what + "arena", videos=len(held),
                rows_differing_from_shadow_arena=a_mism,
                max_distance_diff_vs_shadow_arena=a_ddiff,
                rows_differing_from_rebuild=b_mism,
                max_distance_diff_vs_rebuild=b_ddiff))
            require(a_mism == 0 and a_ddiff <= 1e-3 and b_mism == 0
                    and b_ddiff <= 1e-3,
                    f"live[{what}follow] segment {s}: {follow_checks[-1]}")
    del shadow
    require(launches["lstm_hs"] > 0, "live: K1b (lstm_hs) never launched")
    cli = _live_cli(workdir)
    rec = dict(phase="live", preset="serving_10k", videos=LIVE_VIDEOS,
               capacity_videos=LIVE_CAPACITY, grown_to=LIVE_GROW, k=k,
               setup_s=setup_s, fixed_batch=fixed_batch,
               arena_build_s=build_s,
               append_s=appends, append_first_s=appends[0],
               append_steady_s=float(np.median(appends[1:])),
               **timings, arena_in_place=in_place, reload_bit_exact=True,
               arena=dict(dtype=str(live.m_cat.dtype).split(".")[-1],
                          width=width, bytes_at_build=bytes_build,
                          rows_at_build=cap, bytes_after_reload=bytes_reload,
                          rows_after_reload=live.capacity,
                          memory_allocated=allocated),
               bf16_product=product, graphs=graphs,
               launches=launches, checks=checks,
               follow=dict(micro_batch=8, pipeline_depth=2,
                           requests=len(answered), controls=len(acks),
                           seconds=daemon_s,
                           requests_per_s=len(answered) / daemon_s,
                           launches=daemon_counts, segments=follow_checks),
               cli=cli)
    emit(rec)
    results["live"] = rec
    if shards:
        _sharded_record(results, "live", launches_s, dict(
            shards=shards, timings=timings_s, checks=checks_s,
            follow=dict(requests=len(answered_s), seconds=daemon_s_s,
                        requests_per_s=len(answered_s) / daemon_s_s,
                        launches=daemon_counts_s)))


def _host_us(fn, calls: int = 50) -> float:
    """Host µs a call of ``fn`` spends issuing its work: the host clock
    over ``calls`` back-to-back calls that enqueue on the stream, no sync
    among them (the card drains them afterwards)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def _product_vs_plain(qc, m, msq, sq, k: int, name: str):
    """The score product on a bf16 operand ``m`` [N, D]
    (``parallel.sharding.score_mm``: one bf16 GEMM into f32 sums) against
    its plain version (``mm_f32``: both operands upcast, an f32 GEMM) on
    the same queries ``qc`` [Q, D]: the top-k rows of ``sq + msq - 2 q.m``
    equal outside near-ties and distances within 1e-3; ms of both by CUDA
    events, the GEMM's bound (each operand read once, the f32 scores
    written once) and each one's host µs a call (``_host_us``)."""
    import torch

    from vfr_tpu_torch.device import mm_f32
    from vfr_tpu_torch.ops.topk import top_k_select
    from vfr_tpu_torch.parallel.sharding import score_mm

    require(m.dtype == torch.bfloat16, f"bf16 product {name}: operand is "
            f"{m.dtype}")
    (Q, D), N = qc.shape, m.shape[0]
    ours = lambda: score_mm(qc, m.T, torch.bfloat16)  # noqa: E731
    plain = lambda: mm_f32(qc, m.T, torch.bfloat16)  # noqa: E731
    s_k, s_p = ours() - msq[None, :], plain() - msq[None, :]
    (v_k, r_k), (v_p, r_p) = top_k_select(s_k, k), top_k_select(s_p, k)
    mism, ddiff = compare_to_plain(*(t.cpu().numpy() for t in (
        sq - v_k, r_k, sq - v_p, r_p)))
    del s_k, s_p
    b_ms, b_by = bound(N * D * 2 + Q * D * 2 + Q * N * 4, 2.0 * Q * N * D,
                       "bfloat16")
    require(mism == 0 and ddiff <= 1e-3,
            f"bf16 product {name}: vs mm_f32: {mism} rows differ, max "
            f"|d diff| {ddiff}")
    return dict(shape=[Q, N, D], rows_differing_from_plain=mism,
                max_distance_diff_vs_plain=ddiff, ms=cuda_ms(ours),
                plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
                host_us=_host_us(ours), plain_host_us=_host_us(plain))


def _bf16_product_check(model, q_params, m_cat, msq, weights, toks, lens,
                        k: int):
    """``_product_vs_plain`` on the live arena's bf16 operand at packs of
    8 and 256 queries; then the arena upcast to f32 under the same bf16
    compute (rounded back to bf16 in each product, as an f32 arena of a
    bf16-compute model is) through one operand retriever beside the bf16
    arena: the answers equal, bit for bit."""
    import torch

    from vfr_tpu_torch.eval.corpus import (
        _embed_query_streams,
        make_operand_retriever,
    )
    from vfr_tpu_torch.parallel.sharding import (
        query_cat_scaled,
        query_sq_const,
    )

    out = {}
    with torch.no_grad():
        for Q in (8, 256):
            qs = _embed_query_streams(q_params, model, toks[:Q], lens[:Q])
            out[f"q{Q}"] = _product_vs_plain(
                query_cat_scaled(qs, weights), m_cat, msq,
                query_sq_const(qs, weights)[:, None], k, f"live Q={Q}")
    op = make_operand_retriever(model, weights, k)
    args = (q_params, toks, lens)
    out["f32_operand_answers_equal"] = all(
        torch.equal(a, b) for a, b in zip(op(m_cat.float(), msq, *args),
                                          op(m_cat, msq, *args)))
    require(out["f32_operand_answers_equal"], "live: the arena upcast to "
            "f32 under bf16 compute answers otherwise than the bf16 arena")
    return out


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
        tc = results.get("train_charades", {})
        return dict(follow=follow_launches(name), live=live_launches(name),
                    sharded=results.get("sharded", {}).get(
                        "launches", {}).get(name, 0),
                    train_dp=eval_launches(name, ("train_dp",)),
                    train_charades=(eval_launches(name, ("train_charades",))
                                    + tc.get("loop_launches", {}).get(name,
                                                                      0)),
                    devices=results.get("devices", {}).get(
                        "launches", {}).get(name, 0))

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
                        variant=r["variant"], stepwise_ms=r["stepwise_ms"],
                        chunked_B512=r["chunks"]["B512"]))
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
    # the long-row top-k replaces no Pallas kernel: jax.lax.top_k's select
    if "row_topk" in results:
        r = results["row_topk"]
        name = "row_topk_filter"         # each comes with one merge
        out.append(dict(name="row_topk", route="cuda",
                        source="vfr_tpu_torch/csrc/row_topk.cu",
                        replaces="jax.lax.top_k (XLA)", checked=r["cases"],
                        launches=served("flagship", "launches", name),
                        eval_launches=eval_launches(name),
                        train_launches=train_launches(name),
                        **new_paths(name),
                        graph_launches=r["graph"]["counted"],
                        times=[{key: t[key] for key in ("shape", "ms",
                                                        "device_ms",
                                                        "plain_ms",
                                                        "library_ms",
                                                        "bound_ms",
                                                        "bound_by")}
                               for t in r["times"]]))
    # the score GEMM replaces no Pallas kernel: XLA's dot of the score
    if "score_gemm" in results:
        r = results["score_gemm"]
        name = "score_gemm"
        out.append(dict(name=name, route="cuda",
                        source="vfr_tpu_torch/csrc/score_gemm.cu",
                        replaces="XLA's dot (parallel/sharding.py)",
                        launches=served("flagship", "launches", name),
                        eval_launches=eval_launches(name),
                        train_launches=train_launches(name),
                        **new_paths(name),
                        second_card=r["second_card"],
                        times=[{key: t[key] for key in (
                            "shape", "max_abs_err_vs_f64",
                            "library_err_vs_f64", "ms", "device_ms",
                            "plain_ms", "library_ms", "bound_ms",
                            "bound_by")} for t in r["times"]]))
    return {"kernels": out}


ALL_PHASES = ("kernels", "flagship", "coarse", "devices", "follow", "eval",
              "sharded", "train", "train_charades", "train_dp", "packed",
              "eval_charades", "serving_10k", "live", "gru", "coarse_2m")
# the phases whose set-ups the sharded checks ride on
SHARDED_HOSTS = ("flagship", "eval_charades", "live", "coarse_2m")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of " + ", ".join(ALL_PHASES)
                         + " and profile (coarse, devices, follow and eval "
                           "need flagship; sharded adds its mesh checks to "
                         + ", ".join(SHARDED_HOSTS) + " and runs them); the "
                           "default runs all but profile and is the only "
                           "one that ends with the ok line; rnn runs the "
                           "K1 / K3 kernel checks alone, select the K2 and "
                           "coarse_kernel the K4 checks, row_topk the "
                           "long-row top-k's, score_gemm the score "
                           "GEMM's, mamba2_scan the Nemotron-H tower's "
                           "fused Mamba-2 kernel's, kda_chunk the Kimi "
                           "Linear tower's KDA kernel's, steps prints the "
                           "persistent kernels' per-step time split, "
                           "wgmma_rate the tensor cores' own time for it, "
                           "trace runs the mesh part of the phases "
                           "given and adds host traces to coarse_2m and "
                           "train_dp")
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
    shards = 4 if phases & {"sharded", "trace"} else 0
    if "sharded" in phases:
        phases |= set(SHARDED_HOSTS)
    if "devices" in phases:
        phases.add("flagship")
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
        for cell in ("lstm", "gru"):
            phase_rnn(results, SEED, cell)
            phase_rnn_chunks(results, SEED, cell)
    if phases & {"kernels", "select"}:
        phase_select(results, SEED)
        settle()
    if phases & {"kernels", "coarse_kernel"}:
        phase_coarse_kernel(results, SEED)
        settle()
    if phases & {"kernels", "row_topk"}:
        phase_row_topk(results, SEED)
        settle()
    if phases & {"kernels", "score_gemm"}:
        phase_score_gemm(results, SEED)
        settle()
    if phases & {"kernels", "mamba2_scan"}:
        phase_mamba2_scan(results, SEED)
        settle()
    if phases & {"kernels", "kda_chunk"}:
        phase_kda_chunk(results, SEED)
        settle()
    with tempfile.TemporaryDirectory() as workdir:
        if "flagship" in phases:
            ctx = phase_serving(results, SEED, VIDEOS, workdir)
            if "coarse" in phases:
                phase_coarse(results, ctx, workdir)
                settle()
            if "devices" in phases:
                phase_devices(results, ctx, workdir)
                settle()
            if "follow" in phases:
                phase_follow(results, ctx, workdir)
                settle()
            if "eval" in phases:
                phase_eval(results, ctx)
                settle()
            if "sharded" in phases:
                phase_sharded(results, ctx)
            del ctx
            settle()
        if "train" in phases:
            phase_train(results, SEED, workdir)
            settle()
        if "train_charades" in phases:
            phase_train_charades(results, SEED + 17, workdir,
                                 VIDEOS_CHARADES)
            settle()
        if "train_dp" in phases:
            phase_train_dp(results, SEED, workdir, trace="trace" in phases)
            settle()
        if "packed" in phases:
            phase_packed(results, SEED, workdir)
            settle()
        if "live" in phases:
            phase_live(results, SEED, workdir, shards=shards)
            settle()
    if "eval_charades" in phases:
        phase_eval_charades(results, SEED + 17, VIDEOS_CHARADES,
                            shards=shards)
        settle()
    if "serving_10k" in phases:
        phase_serving_10k(results, SEED, VIDEOS_10K)
        settle()
    if "gru" in phases:
        phase_gru(results, SEED, VIDEOS_10K)
        settle()
    if "coarse_2m" in phases:
        phase_coarse_2m(results, SEED, VIDEOS_2M, shards=shards,
                        trace="trace" in phases)
        settle()
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
