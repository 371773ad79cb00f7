#!/usr/bin/env python
"""The flagship quality run at 10,000 videos, on the PyTorch port: the
twin of the JAX package's ``scripts/quality_run_large.py``.

Same fixture (10,000 videos, 66,000 queries, 2,000 words, noise 0.25,
seed 0; one val query per video, so the val index covers every video,
210,000 rows), same recipe (``didemo_flagship``: InfoNCE over cosine, tau
0.018, B=128, mean query pool, EMA 0.999, 8 mined negatives refreshed
every epoch from epoch 3; eval every 4th epoch, one chunk per epoch).
Writes ``final_metrics.json`` and ``metrics.jsonl`` under ``--out``: train
wall time, step ms (median over the epoch chunks), mining refresh
seconds, per-video and corpus metrics of the served (EMA) weights, and
the coarse prefilter's recall@10 against the exact retriever on the
trained embeddings (d_coarse 32, C=2048, blockmax and centroid), with the
card's name and power limit.

    python -m vfr_tpu_torch.scripts.quality_run_large --out DIR

Checkpoints go to ``--checkpoint-dir`` (a temporary directory by
default; about 100 MB each).  ``--resume`` continues a run from there, for
runs split across calls; ``--epochs`` cuts the run (recorded as such).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

NUM_VIDEOS = 10_000
NUM_QUERIES = 66_000
VOCAB_WORDS = 2_000


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _coarse_recall(params, model, dataset, index, eval_cfg, d_coarse=32,
                   cands=2048, k=10):
    """recall@k of the coarse retriever (blockmax and centroid) against the
    exact retriever over every val query, and the coarse build seconds."""
    import torch

    from vfr_tpu_torch.eval.coarse import (
        build_coarse_index,
        make_coarse_retriever,
    )
    from vfr_tpu_torch.eval.corpus import _params_device, make_retriever

    dev = _params_device(params)
    t0 = time.perf_counter()
    coarse = build_coarse_index(index, d_coarse=d_coarse)
    build_s = time.perf_counter() - t0
    exact = make_retriever(model, index, k, rnn_kernel=eval_cfg.rnn_kernel)
    modes = {m: make_coarse_retriever(model, coarse, k, num_candidates=cands,
                                      mode=m, rnn_kernel=eval_cfg.rnn_kernel)
             for m in ("blockmax", "centroid")}
    hits = {m: 0 for m in modes}
    n = 0
    for b in dataset.eval_batches(eval_cfg.corpus_query_batch,
                                  with_features=False):
        toks = torch.from_numpy(b["tokens"]).to(dev)
        lens = torch.from_numpy(b["lengths"]).to(dev)
        ref = exact(params, toks, lens)[1].cpu().numpy()
        valid = b["valid"]
        for m, fn in modes.items():
            got = fn(params, toks, lens)[1].cpu().numpy()
            hits[m] += sum(len(set(r) & set(g)) for r, g, v in
                           zip(ref, got, valid) if v)
        n += int(valid.sum())
    return {"d_coarse": d_coarse, "candidates": cands, "k": k,
            "build_s": round(build_s, 3),
            **{f"recall@{k}_{m}": hits[m] / (k * n) for m in modes}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--epochs", type=int, default=0,
                    help="0 = the preset's 20")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=-1,
                    help="fixture/init seed override (-1 = preset default)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.data.didemo import DidemoDataset
    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.data.loaders import DataBundle
    from vfr_tpu_torch.data.synthetic import make_didemo_fixture
    from vfr_tpu_torch.device import resolve_device
    from vfr_tpu_torch.eval.corpus import build_moment_index, corpus_evaluate
    from vfr_tpu_torch.eval.moment_eval import evaluate
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.train.loop import train
    from vfr_tpu_torch.utils.io import tree_fingerprint

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    metrics_path = os.path.join(args.out, "metrics.jsonl")
    if os.path.exists(metrics_path) and not args.resume:
        os.remove(metrics_path)
    tmp = None
    ck = args.checkpoint_dir
    if ck is None:
        tmp = tempfile.TemporaryDirectory()
        ck = tmp.name
    base = get_preset("didemo_flagship")
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, data_dir=os.path.join(args.out, "no_real_data"),
            synthetic_num_videos=NUM_VIDEOS,
            synthetic_num_queries=NUM_QUERIES, synthetic_noise=0.25,
            synthetic_vocab_words=VOCAB_WORDS,
            **({"synthetic_seed": args.seed} if args.seed >= 0 else {})),
        train=dataclasses.replace(
            base.train,
            num_epochs=args.epochs or base.train.num_epochs,
            eval_every_epochs=4, checkpoint_every_epochs=4,
            keep_checkpoints=1, checkpoint_dir=ck,
            metrics_path=metrics_path,
            **({"seed": base.train.seed + args.seed + 1}
               if args.seed >= 0 else {})),
        eval=dataclasses.replace(base.eval, eval_batch_size=512,
                                 corpus_query_batch=256))

    t0 = time.perf_counter()
    fix = make_didemo_fixture(
        num_videos=NUM_VIDEOS, num_queries=NUM_QUERIES,
        feature_dim=cfg.data.feature_dim, glove_dim=cfg.data.glove_dim,
        noise=cfg.data.synthetic_noise, with_flow=True,
        vocab_words=VOCAB_WORDS, seed=cfg.data.synthetic_seed)
    by_video = defaultdict(list)
    for a in fix.annotations:
        by_video[a["video"]].append(a)
    train_anns, val_anns = [], []
    for v in sorted(by_video):
        val_anns.append(by_video[v][-1])
        train_anns.extend(by_video[v][:-1])
    train_ds = DidemoDataset(train_anns, fix.rgb, fix.flow, fix.vocab,
                             cfg.data)
    val_ds = DidemoDataset(val_anns, fix.rgb, fix.flow, fix.vocab, cfg.data)
    bundle = DataBundle(train_ds, val_ds, fix.vocab, fix.glove,
                        cfg.data.feature_dim, "synthetic")
    # one chunk (and one metrics fetch) per epoch
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps_per_call=max(
            1, train_ds.num_queries // cfg.train.batch_size)))
    t_fixture = time.perf_counter() - t0
    print(f"[fixture] {NUM_VIDEOS} videos, train {train_ds.num_queries} / "
          f"val {val_ds.num_queries} queries, built in {t_fixture:.0f}s",
          file=sys.stderr, flush=True)
    device_banks = {
        "train": banks_to_device(dict(train_ds.feature_banks()),
                                 cfg.data.bank_dtype, device=dev),
        "val": banks_to_device(dict(val_ds.feature_banks()),
                               cfg.data.bank_dtype, device=dev)}

    t0 = time.perf_counter()
    params, final_eval = train(cfg, bundle=bundle, resume=args.resume,
                               device_banks=device_banks, device=dev)
    t_train = time.perf_counter() - t0
    model = build_model(cfg, dataset=bundle.train)
    official = evaluate(
        params, model, val_ds,
        dataclasses.replace(cfg.eval, protocol="didemo_official"),
        feature_banks=device_banks["val"])
    t0 = time.perf_counter()
    corpus = corpus_evaluate(params, model, val_ds, cfg.eval,
                             feature_banks=device_banks["val"])
    t_corpus = time.perf_counter() - t0
    index = build_moment_index(params, model, val_ds,
                               with_fingerprint=False,
                               feature_banks=device_banks["val"])
    coarse = _coarse_recall(params, model, val_ds, index, cfg.eval)

    records = [json.loads(l) for l in open(metrics_path, encoding="utf-8")]
    refresh_s = [r["refresh_s"] for r in records if r["tag"] == "mine"]
    steps = [r for r in records if r["tag"] == "train"]
    epochs_done = max((r["epoch"] for r in steps), default=-1) + 1
    out = {
        "preset": "didemo_flagship",
        "card": _card(),
        "params_fingerprint": tree_fingerprint(params),
        "epochs": cfg.train.num_epochs,
        "epochs_in_log": epochs_done,
        "batch_size": cfg.train.batch_size,
        "steps": steps[-1]["step"] if steps else 0,
        "step_ms_median": (float(np.median([r["step_ms"] for r in steps]))
                           if steps else None),
        "step_ms_first_chunk": steps[0]["step_ms"] if steps else None,
        "fixture": {"num_videos": NUM_VIDEOS,
                    "num_queries_train": train_ds.num_queries,
                    "num_queries_val": val_ds.num_queries,
                    "noise": cfg.data.synthetic_noise,
                    "vocab_words": VOCAB_WORDS,
                    "seed": cfg.data.synthetic_seed},
        "mining": {"count": cfg.train.hard_negative_count,
                   "num_refreshes": len(refresh_s),
                   "refresh_s": refresh_s},
        "wall_s": {"fixture": round(t_fixture, 1),
                   "train_total": round(t_train, 1),
                   "corpus_eval": round(t_corpus, 1)},
        "chance_video_R@1": 1.0 / NUM_VIDEOS,
        "eval_threshold": final_eval,
        "eval_official": official,
        "corpus": corpus,
        "coarse": coarse,
    }
    path = os.path.join(args.out, "final_metrics.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    print(json.dumps({k: out[k] for k in ("card", "corpus", "coarse",
                                          "step_ms_median", "wall_s")},
                     sort_keys=True))
    print(f"wrote {path}")
    if tmp is not None:
        tmp.cleanup()


if __name__ == "__main__":
    main()
