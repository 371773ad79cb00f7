#!/usr/bin/env python
"""The Charades-STA quality run at 2,000 videos, on the PyTorch port: the
twin of the JAX package's ``scripts/quality_run_charades_large.py``.

Same fixture (2,000 videos, 16,000 queries, 800 words, noise 0.25, two
planted moments per video, fixture seed 0; one val query per video, so
the val index covers every video: 128,000 window rows), same recipe
(``charades_flagship``: InfoNCE over cosine, tau 0.02, B=64, last query
pool, EMA 0.999, 8 mined negatives refreshed every epoch from epoch 3,
20 epochs; about two chunks per epoch).  Writes ``final_metrics.json``
and ``metrics.jsonl`` under ``--out`` with the JAX twin's keys (the
threshold-protocol eval of the final epoch, corpus retrieval over the
whole window bank, mining refresh seconds, wall times), plus the card's
name and power limit, the training seed, step ms (median over the
chunks) and the served (EMA) weights' fingerprint.

    python -m vfr_tpu_torch.scripts.quality_run_charades_large --out DIR

``--seed N`` sets the training seed (initialisation, batch order,
dropout; the fixture stays at seed 0); -1 keeps the preset's.
Checkpoints go to ``--checkpoint-dir`` (a temporary directory by
default); ``--resume`` continues a run from there, ``--epochs`` cuts the
run (recorded as such).  ``--num-videos`` / ``--num-queries`` shrink the
fixture for a plumbing run (``--device cpu`` runs on the CPU).
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

from vfr_tpu_torch.scripts.quality_run_large import _card

NUM_VIDEOS = 2_000
NUM_QUERIES = 16_000
VOCAB_WORDS = 800
MOMENTS_PER_VIDEO = 2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--epochs", type=int, default=0,
                    help="0 = the preset's 20")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=-1,
                    help="training seed (-1 = the preset's)")
    ap.add_argument("--num-videos", type=int, default=NUM_VIDEOS)
    ap.add_argument("--num-queries", type=int, default=NUM_QUERIES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.data.charades import CharadesSTADataset
    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.data.loaders import DataBundle
    from vfr_tpu_torch.data.synthetic import make_charades_fixture
    from vfr_tpu_torch.device import resolve_device
    from vfr_tpu_torch.eval.corpus import corpus_evaluate
    from vfr_tpu_torch.train.loop import train
    from vfr_tpu_torch.utils.io import tree_fingerprint

    dev = resolve_device(args.device)
    n_videos, n_queries = args.num_videos, args.num_queries
    os.makedirs(args.out, exist_ok=True)
    metrics_path = os.path.join(args.out, "metrics.jsonl")
    if os.path.exists(metrics_path) and not args.resume:
        os.remove(metrics_path)
    tmp = None
    ck = args.checkpoint_dir
    if ck is None:
        tmp = tempfile.TemporaryDirectory()
        ck = tmp.name
    base = get_preset("charades_flagship")
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, data_dir=os.path.join(args.out, "no_real_data"),
            synthetic_num_videos=n_videos, synthetic_num_queries=n_queries,
            synthetic_noise=0.25, synthetic_vocab_words=VOCAB_WORDS,
            synthetic_moments_per_video=MOMENTS_PER_VIDEO),
        train=dataclasses.replace(
            base.train,
            num_epochs=args.epochs or base.train.num_epochs,
            # about two chunks (metric fetches) per epoch, as the JAX twin
            steps_per_call=max(1, (n_queries - n_videos)
                               // base.train.batch_size // 2),
            checkpoint_every_epochs=10, keep_checkpoints=1,
            checkpoint_dir=ck, metrics_path=metrics_path,
            **({"seed": args.seed} if args.seed >= 0 else {})),
        eval=dataclasses.replace(base.eval, eval_batch_size=512,
                                 corpus_query_batch=256))

    t0 = time.perf_counter()
    fix = make_charades_fixture(
        num_videos=n_videos, num_queries=n_queries,
        feature_dim=cfg.data.feature_dim, glove_dim=cfg.data.glove_dim,
        max_duration=cfg.data.max_duration,
        feature_seconds=cfg.data.feature_seconds,
        noise=cfg.data.synthetic_noise, with_flow=cfg.data.use_flow,
        vocab_words=VOCAB_WORDS, moments_per_video=MOMENTS_PER_VIDEO,
        seed=cfg.data.synthetic_seed)
    # one val query per video: the val index covers every corpus video
    by_video = defaultdict(list)
    for a in fix.annotations:
        by_video[a["video"]].append(a)
    train_anns, val_anns = [], []
    for v in sorted(by_video):
        val_anns.append(by_video[v][-1])
        train_anns.extend(by_video[v][:-1])
    flow = fix.flow if cfg.data.use_flow else None
    train_ds = CharadesSTADataset(train_anns, fix.rgb, flow, fix.vocab,
                                  cfg.data)
    val_ds = CharadesSTADataset(val_anns, fix.rgb, flow, fix.vocab, cfg.data)
    bundle = DataBundle(train_ds, val_ds, fix.vocab, fix.glove,
                        cfg.data.feature_dim, "synthetic")
    t_fixture = time.perf_counter() - t0
    print(f"[fixture] {n_videos} videos, train {train_ds.num_queries} / "
          f"val {val_ds.num_queries} queries, built in {t_fixture:.0f}s",
          file=sys.stderr, flush=True)
    # the banks go up once, for the loop and the corpus eval after it;
    # Charades' carry video_tef (mined negatives re-embed with it)
    device_banks = {
        split: banks_to_device({**ds.feature_banks(),
                                "video_tef": ds.video_tef},
                               cfg.data.bank_dtype, device=dev)
        for split, ds in (("train", train_ds), ("val", val_ds))}

    t0 = time.perf_counter()
    params, final_eval = train(cfg, bundle=bundle, resume=args.resume,
                               device_banks=device_banks, device=dev)
    t_train = time.perf_counter() - t0
    from vfr_tpu_torch.models.build import build_model

    model = build_model(cfg, dataset=bundle.train)
    t0 = time.perf_counter()
    corpus = corpus_evaluate(params, model, val_ds, cfg.eval,
                             feature_banks=device_banks["val"])
    t_corpus = time.perf_counter() - t0

    records = [json.loads(l) for l in open(metrics_path, encoding="utf-8")]
    refresh_s = [r["refresh_s"] for r in records if r["tag"] == "mine"]
    steps = [r for r in records if r["tag"] == "train"]
    setup = next((r for r in records if r["tag"] == "setup"), {})
    out = {
        "preset": "charades_flagship",
        "card": _card(),
        "params_fingerprint": tree_fingerprint(params),
        "ema_decay": cfg.train.ema_decay,
        "loss": {"type": cfg.train.loss_type,
                 "temperature": cfg.train.temperature,
                 "lambda_intra": cfg.train.lambda_intra,
                 "lambda_inter": cfg.train.lambda_inter},
        "model": {"distance": cfg.model.distance,
                  "joint_dim": cfg.model.joint_dim,
                  "query_pool": cfg.model.query_pool},
        "fixture": {"num_videos": n_videos,
                    "num_queries_train": train_ds.num_queries,
                    "num_queries_val": val_ds.num_queries,
                    "noise": cfg.data.synthetic_noise,
                    "vocab_words": VOCAB_WORDS,
                    "moments_per_video": MOMENTS_PER_VIDEO,
                    "seed": cfg.data.synthetic_seed},
        "train_seed": cfg.train.seed,
        "epochs": cfg.train.num_epochs,
        "epochs_in_log": max((r["epoch"] for r in steps), default=-1) + 1,
        "batch_size": cfg.train.batch_size,
        "steps": steps[-1]["step"] if steps else 0,
        "step_ms_median": (float(np.median([r["step_ms"] for r in steps]))
                           if steps else None),
        "window_bank": {"scales": list(cfg.data.window_scales),
                        "stride_ratio": cfg.data.window_stride_ratio,
                        "max_windows": cfg.data.max_windows},
        "mining": {
            "count": cfg.train.hard_negative_count,
            "refresh_epochs": cfg.train.hard_negative_refresh_epochs,
            "num_refreshes": len(refresh_s),
            "refresh_wall_s_first": refresh_s[0] if refresh_s else None,
            "refresh_wall_s_median_steady": (
                float(np.median(refresh_s[1:]))
                if len(refresh_s) > 1 else None),
        },
        "wall_s": {"fixture": round(t_fixture, 1),
                   "train_total": round(t_train, 1),
                   "corpus_eval": round(t_corpus, 1),
                   "loop_init": setup.get("init_s"),
                   "bank_upload": setup.get("bank_upload_s"),
                   "bank_mb": setup.get("bank_mb")},
        "scale_note": (
            f"{n_videos} videos x {cfg.data.max_windows} windows = "
            f"{n_videos * cfg.data.max_windows} index rows (the JAX "
            "package's twin: 2,000 videos = 1.5x the real Charades-STA "
            "test corpus)"),
        "chance_video_R@1": 1.0 / n_videos,
        "eval_threshold": final_eval,
        # Charades-STA has one GT interval per query: "threshold" is its
        # official protocol, as the JAX twin records
        "eval_official": "N/A: didemo_official rank-aggregation protocol "
                         "is DiDeMo-specific (single-GT dataset)",
        "corpus": corpus,
    }
    path = os.path.join(args.out, "final_metrics.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    print(json.dumps({k: out[k] for k in ("card", "train_seed", "corpus",
                                          "eval_threshold", "mining",
                                          "step_ms_median", "wall_s")},
                     sort_keys=True))
    print(f"wrote {path}")
    if tmp is not None:
        tmp.cleanup()


if __name__ == "__main__":
    main()
