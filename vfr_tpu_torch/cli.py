"""CLI of the PyTorch port: ``train``, ``eval``, ``corpus``, ``index``,
``serve`` and ``pack``.

    python -m vfr_tpu_torch.cli train  --preset didemo_flagship \
        --checkpoint-dir ck
    python -m vfr_tpu_torch.cli eval   --preset charades_flagship
    python -m vfr_tpu_torch.cli corpus --preset didemo_flagship \
        --topk-method fused
    python -m vfr_tpu_torch.cli index --preset didemo_flagship --out idx.npz
    python -m vfr_tpu_torch.cli serve --preset didemo_flagship \
        --index-path idx.npz --queries queries.txt --topk 10
    python -m vfr_tpu_torch.cli serve --preset didemo_flagship \
        --queries - --follow --live-capacity-videos 20000
    python -m vfr_tpu_torch.cli pack --npz features_rgb.npz \
        --out features_rgb.vfrf

``eval`` is per-video localization (``--protocol threshold`` or
``didemo_official``), ``corpus`` corpus retrieval eval (through the exact,
fused or, with ``--coarse-dim``, coarse retriever); both print the metric
dict and score queries with the f32 scan twin of the recurrence
(``EvalConfig.rnn_kernel="scan"``), as the JAX package does.

``train`` runs the training loop (``train.loop.train``) and writes step
checkpoints (``ckpt_<step>.npz``, plus ``best.npz`` with
``--best-metric``) that ``eval`` / ``corpus`` / ``index`` / ``serve
--checkpoint-dir`` open (``--best`` for ``best.npz``); ``--debug-nans``
turns on autograd's anomaly detection.

``index --coarse-dim D`` also writes the coarse prefilter to
``<out>.coarse.npz``; ``serve --index-path idx.npz --coarse-path
idx.coarse.npz`` (or ``--coarse-dim D`` to build it in-process) serves
through the two-stage retriever (``--coarse-mode``,
``--coarse-candidates``).

``serve --follow`` is the daemon (``eval.corpus.serve_follow``): queries
from ``--queries`` (``-`` for stdin) are packed up to ``--micro-batch`` per
dispatch and answered one JSON line each, flushed.  With
``--live-capacity-videos N`` (or ``--live-arena snapshot.npz``) it serves
a live index (``eval.live``) that control lines change while it runs.
``pack`` writes the packed ``.vfrf`` feature store the loaders prefer.

``train --trace-dir D`` and ``serve --trace-dir D`` (with ``--follow``
too) run torch.profiler over the training loop or the serving and write
its Chrome trace (``D/train_trace.json``, ``D/serve_trace.json``), and
beside it ``D/port_spans.json``: the port's own spans, counters and stage
maps (``utils/trace.py``) in Chrome trace format on the same time base,
so that both load into one Perfetto view.  While the profiler runs the
port records its hot-path spans:
- ``graphs.call`` (one batch call on the card: a CUDA graph replay) and
  its parts ``graphs.key``, ``graphs.inputs``, ``graphs.replay``,
  ``graphs.outputs``;
- under ``--follow``, a pack's ``pack.tokens`` (tokenizing),
  ``pack.dispatch`` (copies in, the retrieval, copies out),
  ``pack.wait`` (waiting on the card) and ``pack.records`` (the JSON
  records built), and each request's ``request`` (the line read to its
  record) with its ``queue`` (read to packed), the request's parent
  being its pack;
- always, the set-up spans ``kernels.load`` / ``kernels.build`` (a
  kernel library loaded, compiled first), ``graphs.capture`` /
  ``graphs.warm`` / ``graphs.record`` (a batch captured as a graph),
  ``setup.operands`` and ``setup.query_params``.
The counters (``otherData.counters``) count batch calls, replays,
captures and evictions (``graphs.*``), each top-k's route
(``select.kernel``, ``select.key64``, ``select.order32_tie``), the
daemon's requests, packs, pack sizes and idle flushes (``daemon.*``) and
every kernel's launches (``<kernel>_kernel.launches.*``).

The flags are the JAX package's for these subcommands, plus ``--device``
(default ``cuda``; ``--device cpu`` is the only way onto the CPU).  With no
real data under --data-dir the synthetic fixture is used.  ``corpus`` and
``serve --shards N`` (with ``--follow`` and the live flags too) follow the
JAX package's rule: a "corpus" mesh of the first N devices of ``--device``'s
type when N > 1 and at least N are visible, the index row-sharded over it
(``parallel/mesh.py``); otherwise unsharded on one device.  ``train
--data-parallel`` builds a "data" mesh of every visible device of
``--device``'s type when there are two or more (each batch split over
them, ``train.step``); with one it warns and trains on that device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from vfr_tpu_torch.config import PRESETS, get_preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vfr_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, best=True):
        sp.add_argument("--preset", default="didemo_rgb",
                        choices=sorted(PRESETS))
        sp.add_argument("--data-dir", default=None)
        sp.add_argument("--checkpoint-dir", default=None,
                        help="directory holding the step checkpoints of "
                             "`train` or a params.npz (see "
                             "vfr_tpu_torch.bridge); seeded weights when "
                             "absent")
        sp.add_argument("--batch-size", type=int, default=None)
        sp.add_argument("--seed", type=int, default=None)
        sp.add_argument("--metrics-path", default=None)
        sp.add_argument("--bank-dtype", default=None,
                        choices=("float32", "bfloat16"))
        sp.add_argument("--compute-dtype", default=None,
                        choices=["float32", "bfloat16"])
        if best:
            sp.add_argument("--best", action="store_true",
                            help="open <checkpoint-dir>/best.npz (tracked "
                                 "by train --best-metric) instead of the "
                                 "newest step checkpoint")
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; raises "
                             "when CUDA is absent unless 'cpu' is given)")

    t = sub.add_parser("train", help="run the training loop")
    common(t, best=False)
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--margin", type=float, default=None)
    t.add_argument("--loss-type", default=None,
                   choices=["triplet", "infonce"],
                   help="objective: max-margin triplet or softmax "
                        "contrastive (InfoNCE) over the same [B,B,P] "
                        "cross-distance tensor")
    t.add_argument("--temperature", type=float, default=None,
                   help="infonce softmax temperature over -distance/tau")
    t.add_argument("--learn-temperature", action="store_true",
                   help="infonce: train tau as a parameter (log-temperature "
                        "initialized at --temperature)")
    t.add_argument("--temperature-final", type=float, default=None,
                   help="infonce: cosine-anneal tau from --temperature to "
                        "this value over training")
    t.add_argument("--ema-decay", type=float, default=None,
                   help="Polyak-average the params (0 = off); eval and "
                        "serving read the average")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all local devices")
    t.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the train loop "
                        "and the port's spans beside it")
    t.add_argument("--debug-nans", action="store_true",
                   help="turn on torch.autograd.set_detect_anomaly")
    t.add_argument("--hard-negatives", type=int, default=None,
                   help="mined hard inter-video negatives per query (0 = "
                        "off)")
    t.add_argument("--hard-negative-refresh", type=int, default=None,
                   help="epochs between hard-negative re-mining passes")
    t.add_argument("--best-metric", default=None,
                   help="track the best val checkpoint by this eval metric "
                        "(e.g. R@1_tiou0.5): every improving eval rolls "
                        "<checkpoint-dir>/best.npz; open it with --best")
    t.add_argument("--eval-every", type=int, default=None,
                   help="epochs between val evals (the last epoch always "
                        "evaluates)")
    t.add_argument("--steps-per-call", type=int, default=None,
                   help="optimizer steps per chunk (0 = log_every_steps); "
                        "one metrics fetch per chunk")

    e = sub.add_parser("eval", help="per-video localization eval")
    common(e)
    e.add_argument("--protocol", default=None,
                   choices=["threshold", "didemo_official"])

    c = sub.add_parser("corpus", help="corpus-level retrieval eval")
    common(c)
    c.add_argument("--shards", type=int, default=None,
                   help="devices to shard the moment index over")
    c.add_argument("--topk", type=int, default=None)
    c.add_argument("--num-videos", type=int, default=None)
    c.add_argument("--topk-method", default=None,
                   choices=["exact", "approx", "fused"])
    c.add_argument("--index-dtype", default=None,
                   choices=["float32", "bfloat16"])
    c.add_argument("--coarse-dim", type=int, default=None,
                   help="evaluate through the two-stage coarse-to-fine "
                        "retriever at this PCA rank (0/absent = exact "
                        "full scan)")
    c.add_argument("--coarse-candidates", type=int, default=None,
                   help="stage-1 survivors per query for --coarse-dim")
    c.add_argument("--coarse-mode", choices=["blockmax", "centroid"],
                   default=None)

    s = sub.add_parser("serve", help="answer free-text queries against the "
                       "moment index (one JSON line per query)")
    common(s)
    s.add_argument("--queries", required=True,
                   help="text file with one query per line, or '-' for stdin")
    s.add_argument("--shards", type=int, default=None)
    s.add_argument("--topk", type=int, default=10)
    s.add_argument("--num-videos", type=int, default=None)
    s.add_argument("--topk-method", default=None,
                   choices=["exact", "approx", "fused"])
    s.add_argument("--index-dtype", default=None,
                   choices=["float32", "bfloat16"])
    s.add_argument("--index-path", default=None,
                   help="load a prebuilt moment index (see `index`) instead "
                        "of re-embedding the corpus")
    s.add_argument("--coarse-path", default=None)
    s.add_argument("--coarse-dim", type=int, default=None)
    s.add_argument("--coarse-mode", choices=["blockmax", "centroid"],
                   default="blockmax")
    s.add_argument("--coarse-candidates", type=int, default=2048)
    s.add_argument("--follow", action="store_true",
                   help="daemon mode: answer the queries line by line (one "
                        "JSON line per query, flushed at once) until EOF")
    s.add_argument("--live-arena", default=None,
                   help="--follow only: boot the live index from an arena "
                        "snapshot (written by the '!save <path>' control "
                        "line) instead of embedding the corpus")
    s.add_argument("--live-capacity-videos", type=int, default=0,
                   help="--follow only: serve from a capacity-padded live "
                        "index that changes while the daemon runs: control "
                        "lines '!add <delta.npz>', '!remove <id> ...', "
                        "'!save <path>', '!stats', '!compact', '!grow "
                        "<capacity_videos>'; value = the arena's capacity "
                        "in videos; exact/approx scan (no --index-path / "
                        "--coarse-path)")
    s.add_argument("--micro-batch", type=int, default=8,
                   help="--follow only: most queries packed into one "
                        "dispatch")
    s.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the serving and "
                        "the port's spans and counters beside it "
                        "(port_spans.json)")
    s.add_argument("--length-buckets", default=None,
                   help="group queries by token length and run each group "
                        "with the token axis sliced to its bucket: 'auto' "
                        "(multiples of 8) or a list '8,16'; results are "
                        "identical to unbucketed serving")

    ix = sub.add_parser("index", help="build and save the moment index")
    common(ix)
    ix.add_argument("--out", required=True, help="output .npz path")
    ix.add_argument("--num-videos", type=int, default=None)
    ix.add_argument("--index-dtype", default=None,
                    choices=["float32", "bfloat16"])
    ix.add_argument("--coarse-dim", type=int, default=0)

    k = sub.add_parser("pack", help="convert an .npz feature dump to the "
                       "packed mmap .vfrf format (native reader)")
    k.add_argument("--npz", required=True)
    k.add_argument("--out", required=True)
    k.add_argument("--rows", type=int, default=0,
                   help="static row grid (0 = max rows over videos)")
    k.add_argument("--device", default="cuda",
                   help="as every entry point: raises when CUDA is absent "
                        "unless 'cpu' is given (packing itself is host "
                        "work)")
    return p


def apply_overrides(cfg, args):
    data, model, train, ev = cfg.data, cfg.model, cfg.train, cfg.eval
    if args.data_dir is not None:
        data = dataclasses.replace(data, data_dir=args.data_dir)
    if args.bank_dtype is not None:
        data = dataclasses.replace(data, bank_dtype=args.bank_dtype)
    if args.compute_dtype is not None:
        model = dataclasses.replace(model, compute_dtype=args.compute_dtype)
    tkw = {}
    if args.checkpoint_dir is not None:
        tkw["checkpoint_dir"] = args.checkpoint_dir
    if args.batch_size is not None:
        tkw["batch_size"] = args.batch_size
    if args.seed is not None:
        tkw["seed"] = args.seed
    if args.metrics_path is not None:
        tkw["metrics_path"] = args.metrics_path
    for flag, key in (("epochs", "num_epochs"), ("lr", "learning_rate"),
                      ("margin", "margin"), ("loss_type", "loss_type"),
                      ("temperature", "temperature"),
                      ("temperature_final", "temperature_final"),
                      ("ema_decay", "ema_decay"),
                      ("hard_negatives", "hard_negative_count"),
                      ("hard_negative_refresh",
                       "hard_negative_refresh_epochs"),
                      ("eval_every", "eval_every_epochs"),
                      ("steps_per_call", "steps_per_call"),
                      ("best_metric", "best_metric")):
        if getattr(args, flag, None) is not None:
            tkw[key] = getattr(args, flag)
    if getattr(args, "learn_temperature", False):
        tkw["learn_temperature"] = True
    if tkw:
        train = dataclasses.replace(train, **tkw)
    ekw = {}
    if getattr(args, "protocol", None) is not None:
        ekw["protocol"] = args.protocol
    if getattr(args, "shards", None) is not None:
        ekw["corpus_shards"] = args.shards
    if getattr(args, "topk", None) is not None:
        ekw["corpus_topk"] = args.topk
    if getattr(args, "num_videos", None) is not None:
        ekw["corpus_num_videos"] = args.num_videos
    if getattr(args, "topk_method", None) is not None:
        ekw["topk_method"] = args.topk_method
    if getattr(args, "index_dtype", None) is not None:
        ekw["index_dtype"] = args.index_dtype
    if args.cmd == "corpus":
        for key in ("coarse_dim", "coarse_candidates", "coarse_mode"):
            if getattr(args, key) is not None:
                ekw[key] = getattr(args, key)
    if args.bank_dtype is not None:
        ekw["bank_dtype"] = args.bank_dtype
    if ekw:
        ev = dataclasses.replace(ev, **ekw)
    return dataclasses.replace(cfg, data=data, model=model, train=train,
                               eval=ev)


def _visible_devices(device) -> int:
    """Devices of ``device``'s type this process sees."""
    return len(_devices(device))


def _devices(device):
    """The devices of ``device``'s type this process sees, in order."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _corpus_mesh(cfg, args):
    """The JAX package's rule for ``--shards N``: a "corpus" mesh of N
    devices when N > 1 and at least N are visible, else None (unsharded
    on one device)."""
    shards = cfg.eval.corpus_shards
    if shards > 1 and _visible_devices(args.device) >= shards:
        from vfr_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(("corpus",), shape=(shards,),
                         devices=_devices(args.device))
    return None


def _data_mesh(args):
    """The JAX package's rule for ``train --data-parallel``: a "data" mesh of
    every visible device of ``--device``'s type when there are two or more;
    else a warning and None (one device)."""
    if not args.data_parallel:
        return None
    if _visible_devices(args.device) > 1:
        from vfr_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(("data",), devices=_devices(args.device))
    print("[warn] --data-parallel requested but only 1 device is visible; "
          "running single-chip (no DP mesh)", file=sys.stderr)
    return None


def _pack(args) -> int:
    import numpy as np

    from vfr_tpu_torch.data.packed import pack_features
    from vfr_tpu_torch.device import resolve_device

    resolve_device(args.device)

    try:
        with np.load(args.npz) as z:
            table = {k: z[k] for k in z.files}
    except FileNotFoundError:
        print(f"error: feature archive not found: {args.npz}",
              file=sys.stderr)
        return 2
    path = pack_features(table, args.out, rows=args.rows or None)
    print(f"packed {len(table)} videos -> {path}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "pack":
        return _pack(args)
    cfg = apply_overrides(get_preset(args.preset), args)
    if args.cmd == "train":
        return _train(cfg, args)

    from vfr_tpu_torch.checkpoint import load_for_eval
    from vfr_tpu_torch.eval.corpus import (
        build_moment_index,
        load_index,
        save_index,
    )

    mesh = _corpus_mesh(cfg, args) if args.cmd in ("corpus", "serve") \
        else None
    params, model, bundle = load_for_eval(cfg, prefer_best=args.best,
                                          device=args.device)
    if args.cmd in ("eval", "corpus"):
        if args.cmd == "eval":
            from vfr_tpu_torch.eval.moment_eval import evaluate

            metrics = evaluate(params, model, bundle.val, cfg.eval)
        else:
            from vfr_tpu_torch.eval.corpus import corpus_evaluate

            metrics = corpus_evaluate(params, model, bundle.val, cfg.eval,
                                      mesh=mesh)
        print({k: round(v, 4) for k, v in metrics.items()})
        return 0
    if args.cmd == "index":
        index = build_moment_index(
            params, model, bundle.val,
            num_videos=cfg.eval.corpus_num_videos,
            index_dtype=cfg.eval.index_dtype)
        path = save_index(index, args.out)
        print(f"indexed {index.num_videos} videos ({index.num_rows} moments, "
              f"{index.m.dtype}) -> {path}")
        if args.coarse_dim > 0:
            from vfr_tpu_torch.eval.coarse import (
                build_coarse_index,
                save_coarse,
            )

            coarse = build_coarse_index(index, d_coarse=args.coarse_dim)
            cpath = save_coarse(coarse,
                                path[: -len(".npz")] + ".coarse.npz")
            print(f"coarse prefilter rank {coarse.d_coarse} -> {cpath}")
        return 0

    index = (load_index(args.index_path, device=args.device)
             if args.index_path else None)
    coarse = None
    if args.coarse_path:
        if index is None:
            print("error: --coarse-path needs --index-path (the coarse "
                  "file stores only the prefilter; stage-2 operands "
                  "come from the moment index)", file=sys.stderr)
            return 2
        from vfr_tpu_torch.eval.coarse import load_coarse

        coarse = load_coarse(args.coarse_path, index)
    with _profiled(args, "serve"):
        if args.follow:
            return _follow(cfg, args, params, model, bundle, index, coarse,
                           mesh)
        return _serve(cfg, args, params, model, bundle, index, coarse, mesh)


def _profiled(args, name: str):
    """Context: with ``--trace-dir``, torch.profiler over the block, then
    its Chrome trace (``<name>_trace.json``) and the port's recorder
    (``port_spans.json``, on the trace's time base) written there."""
    import contextlib

    if not args.trace_dir:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def run():
        import os
        import re

        import torch
        from torch.profiler import ProfilerActivity, profile

        from vfr_tpu_torch.utils import trace

        acts = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, f"{name}_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            base = re.search(r'"baseTimeNanoseconds":\s*(\d+)', f.read())
        trace.export_chrome(os.path.join(args.trace_dir, "port_spans.json"),
                            int(base.group(1)) if base else 0)

    return run()


def _serve(cfg, args, params, model, bundle, index, coarse, mesh) -> int:
    """``serve`` without ``--follow``: one JSON line per query."""
    from vfr_tpu_torch.eval.corpus import serve_queries

    if args.queries == "-":
        queries = [l.strip() for l in sys.stdin if l.strip()]
    else:
        with open(args.queries, "r", encoding="utf-8") as f:
            queries = [l.strip() for l in f if l.strip()]
    for rec in serve_queries(
        params, model, bundle.val, bundle.vocab, queries,
        k=args.topk,
        mesh=mesh,
        batch_size=cfg.eval.corpus_query_batch,
        max_query_len=cfg.data.max_query_len,
        num_videos=cfg.eval.corpus_num_videos,
        topk_method=cfg.eval.topk_method,
        approx_recall=cfg.eval.approx_recall,
        index_dtype=cfg.eval.index_dtype,
        index=index,
        coarse=coarse,
        coarse_dim=args.coarse_dim or 0,
        coarse_candidates=args.coarse_candidates,
        coarse_mode=args.coarse_mode,
        length_buckets=args.length_buckets,
    ):
        print(json.dumps(rec))
    return 0


def _follow(cfg, args, params, model, bundle, index, coarse, mesh) -> int:
    """``serve --follow``: one JSON line per record, flushed; with a mesh
    the live arena is built or loaded row-sharded over it."""
    import contextlib

    from vfr_tpu_torch.eval.corpus import serve_follow

    live = None
    if args.live_capacity_videos > 0 or args.live_arena:
        from vfr_tpu_torch.eval.live import load_arena, make_live_index

        if index is not None or coarse is not None:
            print("error: live serving is exact serving over its own arena "
                  "(no --index-path/--coarse-path)", file=sys.stderr)
            return 2
        if args.live_arena:
            live = load_arena(args.live_arena, params=params, model=model,
                              device=args.device, mesh=mesh)
        else:
            live = make_live_index(
                params, model, bundle.val,
                capacity_videos=args.live_capacity_videos,
                num_videos=cfg.eval.corpus_num_videos,
                index_dtype=cfg.eval.index_dtype, mesh=mesh)
    with contextlib.ExitStack() as stack:
        src = (sys.stdin if args.queries == "-" else stack.enter_context(
            open(args.queries, "r", encoding="utf-8")))
        lines = (t for t in (line.strip() for line in src) if t)
        for rec in serve_follow(
            params, model, bundle.val, bundle.vocab, lines,
            k=args.topk,
            max_query_len=cfg.data.max_query_len,
            num_videos=cfg.eval.corpus_num_videos,
            topk_method=cfg.eval.topk_method,
            approx_recall=cfg.eval.approx_recall,
            index_dtype=cfg.eval.index_dtype,
            index=index,
            micro_batch=max(args.micro_batch, 1),
            mesh=mesh,
            live=live,
            coarse=coarse,
            coarse_dim=args.coarse_dim or 0,
            coarse_candidates=args.coarse_candidates,
            coarse_mode=args.coarse_mode,
        ):
            print(json.dumps(rec), flush=True)
    return 0


def _train(cfg, args) -> int:
    import contextlib

    import torch

    from vfr_tpu_torch.train.loop import train

    mesh = _data_mesh(args)
    with contextlib.ExitStack() as stack:
        if args.debug_nans:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        stack.enter_context(_profiled(args, "train"))
        _, metrics = train(cfg, resume=args.resume, mesh=mesh,
                           device=args.device)
    print({k: round(v, 4) for k, v in metrics.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
