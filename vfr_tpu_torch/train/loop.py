"""Training loop (the port of the JAX package's ``train/loop.py``):
epochs, hard-negative mining refreshes, eval, checkpoints, resume.

A background thread (``data.prefetch.Prefetcher``, ``prefetch_depth``
chunks ahead) assembles id-and-token batches (a few KB each) into chunks of
K steps and copies each to the device off the step's stream; clip features
live on the device for the whole run (``banks_to_device``) and are
gathered there by ``video_idx``.

Query-dropout masks depend only on (seed, absolute step)
(``dropout_keep_mask``), so a resumed run draws the masks the original
run would have drawn.

With a ``mesh`` (data parallel over its "data" axis; ``train.step``) the
params, optimizer state, Polyak average, eval and checkpoints live on the
axis's lead device; the train banks are placed on every mesh device, the
prefetcher sends each chunk's shards to their devices, and the mining
refresh splits the index over the same axis.
"""

from __future__ import annotations

import json
import math
import os
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vfr_tpu_torch.checkpoint import init_train_params
from vfr_tpu_torch.config import ExperimentConfig, infonce_tau_warning
from vfr_tpu_torch.data.features import banks_by_device, banks_to_device
from vfr_tpu_torch.data.loaders import DataBundle, load_datasets
from vfr_tpu_torch.data.prefetch import Prefetcher
from vfr_tpu_torch.device import resolve_device
from vfr_tpu_torch.eval.moment_eval import evaluate
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_payload,
    restore_checkpoint,
    restore_ema,
    save_checkpoint,
)
from vfr_tpu_torch.train.hard_negatives import mine_hard_negatives
from vfr_tpu_torch.train.optim import make_optimizer
from vfr_tpu_torch.train.step import (
    chunk_steps,
    make_train_multi_step,
    place_batch,
)
from vfr_tpu_torch.utils.logging import MetricsLogger
from vfr_tpu_torch.utils.tree import tree_map


def dropout_keep_mask(seed: int, step: int, shape, rate: float
                      ) -> np.ndarray:
    """Query dropout's keep mask for absolute step ``step`` of a run with
    ``seed``: P(keep) = 1 - rate, drawn from a numpy generator seeded by
    (seed, step) alone."""
    rng = np.random.default_rng([seed, step])
    return rng.random(shape) < (1.0 - rate)


def train(
    cfg: ExperimentConfig,
    bundle: Optional[DataBundle] = None,
    resume: bool = False,
    mesh=None,
    logger: Optional[MetricsLogger] = None,
    device_banks: Optional[Dict[str, Dict]] = None,
    device=None,
) -> Tuple[Dict, Dict[str, float]]:
    """Run the training loop on ``device`` (CUDA unless asked otherwise),
    or data parallel over ``mesh``'s "data" axis (``device`` is then its
    lead); returns (serving params: the EMA tree when kept, final eval
    metrics), on that device.

    ``device_banks``: optional {"train": banks, "val": banks} already on
    the device (``banks_to_device``; the train banks may be its ``mesh=``
    form), to share them with later evals."""
    dev = resolve_device(device) if mesh is None else mesh.lead("data")
    tcfg = cfg.train
    if tcfg.best_metric and (
            tcfg.best_metric not in expected_eval_metrics(cfg.eval)):
        # fail before training, not at the first eval
        raise KeyError(
            f"best_metric {tcfg.best_metric!r} is not a metric this "
            f"EvalConfig produces; have "
            f"{sorted(expected_eval_metrics(cfg.eval))}")
    tau_msg = infonce_tau_warning(cfg)
    if tau_msg is not None:
        warnings.warn(tau_msg, stacklevel=2)
    if bundle is None:
        bundle = load_datasets(cfg.data)
    ds, val_ds = bundle.train, bundle.val
    model = build_model(cfg, dataset=ds)
    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(tcfg.metrics_path
                               or f"{tcfg.checkpoint_dir}/metrics.jsonl")

    t_setup = time.perf_counter()
    params = init_train_params(torch.Generator().manual_seed(tcfg.seed),
                               model, bundle.glove, bundle.feature_dim, tcfg,
                               dev)
    steps_per_epoch = tcfg.steps_per_epoch or max(
        1, math.ceil(ds.num_queries / tcfg.batch_size))
    total_steps = steps_per_epoch * tcfg.num_epochs
    opt = make_optimizer(tcfg, total_steps)
    opt_state = opt.init(params)
    # the Polyak average: a separate tree, updated after every step; eval,
    # checkpoints and serving read it while the raw params keep training
    ema = (tree_map(torch.clone, params) if tcfg.ema_decay > 0 else None)
    start_step = 0
    best_val = float("-inf")
    if resume:
        ckpt = latest_checkpoint(tcfg.checkpoint_dir)
        if ckpt:
            payload = load_payload(ckpt)
            start_step, params, opt_state, _ = restore_checkpoint(
                ckpt, payload=payload, device=dev)
            if ema is not None:
                ema = restore_ema(ckpt, payload=payload, device=dev)
            del payload
            logger.log("resume", start_step, {"checkpoint": ckpt})
            if tcfg.best_metric:
                # a post-resume eval must not overwrite best.npz with a
                # worse value: recover the best so far from the run's log
                best_val = max(best_val, _best_from_log(
                    getattr(logger, "path", None) or tcfg.metrics_path
                    or f"{tcfg.checkpoint_dir}/metrics.jsonl",
                    tcfg.best_metric))
                if best_val == float("-inf"):
                    warnings.warn(
                        "resuming a best_metric run but no previous 'best' "
                        "record was found in the metrics log; the first "
                        "post-resume eval will (re)write best.npz even if "
                        "it is worse than the historical best", stacklevel=2)

    # one copy of the corpus features to the device for the whole run
    bank_arrays = dict(ds.feature_banks())
    if hasattr(ds, "video_tef"):
        # Charades: mined negatives re-embed with their video's TEF rows
        bank_arrays["video_tef"] = ds.video_tef
    t_banks = time.perf_counter()
    if device_banks is not None:
        train_banks, val_banks = device_banks["train"], device_banks["val"]
        missing = set(bank_arrays) - set(train_banks)
        if missing:
            raise ValueError(
                f"injected device_banks['train'] missing keys {missing} "
                "(Charades needs the video_tef bank)")
    else:
        train_banks = banks_to_device(bank_arrays, cfg.data.bank_dtype,
                                      device=dev, mesh=mesh)
        val_banks = banks_to_device(dict(val_ds.feature_banks()),
                                    cfg.data.bank_dtype, device=dev)
    if mesh is not None:
        # one bank dict per distinct mesh device, the lead's first
        train_banks = banks_by_device(train_banks, mesh.axis_devices("data"))
    placed = [train_banks] if mesh is None else list(train_banks.values())
    mine_banks = placed[0]
    for d in {dev, *(v.device for b in placed for v in b.values())}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    bank_mb = sum(v.element_size() * v.numel()
                  for d in (*placed, val_banks) for v in d.values()) / 1e6
    logger.log("setup", start_step, {
        "init_s": round(t_banks - t_setup, 3),
        "bank_upload_s": round(time.perf_counter() - t_banks, 3),
        "bank_mb": round(bank_mb, 3),
    })
    K = tcfg.steps_per_call or max(1, min(tcfg.log_every_steps,
                                          steps_per_epoch))
    multi_step_fn = make_train_multi_step(model, tcfg, opt, mesh=mesh,
                                          feature_banks=train_banks)
    placement = {}
    if mesh is not None:
        devices = mesh.axis_devices("data")
        placement["place"] = lambda chunk, copy: place_batch(
            chunk, devices, 1, copy)
    step = start_step
    final_metrics: Dict[str, float] = {}
    epoch0 = start_step // steps_per_epoch
    skip0 = start_step % steps_per_epoch     # mid-epoch resume position
    rate = cfg.model.query_dropout
    # temperature anneal: cosine ramp temperature -> temperature_final
    # over all steps, one value per step riding the batch
    anneal_tau = None
    if tcfg.loss_type == "infonce" and tcfg.temperature_final > 0:
        if tcfg.learn_temperature:
            raise ValueError(
                "temperature_final and learn_temperature are mutually "
                "exclusive (scheduled tau would mask the learned one)")
        t0_, tf_, T_ = (tcfg.temperature, tcfg.temperature_final,
                        total_steps)

        def anneal_tau(abs_step):
            frac = min(max(abs_step / max(T_ - 1, 1), 0.0), 1.0)
            return np.float32(tf_ + 0.5 * (t0_ - tf_)
                              * (1.0 + math.cos(math.pi * frac)))

    mined = None
    hn = tcfg.hard_negative_count
    for epoch in range(epoch0, tcfg.num_epochs):
        skip = skip0 if epoch == epoch0 else 0
        if hn > 0 and epoch >= tcfg.hard_negative_start_epoch and (
            mined is None
            or (epoch - tcfg.hard_negative_start_epoch)
            % max(tcfg.hard_negative_refresh_epochs, 1) == 0
        ):
            t_mine = time.perf_counter()
            mined = mine_hard_negatives(params, model, ds, hn,
                                        feature_banks=mine_banks, mesh=mesh)
            logger.log("mine", step, {
                "epoch": epoch, "count": hn,
                "mined_valid_frac": float((mined[0] >= 0).mean()),
                "refresh_s": round(time.perf_counter() - t_mine, 3),
            })

        def epoch_chunks(e=epoch, skip=skip, mined=mined):
            buf = []
            for i, b in enumerate(ds.train_batches(
                    tcfg.batch_size, steps_per_epoch, seed=tcfg.seed + e,
                    sample_targets=(tcfg.target_sampling == "sample"),
                    with_features=False)):
                if i < skip:
                    continue      # mid-epoch resume: replay the unseen tail
                abs_step = e * steps_per_epoch + i
                if rate > 0:
                    b["dropout_keep"] = dropout_keep_mask(
                        tcfg.seed, abs_step,
                        (tcfg.batch_size, cfg.model.lstm_hidden), rate)
                if anneal_tau is not None:
                    b["tau_now"] = anneal_tau(abs_step)
                if mined is not None:
                    b["hard_neg_video"] = mined[0][b["query_idx"]]
                    b["hard_neg_prop"] = mined[1][b["query_idx"]]
                buf.append(b)
                if len(buf) == K:
                    yield _stack_chunk(buf)
                    buf = []
            if buf:
                yield _stack_chunk(buf)

        t_last = time.perf_counter()
        for chunk in Prefetcher(epoch_chunks, depth=tcfg.prefetch_depth,
                                device=dev, **placement):
            k = chunk_steps(chunk)
            if ema is None:
                params, opt_state, aux = multi_step_fn(params, opt_state,
                                                       chunk)
            else:
                params, opt_state, ema, aux = multi_step_fn(
                    params, opt_state, chunk, ema)
            step += k
            loss = float(aux["loss"])            # the chunk's one sync
            now = time.perf_counter()
            dt = (now - t_last) / k
            rec = {
                "epoch": epoch,
                "loss": loss,
                "loss_intra": float(aux["loss_intra"]),
                "loss_inter": float(aux["loss_inter"]),
                "train_r1": float(aux["train_r1"]),
                "grad_norm": float(aux["grad_norm"]),
                "step_ms": 1e3 * dt,
                "queries_per_sec": tcfg.batch_size / max(dt, 1e-9),
            }
            if "tau" in aux:
                rec["tau"] = float(aux["tau"])
            logger.log("train", step, rec)
            t_last = now
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"loss diverged at step {step}: {loss}")

        if ((epoch + 1) % max(tcfg.eval_every_epochs, 1) == 0
                or epoch == tcfg.num_epochs - 1):
            t_eval = time.perf_counter()
            metrics = evaluate(ema if ema is not None else params, model,
                               val_ds, cfg.eval, feature_banks=val_banks)
            logger.log("eval", step, {
                **metrics, "eval_s": round(time.perf_counter() - t_eval, 3)})
            final_metrics = metrics
            if tcfg.best_metric:
                if tcfg.best_metric not in metrics:
                    raise KeyError(
                        f"best_metric {tcfg.best_metric!r} is not an eval "
                        f"metric; have {sorted(metrics)}")
                val = float(metrics[tcfg.best_metric])
                if val > best_val:
                    best_val = val
                    save_checkpoint(tcfg.checkpoint_dir, step, params,
                                    opt_state, cfg, ema=ema,
                                    filename="best.npz")
                    logger.log("best", step, {
                        "metric": tcfg.best_metric, "value": val,
                        "epoch": epoch})
        if ((epoch + 1) % tcfg.checkpoint_every_epochs == 0
                or epoch == tcfg.num_epochs - 1):
            save_checkpoint(tcfg.checkpoint_dir, step, params, opt_state,
                            cfg, keep=tcfg.keep_checkpoints, ema=ema)

    if own_logger:
        logger.close()
    return (ema if ema is not None else params), final_metrics


def _best_from_log(path: str, metric: str) -> float:
    """Best-so-far value of ``metric`` from a metrics JSONL, skipping a
    torn trailing line."""
    best = float("-inf")
    if not os.path.exists(path):
        return best
    with open(path, encoding="utf-8") as f:
        for line in f:
            try:
                r = json.loads(line)
            except ValueError:
                continue
            if r.get("tag") == "best" and r.get("metric") == metric:
                best = max(best, float(r["value"]))
    return best


def expected_eval_metrics(ecfg) -> set:
    """The metric names ``evaluate`` emits for this EvalConfig."""
    names = {"mIoU", "num_queries"}
    for k in ecfg.recall_ks:
        for t in ecfg.tiou_thresholds:
            names.add(f"R@{k}_tiou{t}")
    if ecfg.protocol == "didemo_official":
        names |= {f"R@{k}_official" for k in ecfg.recall_ks}
        names.add("mIoU_official")
    return names


def _stack_chunk(batches):
    """Stack batch dicts along a new leading step axis [K, ...]."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
