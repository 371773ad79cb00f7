"""Training: the preset's train step, state carried from step to step.

Set-up builds the model, the seeded weights, the clip-feature banks (the
corpus's videos x clips x streams) and ``staged_batches`` batches, each a
fresh draw of tokens, targets, video rows and mined negatives, and builds
one train step with its optimizer state and Polyak average.  It drives
that step through its first ``WARM_STEPS`` steps on the first batches, as
the window does, and keeps what the check reads: the first three losses,
the Adam state after the first step, the params and the average after the
third.  The window runs the same step on the following batches (a window
longer than the staged batches starts them over); every loss is checked
finite after it.

Traffic keys: ``len_min``, ``len_max``, ``staged_batches``; the batch
size, the mined negatives and the rest of the recipe are the
configuration's.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from vfrbench import inputs
from vfrbench.drivers import _common
from vfrbench.reference import judge, mcn

CHECKED_STEPS = 3
WARM_STEPS = 5
B1 = 0.9


def spec(s, cfg, dev):
    """The reference's description of the recipe."""
    t = cfg.train
    if (t.loss_type != "infonce" or t.optimizer != "adam"
            or t.lr_schedule != "constant" or t.grad_clip_norm
            or t.warmup_steps or t.learn_temperature or t.temperature_final
            or t.lambda_inter_rev or t.inter_negatives != "all_spans"):
        raise ValueError("the benchmark's train reference covers InfoNCE "
                         "over all spans with mined negatives, Adam at a "
                         "constant rate, no clipping")
    return dict(s, **mcn.spec_tables(s["clips"], dev),
                temperature=float(t.temperature),
                lambda_intra=float(t.lambda_intra),
                lambda_inter=float(t.lambda_inter),
                learning_rate=float(np.float32(t.learning_rate)),
                ema_decay=float(t.ema_decay))


def setup(cell, cfg, seed: int, seconds: float, dev):
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.train.optim import make_optimizer
    from vfr_tpu_torch.train.step import make_train_step

    tr = cell.traffic
    s = _common.sizes(cell, cfg)
    _common.check_model(s, cfg)
    ref_spec = spec(s, cfg, dev)
    B, Hn = int(cfg.train.batch_size), int(cfg.train.hard_negative_count)
    if cfg.train.ema_decay <= 0 or Hn <= 0:
        raise ValueError("the train cell runs the flagship recipe: mined "
                         "negatives and a Polyak average")
    model = build_model(cfg)
    params = inputs.make_params(s, seed, dev)
    params0 = mcn.flatten(inputs.clone_tree(params))
    banks = inputs.feature_banks(s["stream_names"], s["train_videos"],
                                 s["clips"], s["F"], seed, dev)
    batches = inputs.train_batches(
        int(tr["staged_batches"]), B, s["T"], s["vocab"], int(tr["len_min"]),
        int(tr["len_max"]), s["train_videos"], s["P"], Hn, seed, dev)
    opt = make_optimizer(cfg.train)
    step = make_train_step(model, cfg.train, opt, feature_banks=banks)
    st = SimpleNamespace(cell=cell, cfg=cfg, seed=seed, dev=dev, s=s, B=B,
                         spec=ref_spec, banks=banks, batches=batches,
                         params0=params0, step=step, p=params,
                         opt=opt.init(params), ema=inputs.clone_tree(params),
                         next=0, losses=[], window_losses=[])
    for t in range(WARM_STEPS):
        aux = _step(st)
        if t < CHECKED_STEPS:
            st.losses.append(aux["loss"])
        if t == 0:
            st.mu1 = st.opt["mu"]
        if t == CHECKED_STEPS - 1:
            st.params3 = mcn.flatten(st.p)
            st.ema3 = mcn.flatten(inputs.clone_tree(st.ema))
    _common.sync(dev)
    return st


def _batch(st, i: int):
    j = i % st.batches["tokens"].shape[0]
    return {k: v[j] for k, v in st.batches.items()}


def _step(st):
    st.p, st.opt, st.ema, aux = st.step(st.p, st.opt, _batch(st, st.next),
                                        st.ema)
    st.next += 1
    return aux


def window(st, seconds: float, tracer):
    steps = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        tracer.tick(now)
        with tracer.span("train_step"):
            aux = _step(st)
        tracer.count("steps")
        st.window_losses.append(aux["loss"])
        steps += 1
    _common.sync(st.dev)
    t1 = time.perf_counter()
    tracer.stop()
    losses = torch.stack(st.window_losses)
    nonfinite = int((~torch.isfinite(losses)).sum())
    lens = st.batches["lengths"].float()
    return {"steps": steps, "queries": steps * st.B, "seconds": t1 - t0,
            "attempted": steps * st.B, "failed": nonfinite * st.B,
            "nonfinite_steps": nonfinite,
            "shapes": dict(st.s, B=st.B, clips=st.s["clips"],
                           hard=int(st.cfg.train.hard_negative_count),
                           live_steps=float(lens.sum(1).mean()))}


def release(st) -> None:
    """Free the port's step, its state and the window's losses; keep the
    snapshots the check reads."""
    st.step = st.p = st.opt = st.ema = None
    st.window_losses = None
    if _common.on_card(st.dev):
        torch.cuda.empty_cache()


def program_readings(st):
    """What the port's first three steps gave: their losses, the first
    gradient (Adam's first moment after one step over 1 - b1), the params
    and the Polyak average after the third."""
    mu = mcn.flatten(st.mu1)
    return {"losses": [float(x) for x in st.losses],
            "grads": {n: g / (1.0 - B1) for n, g in mu.items()},
            "params": st.params3, "ema": st.ema3}


def reference_readings(st, plan):
    batches = [_batch(st, i) for i in range(CHECKED_STEPS)]
    with mcn.f32_only():
        return mcn.train_steps(
            mcn._unflatten(st.params0.items()), st.spec, batches, st.banks,
            plan)


def check(st, control: bool = False):
    ref = reference_readings(st, {"all": "float32"})
    prog = (reference_readings(st, {"all": "tf32"}) if control
            else program_readings(st))
    return judge.train_readings(prog, ref, st.params0)


READINGS = ("loss_gap", "grad_gap", "step_gap", "ema_gap")
