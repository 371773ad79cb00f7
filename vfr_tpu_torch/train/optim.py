"""Optimizers with optax's update rules (the port of the JAX package's
``train/optim.py``): plain functions over the params dict and an explicit
state dict.

What is optax's and not ``torch.optim``'s:
* the schedule is evaluated at the count BEFORE the step, so with warmup
  the first step has lr 0 (``linear_schedule(0, base, warmup)``);
* global-norm clipping keeps ``g`` when ``|g| < max`` and otherwise gives
  ``(g / |g|) * max`` (``clip_grad_norm_`` scales by ``max / (|g| + 1e-6)``);
* adam: bias-corrected moments, ``eps`` added outside the square root;
* adamw: decoupled decay ``+ wd * p`` before the lr scaling, masked off
  ``embeddings`` and ``log_tau`` (``_decay_mask``) unless
  ``freeze_embeddings=False``, which decays every leaf;
* sgd: optax's ``trace`` momentum, ``t <- g + momentum * t``.
Schedules run in f32, as optax's do under jit.

``make_optimizer(...)`` returns ``Optimizer(init, update)``:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; ``apply_updates(params, updates)`` adds them.  A ``None`` grad
(the frozen GloVe table) leaves its leaf and its moments untouched, which
is what optax's zero gradient does to a leaf outside the decay mask; where
adamw decays every leaf it is a zero gradient, as in optax.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from vfr_tpu_torch.config import TrainConfig
from vfr_tpu_torch.utils.tree import flatten, tree_map, unflatten

B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adam / adamw defaults


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def make_schedule(tcfg: TrainConfig, total_steps: int = 0
                  ) -> Callable[[int], float]:
    """count -> learning rate (an f32 value as a Python float)."""
    base = tcfg.learning_rate
    if tcfg.lr_schedule == "constant":
        def sched(count):
            return base
    elif tcfg.lr_schedule == "cosine":
        decay = max(total_steps - tcfg.warmup_steps, 1)

        def sched(count):
            c = min(count, decay)
            return base * (0.5 * (1.0 + math.cos(math.pi * c / decay)))
    elif tcfg.lr_schedule == "step":
        every = tcfg.lr_decay_steps or max(total_steps // 3, 1)

        def sched(count):
            if count <= 0:
                return base
            return base * tcfg.lr_decay_rate ** math.floor(count / every)
    else:
        raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")
    if tcfg.warmup_steps > 0:
        main, W = sched, tcfg.warmup_steps

        def sched(count):
            if count >= W:
                return main(count - W)
            return -base * (1.0 - min(max(count, 0), W) / W) + base
    return lambda count: float(np.float32(sched(count)))


def _decay_mask(params) -> Dict[str, bool]:
    """adamw decays every top-level entry but the GloVe table and the
    learnable log-temperature."""
    return {k: k not in ("embeddings", "log_tau") for k in params}


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2) (optax.global_norm)."""
    return torch.sqrt(sum((x * x).sum() for x in leaves))


def make_optimizer(tcfg: TrainConfig, total_steps: int = 0,
                   freeze_embeddings: bool = True) -> Optimizer:
    sched = make_schedule(tcfg, total_steps)
    kind = tcfg.optimizer
    if kind not in ("adam", "adamw", "sgd"):
        raise ValueError(f"unknown optimizer {kind!r}")
    clip = tcfg.grad_clip_norm
    decay_all = kind == "adamw" and not freeze_embeddings
    slots = ("trace",) if kind == "sgd" else ("mu", "nu")

    def init(params):
        state = {"count": 0}
        for slot in slots:
            state[slot] = tree_map(torch.zeros_like, params)
        return state

    def update(grads, state, params):
        paths, gs = flatten(grads)
        if decay_all:
            gs = [torch.zeros_like(p) if g is None else g
                  for g, p in zip(gs, flatten(params)[1])]
        live = [i for i, g in enumerate(gs) if g is not None]
        g = [gs[i] for i in live]
        if clip > 0:
            norm = global_norm(g)
            keep = norm < clip
            g = [torch.where(keep, t, (t / norm) * clip) for t in g]
        count = state["count"]
        lr = sched(count)
        new_state = {"count": count + 1}
        if kind == "sgd":
            _, tr = flatten(state["trace"])
            t_new = torch._foreach_add(
                g, torch._foreach_mul([tr[i] for i in live], tcfg.momentum))
            upd = t_new
            for i, t in zip(live, t_new):
                tr[i] = t
            new_state["trace"] = unflatten(paths, tr)
        else:
            _, mu = flatten(state["mu"])
            _, nu = flatten(state["nu"])
            m_new = torch._foreach_add(
                torch._foreach_mul(g, 1.0 - B1),
                torch._foreach_mul([mu[i] for i in live], B1))
            v_new = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - B2),
                torch._foreach_mul([nu[i] for i in live], B2))
            c = np.float32(count + 1)
            bc1 = float(np.float32(1.0) - np.float32(B1) ** c)
            bc2 = float(np.float32(1.0) - np.float32(B2) ** c)
            denom = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(v_new, bc2)), EPS)
            upd = torch._foreach_div(torch._foreach_div(m_new, bc1), denom)
            if kind == "adamw":
                mask = _decay_mask(params)
                _, ps = flatten(params)
                upd = [u + tcfg.weight_decay * ps[i]
                       if decay_all or mask[paths[i][0]] else u
                       for i, u in zip(live, upd)]
            for i, m, v in zip(live, m_new, v_new):
                mu[i], nu[i] = m, v
            new_state["mu"] = unflatten(paths, mu)
            new_state["nu"] = unflatten(paths, nu)
        upd = torch._foreach_mul(upd, -lr)
        out = [None] * len(gs)
        for i, u in zip(live, upd):
            out[i] = u
        return unflatten(paths, out), new_state

    return Optimizer(init, update)


def apply_updates(params, updates):
    """params + updates, leaf by leaf; a None update keeps the leaf."""
    return tree_map(lambda p, u: p if u is None else p + u, params, updates)
