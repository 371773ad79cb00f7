"""The train step (the port of the JAX package's ``train/step.py``):
forward, the hand-written backward of the recurrence (``ops.lstm``),
autograd elsewhere, the optax-rule update (``train.optim``) and the
Polyak average, on the params' device.

Batches are dicts of tensors on that device.  With ``feature_banks``
(stream -> [V, C, F], plus ``video_tef`` for Charades) a batch carries
``video_idx`` only and clip features are gathered from the banks.
``make_train_multi_step`` runs K steps per call on a stacked chunk and
averages their metrics without a host sync inside the chunk: the model's
static tables are moved to the device once (``tables_on``) and no step
copies from the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from vfr_tpu_torch.config import TrainConfig
from vfr_tpu_torch.models.mcn import (
    Model,
    embed_moments,
    embed_queries_multi,
    tables_on,
)
from vfr_tpu_torch.train.loss import compute_loss
from vfr_tpu_torch.train.optim import Optimizer, apply_updates, global_norm
from vfr_tpu_torch.utils.tree import flatten, unflatten


def loss_from_batch(
    params: Dict, model: Model, tcfg: TrainConfig,
    batch: Dict[str, torch.Tensor], dropout_keep=None,
    feature_banks: Optional[Dict[str, torch.Tensor]] = None,
):
    """(loss, aux) of one batch.  ``dropout_keep`` [B, H] bool (or the
    batch's ``dropout_keep``) is query dropout's keep mask."""
    if dropout_keep is None:
        dropout_keep = batch.get("dropout_keep")
    if feature_banks is not None:
        vidx = batch["video_idx"].long()
        feats = {s: feature_banks[s][vidx] for s in model.streams}
    else:
        feats = {s: batch[s] for s in model.streams}
    q = embed_queries_multi(params, model, batch["tokens"], batch["lengths"],
                            dropout_keep=dropout_keep)
    m = embed_moments(params, model, feats, tef=batch.get("tef"),
                      context_mask=batch.get("context_mask"))
    hard_m, hard_valid = None, None
    hv = batch.get("hard_neg_video")
    if hv is not None and feature_banks is not None:
        # the mined (video, proposal) pairs embedded with the current
        # params: only the mined proposal of each video, through its
        # pooling-matrix row (and TEF row)
        hp = batch["hard_neg_prop"]
        B, Hn = hv.shape
        hv_safe = torch.clamp(hv, min=0).reshape(-1).long()
        hp_safe = torch.clamp(hp, min=0).reshape(-1).long()
        dev = hv.device
        feats_h = {s: feature_banks[s][hv_safe] for s in model.streams}
        pm_h = torch.as_tensor(model.pool_matrix, dtype=torch.float32,
                               device=dev)[hp_safe][:, None, :]
        tef_h = None
        if model.cfg.use_tef:
            if "video_tef" in feature_banks:
                # Charades: the mined video's TEF row, then its window's
                tef_bank = feature_banks["video_tef"][hv_safe]  # [B*Hn, P, 2]
                tef_h = torch.gather(
                    tef_bank, 1, hp_safe[:, None, None].expand(-1, 1, 2))
            else:
                tef_h = torch.as_tensor(model.tef, dtype=torch.float32,
                                        device=dev)[hp_safe][:, None, :]
        m_h = embed_moments(params, model, feats_h, tef=tef_h,
                            pool_matrix=pm_h)                 # [B*Hn, 1, d]
        hard_m = {s: m_h[s][:, 0].reshape(B, Hn, -1) for s in model.streams}
        hard_valid = hv >= 0
    # temperature: a scheduled per-step tau rides the batch; else the
    # learnable log_tau param; else tcfg.temperature
    if "tau_now" in batch:
        log_tau = torch.log(batch["tau_now"].to(torch.float32))
    else:
        log_tau = params.get("log_tau")
    return compute_loss(
        model, tcfg, q, m,
        target=batch["target"],
        video_idx=batch["video_idx"],
        proposal_mask=batch.get("window_mask"),
        hard_moments=hard_m,
        hard_valid=hard_valid,
        log_tau=log_tau,
    )


def _ema_update(ema, params, decay: float):
    """One Polyak step in place: ema + (1 - d) * (params - ema) over the
    whole tree, d in f32."""
    if decay <= 0 or ema is None:
        return ema
    c = float(torch.tensor(1.0) - torch.tensor(decay, dtype=torch.float32))
    _, e = flatten(ema)
    _, p = flatten(params)
    diff = torch._foreach_sub(p, e)
    torch._foreach_mul_(diff, c)
    torch._foreach_add_(e, diff)
    return ema


def _check_ema_arg(tcfg: TrainConfig, ema) -> None:
    """ema_decay > 0 makes the ema tree a required argument: without it
    the average a config asks for would silently not be kept."""
    if tcfg.ema_decay > 0 and ema is None:
        raise ValueError(
            f"TrainConfig.ema_decay={tcfg.ema_decay} > 0 but no ema tree "
            "was passed to the train step; seed it from a copy of the "
            "initial params and thread the returned tree through every call")


def _grads(params, model, tcfg, batch, banks):
    """(aux, grads): grads a tree like params, None where no gradient
    flows (the frozen GloVe table); grad_norm in aux is pre-clip."""
    paths, leaves = flatten(params)
    frozen = [model.freeze_embeddings and p == ("embeddings",)
              for p in paths]
    req = [l if f else l.detach().requires_grad_(True)
           for l, f in zip(leaves, frozen)]
    with torch.enable_grad():
        loss, aux = loss_from_batch(unflatten(paths, req), model, tcfg,
                                    batch, feature_banks=banks)
        wrt = [r for r, f in zip(req, frozen) if not f]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for r, f in zip(req, frozen):
        g = None if f else next(got)
        grads.append(torch.zeros_like(r) if g is None and not f else g)
    aux = dict(aux)
    aux["grad_norm"] = global_norm([g for g in grads if g is not None])
    return aux, unflatten(paths, grads)


def _device_model(model: Model):
    """``model`` -> the same model with its tables on the params' device,
    moved once per device."""
    cache = {}

    def on(params):
        dev = params["embeddings"].device
        if dev not in cache:
            cache[dev] = tables_on(model, dev)
        return cache[dev]
    return on


def _one_step(params, opt_state, ema, batch, model, tcfg, optimizer, banks):
    aux, grads = _grads(params, model, tcfg, batch, banks)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = apply_updates(params, updates)
    ema = _ema_update(ema, params, tcfg.ema_decay)
    return params, opt_state, ema, aux


def make_train_step(
    model: Model,
    tcfg: TrainConfig,
    optimizer: Optimizer,
    mesh=None,
    feature_banks: Optional[Dict[str, torch.Tensor]] = None,
):
    """``train_step(params, opt_state, batch[, ema])``.  Arity follows
    ``tcfg.ema_decay``: 0 -> ``(params, opt_state, metrics)``; > 0 ->
    ``(params, opt_state, ema, metrics)`` with ``ema`` required (updated
    in place).  ``mesh`` (the data-parallel step) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel train step is not yet ported to vfr_tpu_torch")

    on_device = _device_model(model)

    def step(params, opt_state, batch, ema=None):
        _check_ema_arg(tcfg, ema)
        params, opt_state, ema, aux = _one_step(
            params, opt_state, ema, batch, on_device(params), tcfg,
            optimizer, feature_banks)
        if tcfg.ema_decay > 0:
            return params, opt_state, ema, aux
        return params, opt_state, aux

    return step


def make_train_multi_step(
    model: Model,
    tcfg: TrainConfig,
    optimizer: Optimizer,
    mesh=None,
    feature_banks: Optional[Dict[str, torch.Tensor]] = None,
):
    """K optimizer steps per call over a stacked chunk (a batch dict with a
    leading step axis [K, B, ...]): ``multi_step(params, opt_state,
    chunk[, ema]) -> (params, opt_state[, ema], aux_mean)``, the per-step
    metrics averaged on the device (no host sync inside the chunk)."""
    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel train step is not yet ported to vfr_tpu_torch")

    on_device = _device_model(model)

    def multi_step(params, opt_state, chunk, ema=None):
        _check_ema_arg(tcfg, ema)
        K = chunk["tokens"].shape[0]
        dev_model = on_device(params)
        auxs = []
        for k in range(K):
            batch = {key: v[k] for key, v in chunk.items()}
            params, opt_state, ema, aux = _one_step(
                params, opt_state, ema, batch, dev_model, tcfg, optimizer,
                feature_banks)
            auxs.append(aux)
        aux_mean = {key: torch.stack([a[key] for a in auxs]).mean(0)
                    for key in auxs[0]}
        if tcfg.ema_decay > 0:
            return params, opt_state, ema, aux_mean
        return params, opt_state, aux_mean

    return multi_step
