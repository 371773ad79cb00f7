"""Restore serving weights: the counterpart of the JAX package's
``train.loop.load_for_eval``.

The checkpoint directory's newest step checkpoint (``ckpt_<step>.npz``,
written by ``cli train``; see ``train.checkpoint``) is served, else its
``params.npz`` (converted from a JAX checkpoint by
``bridge.save_params_npz``); ``prefer_best`` opens ``best.npz`` instead.
The EMA tree is served when the stored train config has
``ema_decay > 0``.  Without any file, parameters are initialised from
``torch.Generator().manual_seed(cfg.train.seed)``.  Those seeded weights
differ from the JAX package's ``jax.random`` weights at the same seed; to
serve identical weights in both packages, convert the JAX checkpoint with
``bridge.save_params_npz``.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch

from vfr_tpu_torch.bridge import load_params_npz, params_from_numpy
from vfr_tpu_torch.config import ExperimentConfig
from vfr_tpu_torch.data.loaders import DataBundle, load_datasets
from vfr_tpu_torch.device import resolve_device
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.models.mcn import init_model_params
from vfr_tpu_torch.train.checkpoint import BEST_FILE, latest_checkpoint

PARAMS_FILE = "params.npz"


def init_train_params(generator, model, glove, feature_dim, tcfg,
                      device="cpu"):
    """Model params + training-owned parameters (the learnable
    log-temperature), so the tree matches what a training run saves."""
    params = init_model_params(generator, model, glove, feature_dim, device)
    if tcfg.loss_type == "infonce" and tcfg.learn_temperature:
        params["log_tau"] = torch.log(
            torch.tensor(tcfg.temperature, dtype=torch.float32)).to(device)
    return params


def load_for_eval(cfg: ExperimentConfig,
                  bundle: Optional[DataBundle] = None,
                  prefer_best: bool = False, device=None):
    """(params, model, bundle) for eval/serving on ``device`` (CUDA unless
    asked otherwise; raises without CUDA)."""
    dev = resolve_device(device)
    if bundle is None:
        bundle = load_datasets(cfg.data)
    model = build_model(cfg, dataset=bundle.train)
    ckpt_dir = cfg.train.checkpoint_dir
    path = (os.path.join(ckpt_dir, BEST_FILE) if prefer_best
            else latest_checkpoint(ckpt_dir)
            or os.path.join(ckpt_dir, PARAMS_FILE))
    if not os.path.exists(path):
        if prefer_best:
            raise FileNotFoundError(
                f"--best requested but {path} does not exist")
        gen = torch.Generator().manual_seed(cfg.train.seed)
        params = init_train_params(gen, model, bundle.glove,
                                   bundle.feature_dim, cfg.train, dev)
        return params, model, bundle
    tree, ema, config_json = load_params_npz(path)
    tcfg = (ExperimentConfig.from_json(config_json).train
            if config_json else cfg.train)
    if tcfg.ema_decay > 0:
        if ema is None:
            warnings.warn(
                f"checkpoint {path} has no 'ema' tree; serving RAW params "
                "instead of the Polyak average", stacklevel=2)
        else:
            tree = ema
    return params_from_numpy(tree, dev), model, bundle
