"""Checkpoint / resume (the port of the JAX package's
``train/checkpoint.py``), in the npz format of ``bridge.save_params_npz``.

One ``.npz`` per save: ``params/...``, ``ema/...`` (when the run keeps a
Polyak average), ``opt_state/...`` (the ``train.optim`` state: ``count``
and the moment or trace trees), ``step`` and the experiment config as JSON
under ``config_json``.  Step checkpoints are ``ckpt_<step:08d>.npz`` with
a rolling retention window of ``keep``; a named file (``best.npz``) sits
outside it and outside ``latest_checkpoint``'s view.  Writes are atomic.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np

from vfr_tpu_torch.bridge import _flatten, _unflatten, params_from_numpy
from vfr_tpu_torch.config import ExperimentConfig
from vfr_tpu_torch.device import resolve_device
from vfr_tpu_torch.utils.io import atomic_savez

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")
BEST_FILE = "best.npz"


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    params: Any,
    opt_state: Any,
    config: Optional[ExperimentConfig] = None,
    keep: int = 3,
    ema: Any = None,
    filename: Optional[str] = None,
) -> str:
    """Write one checkpoint; ``filename`` (e.g. ``best.npz``) replaces the
    step-stamped name and skips retention.  Returns the path written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    if ema is not None:
        _flatten(ema, "ema", flat)
    _flatten(opt_state, "opt_state", flat)
    flat["step"] = np.asarray(step, np.int64)
    flat["config_json"] = np.asarray(config.to_json() if config else "")
    path = atomic_savez(os.path.join(
        ckpt_dir, filename or f"ckpt_{step:08d}.npz"), flat)
    if filename is None:
        _gc(ckpt_dir, keep)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for fn in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fn)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, fn), int(m.group(1))
    return best


def best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The rolling best-val checkpoint of a ``best_metric`` run, or None."""
    path = os.path.join(ckpt_dir, BEST_FILE)
    return path if os.path.exists(path) else None


def load_payload(path: str) -> Dict[str, np.ndarray]:
    """Every array of a checkpoint file, read once."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def config_of(payload: Dict[str, np.ndarray]) -> Optional[ExperimentConfig]:
    cj = str(payload.get("config_json", ""))
    return ExperimentConfig.from_json(cj) if cj else None


def _opt_state(tree: Dict, device) -> Dict:
    out = {k: params_from_numpy(v, device) for k, v in tree.items()
           if k != "count"}
    out["count"] = int(tree["count"])
    return out


def restore_checkpoint(path: str, payload: Optional[Dict] = None,
                       device=None
                       ) -> Tuple[int, Dict, Optional[Dict],
                                  Optional[ExperimentConfig]]:
    """(step, params, opt_state or None, config) on ``device`` (CUDA unless
    asked otherwise; raises without CUDA)."""
    device = resolve_device(device)
    stored = load_payload(path) if payload is None else payload
    params = params_from_numpy(_unflatten(stored, "params"), device)
    opt = _unflatten(stored, "opt_state")
    return (int(stored["step"]), params,
            _opt_state(opt, device) if opt else None, config_of(stored))


def restore_ema(path: str, payload: Optional[Dict] = None, device=None):
    """The Polyak-averaged params of an ``ema_decay > 0`` run (on ``device``,
    CUDA unless asked otherwise); the raw params, with a warning, when the
    file has no average."""
    device = resolve_device(device)
    stored = load_payload(path) if payload is None else payload
    tree = _unflatten(stored, "ema")
    if not tree:
        warnings.warn(
            f"checkpoint {path} has no 'ema' tree; restoring RAW params "
            "instead of the Polyak average", stacklevel=2)
        tree = _unflatten(stored, "params")
    return params_from_numpy(tree, device)


def _gc(ckpt_dir: str, keep: int) -> None:
    entries = []
    for fn in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fn)
        if m:
            entries.append((int(m.group(1)), fn))
    for _, fn in sorted(entries)[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, fn))

