"""Weights carried across from the JAX package, and the port's checkpoint
format.

The JAX package's parameter tree, as nested numpy dicts (what its
``train.checkpoint.load_payload`` returns under ``params`` / ``ema``, or
``jax.device_get`` of ``init_model_params``), keeps its keys and layouts
here: ``embeddings``; ``lstm/layer{l}/{w_ih [E, 4H], w_hh [H, 4H], b [4H]}``,
or for a GRU model (``rnn_cell="gru"``) ``lstm/layer{l}/{w_ih [E, 3H],
w_hh [H, 3H], b_ih [3H], b_hh [3H]}``; ``query_proj`` or ``query_proj_{s}`` / ``{w, b}``; ``moment_proj_{s}`` /
``{w, b}``; ``query_attn``.

A checkpoint of the port is one ``.npz``: ``params/<a>/<b>/...`` keys (the
``/``-joined tree path), optional ``ema/...`` keys, and the experiment
config as JSON under ``config_json``.  A JAX checkpoint converts in three
lines where both packages are installed: parse it with the JAX package's
``load_payload`` and hand ``payload["params"]``, ``payload["config_json"]``
and ``payload.get("ema")`` to ``save_params_npz`` (README.md shows them).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vfr_tpu_torch.utils.io import atomic_savez, to_numpy


def params_from_numpy(tree, device="cpu") -> Dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (values copied bit for bit)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(params) -> Dict:
    """Inverse of ``params_from_numpy``: host numpy copies, same nesting."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return to_numpy(params)


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"parameter key {k!r} contains '/'")
            _flatten(v, f"{prefix}/{k}", out)
    else:
        out[prefix] = to_numpy(tree)


def _unflatten(flat: Dict[str, np.ndarray], root: str):
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        if parts[0] != root:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params_npz(path: str, params, config_json: str = "",
                    ema=None) -> str:
    """Write params (tensors or numpy), optional EMA params and the config
    JSON to one ``.npz`` atomically; returns the path written."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    if ema is not None:
        _flatten(ema, "ema", flat)
    flat["config_json"] = np.asarray(config_json or "")
    return atomic_savez(path, flat)


def load_params_npz(path: str) -> Tuple[Dict, Optional[Dict], str]:
    """(params, ema or None, config_json) as nested numpy dicts."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    config_json = str(flat.pop("config_json", ""))
    ema = _unflatten(flat, "ema")
    return _unflatten(flat, "params"), (ema or None), config_json
