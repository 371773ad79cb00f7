"""Crash-safe artifact persistence and parameter fingerprints."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from vfr_tpu_torch.utils.tree import flatten


def tree_leaves(tree):
    """Leaves of a nested dict in sorted-key order at every level — the
    order ``jax.tree.leaves`` gives a dict pytree, so fingerprints agree
    with the JAX package's on the same values."""
    return flatten(tree)[1]


def to_numpy(leaf) -> np.ndarray:
    """Host numpy copy of a tensor; a bf16 tensor comes back as its uint16
    bit pattern (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def tree_fingerprint(tree) -> str:
    """SHA-1 over every leaf's dtype/shape/bytes of a nested parameter dict
    (same per-leaf encoding as the JAX package's ``utils/io.py``)."""
    h = hashlib.sha1()
    for leaf in tree_leaves(tree):
        a = to_numpy(leaf)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def atomic_savez(path: str, arrays: dict, compressed: bool = False) -> str:
    """``np.savez`` of ``arrays`` to ``path`` atomically (tmp file in the
    destination directory + ``os.replace``); appends ``.npz`` when missing
    and returns the path written."""
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            (np.savez_compressed if compressed else np.savez)(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path
