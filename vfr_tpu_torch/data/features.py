"""Precomputed clip-feature store: video id -> ``[num_clips, feature_dim]``
float32 (DiDeMo) or ``[T, feature_dim]`` per-second rows (Charades-STA),
from one ``.npz`` per stream, a directory of ``<video_id>.npy`` files or a
packed ``.vfrf`` file (``data/packed.py``); and ``banks_to_device``, the
one-time copy of full-corpus banks to the device."""

from __future__ import annotations

import os
from typing import Dict, Iterable

import numpy as np
import torch

from vfr_tpu_torch.device import resolve_device


class FeatureStore:
    """In-memory map video id -> feature array."""

    def __init__(self, table: Dict[str, np.ndarray]):
        self._table = {k: np.asarray(v, dtype=np.float32)
                       for k, v in table.items()}

    def __getitem__(self, video_id: str) -> np.ndarray:
        return self._table[video_id]

    def ids(self) -> Iterable[str]:
        return self._table.keys()

    def get_padded(self, video_id: str, rows: int) -> np.ndarray:
        """Features zero-padded/truncated to ``rows`` rows (the static row
        grid); pooling matrices and validity masks carry the true length."""
        f = self._table[video_id]
        out = np.zeros((rows, f.shape[1]), dtype=np.float32)
        n = min(rows, f.shape[0])
        out[:n] = f[:n]
        return out

    def __contains__(self, video_id: str) -> bool:
        return video_id in self._table

    def __len__(self) -> int:
        return len(self._table)

    @classmethod
    def load(cls, path: str):
        """Load from ``.npz``, a ``<video_id>.npy`` directory, or a packed
        ``.vfrf`` file (a ``PackedFeatureStore``: mapped, not read)."""
        if path.endswith(".vfrf"):
            from vfr_tpu_torch.data.packed import PackedFeatureStore

            return PackedFeatureStore(path)
        if os.path.isdir(path):
            table = {}
            for fn in sorted(os.listdir(path)):
                if fn.endswith(".npy"):
                    table[fn[:-4]] = np.load(os.path.join(path, fn))
            return cls(table)
        with np.load(path) as z:
            return cls({k: z[k] for k in z.files})

    @classmethod
    def maybe_load(cls, path: str):
        """``load(path)`` when it exists; else the packed twin
        ``<stem>.vfrf`` when that exists; else None."""
        if os.path.exists(path):
            return cls.load(path)
        vfrf = os.path.splitext(path)[0] + ".vfrf"
        if os.path.exists(vfrf):
            return cls.load(vfrf)
        return None


# feature-stream bank keys eligible for bank_dtype quantization; small
# exact tables (video_tef, masks) always stay at their native dtype
_STREAM_KEYS = ("rgb", "flow")


def banks_to_device(banks: dict, bank_dtype: str = "float32",
                    device=None) -> Dict[str, torch.Tensor]:
    """One-time copy of full-corpus feature banks to ``device`` (CUDA unless
    asked otherwise; raises without CUDA).

    ``bank_dtype="bfloat16"`` converts the rgb/flow streams on the host
    before the copy (half the bytes moved and held); consumers upcast at
    gather time, so only the stored inputs are quantized.  Other keys keep
    their dtype."""
    if bank_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown bank_dtype {bank_dtype!r}")
    device = resolve_device(device)
    out = {}
    for k, v in banks.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in _STREAM_KEYS:
            t = t.to(torch.bfloat16 if bank_dtype == "bfloat16"
                     else torch.float32)
        out[k] = t.to(device)
    return out
