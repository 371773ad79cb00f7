"""Packed mmap feature store (``.vfrf``): the writer, and a reader over the
native C++ library (``csrc/host/vfr_io.cc``, built with ``g++`` at first
use by ``kernels.build.load_host``) with an ``np.memmap`` reader for where
that build fails.  The file format is the JAX package's, byte for byte:

    offset 0   magic "VFRF1\\0\\0\\0"
    offset 8   int64 num_videos
    offset 16  int32 rows (static row grid)
    offset 20  int32 feature dim
    offset 24  num_videos * 64 bytes of null-padded ids, sorted
    then       num_videos * rows * dim float32 features

A cold start of a large corpus from ``.npz`` decompresses the whole archive
up front; the packed file is mapped (page-cache backed) and gathered by a
multithreaded copy loop.  ``PackedFeatureStore.native`` says which reader
serves a store.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

MAGIC = b"VFRF1\x00\x00\x00"
ID_BYTES = 64
_HEADER = 24

_lib = None
_lib_tried = False


def _load_native():
    """The native reader, built on first use; None when that fails (the
    memmap reader then serves), tried once per process."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    from vfr_tpu_torch.kernels.build import load_host

    try:
        _lib = load_host("vfr_io")
    except (RuntimeError, OSError):
        _lib = None
    return _lib


def pack_features(
    table: Dict[str, np.ndarray], path: str, rows: Optional[int] = None
) -> str:
    """Write a VFRF file from video_id -> [r, dim] float32 (padded to the
    static ``rows`` grid; ids sorted for binary search)."""
    ids = sorted(table)
    if not ids:
        raise ValueError("empty feature table")
    dim = int(table[ids[0]].shape[1])
    rows = rows or max(int(table[v].shape[0]) for v in ids)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.int64(len(ids)).tobytes())
        f.write(np.int32(rows).tobytes())
        f.write(np.int32(dim).tobytes())
        for v in ids:
            b = v.encode("utf-8")
            if len(b) >= ID_BYTES:
                raise ValueError(
                    f"video id too long ({len(b)} >= {ID_BYTES}): {v}")
            f.write(b + b"\x00" * (ID_BYTES - len(b)))
        for v in ids:
            arr = np.asarray(table[v], dtype=np.float32)
            if arr.shape[1] != dim:
                raise ValueError(f"dim mismatch for {v}")
            out = np.zeros((rows, dim), np.float32)
            r = min(rows, arr.shape[0])
            out[:r] = arr[:r]
            f.write(out.tobytes())
    return path


class PackedFeatureStore:
    """Reader over a VFRF file: the ``FeatureStore`` surface plus a batched
    ``gather(indices)``."""

    def __init__(self, path: str, prefer_native: bool = True):
        self.path = path
        self._h = None
        self._lib = _load_native() if prefer_native else None
        if self._lib is not None:
            self._h = self._lib.vfr_open(path.encode("utf-8"))
            if not self._h:
                self._lib = None
        if self._lib is not None:
            self.num_videos = int(self._lib.vfr_num_videos(self._h))
            self.rows = int(self._lib.vfr_rows(self._h))
            self.dim = int(self._lib.vfr_dim(self._h))
            self.backend = "native"
        else:
            self._open_numpy(path)
            self.backend = "numpy"

    @property
    def native(self) -> bool:
        """True when the native reader serves this store."""
        return self.backend == "native"

    def _open_numpy(self, path: str):
        with open(path, "rb") as f:
            head = f.read(_HEADER)
        if head[:8] != MAGIC:
            raise ValueError(f"{path} is not a VFRF file")
        self.num_videos = int(np.frombuffer(head, np.int64, 1, 8)[0])
        self.rows = int(np.frombuffer(head, np.int32, 1, 16)[0])
        self.dim = int(np.frombuffer(head, np.int32, 1, 20)[0])
        ids_raw = np.memmap(path, np.uint8, "r", _HEADER,
                            (self.num_videos * ID_BYTES,))
        self._ids = [
            bytes(ids_raw[i * ID_BYTES: (i + 1) * ID_BYTES])
            .split(b"\x00", 1)[0]
            .decode("utf-8")
            for i in range(self.num_videos)
        ]
        self._id_to_row = {v: i for i, v in enumerate(self._ids)}
        self._mm = np.memmap(
            path, np.float32, "r", _HEADER + self.num_videos * ID_BYTES,
            (self.num_videos, self.rows, self.dim),
        )

    # -------------------------------------------------- id-keyed interface
    def find(self, video_id: str) -> int:
        if self.native:
            return int(self._lib.vfr_find(self._h, video_id.encode("utf-8")))
        return self._id_to_row.get(video_id, -1)

    def ids(self) -> Iterable[str]:
        if self.native:
            buf = ctypes.create_string_buffer(ID_BYTES)
            for i in range(self.num_videos):
                self._lib.vfr_id_at(self._h, i, buf)
                yield buf.value.decode("utf-8")
        else:
            yield from self._ids

    def __contains__(self, video_id: str) -> bool:
        return self.find(video_id) >= 0

    def __len__(self) -> int:
        return self.num_videos

    def __getitem__(self, video_id: str) -> np.ndarray:
        row = self.find(video_id)
        if row < 0:
            raise KeyError(video_id)
        return self.gather(np.asarray([row], np.int64))[0]

    def get_padded(self, video_id: str, rows: int) -> np.ndarray:
        f = self[video_id]
        out = np.zeros((rows, self.dim), np.float32)
        r = min(rows, f.shape[0])
        out[:r] = f[:r]
        return out

    # -------------------------------------------------- batched fast path
    def gather(self, indices: Sequence[int], threads: int = 8) -> np.ndarray:
        """out[i] = features[indices[i]] as one [n, rows, dim] block; an
        index out of range gives a zero block."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        n = idx.shape[0]
        if self.native:
            out = np.empty((n, self.rows, self.dim), np.float32)
            self._lib.vfr_gather(
                self._h,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                threads,
            )
            return out
        safe = np.clip(idx, 0, self.num_videos - 1)
        out = np.asarray(self._mm[safe])
        out[(idx < 0) | (idx >= self.num_videos)] = 0.0
        return out

    def close(self):
        if self.native and self._h:
            self._lib.vfr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
