"""Charades-STA dataset: sliding-window moment retrieval (the port's copy of
the JAX package's ``data/charades.py``).

Parses the official ``<video> <start> <end>##<sentence>`` annotation format
(or pre-parsed dicts) plus per-second ``[T, F]`` features.  All videos share
ONE static window bank (``ops.proposals.charades_window_bank``); per-video
variability is carried by masks and duration-normalized TEF.

Batch keys: tokens, lengths, feats [B,T,F], (flow), target, video_idx,
window_mask [B,W] bool, tef [B,W,2], gt_spans [B,1,2], gt_mask [B,1],
valid (eval only).  Window bank arrays live on the dataset: ``windows``
[W,2] seconds and ``pool`` [W,T].
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Union

import numpy as np

from vfr_tpu_torch.config import DataConfig
from vfr_tpu_torch.data.features import FeatureStore
from vfr_tpu_torch.data.glove import Vocab, tokenize
from vfr_tpu_torch.ops.proposals import (
    charades_window_bank,
    window_tef,
    window_validity_mask,
)
from vfr_tpu_torch.ops.tiou import tiou


def parse_charades_lines(lines: List[str]) -> List[dict]:
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        head, _, desc = line.partition("##")
        vid, s, e = head.split()
        out.append({
            "video": vid,
            "start": float(s),
            "end": float(e),
            "description": desc,
        })
    return out


def load_charades_annotations(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as f:
        return parse_charades_lines(f.readlines())


class CharadesSTADataset:
    def __init__(
        self,
        annotations: Union[List[dict], List[str]],
        rgb: FeatureStore,
        flow: Optional[FeatureStore],
        vocab: Vocab,
        cfg: DataConfig,
        durations: Optional[Dict[str, float]] = None,
    ):
        if annotations and isinstance(annotations[0], str):
            annotations = parse_charades_lines(annotations)  # type: ignore
        self.cfg = cfg
        self.vocab = vocab
        T = int(round(cfg.max_duration / cfg.feature_seconds))
        self.num_feature_rows = T
        self.windows, self.pool = charades_window_bank(
            cfg.max_duration, cfg.feature_seconds, cfg.window_scales,
            cfg.window_stride_ratio, cfg.max_windows,
        )
        W = cfg.max_windows
        self.num_proposals = W

        self.video_ids = sorted({a["video"] for a in annotations})
        vrow = {v: i for i, v in enumerate(self.video_ids)}
        F = cfg.feature_dim
        self.rgb_feats = np.stack(
            [rgb.get_padded(v, T)[:, :F] for v in self.video_ids]
        )
        self.flow_feats = (
            np.stack([flow.get_padded(v, T)[:, :F] for v in self.video_ids])
            if flow is not None
            else None
        )

        # Per-video duration: annotation field, caller-supplied map, or the
        # number of nonzero feature rows as a fallback.
        dur = {}
        for a in annotations:
            if "duration" in a:
                dur[a["video"]] = float(a["duration"])
        if durations:
            dur.update(durations)
        self.durations = np.zeros(len(self.video_ids), dtype=np.float32)
        for v, i in vrow.items():
            if v in dur:
                self.durations[i] = dur[v]
            else:
                nz = np.flatnonzero(np.abs(self.rgb_feats[i]).sum(axis=1) > 0)
                self.durations[i] = (
                    (nz[-1] + 1) * cfg.feature_seconds if len(nz)
                    else cfg.max_duration
                )

        # Static per-video window masks + duration-normalized TEF.
        self.window_mask = np.stack([
            window_validity_mask(self.windows, d, cfg.feature_seconds)
            for d in self.durations
        ])  # [V, W]
        # A video shorter than the smallest window scale would get an
        # all-False mask (degenerate targets, all-inf eval distances): its
        # shortest real bank window is always usable (pooling over zero
        # padded tail rows is well-defined).
        lengths_w = self.windows[:, 1] - self.windows[:, 0]
        real = lengths_w > 1e-6
        shortest = int(np.argmin(np.where(real, lengths_w, np.inf)))
        empty = ~self.window_mask.any(axis=1)
        self.window_mask[empty, shortest] = True
        self.video_tef = np.stack([
            window_tef(self.windows, d) for d in self.durations
        ])  # [V, W, 2]

        N, L = len(annotations), cfg.max_query_len
        self.tokens = np.zeros((N, L), dtype=np.int32)
        self.lengths = np.zeros(N, dtype=np.int32)
        self.target = np.zeros(N, dtype=np.int32)
        self.video_idx = np.zeros(N, dtype=np.int32)
        self.gt_spans = np.zeros((N, 1, 2), dtype=np.float32)
        self.gt_mask = np.ones((N, 1), dtype=bool)

        for i, a in enumerate(annotations):
            ids, n = vocab.encode(tokenize(a["description"]), L)
            self.tokens[i], self.lengths[i] = ids, n
            v = vrow[a["video"]]
            self.video_idx[i] = v
            gt = np.asarray([a["start"], a["end"]], dtype=np.float32)
            self.gt_spans[i, 0] = gt
            # target = max-tIoU window among this video's valid windows
            ious = tiou(self.windows, gt)
            ious = np.where(self.window_mask[v], ious, -1.0)
            self.target[i] = int(np.argmax(ious))

        self.num_queries = N

    def _gather(self, idx: np.ndarray, with_gt: bool,
                with_features: bool = True) -> Dict[str, np.ndarray]:
        v = self.video_idx[idx]
        b = {
            "tokens": self.tokens[idx],
            "lengths": self.lengths[idx],
            "target": self.target[idx],
            "video_idx": v,
            "window_mask": self.window_mask[v],
            "tef": self.video_tef[v],
            "query_idx": idx.astype(np.int32),
        }
        if with_features:
            b["rgb"] = self.rgb_feats[v]
            if self.flow_feats is not None:
                b["flow"] = self.flow_feats[v]
        if with_gt:
            b["gt_spans"] = self.gt_spans[idx]
            b["gt_mask"] = self.gt_mask[idx]
        return b

    def feature_banks(self) -> Dict[str, np.ndarray]:
        """stream -> [V, T, F] full-corpus feature arrays (for a one-time
        device copy, ``data.features.banks_to_device``)."""
        banks = {"rgb": self.rgb_feats}
        if self.flow_feats is not None:
            banks["flow"] = self.flow_feats
        return banks

    def train_batches(self, batch_size: int, steps: int, seed: int,
                      sample_targets: bool = False,
                      with_features: bool = True
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """``steps`` shuffled batches of a fixed shape (a fresh permutation
        whenever the current one runs out).  A Charades-STA query has one
        GT interval, so ``sample_targets`` changes nothing."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(self.num_queries)
        pos = 0
        for _ in range(steps):
            if pos + batch_size > len(order):
                order = rng.permutation(self.num_queries)
                pos = 0
            idx = order[pos : pos + batch_size]
            pos += batch_size
            yield self._gather(idx, with_gt=False,
                               with_features=with_features)

    def eval_batches(self, batch_size: int, with_features: bool = True
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """All queries once; the final batch padded with query 0 and a
        ``valid`` mask."""
        for start in range(0, self.num_queries, batch_size):
            idx = np.arange(start, min(start + batch_size, self.num_queries))
            valid = np.ones(batch_size, dtype=bool)
            if len(idx) < batch_size:
                valid[len(idx):] = False
                idx = np.concatenate(
                    [idx, np.zeros(batch_size - len(idx), dtype=idx.dtype)]
                )
            b = self._gather(idx, with_gt=True, with_features=with_features)
            b["valid"] = valid
            yield b
