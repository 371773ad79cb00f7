"""DiDeMo dataset (SURVEY.md C1): annotations + clip features -> batches.

Consumes DiDeMo-schema annotation dicts (``video``, ``description``,
``times`` = per-annotator inclusive clip spans) and per-video ``[C, F]``
clip features.  Every emitted batch is a dict of fixed-shape numpy arrays —
TPU-ready with zero dynamic padding (21 proposals and 6 clips are static).

Batch keys:
  tokens    [B, T] int32 GloVe ids (0 = pad)
  lengths   [B]    int32
  rgb       [B, C, F] float32
  flow      [B, C, F] float32 (only when a flow store is present)
  target    [B]    int32  — training target proposal index (annotator mode)
  video_idx [B]    int32  — corpus row of the query's video (negative identity)
  gt_spans  [B, A, 2] float32 second intervals per annotator
  gt_mask   [B, A] bool
  valid     [B]    bool   — eval-batch padding mask
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterator, List, Optional

import numpy as np

from vfr_tpu_torch.config import DataConfig
from vfr_tpu_torch.data.features import FeatureStore
from vfr_tpu_torch.data.glove import Vocab, tokenize
from vfr_tpu_torch.ops.proposals import didemo_proposals, span_index, spans_to_seconds

MAX_ANNOTATORS = 4


def load_annotations(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


class DidemoDataset:
    def __init__(
        self,
        annotations: List[dict],
        rgb: FeatureStore,
        flow: Optional[FeatureStore],
        vocab: Vocab,
        cfg: DataConfig,
    ):
        self.cfg = cfg
        self.vocab = vocab
        C = cfg.num_clips
        self.spans = didemo_proposals(C)                       # [P, 2]
        self.span_seconds = spans_to_seconds(self.spans, cfg.clip_seconds)
        self.num_proposals = self.spans.shape[0]

        # Corpus video table (sorted for determinism).
        self.video_ids: List[str] = sorted({a["video"] for a in annotations})
        vrow = {v: i for i, v in enumerate(self.video_ids)}
        F = cfg.feature_dim
        self.rgb_feats = np.stack(
            [_fit(rgb[v], C, F) for v in self.video_ids]
        )  # [V, C, F]
        self.flow_feats = (
            np.stack([_fit(flow[v], C, F) for v in self.video_ids])
            if flow is not None
            else None
        )

        N, T = len(annotations), cfg.max_query_len
        self.tokens = np.zeros((N, T), dtype=np.int32)
        self.lengths = np.zeros(N, dtype=np.int32)
        self.target = np.zeros(N, dtype=np.int32)
        self.video_idx = np.zeros(N, dtype=np.int32)
        self.gt_spans = np.zeros((N, MAX_ANNOTATORS, 2), dtype=np.float32)
        self.gt_mask = np.zeros((N, MAX_ANNOTATORS), dtype=bool)
        # per-annotator GT proposal index (-1 = padding) for the
        # DiDeMo-official rank-aggregation protocol
        self.gt_prop_idx = np.full((N, MAX_ANNOTATORS), -1, dtype=np.int32)

        for i, a in enumerate(annotations):
            ids, n = vocab.encode(tokenize(a["description"]), T)
            self.tokens[i], self.lengths[i] = ids, n
            self.video_idx[i] = vrow[a["video"]]
            times = [
                (int(t[0]), int(min(t[1], C - 1)))
                for t in a["times"]
                if 0 <= int(t[0]) < C and int(t[0]) <= int(t[1])
            ][:MAX_ANNOTATORS]
            if not times:
                times = [(0, 0)]
            # training target = most common annotator span; ties break to
            # the smallest proposal index (deterministic, documented rule —
            # Counter.most_common alone would break ties by insertion order)
            counts = Counter(times)
            mode_span = min(
                counts, key=lambda s: (-counts[s], span_index(s, C))
            )
            self.target[i] = span_index(mode_span, C)
            sec = spans_to_seconds(np.asarray(times, np.int32), cfg.clip_seconds)
            self.gt_spans[i, : len(times)] = sec
            self.gt_mask[i, : len(times)] = True
            for ann, t in enumerate(times):
                self.gt_prop_idx[i, ann] = span_index(t, C)

        self.num_queries = N

    # ---------------------------------------------------------------- batches
    def _gather(self, idx: np.ndarray, with_gt: bool,
                with_features: bool = True) -> Dict[str, np.ndarray]:
        b = {
            "tokens": self.tokens[idx],
            "lengths": self.lengths[idx],
            "target": self.target[idx],
            "video_idx": self.video_idx[idx],
            # dataset row of each query — lets the train loop join
            # per-query side tables (e.g. mined hard negatives)
            "query_idx": idx.astype(np.int32),
        }
        if with_features:
            # host-side gather; device-resident feature banks skip this
            # entirely (train/step.py feature_banks)
            b["rgb"] = self.rgb_feats[self.video_idx[idx]]
            if self.flow_feats is not None:
                b["flow"] = self.flow_feats[self.video_idx[idx]]
        if with_gt:
            b["gt_spans"] = self.gt_spans[idx]
            b["gt_mask"] = self.gt_mask[idx]
            b["gt_prop_idx"] = self.gt_prop_idx[idx]
        return b

    def feature_banks(self) -> Dict[str, np.ndarray]:
        """stream -> [V, C, F] full-corpus feature arrays (for one-time
        device upload; see train/step.py feature_banks)."""
        banks = {"rgb": self.rgb_feats}
        if self.flow_feats is not None:
            banks["flow"] = self.flow_feats
        return banks

    def train_batches(
        self, batch_size: int, steps: int, seed: int,
        sample_targets: bool = False, with_features: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """``steps`` shuffled batches (with-replacement epochs, fixed shape).

        ``sample_targets``: draw a random annotator's span as the training
        target each step instead of the consensus mode (TrainConfig.
        target_sampling="sample") — annotation-noise augmentation."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(self.num_queries)
        pos = 0
        for _ in range(steps):
            if pos + batch_size > len(order):
                order = rng.permutation(self.num_queries)
                pos = 0
            idx = order[pos : pos + batch_size]
            pos += batch_size
            b = self._gather(idx, with_gt=False, with_features=with_features)
            if sample_targets:
                counts = self.gt_mask[idx].sum(axis=1).clip(min=1)
                pick = rng.integers(0, counts)
                b["target"] = self.gt_prop_idx[idx, pick].astype(np.int32)
            yield b

    def eval_batches(self, batch_size: int, with_features: bool = True
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """All queries once; final batch padded by repetition + ``valid`` mask."""
        for start in range(0, self.num_queries, batch_size):
            idx = np.arange(start, min(start + batch_size, self.num_queries))
            valid = np.ones(batch_size, dtype=bool)
            if len(idx) < batch_size:
                valid[len(idx) :] = False
                idx = np.concatenate(
                    [idx, np.zeros(batch_size - len(idx), dtype=idx.dtype)]
                )
            b = self._gather(idx, with_gt=True, with_features=with_features)
            b["valid"] = valid
            yield b


def _fit(feats: np.ndarray, rows: int, dim: int) -> np.ndarray:
    """Pad/truncate a [c, f] feature array onto the static [rows, dim] grid."""
    out = np.zeros((rows, dim), dtype=np.float32)
    r = min(rows, feats.shape[0])
    d = min(dim, feats.shape[1])
    out[:r, :d] = feats[:r, :d]
    if feats.shape[0] < rows and feats.shape[0] > 0:
        # DiDeMo videos shorter than 6 clips: repeat the last real clip so
        # mean pooling over spans touching the tail stays well-defined.
        out[feats.shape[0] : rows, :d] = feats[-1, :d]
    return out
