"""What the drivers share: a configuration's sizes, its seeded weights and
index, the reference's model description, and the host's view of a
window's results."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vfrbench import catalog, inputs


def sizes(cell: "catalog.Cell", cfg) -> Dict:
    """Every size the drivers, the counts and the reference read, from the
    configuration as it is run (``cfg``) and its file's ``corpus``."""
    d, m = cfg.data, cfg.model
    streams = ("rgb", "flow") if d.use_flow else ("rgb",)
    weights = (tuple(m.stream_weights) if len(m.stream_weights) == len(streams)
               else tuple(1.0 / len(streams) for _ in streams))
    corpus = cell.config["corpus"]
    C = int(d.num_clips)
    return {
        "E": int(d.glove_dim), "H": int(m.lstm_hidden),
        "layers": int(m.lstm_layers), "d": int(m.joint_dim),
        "T": int(d.max_query_len), "F": int(d.feature_dim),
        "vocab": int(corpus["vocab"]), "videos": int(corpus["videos"]),
        "row_std": float(corpus.get("row_std", 1.0)),
        "train_videos": int(corpus.get("train_videos", corpus["videos"])),
        "clips": C, "P": C * (C + 1) // 2,
        "clip_seconds": float(d.clip_seconds),
        "stream_names": streams, "streams": len(streams),
        "stream_weights": weights,
        "per_stream_proj": bool(m.per_stream_query_proj),
        "global_context": bool(m.use_global_context), "tef": bool(m.use_tef),
        "query_pool": m.query_pool, "distance": m.distance,
        "compute_dtype": m.compute_dtype, "rnn_cell": m.rnn_cell,
    }


def check_model(s: Dict, cfg) -> None:
    """The reference covers the MCN LSTM tower with mean-pooled, factored
    moments; a configuration outside it is refused before a run."""
    m = cfg.model
    if (m.rnn_cell != "lstm" or m.pooling != "mean"
            or m.normalize_embeddings or m.query_dropout
            or s["query_pool"] not in ("last", "mean")
            or s["distance"] not in ("sqeuclidean", "cosine")):
        raise ValueError("the benchmark's reference covers an LSTM query "
                         "tower (last or mean pool), mean segment pooling "
                         "and the sqeuclidean or cosine distance")


def index_dtype(cfg) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.eval.index_dtype]


def serving_plan(cfg, dev) -> Dict[str, str]:
    """The precisions a serving configuration states: the recurrence's
    products on bf16 operands where the serving kernel runs (``use_pallas``
    "auto" on a card, or "always"), else at the compute dtype; the
    projection at the compute dtype; the score at the product dtype (a bf16
    index's, else the compute dtype's)."""
    compute = cfg.model.compute_dtype
    kernel = cfg.model.use_pallas == "always" or (
        cfg.model.use_pallas == "auto" and on_card(dev))
    score = ("bfloat16" if cfg.eval.index_dtype == "bfloat16" else compute)
    return {"recurrence": "bfloat16" if kernel else compute,
            "projection": compute, "score": score}


def make_index(s: Dict, cfg, seed: int, dev):
    """The index as a saved one loads (``MomentIndex``, no fingerprint):
    V x P rows of S streams, their squared norms, and each row's video,
    proposal and seconds."""
    from vfr_tpu_torch.eval.corpus import MomentIndex

    V, P = s["videos"], s["P"]
    m, m_sq = inputs.index_rows(s["streams"], V * P, s["d"],
                                s["distance"] == "cosine", index_dtype(cfg),
                                seed, dev, s["row_std"])
    spans = inputs.didemo_spans(s["clips"], s["clip_seconds"])
    return MomentIndex(
        m=m, m_sq=m_sq,
        video_row=np.repeat(np.arange(V, dtype=np.int32), P),
        prop_idx=np.tile(np.arange(P, dtype=np.int32), V),
        spans_sec=np.tile(spans, (V, 1)),
        weights=np.asarray(s["stream_weights"], np.float32))


def on_card(dev) -> bool:
    return torch.device(dev).type == "cuda"


def sync(dev) -> None:
    if on_card(dev):
        torch.cuda.synchronize(dev)


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from the seed (Algorithm R)."""

    def __init__(self, size: int, seed: int, stream: int):
        self.size = size
        self.rng = inputs.host_rng(seed, stream)
        self.slots = [None] * size
        self.seen = 0

    def wants(self) -> int:
        """The slot the next item goes to, or -1 when it is not kept."""
        j = self.seen
        self.seen += 1
        if j < self.size:
            return j
        r = int(self.rng.integers(0, j + 1))
        return r if r < self.size else -1

    def put(self, slot: int, key: int, item) -> None:
        self.slots[slot] = (key, item)

    def sample(self):
        return sorted((s for s in self.slots if s is not None),
                      key=lambda kv: kv[0])
