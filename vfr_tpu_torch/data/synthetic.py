"""Deterministic synthetic DiDeMo and Charades-STA fixtures (the port's
copy of the JAX package's ``data/synthetic.py``: ``make_didemo_fixture``,
``make_charades_fixture``, ``charades_lines``; the same
``np.random.default_rng`` draws, so byte-identical output at the same
arguments — tested).

Each annotated moment owns a pool of vocabulary words; the moment's clip
features contain a fixed random projection of the pool's mean GloVe vector,
and a query about the moment samples words from the pool, so the two towers
have a recoverable joint embedding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from vfr_tpu_torch.data.features import FeatureStore
from vfr_tpu_torch.data.glove import Vocab, synthetic_glove


@dataclass
class SyntheticFixture:
    annotations: List[dict]            # DiDeMo-schema dicts
    rgb: FeatureStore
    flow: Optional[FeatureStore]
    vocab: Vocab
    glove: np.ndarray                  # [V, glove_dim]
    meta: dict = field(default_factory=dict)


def _content_words(rng: np.random.Generator, vocab_words: List[str], n: int):
    idx = rng.choice(len(vocab_words), size=n, replace=False)
    return [vocab_words[i] for i in idx]


def _partition_clips(rng: np.random.Generator,
                     num_clips: int) -> List[Tuple[int, int]]:
    """Random partition of [0, num_clips) into contiguous inclusive spans."""
    cuts = sorted(
        rng.choice(
            np.arange(1, num_clips),
            size=rng.integers(1, min(3, num_clips - 1) + 1),
            replace=False,
        ).tolist()
    )
    bounds = [0] + cuts + [num_clips]
    return [(bounds[i], bounds[i + 1] - 1) for i in range(len(bounds) - 1)]


def make_didemo_fixture(
    num_videos: int = 64,
    num_queries: int = 256,
    feature_dim: int = 256,
    glove_dim: int = 64,
    num_clips: int = 6,
    clip_seconds: float = 5.0,
    noise: float = 0.1,
    with_flow: bool = True,
    vocab_words: int = 200,
    words_per_moment: int = 12,
    words_per_query: int = 8,
    seed: int = 0,
) -> SyntheticFixture:
    rng = np.random.default_rng(seed)
    words = [f"w{i:04d}" for i in range(vocab_words)]
    vocab = Vocab(words)
    glove = synthetic_glove(vocab, glove_dim)

    # fixed random projections tie query space to each feature stream
    A_rgb = rng.standard_normal((glove_dim, feature_dim)).astype(np.float32)
    A_rgb /= np.sqrt(glove_dim)
    A_flow = rng.standard_normal((glove_dim, feature_dim)).astype(np.float32)
    A_flow /= np.sqrt(glove_dim)

    rgb_table: Dict[str, np.ndarray] = {}
    flow_table: Dict[str, np.ndarray] = {}
    moments: List[Tuple[str, Tuple[int, int], List[str]]] = []

    for v in range(num_videos):
        vid = f"vid{v:05d}"
        rgb = noise * rng.standard_normal(
            (num_clips, feature_dim)).astype(np.float32)
        flow = noise * rng.standard_normal(
            (num_clips, feature_dim)).astype(np.float32)
        for span in _partition_clips(rng, num_clips):
            pool = _content_words(rng, words, words_per_moment)
            g = glove[[vocab.stoi[w] for w in pool]].mean(axis=0)
            rgb[span[0] : span[1] + 1] += g @ A_rgb
            flow[span[0] : span[1] + 1] += g @ A_flow
            moments.append((vid, span, pool))
        rgb_table[vid] = rgb
        flow_table[vid] = flow

    annotations: List[dict] = []
    for q in range(num_queries):
        vid, span, pool = moments[q % len(moments)]
        k = min(words_per_query, len(pool))
        desc = " ".join(rng.choice(pool, size=k, replace=False).tolist())
        annotations.append({
            "annotation_id": q,
            "video": vid,
            "description": desc,
            "times": [[int(span[0]), int(span[1])]] * 4,
            "num_segments": num_clips,
        })

    return SyntheticFixture(
        annotations=annotations,
        rgb=FeatureStore(rgb_table),
        flow=FeatureStore(flow_table) if with_flow else None,
        vocab=vocab,
        glove=glove,
        meta={
            "kind": "didemo",
            "num_clips": num_clips,
            "clip_seconds": clip_seconds,
            "feature_dim": feature_dim,
            "glove_dim": glove_dim,
        },
    )


def make_charades_fixture(
    num_videos: int = 64,
    num_queries: int = 256,
    feature_dim: int = 256,
    glove_dim: int = 64,
    max_duration: float = 40.0,
    feature_seconds: float = 1.0,
    noise: float = 0.1,
    with_flow: bool = False,
    vocab_words: int = 200,
    words_per_moment: int = 12,
    words_per_query: int = 8,
    moments_per_video: int = 1,
    seed: int = 0,
) -> SyntheticFixture:
    """Charades-STA-schema fixture: per-second ``[T, F]`` features (zero
    past each video's random duration) and ``moments_per_video`` disjoint
    planted spans per video, each with its own word pool (intra-video
    distractors when > 1)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i:04d}" for i in range(vocab_words)]
    vocab = Vocab(words)
    glove = synthetic_glove(vocab, glove_dim)
    A = rng.standard_normal((glove_dim, feature_dim)).astype(np.float32)
    A /= np.sqrt(glove_dim)
    A_flow = rng.standard_normal((glove_dim, feature_dim)).astype(np.float32)
    A_flow /= np.sqrt(glove_dim)

    T = int(round(max_duration / feature_seconds))
    rgb_table: Dict[str, np.ndarray] = {}
    flow_table: Dict[str, np.ndarray] = {}
    moments: List[Tuple[str, Tuple[float, float], List[str], float]] = []

    for v in range(num_videos):
        vid = f"cvid{v:05d}"
        duration = float(rng.uniform(0.5 * max_duration, max_duration))
        n_rows = int(round(duration / feature_seconds))
        rgb = np.zeros((T, feature_dim), dtype=np.float32)
        flow = np.zeros((T, feature_dim), dtype=np.float32)
        rgb[:n_rows] = noise * rng.standard_normal((n_rows, feature_dim))
        flow[:n_rows] = noise * rng.standard_normal((n_rows, feature_dim))
        # one moment per disjoint slot of the duration
        slots = np.linspace(0.0, duration, moments_per_video + 1)
        for j in range(moments_per_video):
            lo, hi = float(slots[j]), float(slots[j + 1])
            span_max = min(26.0, hi - lo)
            span_min = min(8.0, 0.6 * span_max)
            length = float(rng.uniform(span_min, span_max))
            start = float(rng.uniform(lo, hi - length))
            end = start + length
            pool = _content_words(rng, words, words_per_moment)
            g = glove[[vocab.stoi[w] for w in pool]].mean(axis=0)
            a = int(np.floor(start))
            b = max(int(np.ceil(end)), a + 1)
            rgb[a:b] += g @ A
            flow[a:b] += g @ A_flow
            moments.append((vid, (start, end), pool, duration))
        rgb_table[vid] = rgb
        flow_table[vid] = flow

    annotations: List[dict] = []
    for q in range(num_queries):
        vid, (s, e), pool, duration = moments[q % len(moments)]
        k = min(words_per_query, len(pool))
        desc = " ".join(rng.choice(pool, size=k, replace=False).tolist())
        annotations.append({
            "video": vid,
            "start": round(s, 2),
            "end": round(e, 2),
            "description": desc,
            "duration": round(duration, 2),
        })

    return SyntheticFixture(
        annotations=annotations,
        rgb=FeatureStore(rgb_table),
        flow=FeatureStore(flow_table) if with_flow else None,
        vocab=vocab,
        glove=glove,
        meta={
            "kind": "charades_sta",
            "max_duration": max_duration,
            "feature_seconds": feature_seconds,
            "feature_dim": feature_dim,
            "glove_dim": glove_dim,
        },
    )


def charades_lines(annotations: List[dict]) -> List[str]:
    """Render fixture annotations in the official Charades-STA text format."""
    return [
        f"{a['video']} {a['start']} {a['end']}##{a['description']}"
        for a in annotations
    ]
