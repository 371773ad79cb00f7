"""Dataset assembly: real files when present, the synthetic fixture
otherwise.

Real layouts (the same as the JAX package's):

didemo:        <data_dir>/{train,val,test}_data.json   (DiDeMo schema)
               <data_dir>/features_rgb.npz  [per video: [6, F]]
               <data_dir>/features_flow.npz (when the preset uses flow)
               <data_dir>/glove.txt         (optional, glove.*.300d format)
charades_sta:  <data_dir>/charades_sta_{train,test}.txt
               <data_dir>/features_rgb.npz  [per video: [T, F]]

A packed ``features_<stream>.vfrf`` (``cli pack``) is preferred over the
``.npz`` of the same stream.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from vfr_tpu_torch.config import DataConfig
from vfr_tpu_torch.data.charades import (
    CharadesSTADataset,
    load_charades_annotations,
)
from vfr_tpu_torch.data.didemo import DidemoDataset, load_annotations
from vfr_tpu_torch.data.features import FeatureStore
from vfr_tpu_torch.data.glove import Vocab, load_glove, synthetic_glove
from vfr_tpu_torch.data.synthetic import (
    make_charades_fixture,
    make_didemo_fixture,
)


@dataclass
class DataBundle:
    train: object
    val: object
    vocab: Vocab
    glove: np.ndarray
    feature_dim: int
    source: str          # "real" | "synthetic"


def _load_store(data_dir: str, stream: str):
    """The packed ``features_<stream>.vfrf`` when present, else the
    ``.npz``."""
    vfrf = os.path.join(data_dir, f"features_{stream}.vfrf")
    if os.path.exists(vfrf):
        return FeatureStore.load(vfrf)
    return FeatureStore.load(os.path.join(data_dir, f"features_{stream}.npz"))


def _load_flow(data_dir: str, use_flow: bool):
    """The flow store (``.npz``, else its ``.vfrf`` twin), raising when the
    config wants a flow stream and neither file exists."""
    if not use_flow:
        return None
    flow = FeatureStore.maybe_load(os.path.join(data_dir, "features_flow.npz"))
    if flow is None:
        raise FileNotFoundError(
            f"use_flow=True but neither features_flow.npz nor "
            f"features_flow.vfrf exists under {data_dir}; provide the flow "
            "feature dump or use an rgb-only preset (e.g. didemo_rgb)")
    return flow


def _glove(data_dir: str, vocab: Vocab, glove_dim: int) -> np.ndarray:
    glove_path = os.path.join(data_dir, "glove.txt")
    return (load_glove(glove_path, vocab, glove_dim)
            if os.path.exists(glove_path)
            else synthetic_glove(vocab, glove_dim))


def load_datasets(dcfg: DataConfig) -> DataBundle:
    if dcfg.dataset == "charades_sta":
        return _load_charades(dcfg)
    return _load_didemo(dcfg)


def _load_didemo(dcfg: DataConfig) -> DataBundle:
    d = dcfg.data_dir
    train_json = os.path.join(d, "train_data.json")
    if os.path.exists(train_json):
        train_anns = load_annotations(train_json)
        val_path = next(
            (p for p in ("val_data.json", "test_data.json")
             if os.path.exists(os.path.join(d, p))),
            None,
        )
        val_anns = (load_annotations(os.path.join(d, val_path))
                    if val_path else train_anns)
        rgb = _load_store(d, "rgb")
        flow = _load_flow(d, dcfg.use_flow)
        vocab = Vocab.from_corpus(
            (a["description"] for a in train_anns), max_size=dcfg.vocab_size)
        glove = _glove(d, vocab, dcfg.glove_dim)
        train_ds = DidemoDataset(train_anns, rgb, flow, vocab, dcfg)
        val_ds = DidemoDataset(val_anns, rgb, flow, vocab, dcfg)
        return DataBundle(train_ds, val_ds, vocab, glove, dcfg.feature_dim,
                          "real")

    fix = make_didemo_fixture(
        num_videos=dcfg.synthetic_num_videos,
        num_queries=dcfg.synthetic_num_queries,
        feature_dim=dcfg.feature_dim,
        glove_dim=dcfg.glove_dim,
        num_clips=dcfg.num_clips,
        clip_seconds=dcfg.clip_seconds,
        noise=dcfg.synthetic_noise,
        with_flow=dcfg.use_flow,
        vocab_words=dcfg.synthetic_vocab_words,
        seed=dcfg.synthetic_seed,
    )
    n_val = max(1, len(fix.annotations) // 5)
    train_ds = DidemoDataset(fix.annotations[:-n_val], fix.rgb, fix.flow,
                             fix.vocab, dcfg)
    val_ds = DidemoDataset(fix.annotations[-n_val:], fix.rgb, fix.flow,
                           fix.vocab, dcfg)
    return DataBundle(train_ds, val_ds, fix.vocab, fix.glove,
                      dcfg.feature_dim, "synthetic")


def _load_charades(dcfg: DataConfig) -> DataBundle:
    d = dcfg.data_dir
    train_txt = os.path.join(d, "charades_sta_train.txt")
    if os.path.exists(train_txt):
        train_anns = load_charades_annotations(train_txt)
        test_txt = os.path.join(d, "charades_sta_test.txt")
        val_anns = (load_charades_annotations(test_txt)
                    if os.path.exists(test_txt) else train_anns)
        rgb = _load_store(d, "rgb")
        flow = _load_flow(d, dcfg.use_flow)
        vocab = Vocab.from_corpus(
            (a["description"] for a in train_anns), max_size=dcfg.vocab_size)
        glove = _glove(d, vocab, dcfg.glove_dim)
        train_ds = CharadesSTADataset(train_anns, rgb, flow, vocab, dcfg)
        val_ds = CharadesSTADataset(val_anns, rgb, flow, vocab, dcfg)
        return DataBundle(train_ds, val_ds, vocab, glove, dcfg.feature_dim,
                          "real")

    fix = make_charades_fixture(
        num_videos=dcfg.synthetic_num_videos,
        num_queries=dcfg.synthetic_num_queries,
        feature_dim=dcfg.feature_dim,
        glove_dim=dcfg.glove_dim,
        max_duration=dcfg.max_duration,
        feature_seconds=dcfg.feature_seconds,
        noise=dcfg.synthetic_noise,
        with_flow=dcfg.use_flow,
        vocab_words=dcfg.synthetic_vocab_words,
        moments_per_video=dcfg.synthetic_moments_per_video,
        seed=dcfg.synthetic_seed,
    )
    n_val = max(1, len(fix.annotations) // 5)
    flow = fix.flow if dcfg.use_flow else None
    train_ds = CharadesSTADataset(fix.annotations[:-n_val], fix.rgb, flow,
                                  fix.vocab, dcfg)
    val_ds = CharadesSTADataset(fix.annotations[-n_val:], fix.rgb, flow,
                                fix.vocab, dcfg)
    return DataBundle(train_ds, val_ds, fix.vocab, fix.glove,
                      dcfg.feature_dim, "synthetic")
