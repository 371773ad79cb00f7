"""Model factory: wire config + dataset static tables into a Model context."""

from __future__ import annotations

import dataclasses

import numpy as np

from vfr_tpu_torch.config import ExperimentConfig
from vfr_tpu_torch.models.mcn import Model
from vfr_tpu_torch.ops.proposals import (
    didemo_proposals,
    pooling_matrix,
    temporal_endpoint_features,
)


def build_model(cfg: ExperimentConfig, dataset=None) -> Model:
    streams = ("rgb", "flow") if cfg.data.use_flow else ("rgb",)
    mcfg = cfg.model
    if len(mcfg.stream_weights) != len(streams):
        mcfg = dataclasses.replace(
            mcfg, stream_weights=tuple(1.0 / len(streams) for _ in streams))
    if cfg.data.dataset == "charades_sta":
        if dataset is None:
            raise ValueError("charades model needs the dataset's window bank")
        pool = np.asarray(dataset.pool, np.float32)   # [W, T]
        tef = None                                    # per-video, from batches
    else:
        spans = didemo_proposals(cfg.data.num_clips)
        # the mean matrix doubles as the span-membership indicator for
        # pooling="max" (models.mcn._segment_max uses its nonzero pattern)
        pool = np.asarray(pooling_matrix(spans, cfg.data.num_clips, "mean"),
                          np.float32)
        tef = np.asarray(
            temporal_endpoint_features(spans, cfg.data.num_clips), np.float32)
    return Model(cfg=mcfg, streams=streams, pool_matrix=pool, tef=tef,
                 decoder=cfg.decoder)
