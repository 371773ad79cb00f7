"""A small two-package world for the live-index and follow-serving tests:
one synthetic DiDeMo corpus (two streams, cosine, small widths) built as
the JAX package's and the port's dataset on the same numpy weights, plus
a second fixture whose videos are the deltas of ``!add``."""

import types

import jax
import jax.numpy as jnp
import numpy as np

from vfr_tpu.config import DataConfig as JDataConfig
from vfr_tpu.config import ExperimentConfig as JExperimentConfig
from vfr_tpu.config import ModelConfig as JModelConfig
from vfr_tpu.data.didemo import DidemoDataset as JDidemoDataset
from vfr_tpu.data.synthetic import make_didemo_fixture
from vfr_tpu.models.build import build_model as j_build_model
from vfr_tpu.models.mcn import init_model_params as j_init_model_params
from vfr_tpu_torch.bridge import params_from_numpy
from vfr_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
from vfr_tpu_torch.data.didemo import DidemoDataset
from vfr_tpu_torch.models.build import build_model

F, E, H, J = 24, 16, 32, 8


def _fixture(num_videos, seed, prefix=None):
    fix = make_didemo_fixture(num_videos=num_videos, num_queries=3 *
                              num_videos, feature_dim=F, glove_dim=E,
                              seed=seed)
    data = dict(feature_dim=F, glove_dim=E, use_flow=True)
    jds = JDidemoDataset(fix.annotations, fix.rgb, fix.flow, fix.vocab,
                         JDataConfig(**data))
    tds = DidemoDataset(fix.annotations, fix.rgb, fix.flow, fix.vocab,
                        DataConfig(**data))
    if prefix is not None:
        # re-key so two fixtures never collide on video ids
        for ds in (jds, tds):
            ds.video_ids = [v.replace("vid", prefix) for v in ds.video_ids]
    return fix, jds, tds


def world(compute_dtype="float32", seed=7):
    fix, jds, tds = _fixture(12, seed)
    _, _, delta = _fixture(6, seed + 4, prefix="new")
    kw = dict(joint_dim=J, lstm_hidden=H, stream_weights=(0.5, 0.5),
              distance="cosine", compute_dtype=compute_dtype)
    data = dict(feature_dim=F, glove_dim=E, use_flow=True)
    jmodel = j_build_model(JExperimentConfig(
        name="live", data=JDataConfig(**data), model=JModelConfig(**kw)))
    tmodel = build_model(ExperimentConfig(
        name="live", data=DataConfig(**data), model=ModelConfig(**kw)))
    tree = jax.tree.map(np.asarray, jax.device_get(j_init_model_params(
        jax.random.PRNGKey(3), jmodel, fix.glove, F)))
    batch = next(tds.eval_batches(8, with_features=False))
    return types.SimpleNamespace(
        jmodel=jmodel, tmodel=tmodel, jds=jds, tds=tds, delta=delta,
        vocab=fix.vocab, tree=tree,
        jparams=jax.tree.map(jnp.asarray, tree),
        tparams=params_from_numpy(tree),
        toks=batch["tokens"], lens=batch["lengths"])


def concat_corpus(ds, extra=None, drop=()):
    """A corpus shim: ``ds`` followed by ``extra`` ([(id, rgb, flow)]),
    without the videos in ``drop`` (order kept), for a rebuild."""
    ids = list(ds.video_ids)
    rgb = list(ds.rgb_feats)
    flow = list(ds.flow_feats)
    for v, r, f in extra or ():
        ids.append(v)
        rgb.append(r)
        flow.append(f)
    keep = [i for i, v in enumerate(ids) if v not in set(drop)]
    return types.SimpleNamespace(
        video_ids=[ids[i] for i in keep],
        rgb_feats=np.stack([rgb[i] for i in keep]),
        flow_feats=np.stack([flow[i] for i in keep]),
        num_proposals=ds.num_proposals,
        span_seconds=ds.span_seconds)
