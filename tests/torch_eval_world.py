"""Shared small worlds for the eval parity tests of the PyTorch port: one
DiDeMo and one Charades-STA corpus built by both packages from the same
synthetic fixture, each with the same seeded weights on both sides (JAX
init, carried across as numpy), at the JAX tests' widths."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vfr_tpu.config import DataConfig as JDataConfig
from vfr_tpu.config import EvalConfig as JEvalConfig
from vfr_tpu.config import ExperimentConfig as JExperimentConfig
from vfr_tpu.config import ModelConfig as JModelConfig
from vfr_tpu.data.charades import CharadesSTADataset as JCharades
from vfr_tpu.data.didemo import DidemoDataset as JDidemo
from vfr_tpu.data.synthetic import make_charades_fixture as j_charades_fix
from vfr_tpu.data.synthetic import make_didemo_fixture as j_didemo_fix
from vfr_tpu.models.build import build_model as j_build_model
from vfr_tpu.models.mcn import init_model_params as j_init_model_params
from vfr_tpu_torch.bridge import params_from_numpy
from vfr_tpu_torch.config import DataConfig, EvalConfig, ExperimentConfig
from vfr_tpu_torch.config import ModelConfig
from vfr_tpu_torch.data.charades import CharadesSTADataset
from vfr_tpu_torch.data.didemo import DidemoDataset
from vfr_tpu_torch.models.build import build_model

F, E, H, J = 32, 16, 24, 24

# 48 queries in batches of 20: the last batch is padded (``valid``)
EVAL = dict(eval_batch_size=20, corpus_query_batch=20, corpus_topk=10)


@dataclasses.dataclass
class World:
    jcfg: object
    tcfg: object
    jds: object
    tds: object
    jmodel: object
    tmodel: object
    tree: dict          # numpy params (JAX init)
    vocab: object

    @property
    def jparams(self):
        return jax.tree.map(jnp.asarray, self.tree)

    @property
    def tparams(self):
        return params_from_numpy(self.tree)

    def ecfgs(self, **kw):
        """(JAX EvalConfig, port EvalConfig) with the same fields."""
        kw = {**EVAL, **kw}
        return JEvalConfig(**kw), EvalConfig(**kw)

    def with_model(self, **kw):
        """The same world with ModelConfig fields replaced on both sides."""
        jcfg = dataclasses.replace(self.jcfg, model=dataclasses.replace(
            self.jcfg.model, **kw))
        tcfg = dataclasses.replace(self.tcfg, model=dataclasses.replace(
            self.tcfg.model, **kw))
        return dataclasses.replace(
            self, jcfg=jcfg, tcfg=tcfg,
            jmodel=j_build_model(jcfg, dataset=self.jds),
            tmodel=build_model(tcfg, dataset=self.tds))


def _make(data, model, fixture, jds_cls, tds_cls, seed, with_flow):
    jcfg = JExperimentConfig(name="t", data=JDataConfig(**data),
                             model=JModelConfig(**model))
    tcfg = ExperimentConfig(name="t", data=DataConfig(**data),
                            model=ModelConfig(**model))
    flow = fixture.flow if with_flow else None
    jds = jds_cls(fixture.annotations, fixture.rgb, flow, fixture.vocab,
                  jcfg.data)
    tds = tds_cls(fixture.annotations, fixture.rgb, flow, fixture.vocab,
                  tcfg.data)
    jmodel = j_build_model(jcfg, dataset=jds)
    tmodel = build_model(tcfg, dataset=tds)
    tree = jax.tree.map(np.asarray, jax.device_get(j_init_model_params(
        jax.random.PRNGKey(seed), jmodel, fixture.glove, F)))
    return World(jcfg, tcfg, jds, tds, jmodel, tmodel, tree, fixture.vocab)


def didemo_world(seed=10, num_videos=12, num_queries=48, **model_kw):
    """Two streams, cosine, mean query pool (the flagship's shape)."""
    fix = j_didemo_fix(num_videos=num_videos, num_queries=num_queries,
                       feature_dim=F, glove_dim=E, seed=seed)
    model = dict(joint_dim=J, lstm_hidden=H, stream_weights=(0.5, 0.5),
                 distance="cosine", query_pool="mean", **model_kw)
    data = dict(feature_dim=F, glove_dim=E, use_flow=True)
    return _make(data, model, fix, JDidemo, DidemoDataset, seed, True)


def charades_world(seed=21, num_videos=12, num_queries=48, **model_kw):
    """One stream, cosine, last query pool (charades_flagship's shape)."""
    fix = j_charades_fix(num_videos=num_videos, num_queries=num_queries,
                         feature_dim=F, glove_dim=E, moments_per_video=2,
                         seed=seed)
    model = dict(joint_dim=J, lstm_hidden=H, stream_weights=(1.0,),
                 distance="cosine", **model_kw)
    data = dict(dataset="charades_sta", feature_dim=F, glove_dim=E,
                use_flow=False, max_windows=64)
    return _make(data, model, fix, JCharades, CharadesSTADataset, seed,
                 False)


def min_gap(values: np.ndarray, ks=None) -> float:
    """Smallest gap between neighbours of the rows of ``values`` [Q, N]
    sorted ascending (infinite values ignored): between positions k-1 and k
    for each k of ``ks`` (the top-k boundaries), or between any neighbours.
    Values that move by less than half the any-neighbour gap keep their
    order."""
    out = np.inf
    for row in values:
        v = np.sort(row[np.isfinite(row)])
        gaps = np.diff(v)
        if ks is not None:
            gaps = gaps[[k - 1 for k in ks if k < len(v)]]
        if len(gaps):
            out = min(out, float(gaps.min()))
    return out
