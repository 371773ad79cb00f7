"""The PyTorch port's model towers and data fixture against the JAX
package's, on the same numpy weights (small widths).

* ``embed_queries_multi`` for last / mean / attn pools, shared and
  per-stream projections: atol 1e-5 through the f32 scan twins; atol 1e-4
  through the kernels (``use_pallas="always"``: the Pallas interpreter vs
  the CUDA kernel's plain version, both with bf16 weights).
* ``embed_moments`` (factored): atol 1e-5 in f32, 1e-3 with bf16 compute
  (bf16-rounded operands of a 24-wide product).
* The synthetic fixture and the DiDeMo dataset arrays: byte-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.config import DataConfig as JDataConfig
from vfr_tpu.config import ExperimentConfig as JExperimentConfig
from vfr_tpu.config import ModelConfig as JModelConfig
from vfr_tpu.data.didemo import DidemoDataset as JDidemoDataset
from vfr_tpu.data.synthetic import make_didemo_fixture as j_fixture
from vfr_tpu.models.build import build_model as j_build_model
from vfr_tpu.models.mcn import embed_moments as j_embed_moments
from vfr_tpu.models.mcn import embed_queries_multi as j_embed_queries_multi
from vfr_tpu.models.mcn import init_model_params as j_init_model_params
from vfr_tpu_torch.bridge import params_from_numpy
from vfr_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
from vfr_tpu_torch.data.didemo import DidemoDataset
from vfr_tpu_torch.data.synthetic import make_didemo_fixture
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.models.mcn import (
    embed_moments,
    embed_queries_multi,
    init_model_params,
)

F, E, H, J = 24, 16, 32, 8


def _cfgs(**model_kw):
    kw = dict(joint_dim=J, lstm_hidden=H, stream_weights=(0.5, 0.5),
              **model_kw)
    data = dict(feature_dim=F, glove_dim=E, use_flow=True)
    return (JExperimentConfig(name="t", data=JDataConfig(**data),
                              model=JModelConfig(**kw)),
            ExperimentConfig(name="t", data=DataConfig(**data),
                             model=ModelConfig(**kw)))


def _setup(seed=0, **model_kw):
    jcfg, tcfg = _cfgs(**model_kw)
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    glove = np.random.default_rng(seed).standard_normal((40, E)).astype(
        np.float32)
    tree = jax.device_get(j_init_model_params(jax.random.PRNGKey(seed),
                                              jmodel, glove, F))
    tree = jax.tree.map(np.asarray, tree)
    if "query_attn" in tree:       # zeros at init: make the pool non-trivial
        tree["query_attn"] = np.random.default_rng(seed + 1).standard_normal(
            H).astype(np.float32)
    return jmodel, tmodel, tree


def _tokens(seed=0, B=6, T=9):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = 1
    toks = rng.integers(1, 40, (B, T)).astype(np.int32)
    toks[np.arange(T)[None, :] >= lengths[:, None]] = 0
    return toks, lengths


@pytest.mark.parametrize("pool,per_stream", [
    ("last", False), ("mean", False), ("attn", False), ("mean", True)])
@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_query_tower_matches_jax(pool, per_stream, use_pallas):
    jmodel, tmodel, tree = _setup(query_pool=pool,
                                  per_stream_query_proj=per_stream,
                                  use_pallas=use_pallas)
    toks, lens = _tokens()
    ref = j_embed_queries_multi(jax.tree.map(jnp.asarray, tree), jmodel,
                                jnp.asarray(toks), jnp.asarray(lens),
                                inference=True)
    got = embed_queries_multi(params_from_numpy(tree), tmodel,
                              torch.from_numpy(toks), torch.from_numpy(lens),
                              inference=True)
    assert got.shape == (2, 6, J)
    tol = 1e-5 if use_pallas == "never" else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5),
                                               ("bfloat16", 1e-3)])
def test_moment_tower_matches_jax(compute_dtype, tol):
    jmodel, tmodel, tree = _setup(compute_dtype=compute_dtype)
    rng = np.random.default_rng(5)
    feats = {s: rng.standard_normal((3, 6, F)).astype(np.float32)
             for s in ("rgb", "flow")}
    ref = j_embed_moments(jax.tree.map(jnp.asarray, tree), jmodel,
                          {s: jnp.asarray(v) for s, v in feats.items()})
    got = embed_moments(params_from_numpy(tree), tmodel,
                        {s: torch.from_numpy(v) for s, v in feats.items()})
    for s in ("rgb", "flow"):
        assert got[s].shape == (3, 21, J)
        np.testing.assert_allclose(got[s].numpy(), np.asarray(ref[s]),
                                   atol=tol)


def test_model_tables_and_cfg_repr_match_jax():
    jmodel, tmodel, _ = _setup(distance="cosine", query_pool="mean")
    assert repr(tmodel.cfg) == repr(jmodel.cfg)
    np.testing.assert_array_equal(tmodel.pool_matrix, jmodel.pool_matrix)
    np.testing.assert_array_equal(tmodel.tef, jmodel.tef)


def test_seeded_params_have_the_jax_tree_structure():
    jmodel, tmodel, tree = _setup(query_pool="attn", per_stream_query_proj=True)
    gen = torch.Generator().manual_seed(0)
    glove = np.zeros((40, E), np.float32)
    params = init_model_params(gen, tmodel, glove, F)
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(tuple(t.shape)), params))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [(p, a.shape) for p, a in flat_t] == \
        [(p, a.shape) for p, a in flat_j]
    again = init_model_params(torch.Generator().manual_seed(0), tmodel,
                              glove, F)
    assert torch.equal(params["lstm"]["layer0"]["w_hh"],
                       again["lstm"]["layer0"]["w_hh"])


def test_gru_not_ported():
    """rnn_cell="gru" seeds the JAX package's GRU tree: the same paths
    (``lstm/layer{l}/{w_ih, w_hh, b_ih, b_hh}``) and shapes."""
    _, tmodel, tree = _setup(rnn_cell="gru", lstm_layers=2)
    params = init_model_params(torch.Generator().manual_seed(0), tmodel,
                               np.zeros((40, E), np.float32), F)
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(tuple(t.shape)), params))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [(p, a.shape) for p, a in flat_t] == \
        [(p, a.shape) for p, a in flat_j]
    assert params["lstm"]["layer1"]["w_hh"].shape == (H, 3 * H)
    assert sorted(params["lstm"]["layer0"]) == ["b_hh", "b_ih", "w_hh",
                                                "w_ih"]


def test_fixture_and_dataset_byte_identical():
    kw = dict(num_videos=9, num_queries=40, feature_dim=F, glove_dim=E,
              seed=11)
    a, b = make_didemo_fixture(**kw), j_fixture(**kw)
    assert a.annotations == b.annotations
    assert a.vocab.itos == b.vocab.itos
    assert a.glove.tobytes() == b.glove.tobytes()
    for store in ("rgb", "flow"):
        sa, sb = getattr(a, store), getattr(b, store)
        assert sorted(sa.ids()) == sorted(sb.ids())
        for v in sb.ids():
            assert sa[v].tobytes() == sb[v].tobytes()
    jcfg, tcfg = _cfgs()
    da = DidemoDataset(a.annotations, a.rgb, a.flow, a.vocab, tcfg.data)
    db = JDidemoDataset(b.annotations, b.rgb, b.flow, b.vocab, jcfg.data)
    assert da.video_ids == db.video_ids
    for name in ("rgb_feats", "flow_feats", "tokens", "lengths", "target",
                 "gt_spans", "gt_prop_idx", "span_seconds"):
        assert getattr(da, name).tobytes() == getattr(db, name).tobytes()


def test_config_copy_matches_jax():
    from vfr_tpu.config import PRESETS as JPRESETS
    from vfr_tpu_torch.config import PRESETS

    assert sorted(PRESETS) == sorted(JPRESETS)
    for name, cfg in PRESETS.items():
        assert repr(cfg) == repr(JPRESETS[name])
        assert cfg.to_json() == JPRESETS[name].to_json()
        assert [f.name for f in dataclasses.fields(cfg.model)] == \
            [f.name for f in dataclasses.fields(JPRESETS[name].model)]
