"""Training objectives of the PyTorch port against the JAX package's
``train/loss.py`` and ``train/step.py::loss_from_batch``, on the same
numpy inputs (d=8, B=6, P=4; the tower at the eval worlds' widths).

* ``cross_distances`` (all three distances, shared and per-stream
  queries): values atol 1e-5, gradients rtol 1e-4 / atol 1e-6, including
  the tie of ``maximum(d, 0)`` at an exact zero squared distance, whose
  gradient both packages split in half;
* the triplet loss (both ``inter_negatives`` modes, proposal mask, mined
  negatives with invalid slots) and InfoNCE (fixed, learnable and
  scheduled tau, hard-negative share, reverse CE): loss and every aux
  value rtol 1e-6 (atol 1e-6 for values at 0);
* ``loss_from_batch`` through both towers on DiDeMo and Charades-STA, with
  mined rows gathered from the banks (Charades through its ``video_tef``
  bank), a scheduled tau and a query-dropout mask drawn by
  ``jax.random.bernoulli`` from the JAX key and handed to both sides: loss
  and aux rtol 1e-5, every parameter gradient rtol 2e-4 / atol 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.config import ModelConfig as JModelConfig
from vfr_tpu.config import TrainConfig as JTrainConfig
from vfr_tpu.models.mcn import Model as JModel
from vfr_tpu.models.mcn import cross_distances as j_cross
from vfr_tpu.train import loss as jloss
from vfr_tpu.train.step import loss_from_batch as j_loss_from_batch
from vfr_tpu_torch.config import ModelConfig, TrainConfig
from vfr_tpu_torch.models.mcn import Model
from vfr_tpu_torch.models.mcn import cross_distances as t_cross
from vfr_tpu_torch.train import loss as tloss
from vfr_tpu_torch.train.step import loss_from_batch as t_loss_from_batch

from torch_eval_world import charades_world, didemo_world

B, P, D = 6, 4, 8
VIDEO_IDX = np.array([0, 1, 1, 2, 3, 3], np.int32)
TARGET = np.array([0, 2, 1, 3, 0, 1], np.int32)


def _models(streams=("rgb",), **kw):
    w = tuple(1.0 / len(streams) for _ in streams)
    pool = np.eye(P, 2, dtype=np.float32)          # unused by the losses
    return (JModel(cfg=JModelConfig(stream_weights=w, **kw),
                   streams=streams, pool_matrix=pool, tef=None),
            Model(cfg=ModelConfig(stream_weights=w, **kw),
                  streams=streams, pool_matrix=pool, tef=None))


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("distance", ["sqeuclidean", "euclidean", "cosine"])
@pytest.mark.parametrize("per_stream", [False, True])
def test_cross_distances_match_jax(distance, per_stream):
    streams = ("rgb", "flow") if per_stream else ("rgb",)
    jm, tm = _models(streams, distance=distance)
    rng = np.random.default_rng(1)
    S = len(streams)
    q = rng.standard_normal((S, 5, D) if per_stream else (5, D)).astype(
        np.float32)
    moms = {s: rng.standard_normal((3, P, D)).astype(np.float32)
            for s in streams}
    if distance == "sqeuclidean":
        # an exact zero distance (query 0 is moment (0, 0), small
        # integers): the floor's tie; under the euclidean sqrt its
        # gradient is 1 / (2e-6) and cancels to noise in either package
        row = np.zeros(D, np.float32)
        row[0] = 1.0
        for s in streams:
            moms[s][0, 0] = row
        if per_stream:
            q[:, 0] = row
        else:
            q[0] = row
    wj = rng.standard_normal((5, 3, P)).astype(np.float32)

    def jf(q, m):
        d = j_cross(jm, q, m)
        return jnp.sum(d * wj), d

    (_, jd), (jgq, jgm) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(q), {s: jnp.asarray(v) for s, v in moms.items()})
    tq = _t(q).requires_grad_(True)
    tmom = {s: _t(v).requires_grad_(True) for s, v in moms.items()}
    td = t_cross(tm, tq, tmom)
    (td * _t(wj)).sum().backward()
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd),
                               atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq),
                               rtol=1e-4, atol=1e-6)
    for s in streams:
        np.testing.assert_allclose(tmom[s].grad.numpy(),
                                   np.asarray(jgm[s]), rtol=1e-4, atol=1e-6)


CASES = {
    "triplet_same_span": dict(loss_type="triplet"),
    "triplet_all_spans_mask_hard": dict(
        loss_type="triplet", inter_negatives="all_spans", lambda_hard=0.3,
        _mask=True, _hard=True),
    "triplet_same_span_mask": dict(loss_type="triplet", _mask=True),
    "infonce": dict(loss_type="infonce", temperature=0.1,
                    lambda_inter=0.7),
    "infonce_mask_hard": dict(loss_type="infonce", temperature=0.05,
                              lambda_inter=1.0, _mask=True, _hard=True),
    "infonce_learned_tau": dict(loss_type="infonce", _log_tau=np.log(0.08)),
    "infonce_tau_clamped": dict(loss_type="infonce", _log_tau=np.log(1e-3)),
    "infonce_reverse": dict(loss_type="infonce", temperature=0.1,
                            lambda_inter_rev=0.5, _hard=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("distance", ["sqeuclidean", "cosine"])
def test_loss_and_aux_match_jax(case, distance):
    kw = dict(CASES[case])
    mask, hard = kw.pop("_mask", False), kw.pop("_hard", False)
    log_tau = kw.pop("_log_tau", None)
    streams = ("rgb", "flow")
    jm, tm = _models(streams, distance=distance)
    rng = np.random.default_rng(hash(case) % 1000)
    q = rng.standard_normal((B, D)).astype(np.float32)
    moms = {s: rng.standard_normal((B, P, D)).astype(np.float32)
            for s in streams}
    args = dict(target=TARGET, video_idx=VIDEO_IDX)
    if mask:
        pm = rng.random((B, P)) < 0.7
        pm[np.arange(B), TARGET] = True
        args["proposal_mask"] = pm
    if hard:
        args["hard_moments"] = {s: rng.standard_normal((B, 3, D)).astype(
            np.float32) for s in streams}
        hv = rng.random((B, 3)) < 0.7
        hv[:, 0] = True
        args["hard_valid"] = hv
    jargs = jax.tree.map(jnp.asarray, args)
    targs = {k: ({s: _t(x) for s, x in v.items()} if isinstance(v, dict)
                 else _t(v)) for k, v in args.items()}
    lt = None if log_tau is None else np.float32(log_tau)
    jl, jaux = jloss.compute_loss(
        jm, JTrainConfig(**kw), jnp.asarray(q),
        {s: jnp.asarray(v) for s, v in moms.items()},
        log_tau=None if lt is None else jnp.asarray(lt), **jargs)
    tl, taux = tloss.compute_loss(
        tm, TrainConfig(**kw), _t(q), {s: _t(v) for s, v in moms.items()},
        log_tau=None if lt is None else _t(lt), **targs)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _batch_parity(world, tcfg_kw, use_dropout, tau_now):
    """loss_from_batch on both sides: (jax loss, aux, grads), (port ...)."""
    kw = dict(loss_type="infonce", temperature=0.05, lambda_inter=1.0,
              inter_negatives="all_spans", **tcfg_kw)
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    ds = world.jds
    b = next(ds.train_batches(8, 1, seed=4, with_features=False))
    rng = np.random.default_rng(5)
    Hn = 3
    hv = rng.integers(0, len(ds.video_ids), (8, Hn)).astype(np.int32)
    hp = rng.integers(0, ds.num_proposals, (8, Hn)).astype(np.int32)
    hv[0, 2] = hp[0, 2] = -1                     # an unfilled mined slot
    b.update(hard_neg_video=hv, hard_neg_prop=hp)
    if tau_now:
        b["tau_now"] = np.float32(0.07)
    banks = dict(ds.feature_banks())
    if hasattr(ds, "video_tef"):
        banks["video_tef"] = ds.video_tef
    rate = world.jcfg.model.query_dropout
    key = jax.random.PRNGKey(3)
    keep = np.asarray(jax.random.bernoulli(
        key, 1.0 - rate, (8, world.jcfg.model.lstm_hidden)))

    def jf(p):
        return j_loss_from_batch(p, world.jmodel, jt,
                                 jax.tree.map(jnp.asarray, b),
                                 dropout_rng=key if use_dropout else None,
                                 feature_banks=jax.tree.map(jnp.asarray,
                                                            banks))

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        world.jparams)
    params = world.tparams

    def req(d):
        for k, v in d.items():
            if isinstance(v, dict):
                req(v)
            elif k != "embeddings":
                v.requires_grad_(True)
    req(params)
    tb = {k: _t(v) for k, v in b.items()}
    tl, taux = t_loss_from_batch(
        params, world.tmodel, tt, tb,
        dropout_keep=_t(keep) if use_dropout else None,
        feature_banks={k: _t(v) for k, v in banks.items()})
    tl.backward()
    return (jl, jaux, jg), (tl, taux, params)


@pytest.mark.parametrize("name,use_dropout,tau_now", [
    ("didemo", True, True), ("didemo", False, False),
    ("charades", False, True)])
def test_loss_from_batch_matches_jax(name, use_dropout, tau_now):
    world = (didemo_world(query_dropout=0.3) if name == "didemo"
             else charades_world())
    (jl, jaux, jg), (tl, taux, params) = _batch_parity(
        world, dict(lambda_intra=1.0), use_dropout, tau_now)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)

    def walk(t, j, path=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, j[k], f"{path}{k}/")
            elif k == "embeddings":
                assert v.grad is None          # frozen: no gradient
                np.testing.assert_array_equal(np.asarray(j[k]), 0.0)
            else:
                np.testing.assert_allclose(v.grad.numpy(), np.asarray(j[k]),
                                           rtol=2e-4, atol=2e-5,
                                           err_msg=path + k)
    walk(params, jg)


def test_dropout_changes_training_output_only():
    """The keep mask applies in training; inference ignores it."""
    from vfr_tpu_torch.models.mcn import embed_queries_multi

    world = didemo_world(query_dropout=0.5)
    b = next(world.tds.eval_batches(8, with_features=False))
    toks, lens = _t(b["tokens"]), _t(b["lengths"])
    keep = torch.from_numpy(np.random.default_rng(0).random(
        (8, world.tcfg.model.lstm_hidden)) < 0.5)
    p = world.tparams
    base = embed_queries_multi(p, world.tmodel, toks, lens)
    drop = embed_queries_multi(p, world.tmodel, toks, lens,
                               dropout_keep=keep)
    inf = embed_queries_multi(p, world.tmodel, toks, lens, inference=True,
                              rnn_kernel="scan", dropout_keep=keep)
    assert not torch.allclose(base, drop)
    torch.testing.assert_close(inf, base, rtol=1e-5, atol=1e-6)
    off = world.tmodel._replace(cfg=dataclasses.replace(
        world.tmodel.cfg, query_dropout=0.0))
    torch.testing.assert_close(
        embed_queries_multi(p, off, toks, lens, dropout_keep=keep), base)
