"""Data-parallel training of the PyTorch port (``train/step.py``,
``train/loop.py`` with ``mesh=``) against the JAX package's DP paths.

The port's mesh is ``[cpu] * n`` over a "data" axis; the JAX package's is
``devices8[:n]`` (``tests/conftest.py``).  Inputs are drawn from a seed
with numpy, the weights cross through ``bridge`` (the eval worlds' small
widths), B=16, K=3.

* ``make_train_multi_step(mesh=)`` for n in {2, 4, 8}: triplet; InfoNCE
  with mined negatives and query dropout (an explicit ``dropout_keep``
  drawn by ``jax.random.bernoulli`` from the JAX keys); a Charades-STA
  batch (``window_mask``, ``tef``, mined negatives through the
  ``video_tef`` bank); EMA with adamw, clipping and a learned temperature.
  Params, the Polyak average and every metric agree with the JAX
  package's DP multi-step at rtol 1e-4, atol 1e-5 (its own DP standard,
  ``tests/test_multi_step.py``, ``tests/test_ema.py``), and with the
  port's single-device multi-step at the same tolerance.  A scheduled
  ``tau_now`` case is held to the JAX package's single-device step: its DP
  step refuses the per-step tau (its input sharding gives the scalar
  ``P("data")``), the port's takes it.
* ``make_train_step(mesh=)`` against the JAX package's DP single step
  (triplet at n = 2, EMA at n = 4, Charades-STA at n = 8), step by step.
* After every call, every mesh position's replica equals the lead's params
  bit for bit.
* ``train(cfg, mesh=)`` at n = 4 for the flagship recipe (InfoNCE, cosine,
  mined from epoch 1, EMA 0.99) against the JAX package's ``train(mesh=)``
  (the standard of ``test_torch_train_loop.py``'s loop test: equal metric
  dicts and mined pairs, losses rtol 1e-4, the EMA tree rtol 1e-4, atol
  1e-6) and against the port's single-device run (metrics 1e-3; chunk
  losses rtol 1e-3, atol 1e-4: ``tests/test_loop_cli.py``'s standard).
* A DP run stopped after one epoch and resumed ends bit-identical to the
  uninterrupted DP run.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.config import TrainConfig as JTrainConfig
from vfr_tpu.config import get_preset as j_get_preset
from vfr_tpu.parallel.mesh import make_mesh as j_make_mesh
from vfr_tpu.train import loop as jloop
from vfr_tpu.train import optim as joptim
from vfr_tpu.train import step as jstep
from vfr_tpu_torch.bridge import params_from_numpy
from vfr_tpu_torch.config import TrainConfig, get_preset
from vfr_tpu_torch.parallel.mesh import make_mesh
from vfr_tpu_torch.train import checkpoint as tckpt
from vfr_tpu_torch.train import loop as tloop
from vfr_tpu_torch.train import optim as toptim
from vfr_tpu_torch.train import step as tstep
from vfr_tpu_torch.utils.tree import flatten

from test_torch_train_loop import (
    _cfg,
    _ckpt_tree,
    _jax_init,
    _records,
    _trees_equal,
)
from torch_eval_world import charades_world, didemo_world

B, K, HN = 16, 3, 4
RTOL, ATOL = 1e-4, 1e-5

CASES = {
    "triplet": dict(world="didemo", train=dict(loss_type="triplet")),
    "infonce_mined_dropout": dict(world="didemo", dropout=0.3, mined=True,
                                  train=dict(loss_type="infonce",
                                             temperature=0.05)),
    "charades": dict(world="charades", mined=True,
                     train=dict(loss_type="infonce", temperature=0.05)),
    "ema": dict(world="didemo", mined=True, learn_tau=True,
                train=dict(loss_type="infonce", temperature=0.05,
                           learn_temperature=True, optimizer="adamw",
                           weight_decay=0.01, grad_clip_norm=2.0,
                           lr_schedule="cosine", warmup_steps=1,
                           ema_decay=0.9)),
    "tau_now": dict(world="didemo", dropout=0.3, mined=True, tau=True,
                    train=dict(loss_type="infonce", temperature=0.05)),
}


@functools.lru_cache(maxsize=None)
def _setup(case):
    """(world, JAX TrainConfig, port TrainConfig, JAX banks, port banks,
    JAX chunk, port chunk (numpy), numpy params) of a case."""
    spec = CASES[case]
    kw = dict(spec.get("model", {}))
    if spec.get("dropout"):
        kw["query_dropout"] = spec["dropout"]
    world = (didemo_world(seed=12, **kw) if spec["world"] == "didemo"
             else charades_world(seed=21, **kw))
    train = dict(learning_rate=3e-3, lambda_inter=1.0, **spec["train"])
    banks = dict(world.jds.feature_banks())
    if hasattr(world.jds, "video_tef"):
        banks["video_tef"] = world.jds.video_tef
    rng = np.random.default_rng(len(case))
    V, P = len(world.jds.video_ids), world.jds.num_proposals
    jb, tb = [], []
    for i, b in enumerate(world.jds.train_batches(B, K, seed=1,
                                                  with_features=False)):
        if spec.get("mined"):
            b["hard_neg_video"] = np.where(
                rng.random((B, HN)) < 0.2, -1,
                rng.integers(0, V, (B, HN))).astype(np.int32)
            b["hard_neg_prop"] = rng.integers(0, P, (B, HN)).astype(np.int32)
        if spec.get("tau"):
            b["tau_now"] = np.float32(0.05 - 0.01 * i)
        t = dict(b)
        if spec.get("dropout"):
            key = jax.random.PRNGKey(100 + i)
            b["dropout_rng"] = np.asarray(key)
            t["dropout_keep"] = np.asarray(jax.random.bernoulli(
                key, 1.0 - spec["dropout"],
                (B, world.tcfg.model.lstm_hidden)))
        jb.append(b)
        tb.append(t)
    tree = dict(world.tree)
    if spec.get("learn_tau"):
        tree["log_tau"] = np.asarray(np.log(0.05), np.float32)
    return (world, JTrainConfig(**train), TrainConfig(**train),
            {k: jnp.asarray(v) for k, v in banks.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in banks.items()},
            {k: np.stack([b[k] for b in jb]) for k in jb[0]},
            {k: np.stack([b[k] for b in tb]) for k in tb[0]}, tree)


@functools.lru_cache(maxsize=None)
def _jax_single(case):
    """The JAX package's single-device multi-step outcome of a case."""
    return _jax_multi(case, None)


def _jax_multi(case, n):
    world, jt, _, jbanks, _, jchunk, _, tree = _setup(case)
    mesh = None if n is None else j_make_mesh(
        ("data",), devices=jax.devices("cpu")[:n])
    opt = joptim.make_optimizer(jt, 10)
    fn = jstep.make_train_multi_step(world.jmodel, jt, opt, mesh=mesh,
                                     feature_banks=jbanks)
    p = jax.tree.map(jnp.asarray, tree)
    args = (p, opt.init(p), jchunk)
    if jt.ema_decay:
        p, _, e, aux = fn(*args, jax.tree.map(jnp.array, p))
    else:
        (p, _, aux), e = fn(*args), None
    return p, e, aux


def _torch_multi(case, mesh):
    world, _, tt, _, tbanks, _, tchunk, tree = _setup(case)
    opt = toptim.make_optimizer(tt, 10)
    fn = tstep.make_train_multi_step(world.tmodel, tt, opt, mesh=mesh,
                                     feature_banks=tbanks)
    p = params_from_numpy(tree)
    chunk = {k: torch.from_numpy(v) for k, v in tchunk.items()}
    if tt.ema_decay:
        p, s, e, aux = fn(p, opt.init(p), chunk, params_from_numpy(tree))
    else:
        (p, s, aux), e = fn(p, opt.init(p), chunk), None
    assert s["count"] == K
    return p, e, aux, fn


def _close(t, j, what, rtol=RTOL, atol=ATOL):
    """Leaves of a port tree against a JAX (or port) tree, in sorted-key
    order."""
    pt, lt = flatten(t)
    lj = jax.tree.leaves(j)
    assert len(lt) == len(lj)
    for path, a, b in zip(pt, lt, lj):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {path}")


def _aux_close(t, j, what):
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {k}")


def _replicas_equal_lead(fn, params, n):
    reps = fn.replicas()
    assert len(reps) == n
    _, lead = flatten(params)
    ids = set()
    for rep in reps:
        paths, leaves = flatten(rep)
        for p, a, b in zip(paths, leaves, lead):
            assert torch.equal(a, b), p
            if p != ("embeddings",):
                ids.add(a.data_ptr())
    # one distinct copy of every trainable leaf per position
    assert len(ids) == n * (len(lead) - 1)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_dp_multi_step_matches_jax_and_one_device(case, n):
    mesh = make_mesh(("data",), devices=[torch.device("cpu")] * n)
    tp, te, taux, fn = _torch_multi(case, mesh)
    _replicas_equal_lead(fn, tp, n)
    # the JAX package's DP step refuses a per-step tau: hold that case to
    # its single-device step, the function its DP step computes
    jp, je, jaux = (_jax_single(case) if CASES[case].get("tau")
                    else _jax_multi(case, n))
    _close(tp, jp, "params vs jax")
    _aux_close(taux, jaux, "aux vs jax")
    sp, se, saux, _ = _torch_multi(case, None)
    _close(tp, sp, "params vs one device")
    _aux_close(taux, saux, "aux vs one device")
    if te is not None:
        _close(te, je, "ema vs jax")
        _close(te, se, "ema vs one device")


@pytest.mark.parametrize("n,case", [(2, "triplet"), (4, "ema"),
                                    (8, "charades")])
def test_dp_train_step_matches_jax(n, case):
    world, jt, tt, jbanks, tbanks, jchunk, tchunk, tree = _setup(case)
    jmesh = j_make_mesh(("data",), devices=jax.devices("cpu")[:n])
    mesh = make_mesh(("data",), devices=[torch.device("cpu")] * n)
    jopt, topt = joptim.make_optimizer(jt, 10), toptim.make_optimizer(tt, 10)
    jfn = jstep.make_train_step(world.jmodel, jt, jopt, mesh=jmesh,
                                feature_banks=jbanks)
    tfn = tstep.make_train_step(world.tmodel, tt, topt, mesh=mesh,
                                feature_banks=tbanks)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp = params_from_numpy(tree)
    ts = topt.init(tp)
    ema = tt.ema_decay > 0
    je = jax.tree.map(jnp.array, jp) if ema else None
    te = params_from_numpy(tree) if ema else None
    for k in range(K):
        jb = {key: v[k] for key, v in jchunk.items()}
        tb = {key: torch.from_numpy(v[k]) for key, v in tchunk.items()}
        if ema:
            jp, js, je, jaux = jfn(jp, js, jb, je)
            tp, ts, te, taux = tfn(tp, ts, tb, te)
            _close(te, je, f"ema step {k}")
        else:
            jp, js, jaux = jfn(jp, js, jb)
            tp, ts, taux = tfn(tp, ts, tb)
        _close(tp, jp, f"params step {k}")
        _aux_close(taux, jaux, f"aux step {k}")
        _replicas_equal_lead(tfn, tp, n)


def _loop_cfg(tmp_path, name, **kw):
    base = dict(ema_decay=0.99, hard_negative_start_epoch=1)
    base.update(kw)
    return (_cfg(j_get_preset, tmp_path / name / "j", **base),
            _cfg(get_preset, tmp_path / name / "t", **base))


def test_dp_loop_matches_jax_and_one_device(monkeypatch, tmp_path, devices8):
    from vfr_tpu.data.loaders import load_datasets as j_load
    from vfr_tpu.models.build import build_model as j_build

    n = 4
    jcfg, tcfg = _loop_cfg(tmp_path, "dp")
    _, single = _loop_cfg(tmp_path, "one")
    jbundle = j_load(jcfg.data)
    holder = {"jmodel": j_build(jcfg, dataset=jbundle.train),
              "jtcfg": jcfg.train}
    _jax_init(monkeypatch, holder)
    mined = {}
    import vfr_tpu.train.hard_negatives as jhn
    j_mine, t_mine = jhn.mine_hard_negatives, tloop.mine_hard_negatives

    def spy(name, fn):
        def run(*a, **k):
            mined.setdefault(name, []).append((fn(*a, **k), k.get("mesh")))
            return mined[name][-1][0]
        return run
    monkeypatch.setattr(jhn, "mine_hard_negatives", spy("jax", j_mine))
    monkeypatch.setattr(tloop, "mine_hard_negatives", spy("torch", t_mine))

    jema, jmetrics = jloop.train(jcfg, bundle=jbundle, mesh=j_make_mesh(
        ("data",), devices=devices8[:n]))
    mesh = make_mesh(("data",), devices=[torch.device("cpu")] * n)
    tema, tmetrics = tloop.train(tcfg, mesh=mesh)
    sema, smetrics = tloop.train(single, device="cpu")
    assert tmetrics == jmetrics
    assert mined["torch"][0][1] is mesh
    for (a, _), (b, _) in zip(mined["torch"], mined["jax"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(flatten(tema)[1], jax.tree.leaves(jema)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-6)
    root = tmp_path / "dp"
    jl = _records(root / "j" / "ck" / "metrics.jsonl", "train")
    tl = _records(root / "t" / "ck" / "metrics.jsonl", "train")
    sl = _records(tmp_path / "one" / "t" / "ck" / "metrics.jsonl", "train")
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == \
        [r["step"] for r in sl]
    for a, b, c in zip(tl, jl, sl):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["loss"], c["loss"], rtol=1e-3,
                                   atol=1e-4)
    assert sorted(tmetrics) == sorted(smetrics)
    for k in smetrics:
        assert abs(tmetrics[k] - smetrics[k]) <= 1e-3, k
    # bank_mb counts the bytes placed: the train banks once per distinct
    # device of the mesh (one here), as on one device
    tb = _records(root / "t" / "ck" / "metrics.jsonl", "setup")
    sb = _records(tmp_path / "one" / "t" / "ck" / "metrics.jsonl", "setup")
    assert tb[0]["bank_mb"] == sb[0]["bank_mb"] > 0


def test_dp_resume_after_an_epoch_is_bit_identical(tmp_path):
    mesh = make_mesh(("data",), devices=[torch.device("cpu")] * 4)
    base = _cfg(get_preset, tmp_path / "a", epochs=3)
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, query_dropout=0.2))
    tloop.train(cfg, mesh=mesh)
    full = tckpt.latest_checkpoint(cfg.train.checkpoint_dir)
    cut = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "b")))
    tloop.train(dataclasses.replace(cut, train=dataclasses.replace(
        cut.train, num_epochs=1)), mesh=mesh)
    tloop.train(cut, resume=True, mesh=mesh)
    resumed = tckpt.latest_checkpoint(cut.train.checkpoint_dir)
    assert os.path.basename(resumed) == os.path.basename(full)
    for root in ("params", "ema", "opt_state"):
        _trees_equal(_ckpt_tree(resumed, root), _ckpt_tree(full, root))
    assert _records(os.path.join(cut.train.checkpoint_dir,
                                 "metrics.jsonl"), "resume")
