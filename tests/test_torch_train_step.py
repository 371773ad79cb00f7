"""Optimizer and train step of the PyTorch port against optax and the JAX
package's ``train/step.py``, on the same numpy weights, batches and
gradients (small widths).

* K steps of every optimizer (adam, adamw with its decay mask, sgd with
  momentum) x schedule (constant, cosine, step) x (warmup 2 + a global-
  norm clip that triggers on some steps, or neither) against the JAX
  package's ``make_optimizer`` (optax): params after every step rtol 1e-5
  (atol 1e-7); the frozen GloVe table never moves.  adamw with
  ``freeze_embeddings`` True and False (every leaf decayed), the table
  with and without a gradient, held to optax's the same way.
* ``make_train_step`` (single steps) and ``make_train_multi_step`` (one
  chunk of K steps, query dropout on with the JAX keys' masks, two
  streams) against the JAX package's: params, the Polyak average and
  every metric (``grad_norm`` is pre-clip) at rtol 1e-5.
* ``ema_decay > 0`` without an ema tree raises; without EMA the steps keep
  the three-value return; ``mesh=`` builds the data-parallel step (held to
  the JAX package's in ``test_torch_dp_train.py``), which keeps the same
  arity rules and refuses a batch size that is not a multiple of the
  mesh's "data" axis.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.config import TrainConfig as JTrainConfig
from vfr_tpu.train import optim as joptim
from vfr_tpu.train import step as jstep
from vfr_tpu_torch.bridge import params_from_numpy
from vfr_tpu_torch.config import TrainConfig
from vfr_tpu_torch.train import optim as toptim
from vfr_tpu_torch.train import step as tstep

from torch_eval_world import didemo_world

SHAPES = {"embeddings": (7, 4), "log_tau": (),
          "lstm": {"layer0": {"w_ih": (4, 12), "b": (12,)}},
          "query_proj": {"w": (3, 5), "b": (5,)}}


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


OPT_CASES = [
    dict(optimizer=o, lr_schedule=s, **extra)
    for o in ("adam", "adamw", "sgd")
    for s in ("constant", "cosine", "step")
    for extra in (dict(warmup_steps=2, grad_clip_norm=1.5), {})]


@pytest.mark.parametrize("kw", OPT_CASES,
                         ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_optimizer_steps_match_optax(kw):
    kw = dict(kw, learning_rate=0.05, weight_decay=0.1, lr_decay_steps=2,
              momentum=0.8)
    K, total = 6, 8
    rng = np.random.default_rng(len(str(kw)))
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    # odd steps' global norm is far above the clip, even steps' below it
    grads = [_tree(lambda s: (rng.standard_normal(s) * (3.0 if k % 2
                                                        else 0.01))
                   .astype(np.float32)) for k in range(K)]
    jopt = joptim.make_optimizer(JTrainConfig(**kw), total)
    topt = toptim.make_optimizer(TrainConfig(**kw), total)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_numpy(params)
    ts = topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for g in grads:
        g = dict(g, embeddings=np.zeros_like(g["embeddings"]))  # frozen
        ju, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tg = params_from_numpy(g)
        tg["embeddings"] = None
        tu, ts = topt.update(tg, ts, tp)
        tp = toptim.apply_updates(tp, tu)
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    np.testing.assert_array_equal(tp["embeddings"].numpy(),
                                  params["embeddings"])


@pytest.mark.parametrize("frozen_table", [True, False],
                         ids=["table-no-grad", "table-grad"])
@pytest.mark.parametrize("freeze", [True, False],
                         ids=["freeze", "decay-all"])
def test_adamw_freeze_embeddings_matches_optax(freeze, frozen_table):
    """``make_optimizer(freeze_embeddings=False)``: adamw decays every
    leaf, the GloVe table and log_tau too, as optax's unmasked adamw; a
    table with no gradient (None here, zeros in optax) is then decayed
    alone.  K steps on the same params and gradients, the tolerance of
    ``test_optimizer_steps_match_optax``."""
    kw = dict(optimizer="adamw", learning_rate=0.05, weight_decay=0.1,
              grad_clip_norm=1.5)
    K = 3
    rng = np.random.default_rng(5)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [_tree(lambda s: rng.standard_normal(s).astype(np.float32))
             for _ in range(K)]
    jopt = joptim.make_optimizer(JTrainConfig(**kw), 8,
                                 freeze_embeddings=freeze)
    topt = toptim.make_optimizer(TrainConfig(**kw), 8,
                                 freeze_embeddings=freeze)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_numpy(params)
    ts = topt.init(tp)
    for g in grads:
        tg = params_from_numpy(g)
        if frozen_table:
            g = dict(g, embeddings=np.zeros_like(g["embeddings"]))
            tg["embeddings"] = None
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tu, ts = topt.update(tg, ts, tp)
        tp = toptim.apply_updates(tp, tu)
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    table_still = np.array_equal(tp["embeddings"].numpy(),
                                 params["embeddings"])
    assert table_still == (freeze and frozen_table)


@pytest.mark.parametrize("name", ["constant", "cosine", "step"])
def test_schedule_counts_from_zero_with_warmup(name):
    """optax evaluates the schedule at the count before the step: lr 0
    first under warmup."""
    kw = dict(learning_rate=0.1, lr_schedule=name, warmup_steps=3,
              lr_decay_steps=2)
    jsched = joptim.make_schedule(JTrainConfig(**kw), 12)
    tsched = toptim.make_schedule(TrainConfig(**kw), 12)
    assert tsched(0) == 0.0
    for c in range(14):
        np.testing.assert_allclose(tsched(c), float(jsched(c)), rtol=1e-6)


def _step_world(ema_decay, dropout=0.0):
    world = didemo_world(seed=12, query_dropout=dropout)
    kw = dict(learning_rate=3e-3, optimizer="adamw", weight_decay=0.01,
              grad_clip_norm=2.0, lr_schedule="cosine", warmup_steps=1,
              loss_type="infonce", temperature=0.05, lambda_inter=1.0,
              ema_decay=ema_decay)
    banks = world.jds.feature_banks()
    return (world, JTrainConfig(**kw), TrainConfig(**kw),
            {k: jnp.asarray(v) for k, v in banks.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in banks.items()})


def _batches(world, K, dropout):
    out = list(world.jds.train_batches(8, K, seed=1, with_features=False))
    t_out = []
    for i, b in enumerate(out):
        tb = dict(b)
        if dropout:
            key = jax.random.PRNGKey(100 + i)
            b["dropout_rng"] = np.asarray(key)
            tb["dropout_keep"] = np.asarray(jax.random.bernoulli(
                key, 1.0 - dropout, (8, world.tcfg.model.lstm_hidden)))
        t_out.append(tb)
    return out, t_out


def _close(t, j, what):
    for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(j)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=what)


def _aux_close(taux, jaux):
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("ema_decay", [0.0, 0.9])
def test_train_step_matches_jax(ema_decay):
    world, jt, tt, jbanks, tbanks = _step_world(ema_decay)
    K = 3
    jb, tb = _batches(world, K, 0.0)
    jopt, topt = joptim.make_optimizer(jt, 10), toptim.make_optimizer(tt, 10)
    jp, tp = world.jparams, world.tparams
    js, ts = jopt.init(jp), topt.init(tp)
    je = jax.tree.map(jnp.array, jp) if ema_decay else None
    te = params_from_numpy(world.tree) if ema_decay else None
    jfn = jstep.make_train_step(world.jmodel, jt, jopt, feature_banks=jbanks)
    tfn = tstep.make_train_step(world.tmodel, tt, topt, feature_banks=tbanks)
    for b, c in zip(jb, tb):
        c = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
        if ema_decay:
            jp, js, je, jaux = jfn(jp, js, b, je)
            tp, ts, te, taux = tfn(tp, ts, c, te)
            _close(te, je, "ema")
        else:
            jp, js, jaux = jfn(jp, js, b)
            tp, ts, taux = tfn(tp, ts, c)
        _close(tp, jp, "params")
        _aux_close(taux, jaux)


def test_multi_step_matches_jax():
    dropout = 0.3
    world, jt, tt, jbanks, tbanks = _step_world(0.9, dropout)
    K = 3
    jb, tb = _batches(world, K, dropout)
    jchunk = {k: np.stack([b[k] for b in jb]) for k in jb[0]}
    tchunk = {k: torch.from_numpy(np.stack([b[k] for b in tb]))
              for k in tb[0]}
    jopt, topt = joptim.make_optimizer(jt, 10), toptim.make_optimizer(tt, 10)
    jp, tp = world.jparams, world.tparams
    jfn = jstep.make_train_multi_step(world.jmodel, jt, jopt,
                                      feature_banks=jbanks)
    tfn = tstep.make_train_multi_step(world.tmodel, tt, topt,
                                      feature_banks=tbanks)
    jp, js, je, jaux = jfn(jp, jopt.init(jp), jchunk,
                           jax.tree.map(jnp.array, jp))
    tp, ts, te, taux = tfn(tp, topt.init(tp), tchunk,
                           params_from_numpy(world.tree))
    _close(tp, jp, "params")
    _close(te, je, "ema")
    _aux_close(taux, jaux)
    assert ts["count"] == K


def test_ema_arg_and_arity():
    world, _, tt, _, tbanks = _step_world(0.9)
    opt = toptim.make_optimizer(tt)
    step = tstep.make_train_step(world.tmodel, tt, opt, feature_banks=tbanks)
    multi = tstep.make_train_multi_step(world.tmodel, tt, opt,
                                        feature_banks=tbanks)
    b = next(world.tds.train_batches(8, 1, seed=0, with_features=False))
    b = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    p = world.tparams
    with pytest.raises(ValueError, match="ema"):
        step(p, opt.init(p), b)
    with pytest.raises(ValueError, match="ema"):
        multi(p, opt.init(p), {k: v[None] for k, v in b.items()})
    off = dataclasses.replace(tt, ema_decay=0.0)
    out = tstep.make_train_step(world.tmodel, off, opt,
                                feature_banks=tbanks)(p, opt.init(p), b)
    assert len(out) == 3 and np.isfinite(float(out[2]["loss"]))
    from vfr_tpu_torch.parallel.mesh import make_mesh

    cpu = torch.device("cpu")
    dp = tstep.make_train_step(world.tmodel, tt, opt,
                               mesh=make_mesh(("data",), devices=[cpu] * 2),
                               feature_banks=tbanks)
    with pytest.raises(ValueError, match="ema"):
        dp(p, opt.init(p), b)
    out = dp(p, opt.init(p), b, world.tparams)
    assert len(out) == 4 and np.isfinite(float(out[3]["loss"]))
    odd = make_mesh(("data",), devices=[cpu] * 3)
    for make, batch in ((tstep.make_train_step, b),
                        (tstep.make_train_multi_step,
                         {k: v[None] for k, v in b.items()})):
        fn = make(world.tmodel, tt, opt, mesh=odd, feature_banks=tbanks)
        with pytest.raises(ValueError, match="batch size 8 .* 3 devices"):
            fn(p, opt.init(p), batch, world.tparams)
