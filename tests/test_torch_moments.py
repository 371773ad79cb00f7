"""The PyTorch port's moment tower and per-proposal distances against the
JAX package's, on the same numpy weights (F=32, H=24, joint 24).

* ``embed_moments`` in the direct and factored forms and with
  ``pooling="max"``, with the static [P, C] pooling matrix and a per-video
  [B, P, C] one, on DiDeMo (static TEF) and Charades-STA (per-video TEF,
  padded bank windows that cover no row): atol 1e-5 in f32.
* ``_segment_max``: a span with no rows pools to 0, and the chunked max
  equals the unchunked one exactly.
* ``fused_distances`` for sqeuclidean, euclidean and cosine: atol 1e-5.
* ``build_model``'s Charades branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.models.mcn import embed_moments as j_embed_moments
from vfr_tpu.models.mcn import fused_distances as j_fused_distances
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.models.mcn import (
    _segment_max,
    embed_moments,
    fused_distances,
)

from torch_eval_world import F, charades_world, didemo_world

B = 5


@pytest.fixture(scope="module")
def worlds():
    return {"didemo": didemo_world(), "charades": charades_world()}


def _inputs(world, seed=0):
    """Per-stream features [B, C, F] (+ per-video TEF for Charades) as numpy."""
    rng = np.random.default_rng(seed)
    C = world.tmodel.pool_matrix.shape[1]
    feats = {s: rng.standard_normal((B, C, F)).astype(np.float32)
             for s in world.tmodel.streams}
    tef = (world.tds.video_tef[:B] if world.tmodel.tef is None else None)
    return feats, tef


def _per_video_pool(world, seed=1):
    """[B, P, C]: the static matrix with a random subset of spans emptied
    per video (the padded-window case) and the rest kept."""
    pm = np.broadcast_to(world.tmodel.pool_matrix,
                         (B, *world.tmodel.pool_matrix.shape)).copy()
    keep = np.random.default_rng(seed).random(pm.shape[:2]) > 0.3
    return (pm * keep[..., None]).astype(np.float32)


def _both(world, feats, tef, **kw):
    tkw = {k: (torch.from_numpy(v) if k == "context_mask" else v)
           for k, v in kw.items()}
    got = embed_moments(world.tparams, world.tmodel,
                        {s: torch.from_numpy(v) for s, v in feats.items()},
                        tef=tef, **tkw)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref = j_embed_moments(world.jparams, world.jmodel,
                          {s: jnp.asarray(v) for s, v in feats.items()},
                          tef=None if tef is None else jnp.asarray(tef),
                          **jkw)
    return got, ref


@pytest.mark.parametrize("name", ["didemo", "charades"])
@pytest.mark.parametrize("pooling,impl,per_video", [
    ("mean", "direct", False), ("mean", "direct", True),
    ("mean", "factored", True), ("max", None, False), ("max", None, True)])
def test_embed_moments_matches_jax(worlds, name, pooling, impl, per_video):
    world = worlds[name].with_model(pooling=pooling)
    feats, tef = _inputs(world)
    kw = {}
    if impl is not None:
        kw["impl"] = impl
    if per_video:
        kw["pool_matrix"] = _per_video_pool(world)
    got, ref = _both(world, feats, tef, **kw)
    for s in world.tmodel.streams:
        assert got[s].shape == ref[s].shape
        np.testing.assert_allclose(got[s].numpy(), np.asarray(ref[s]),
                                   atol=1e-5, err_msg=s)


@pytest.mark.parametrize("name", ["didemo", "charades"])
def test_direct_equals_factored(worlds, name):
    world = worlds[name]
    feats, tef = _inputs(world, seed=3)
    t = {s: torch.from_numpy(v) for s, v in feats.items()}
    mask = torch.from_numpy(
        np.random.default_rng(4).random((B, world.tmodel.pool_matrix.shape[1]))
        > 0.2)
    for kw in ({}, {"context_mask": mask}):
        a = embed_moments(world.tparams, world.tmodel, t, tef=tef,
                          impl="direct", **kw)
        b = embed_moments(world.tparams, world.tmodel, t, tef=tef,
                          impl="factored", **kw)
        for s in world.tmodel.streams:
            np.testing.assert_allclose(a[s].numpy(), b[s].numpy(), atol=1e-5)


def test_context_mask_matches_jax(worlds):
    world = worlds["didemo"].with_model(moment_impl="direct")
    feats, tef = _inputs(world, seed=5)
    mask = np.random.default_rng(6).random((B, 6)) > 0.3
    got, ref = _both(world, feats, tef, context_mask=mask)
    for s in world.tmodel.streams:
        np.testing.assert_allclose(got[s].numpy(), np.asarray(ref[s]),
                                   atol=1e-5)


@pytest.mark.parametrize("per_video", [False, True])
def test_segment_max_empty_spans_and_chunks(worlds, per_video):
    """Charades bank rows past the real windows cover no feature row: they
    pool to 0.  Every chunking gives the unchunked maxima bit for bit."""
    world = worlds["charades"]
    feats, _ = _inputs(world, seed=7)
    f = torch.from_numpy(feats["rgb"]) - 10.0       # all-negative rows
    pm = torch.from_numpy(_per_video_pool(world) if per_video
                          else world.tmodel.pool_matrix)
    P = pm.shape[-2]
    full = _segment_max(pm, f, chunk=P)
    empty = ~(pm > 0).any(-1)
    if not per_video:
        empty = empty[None].expand(B, P)
    assert empty.any()
    assert (full[empty] == 0).all()
    assert (full[~empty] < 0).all()
    for chunk in (1, 3, 7, P + 5, None):
        assert torch.equal(_segment_max(pm, f, chunk=chunk), full), chunk


def test_segment_max_default_chunk_bounds_memory(worlds, monkeypatch):
    from vfr_tpu_torch.models import mcn

    world = worlds["charades"]
    feats, _ = _inputs(world, seed=8)
    f = torch.from_numpy(feats["rgb"])
    pm = torch.from_numpy(world.tmodel.pool_matrix)
    full = _segment_max(pm, f, chunk=pm.shape[0])
    # a budget of two proposals' masked blocks
    monkeypatch.setattr(mcn, "SEGMENT_MAX_BYTES", 2 * f.numel() * 4)
    assert torch.equal(_segment_max(pm, f), full)


@pytest.mark.parametrize("distance", ["sqeuclidean", "euclidean", "cosine"])
@pytest.mark.parametrize("per_stream_q", [False, True])
def test_fused_distances_matches_jax(worlds, distance, per_stream_q):
    world = worlds["didemo"].with_model(distance=distance)
    rng = np.random.default_rng(9)
    S, d = len(world.tmodel.streams), world.tcfg.model.joint_dim
    q = rng.standard_normal((S, B, d) if per_stream_q else (B, d)).astype(
        np.float32)
    m = {s: rng.standard_normal((B, 21, d)).astype(np.float32)
         for s in world.tmodel.streams}
    got = fused_distances(world.tmodel, torch.from_numpy(q),
                          {s: torch.from_numpy(v) for s, v in m.items()})
    ref = j_fused_distances(world.jmodel, jnp.asarray(q),
                            {s: jnp.asarray(v) for s, v in m.items()})
    assert got.shape == (B, 21)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_build_model_charades(worlds):
    world = worlds["charades"]
    np.testing.assert_array_equal(world.tmodel.pool_matrix, world.tds.pool)
    np.testing.assert_array_equal(world.tmodel.pool_matrix,
                                  np.asarray(world.jmodel.pool_matrix))
    assert world.tmodel.tef is None
    with pytest.raises(ValueError, match="window bank"):
        build_model(world.tcfg)
    with pytest.raises(ValueError, match="moment_impl"):
        embed_moments(world.tparams, world.tmodel,
                      {"rgb": torch.zeros(1, 40, F)}, impl="bogus")
