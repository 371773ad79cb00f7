"""The port's row-sharded live arena (``eval/live.py`` with a ``mesh``)
against the JAX package's sharded arena: a port mesh of ``[cpu] * n``
against ``devices8[:n]``, n in {2, 4, 8}, on the same numpy weights (small
widths; ``torch_live_world``).

* After appends (a delta larger than a shard, split across shards),
  removes, a compaction (rows gathered across shards) and a grow (rows
  move between shards) the sharded retrieval returns the JAX sharded
  arena's rows and the port's single-device arena's, distances within
  rtol 1e-5 (atol 1e-6); capacity, rows per shard and the host tables
  equal the JAX package's.
* A sharded ``save_arena`` equals the JAX package's sharded save of the
  same arena byte for byte (f32 and bf16); snapshots move between meshes
  both ways; a small snapshot on a large mesh takes appends; an append
  that does not fit is atomic.
* ``serve_follow`` over a sharded arena answers a script of queries and
  control lines with the JAX package's records (``!stats`` reports the
  mesh size), and refuses an arena built on another mesh.
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_follow import assert_records_match
from torch_live_world import concat_corpus, world
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.eval import live as jlive
from vfr_tpu.parallel.mesh import make_mesh as j_make_mesh
from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.eval import live as tlive
from vfr_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
NS = [2, 4, 8]
K = 10
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def w():
    return world()


def _meshes(devices8, n):
    return (j_make_mesh(("corpus",), devices=devices8[:n]),
            make_mesh(("corpus",), devices=[CPU] * n))


def _delta(w, lo, hi):
    d = w.delta
    return d.video_ids[lo:hi], d.rgb_feats[lo:hi], d.flow_feats[lo:hi]


def _retrieve_t(w, t, k=K):
    d, r = tlive.make_live_retriever(w.tmodel, t, k)(
        w.tparams, torch.from_numpy(w.toks), torch.from_numpy(w.lens))
    return d.numpy(), r.numpy()


def _retrieve_j(w, j, k=K):
    d, r = jlive.make_live_retriever(w.jmodel, j, k, topk_method="exact")(
        w.jparams, jnp.asarray(w.toks), jnp.asarray(w.lens))
    return np.asarray(d), np.asarray(r)


def _check(w, j, t, one=None):
    """The port's sharded arena == the JAX sharded arena (== the port's
    single-device arena ``one`` when given)."""
    d_t, r_t = _retrieve_t(w, t)
    d_j, r_j = _retrieve_j(w, j)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_allclose(d_t, d_j, **TOL)
    if one is not None:
        d_1, r_1 = _retrieve_t(w, one)
        np.testing.assert_array_equal(r_t, r_1)
        np.testing.assert_allclose(d_t, d_1, **TOL)
    for name in ("video_row", "prop_idx", "spans_sec"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.video_ids == j.video_ids
    assert (t.used_rows, t.capacity, t.rows_per_shard) == \
        (j.used_rows, j.capacity, j.rows_per_shard)
    np.testing.assert_array_equal(tlive.msq_host(t) >= 1e29,
                                  np.asarray(j.msq_fused) >= 1e29)


@pytest.mark.parametrize("n", NS)
def test_lifecycle_matches_jax_and_single_device(w, devices8, n):
    """Capacity 18 videos (378 rows): at n = 8, 48 rows a shard, and the
    5-video delta (105 rows) spans three shards."""
    jmesh, tmesh = _meshes(devices8, n)
    j = jlive.make_live_index(w.jparams, w.jmodel, w.jds, capacity_videos=18,
                              mesh=jmesh)
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=18,
                              mesh=tmesh)
    one = tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                                capacity_videos=18)
    assert t.capacity % n == 0 and t.rows_per_shard * n == t.capacity
    assert isinstance(t.m_cat, list) and len(t.m_cat) == n
    _check(w, j, t, one)
    ids, rgb, flow = _delta(w, 0, 5)
    if n == 8:
        assert 5 * w.tds.num_proposals > t.rows_per_shard
    jlive.live_append(j, w.jparams, w.jmodel, w.jds, ids, rgb, flow)
    for x in (t, one):
        assert tlive.live_append(x, w.tparams, w.tmodel, w.tds, ids, rgb,
                                 flow) == 5 * w.tds.num_proposals
    _check(w, j, t, one)
    gone = [w.tds.video_ids[1], ids[2], w.tds.video_ids[8]]
    assert jlive.live_remove(j, gone) == tlive.live_remove(t, gone) == \
        tlive.live_remove(one, gone) == 63
    _check(w, j, t, one)
    assert jlive.live_compact(j) == tlive.live_compact(t) == \
        tlive.live_compact(one) == 63
    _check(w, j, t, one)
    for x in (j, t, one):
        (jlive if x is j else tlive).live_grow(x, 23)
    _check(w, j, t, one)
    more = _delta(w, 5, 6)
    jlive.live_append(j, w.jparams, w.jmodel, w.jds, *more)
    for x in (t, one):
        tlive.live_append(x, w.tparams, w.tmodel, w.tds, *more)
    _check(w, j, t, one)
    d_r, r_r = tcorpus.make_retriever(w.tmodel, tcorpus.build_moment_index(
        w.tparams, w.tmodel, concat_corpus(
            w.tds, list(zip(*_delta(w, 0, 6))), drop=gone),
        with_fingerprint=False), K)(
            w.tparams, torch.from_numpy(w.toks), torch.from_numpy(w.lens))
    d_t, r_t = _retrieve_t(w, t)
    np.testing.assert_array_equal(r_t, r_r.numpy())
    np.testing.assert_allclose(d_t, d_r.numpy(), **TOL)


@pytest.mark.parametrize("index_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4, 8])
def test_sharded_save_equals_jax_bit_for_bit(w, devices8, tmp_path, n,
                                             index_dtype):
    """One JAX snapshot loaded on both packages' meshes, then the same
    remove, compaction (rows move across shards; pad rows hold the old
    row 0) and grow (rows move between shards) on each: the two sharded
    saves are the same file, array for array."""
    jmesh, tmesh = _meshes(devices8, n)
    j0 = jlive.make_live_index(w.jparams, w.jmodel, w.jds, capacity_videos=14,
                               index_dtype=index_dtype)
    jlive.live_append(j0, w.jparams, w.jmodel, w.jds, *_delta(w, 0, 2))
    base = jlive.save_arena(j0, str(tmp_path / "base"), params=w.jparams,
                            model=w.jmodel)
    j = jlive.load_arena(base, params=w.jparams, model=w.jmodel, mesh=jmesh)
    t = tlive.load_arena(base, params=w.tparams, model=w.tmodel, mesh=tmesh)
    gone = [w.tds.video_ids[0], w.tds.video_ids[5], w.delta.video_ids[0]]
    for mod, x in ((jlive, j), (tlive, t)):
        mod.live_remove(x, gone)
        mod.live_compact(x)
        mod.live_grow(x, 17)
    paths = [mod.save_arena(x, str(tmp_path / name), params=P, model=M)
             for mod, x, name, P, M in (
                 (jlive, j, "j", w.jparams, w.jmodel),
                 (tlive, t, "t", w.tparams, w.tmodel))]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
    _check(w, j, t)


def test_snapshots_move_between_meshes(w, devices8, tmp_path):
    """Single device -> 8 shards (capacity padded with free rows) and 8
    shards -> single device -> 4 shards: equal retrievals, and the loaded
    sharded arenas still grow."""
    _, m8 = _meshes(devices8, 8)
    _, m4 = _meshes(devices8, 4)
    one = tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                                capacity_videos=13)
    assert one.capacity % 8
    p1 = tlive.save_arena(one, str(tmp_path / "one"), params=w.tparams,
                          model=w.tmodel)
    s8 = tlive.load_arena(p1, params=w.tparams, model=w.tmodel, mesh=m8)
    assert s8.capacity % 8 == 0 and s8.mesh is m8
    d1, r1 = _retrieve_t(w, one)
    d, r = _retrieve_t(w, s8)
    np.testing.assert_array_equal(r, r1)
    np.testing.assert_allclose(d, d1, **TOL)
    tlive.live_append(s8, w.tparams, w.tmodel, w.tds, *_delta(w, 0, 2))
    p8 = tlive.save_arena(s8, str(tmp_path / "s8"), params=w.tparams,
                          model=w.tmodel)
    back = tlive.load_arena(p8, params=w.tparams, model=w.tmodel,
                            device="cpu")
    assert back.mesh is None and back.capacity == s8.capacity
    s4 = tlive.load_arena(p8, params=w.tparams, model=w.tmodel, mesh=m4)
    d8, r8 = _retrieve_t(w, s8)
    for arena in (back, s4):
        d, r = _retrieve_t(w, arena)
        np.testing.assert_array_equal(r, r8)
        np.testing.assert_allclose(d, d8, **TOL)
    tlive.live_grow(s4, 16)
    tlive.live_append(s4, w.tparams, w.tmodel, w.tds, *_delta(w, 2, 3))
    assert s4.num_videos == s8.num_videos + 1


def test_small_snapshot_on_large_mesh_can_append(w, devices8, tmp_path):
    """3 videos (63 rows) on 8 shards: the capacity is padded so every
    shard holds a whole video (the JAX package's rule), and appends land."""
    jmesh, tmesh = _meshes(devices8, 8)
    small = types.SimpleNamespace(
        video_ids=list(w.tds.video_ids[:3]), rgb_feats=w.tds.rgb_feats[:3],
        flow_feats=w.tds.flow_feats[:3], num_proposals=w.tds.num_proposals,
        span_seconds=w.tds.span_seconds)
    live = tlive.make_live_index(w.tparams, w.tmodel, small,
                                 capacity_videos=3)
    p = tlive.save_arena(live, str(tmp_path / "small"))
    t = tlive.load_arena(p, mesh=tmesh)
    j = jlive.load_arena(p, mesh=jmesh)
    assert t.rows_per_shard >= t.rows_per_video
    assert (t.capacity, t.rows_per_shard) == (j.capacity, j.rows_per_shard)
    ids, rgb, flow = _delta(w, 0, 2)
    assert tlive.live_append(t, w.tparams, w.tmodel, w.tds, ids, rgb,
                             flow) == 2 * w.tds.num_proposals
    jlive.live_append(j, w.jparams, w.jmodel, w.jds, ids, rgb, flow)
    _check(w, j, t)


def test_oversized_sharded_append_is_atomic(w, devices8):
    _, tmesh = _meshes(devices8, 8)
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=13,
                              mesh=tmesh)
    before = ([x.clone() for x in t.m_cat], tlive.msq_host(t).copy(),
              t.video_row.copy(), list(t.video_ids), t.used_rows)
    ids, rgb, flow = _delta(w, 0, 5)
    with pytest.raises(ValueError, match="exceeds capacity"):
        tlive.live_append(t, w.tparams, w.tmodel, w.tds, ids, rgb, flow)
    assert all(torch.equal(a, b) for a, b in zip(before[0], t.m_cat))
    np.testing.assert_array_equal(before[1], tlive.msq_host(t))
    np.testing.assert_array_equal(before[2], t.video_row)
    assert (before[3], before[4]) == (t.video_ids, t.used_rows)
    tlive.live_grow(t, 24)
    assert tlive.live_append(t, w.tparams, w.tmodel, w.tds, ids, rgb,
                             flow) == 5 * w.tds.num_proposals
    with pytest.raises(ValueError, match="at least one video"):
        tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                              capacity_videos=12, mesh=make_mesh(
                                  ("corpus",), devices=[CPU] * 16))


def test_topk_clamp_follows_grow_sharded(w, devices8):
    jmesh, tmesh = _meshes(devices8, 4)
    j = jlive.make_live_index(w.jparams, w.jmodel, w.jds, capacity_videos=12,
                              mesh=jmesh)
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=12,
                              mesh=tmesh)
    big = 12 * 21 + 30
    retrieve = tlive.make_live_retriever(w.tmodel, t, big)
    toks, lens = torch.from_numpy(w.toks), torch.from_numpy(w.lens)
    assert retrieve(w.tparams, toks, lens)[1].shape == (8, 12 * 21)
    tlive.live_grow(t, 14)
    jlive.live_grow(j, 14)
    d_t, r_t = retrieve(w.tparams, toks, lens)
    d_j, r_j = _retrieve_j(w, j, big)
    assert r_t.shape == (8, big)
    np.testing.assert_array_equal(r_t.numpy(), r_j)
    with pytest.raises(ValueError, match="single-device only"):
        tlive.make_live_retriever(w.tmodel, t, 5, topk_method="fused")


def test_follow_over_sharded_arena_matches_jax(w, devices8, tmp_path):
    jmesh, tmesh = _meshes(devices8, 4)
    ids, rgb, flow = _delta(w, 0, 4)
    delta = tmp_path / "delta.npz"
    np.savez(delta, video_ids=np.asarray(ids), rgb=rgb, flow=flow)
    lines = ["w0001 w0002", "w0003", f"!add {delta}", "w0001 w0002",
             f"!remove {ids[1]} {w.tds.video_ids[0]}", "w0004 w0005",
             "!compact", "!stats", "w0003", "w0006"]
    recs = {}
    for name, mod, corpus, P, M, D, mesh in (
            ("jax", jlive, jcorpus, w.jparams, w.jmodel, w.jds, jmesh),
            ("port", tlive, tcorpus, w.tparams, w.tmodel, w.tds, tmesh)):
        live = mod.make_live_index(P, M, D, capacity_videos=20, mesh=mesh)
        recs[name] = list(corpus.serve_follow(
            P, M, D, w.vocab, iter(lines), k=K, micro_batch=4, mesh=mesh,
            live=live))
    got, ref = recs["port"], recs["jax"]
    assert len(got) == len(ref) == len(lines)
    qpos = [i for i, line in enumerate(lines) if not line.startswith("!")]
    assert_records_match([got[i] for i in qpos], [ref[i] for i in qpos],
                         tol=1e-5)
    for i in set(range(len(lines))) - set(qpos):
        assert json.dumps(got[i]) == json.dumps(ref[i])
    assert got[lines.index("!stats")]["shards"] == 4
    one = tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                                capacity_videos=12)
    with pytest.raises(ValueError, match="built on that mesh"):
        next(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                  ["w0001"], mesh=tmesh, live=one))


def test_random_lifecycle_sharded_matches_rebuild(w, devices8):
    """A seeded random walk of appends, removes, compactions and grows on
    a 4-shard arena: after each, retrieval equals a rebuild over the
    corpus it should hold."""
    _, tmesh = _meshes(devices8, 4)
    rng = np.random.default_rng(5)
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=13,
                              mesh=tmesh)
    feats = {v: (r, f) for v, r, f in zip(w.tds.video_ids, w.tds.rgb_feats,
                                          w.tds.flow_feats)}
    pool = list(zip(*_delta(w, 0, 6)))
    for v, r, f in pool:
        feats[v] = (r, f)
    held, removed = list(w.tds.video_ids), []
    for op in ("add", "remove", "compact", "grow", "add", "remove", "add",
               "compact"):
        if op == "add" and pool:
            n = int(rng.integers(1, min(3, len(pool)) + 1))
            batch, pool = pool[:n], pool[n:]
            if n * 21 > t.free_rows:
                tlive.live_grow(t, t.capacity // 21 + n)
            tlive.live_append(t, w.tparams, w.tmodel, w.tds,
                              [b[0] for b in batch],
                              np.stack([b[1] for b in batch]),
                              np.stack([b[2] for b in batch]))
            held += [b[0] for b in batch]
        elif op == "remove":
            alive = [v for v in held if v not in removed]
            gone = [str(v) for v in rng.choice(alive, 2, replace=False)]
            tlive.live_remove(t, gone)
            removed += gone
        elif op == "compact":
            tlive.live_compact(t)
            held = [v for v in held if v not in removed]
            pool += [(v, *feats[v]) for v in removed]
            removed = []
        else:
            tlive.live_grow(t, t.capacity // 21 + 2)
        alive = [v for v in held if v not in removed]
        corpus = types.SimpleNamespace(
            video_ids=alive,
            rgb_feats=np.stack([feats[v][0] for v in alive]),
            flow_feats=np.stack([feats[v][1] for v in alive]),
            num_proposals=w.tds.num_proposals,
            span_seconds=w.tds.span_seconds)
        idx = tcorpus.build_moment_index(w.tparams, w.tmodel, corpus,
                                         with_fingerprint=False)
        d_r, r_r = tcorpus.make_retriever(w.tmodel, idx, K)(
            w.tparams, torch.from_numpy(w.toks), torch.from_numpy(w.lens))
        d, r = _retrieve_t(w, t)
        np.testing.assert_allclose(d, d_r.numpy(), **TOL)
        got = [[(t.video_ids[t.video_row[x]], t.prop_idx[x]) for x in row]
               for row in r]
        want = [[(alive[x // 21], x % 21) for x in row]
                for row in r_r.numpy()]
        assert got == want
