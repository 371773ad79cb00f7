"""The port's live index (``vfr_tpu_torch.eval.live``) against the JAX
package's ``vfr_tpu.eval.live``, on the same numpy weights (small widths).

After every operation (append, remove, compact, grow) the port's live
retrieval returns the JAX live arena's rows and the rows of a from-scratch
rebuild over the same corpus, distances within rtol 1e-5 (atol 1e-6), and
the host tables equal the JAX package's.  Arena files cross between the
packages bit for bit (f32 and bf16).  Appends, removes and compaction
write the arena in place (its ``data_ptr`` is unchanged); ``live_grow``
reallocates once.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_live_world import concat_corpus, world
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.eval import live as jlive
from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.eval import live as tlive

K = 10
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def w():
    return world()


def _delta(w, lo, hi):
    d = w.delta
    return d.video_ids[lo:hi], d.rgb_feats[lo:hi], d.flow_feats[lo:hi]


def _both(w, cap, index_dtype):
    j = jlive.make_live_index(w.jparams, w.jmodel, w.jds,
                              capacity_videos=cap, index_dtype=index_dtype)
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                              capacity_videos=cap, index_dtype=index_dtype)
    return j, t


def _retrieve(w, j, t, k=K):
    d_j, r_j = jlive.make_live_retriever(w.jmodel, j, k,
                                         topk_method="exact")(
        w.jparams, jnp.asarray(w.toks), jnp.asarray(w.lens))
    d_t, r_t = tlive.make_live_retriever(w.tmodel, t, k)(
        w.tparams, torch.from_numpy(w.toks), torch.from_numpy(w.lens))
    return (np.asarray(d_j), np.asarray(r_j)), (d_t.numpy(), r_t.numpy())


def _rebuild(w, corpus, index_dtype, k=K):
    idx = tcorpus.build_moment_index(w.tparams, w.tmodel, corpus,
                                     index_dtype=index_dtype,
                                     with_fingerprint=False)
    d, r = tcorpus.make_retriever(w.tmodel, idx, k)(
        w.tparams, torch.from_numpy(w.toks), torch.from_numpy(w.lens))
    return d.numpy(), r.numpy()


def _check(w, j, t, corpus, index_dtype):
    """Port live == JAX live == port rebuild; host tables equal JAX's."""
    (d_j, r_j), (d_t, r_t) = _retrieve(w, j, t)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_allclose(d_t, d_j, **TOL)
    d_r, r_r = _rebuild(w, corpus, index_dtype)
    np.testing.assert_array_equal(r_t, r_r)
    np.testing.assert_allclose(d_t, d_r, **TOL)
    for name in ("video_row", "prop_idx", "spans_sec"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.video_ids == j.video_ids == list(corpus.video_ids)
    assert (t.used_rows, t.capacity) == (j.used_rows, j.capacity)
    np.testing.assert_array_equal(t.msq_fused.numpy() >= 1e29,
                                  np.asarray(j.msq_fused) >= 1e29)


@pytest.mark.parametrize("index_dtype", ["float32", "bfloat16"])
def test_append_matches_jax_and_rebuild(w, index_dtype):
    j, t = _both(w, 20, index_dtype)
    _check(w, j, t, concat_corpus(w.tds), index_dtype)
    ids, rgb, flow = _delta(w, 0, 3)
    n_j = jlive.live_append(j, w.jparams, w.jmodel, w.jds, ids, rgb, flow)
    n_t = tlive.live_append(t, w.tparams, w.tmodel, w.tds, ids, rgb, flow)
    assert n_t == n_j == 3 * w.tds.num_proposals
    _check(w, j, t, concat_corpus(w.tds, zip(ids, rgb, flow)), index_dtype)


@pytest.mark.parametrize("index_dtype", ["float32", "bfloat16"])
def test_remove_compact_grow_match_jax(w, index_dtype):
    j, t = _both(w, 15, index_dtype)
    ids, rgb, flow = _delta(w, 0, 3)
    extra = list(zip(ids, rgb, flow))
    for live, P, M, D in ((j, w.jparams, w.jmodel, w.jds),
                          (t, w.tparams, w.tmodel, w.tds)):
        jlive_or_t = jlive if live is j else tlive
        jlive_or_t.live_append(live, P, M, D, ids, rgb, flow)
    gone = [w.tds.video_ids[2], ids[1], w.tds.video_ids[7]]
    assert tlive.live_remove(t, gone) == jlive.live_remove(j, gone) == 63
    # removal tombstones: the rows equal a rebuild without those videos in
    # distance; the row ids differ from it until compaction
    (d_j, r_j), (d_t, r_t) = _retrieve(w, j, t)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_allclose(d_t, d_j, **TOL)
    without = concat_corpus(w.tds, extra, drop=gone)
    np.testing.assert_allclose(d_t, _rebuild(w, without, index_dtype)[0],
                               **TOL)
    assert tlive.live_compact(t) == jlive.live_compact(j) == 63
    _check(w, j, t, without, index_dtype)
    # the compacted arena is the JAX package's row for row (survivors
    # packed, every row past them the old row 0)
    np.testing.assert_allclose(t.m_cat.numpy(),
                               np.asarray(j.m_cat.astype(jnp.float32)),
                               rtol=8e-3 if index_dtype == "bfloat16"
                               else 1e-5, atol=1e-5)
    assert tlive.live_grow(t, 22) == jlive.live_grow(j, 22) == 22 * 21
    more = _delta(w, 3, 6)
    for live, P, M, D, mod in ((j, w.jparams, w.jmodel, w.jds, jlive),
                               (t, w.tparams, w.tmodel, w.tds, tlive)):
        mod.live_append(live, P, M, D, *more)
    _check(w, j, t, concat_corpus(without, zip(*more)), index_dtype)


def test_topk_clamp_follows_grow(w):
    """k above a small boot capacity is clamped, and the full k comes back
    after a grow, through the same retriever object."""
    j, t = _both(w, 12, "float32")
    big = 12 * 21 + 30
    retrieve = tlive.make_live_retriever(w.tmodel, t, big)
    toks, lens = torch.from_numpy(w.toks), torch.from_numpy(w.lens)
    assert retrieve(w.tparams, toks, lens)[1].shape == (8, 12 * 21)
    tlive.live_grow(t, 14)
    jlive.live_grow(j, 14)
    d_t, r_t = retrieve(w.tparams, toks, lens)
    assert r_t.shape == (8, big)
    d_j, r_j = jlive.make_live_retriever(w.jmodel, j, big,
                                         topk_method="exact")(
        w.jparams, jnp.asarray(w.toks), jnp.asarray(w.lens))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    # the free rows surface last, at distance >= 1e29
    assert (d_t.numpy()[:, -30:] >= 1e29).all()


def test_pad_rows_map_to_last_video(w):
    """k above the valid rows: the free rows come back with video_row -1,
    which the result mapping sends to video_ids[-1], as in the JAX
    package (its result, kept)."""
    qs = ["w0001 w0002", "w0003"]
    k = 12 * 21 + 5
    recs = {}
    for name, mod, P, M, D, corpus in (
            ("jax", jlive, w.jparams, w.jmodel, w.jds, jcorpus),
            ("port", tlive, w.tparams, w.tmodel, w.tds, tcorpus)):
        live = mod.make_live_index(P, M, D, capacity_videos=13)
        recs[name] = list(corpus.serve_follow(
            P, M, D, w.vocab, qs, k=k, micro_batch=4, live=live))
    for a, b in zip(recs["port"], recs["jax"]):
        assert [(r["video"], r["start"], r["end"]) for r in a["results"]] \
            == [(r["video"], r["start"], r["end"]) for r in b["results"]]
        tail = a["results"][-5:]
        assert all(r["video"] == w.tds.video_ids[-1] and r["start"] == 0.0
                   and r["distance"] >= 1e29 for r in tail)


def _state(t):
    return (t.m_cat.clone(), t.msq_fused.clone(), t.video_row.copy(),
            t.prop_idx.copy(), t.spans_sec.copy(), list(t.video_ids),
            t.used_rows)


@pytest.mark.parametrize("case", ["duplicate", "over_capacity",
                                  "bad_shape"])
def test_rejected_delta_leaves_arena_unchanged(w, case):
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                              capacity_videos=len(w.tds.video_ids)
                              + (2 if case == "over_capacity" else 3))
    ids, rgb, flow = _delta(w, 0, 3)
    if case == "duplicate":
        ids = [ids[0], w.tds.video_ids[4], ids[2]]
        match = "already in the corpus"
    elif case == "over_capacity":
        match = "exceeds capacity"
    else:
        rgb = rgb[:, :, :-1]
        match = "delta rgb shape"
    before = _state(t)
    with pytest.raises(ValueError, match=match):
        tlive.live_append(t, w.tparams, w.tmodel, w.tds, ids, rgb, flow)
    after = _state(t)
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[1], after[1])
    for a, b in zip(before[2:5], after[2:5]):
        np.testing.assert_array_equal(a, b)
    assert before[5:] == after[5:]


def test_remove_unknown_and_mesh_raise(w):
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=12)
    with pytest.raises(ValueError, match="not in the corpus"):
        tlive.live_remove(t, ["nope"])
    with pytest.raises(NotImplementedError, match="sharded live arena"):
        tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                              capacity_videos=12, mesh=object())
    retrieve = tlive.make_live_retriever(w.tmodel, t, 5,
                                         topk_method="fused")
    with pytest.raises(ValueError, match="fused"):
        retrieve(w.tparams, torch.from_numpy(w.toks),
                 torch.from_numpy(w.lens))


def test_charades_delta_matches_jax():
    """A Charades-STA arena (window bank, duration-normalized TEF, validity
    mask) grown by a delta with durations: port == JAX live == JAX
    rebuild."""
    from vfr_tpu.config import DataConfig as JDataConfig
    from vfr_tpu.config import ExperimentConfig as JExperimentConfig
    from vfr_tpu.config import ModelConfig as JModelConfig
    from vfr_tpu.data.charades import CharadesSTADataset as JCharades
    from vfr_tpu.data.synthetic import make_charades_fixture
    from vfr_tpu.models.build import build_model as j_build_model
    from vfr_tpu.models.mcn import init_model_params as j_init
    from vfr_tpu_torch.bridge import params_from_numpy
    from vfr_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
    from vfr_tpu_torch.data.charades import CharadesSTADataset
    from vfr_tpu_torch.models.build import build_model

    F, E = 24, 16
    fix = make_charades_fixture(num_videos=8, num_queries=24, feature_dim=F,
                                glove_dim=E, seed=5)
    data = dict(dataset="charades_sta", feature_dim=F, glove_dim=E,
                use_flow=False)
    kw = dict(joint_dim=8, lstm_hidden=16, distance="cosine")
    jcfg = JExperimentConfig(name="c", data=JDataConfig(**data),
                             model=JModelConfig(**kw))
    tcfg = ExperimentConfig(name="c", data=DataConfig(**data),
                            model=ModelConfig(**kw))
    jds = JCharades(fix.annotations, fix.rgb, None, fix.vocab, jcfg.data)
    tds = CharadesSTADataset(fix.annotations, fix.rgb, None, fix.vocab,
                             tcfg.data)
    jmodel, tmodel = j_build_model(jcfg, dataset=jds), \
        build_model(tcfg, dataset=tds)
    tree = jax.tree.map(np.asarray, jax.device_get(j_init(
        jax.random.PRNGKey(2), jmodel, fix.glove, F)))
    jparams, tparams = jax.tree.map(jnp.asarray, tree), \
        params_from_numpy(tree)
    V = len(tds.video_ids)
    base = V - 3

    def base_ds(ds):
        b = types.SimpleNamespace(**{k: getattr(ds, k) for k in (
            "num_proposals", "windows", "cfg")})
        b.video_ids = list(ds.video_ids[:base])
        b.rgb_feats = ds.rgb_feats[:base]
        b.flow_feats = None
        b.window_mask = ds.window_mask[:base]
        b.video_tef = ds.video_tef[:base]
        return b

    ids = list(tds.video_ids[base:])
    rgb = tds.rgb_feats[base:]
    durations = np.asarray([tds.durations[i] for i in range(base, V)],
                           np.float32)
    j = jlive.make_live_index(jparams, jmodel, base_ds(jds),
                              capacity_videos=V + 1)
    t = tlive.make_live_index(tparams, tmodel, base_ds(tds),
                              capacity_videos=V + 1)
    jlive.live_append(j, jparams, jmodel, base_ds(jds), ids, rgb,
                      durations=durations)
    tlive.live_append(t, tparams, tmodel, base_ds(tds), ids, rgb,
                      durations=durations)
    batch = next(tds.eval_batches(8, with_features=False))
    d_j, r_j = jlive.make_live_retriever(jmodel, j, 5, topk_method="exact")(
        jparams, jnp.asarray(batch["tokens"]), jnp.asarray(batch["lengths"]))
    d_t, r_t = tlive.make_live_retriever(tmodel, t, 5)(
        tparams, torch.from_numpy(batch["tokens"]),
        torch.from_numpy(batch["lengths"]))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **TOL)
    jidx = jcorpus.build_moment_index(jparams, jmodel, jds,
                                      with_fingerprint=False)
    d_r, r_r = jcorpus.make_retriever(jmodel, jidx, 5, topk_method="exact")(
        jparams, jnp.asarray(batch["tokens"]), jnp.asarray(batch["lengths"]))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_r))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_r), **TOL)
    np.testing.assert_array_equal(t.msq_fused.numpy() >= 1e29,
                                  np.asarray(j.msq_fused) >= 1e29)
    with pytest.raises(ValueError, match="durations"):
        tlive.live_append(t, tparams, tmodel, base_ds(tds), ["x"], rgb[:1])


def _bits(m):
    if isinstance(m, torch.Tensor):
        return m.contiguous().view(torch.int32).numpy()
    a = np.asarray(m)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a.view(np.int32)


@pytest.mark.parametrize("index_dtype", ["float32", "bfloat16"])
def test_arena_files_cross_bit_exact(w, tmp_path, index_dtype):
    j, t = _both(w, 16, index_dtype)
    ids, rgb, flow = _delta(w, 0, 2)
    jlive.live_append(j, w.jparams, w.jmodel, w.jds, ids, rgb, flow)
    jlive.live_remove(j, [ids[0]])
    # JAX writes, the port reads (fingerprint checked) ...
    jpath = jlive.save_arena(j, str(tmp_path / "j"), params=w.jparams,
                             model=w.jmodel)
    t2 = tlive.load_arena(jpath, params=w.tparams, model=w.tmodel,
                          device="cpu")
    j_m = np.asarray(j.m_cat)
    if index_dtype == "bfloat16":
        assert np.array_equal(
            t2.m_cat.to(torch.bfloat16).view(torch.int16).numpy()
            .view(np.uint16), j_m.view(np.uint16))
        assert torch.equal(t2.m_cat, t2.m_cat.to(torch.bfloat16).float())
    else:
        assert np.array_equal(_bits(t2.m_cat), j_m.view(np.int32))
    assert np.array_equal(t2.msq_fused.numpy(), np.asarray(j.msq_fused))
    for name in ("video_row", "prop_idx", "spans_sec"):
        np.testing.assert_array_equal(getattr(t2, name), getattr(j, name))
    assert (t2.video_ids, t2.used_rows, t2.index_dtype) == \
        (j.video_ids, j.used_rows, j.index_dtype)
    # ... and writes it back: the file's arrays are the JAX file's, and
    # the JAX package reads it with the fingerprint checked
    tpath = tlive.save_arena(t2, str(tmp_path / "t"), params=w.tparams,
                             model=w.tmodel)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
    j2 = jlive.load_arena(tpath, params=w.jparams, model=w.jmodel)
    assert np.asarray(j2.m_cat).tobytes() == j_m.tobytes()
    (d_j, r_j), (d_t, r_t) = _retrieve(w, j2, t2)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_allclose(d_t, d_j, **TOL)


def test_fingerprint_from_other_checkpoint_rejected(w, tmp_path):
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=12)
    path = tlive.save_arena(t, str(tmp_path / "a"), params=w.tparams,
                            model=w.tmodel)
    other = {k: v for k, v in w.tparams.items()}
    other["query_proj"] = {n: p * 2 for n, p in
                           w.tparams["query_proj"].items()}
    with pytest.raises(ValueError, match="checkpoint"):
        tlive.load_arena(path, params=other, model=w.tmodel, device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        jlive.load_arena(path, params=jax.tree.map(lambda a: a * 2,
                                                   w.jparams),
                         model=w.jmodel)


def test_arena_is_written_in_place(w):
    """append, remove and compact never reallocate the arena; grow
    reallocates once; one retriever object serves across all of them."""
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=16)
    retrieve = tlive.make_live_retriever(w.tmodel, t, K)
    toks, lens = torch.from_numpy(w.toks), torch.from_numpy(w.lens)
    ptrs = (t.m_cat.data_ptr(), t.msq_fused.data_ptr())
    tables = (t.video_row, t.prop_idx, t.spans_sec)
    ids, rgb, flow = _delta(w, 0, 3)
    tlive.live_append(t, w.tparams, w.tmodel, w.tds, ids, rgb, flow)
    retrieve(w.tparams, toks, lens)
    tlive.live_remove(t, [ids[1], w.tds.video_ids[0]])
    retrieve(w.tparams, toks, lens)
    tlive.live_compact(t)
    assert (t.m_cat.data_ptr(), t.msq_fused.data_ptr()) == ptrs
    assert all(a is b for a, b in zip(tables, (t.video_row, t.prop_idx,
                                               t.spans_sec)))
    tlive.live_grow(t, 20)
    assert t.m_cat.data_ptr() != ptrs[0] and t.capacity == 20 * 21
    grown = t.m_cat.data_ptr()
    tlive.live_append(t, w.tparams, w.tmodel, w.tds, *_delta(w, 3, 6))
    assert t.m_cat.data_ptr() == grown
    d, r = retrieve(w.tparams, toks, lens)
    corpus = concat_corpus(
        w.tds, list(zip(ids, rgb, flow)) + list(zip(*_delta(w, 3, 6))),
        drop=[ids[1], w.tds.video_ids[0]])
    d_r, r_r = _rebuild(w, corpus, "float32")
    np.testing.assert_array_equal(r.numpy(), r_r)
    np.testing.assert_allclose(d.numpy(), d_r, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_lifecycle_matches_rebuild(w, seed):
    """A seeded random sequence of appends, removes, compactions and grows:
    after each, the live retrieval equals a rebuild over the corpus it
    should hold (rows, rtol 1e-5)."""
    rng = np.random.default_rng(seed)
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=13)
    feats = {v: (r, f) for v, r, f in zip(w.tds.video_ids, w.tds.rgb_feats,
                                          w.tds.flow_feats)}
    pool = list(zip(*_delta(w, 0, 6)))
    for v, r, f in pool:
        feats[v] = (r, f)
    held = list(w.tds.video_ids)       # the arena's videos, in order
    removed = []                       # tombstoned, not yet compacted
    for _ in range(6):
        op = rng.choice(["add", "remove", "compact", "grow"])
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
            if len(alive) > 2:
                gone = [str(v) for v in rng.choice(alive, 2, replace=False)]
                tlive.live_remove(t, gone)
                removed += gone
        elif op == "compact":
            tlive.live_compact(t)
            held = [v for v in held if v not in removed]
            pool += [(v, *feats[v]) for v in removed]
            removed = []
        else:
            tlive.live_grow(t, t.capacity // 21 + 1)
        alive = [v for v in held if v not in removed]
        corpus = types.SimpleNamespace(
            video_ids=alive,
            rgb_feats=np.stack([feats[v][0] for v in alive]),
            flow_feats=np.stack([feats[v][1] for v in alive]),
            num_proposals=w.tds.num_proposals,
            span_seconds=w.tds.span_seconds)
        d, r = tlive.make_live_retriever(w.tmodel, t, K)(
            w.tparams, torch.from_numpy(w.toks), torch.from_numpy(w.lens))
        d_r, r_r = _rebuild(w, corpus, "float32")
        np.testing.assert_allclose(d.numpy(), d_r, **TOL)
        # live rows -> (video, proposal) equal the rebuild's
        got = [[(t.video_ids[t.video_row[x]], t.prop_idx[x]) for x in row]
               for row in r.numpy()]
        want = [[(alive[x // 21], x % 21) for x in row] for row in r_r]
        assert got == want
