"""The port's score operands against the JAX package's carrier policy, on
one index shared by both (the JAX build, loaded bit-exact into the port)
and the same numpy weights (small widths; ``torch_live_world``), for
compute {f32, bf16} x index {f32, bf16}, and the JAX package's carriers
"auto" and "bfloat16".  The port holds every fixed operand at the index's
stored dtype.

* ``prep_score_operands``: the operand is the index's stored dtype and
  its bits are the JAX package's (uint16 for bf16, int32 views for f32);
  where the JAX package carries a bf16 index as f32, the port's operand
  upcast is that carrier bit for bit.
* ``make_score_topk`` and ``make_stream_retriever`` (M = 2): the JAX
  package's rows under either carrier, distances within rtol 1e-5 (atol
  1e-6), or the bf16 band rtol 8e-3 where the product is bf16.
* ``make_retriever`` keeps the stored dtype, as the JAX package's, and the
  three one-device retrievers hand the top-k one operand and return the
  same answers bit for bit.
* Over a ``[cpu] * 2`` "corpus" mesh the operands are the JAX package's
  ``shard_index_operands`` (the stored dtype) bit for bit, and the sharded
  retrievers return the rows of the JAX package's sharded operand
  retriever over ``devices8[:2]`` and of its one-device retriever under
  either carrier.
* The live arena stays at its index's dtype through build, append,
  remove, compact, grow, save and load, on one device and on a 2-shard
  mesh; an f32 arena under bf16 compute keeps its unrounded values.
* ``parallel.sharding.score_mm``: CPU tensors take the plain version; a
  tensor elsewhere takes ``aten::mm.dtype`` and raises without it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_live_world import world
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.parallel.mesh import make_mesh as j_make_mesh
from vfr_tpu_torch.device import mm_f32
from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.eval import live as tlive
from vfr_tpu_torch.parallel import sharding as tsh
from vfr_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
K = 10
TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=8e-3, atol=1e-6)
DTYPES = ["float32", "bfloat16"]
CARRIERS = ["auto", "bfloat16"]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """(compute, index dtype) -> a world and its index in both packages,
    built once each."""
    out, worlds = {}, {}
    d = tmp_path_factory.mktemp("carrier")

    def get(compute, index_dtype):
        key = (compute, index_dtype)
        if key not in out:
            if compute not in worlds:
                worlds[compute] = world(compute_dtype=compute)
            w = worlds[compute]
            jidx = jcorpus.build_moment_index(w.jparams, w.jmodel, w.jds,
                                              index_dtype=index_dtype)
            path = jcorpus.save_index(jidx,
                                      str(d / f"{compute}_{index_dtype}"))
            out[key] = (w, jidx, tcorpus.load_index(path, device="cpu"))
        return out[key]

    return get


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.view(torch.int32).numpy())
    a = np.asarray(x)
    if a.dtype in (jnp.bfloat16, np.uint16):     # a file stores bf16 as uint16
        return a.view(np.uint16)
    return a.view(np.int32)


def _bf16_product(compute, index_dtype) -> bool:
    return "bfloat16" in (compute, index_dtype)


def _tol(compute, index_dtype):
    return BF16_TOL if _bf16_product(compute, index_dtype) else TOL


def _queries(w):
    return (torch.from_numpy(w.toks), torch.from_numpy(w.lens),
            jnp.asarray(w.toks), jnp.asarray(w.lens))


@pytest.mark.parametrize("carrier", CARRIERS)
@pytest.mark.parametrize("index_dtype", DTYPES)
@pytest.mark.parametrize("compute", DTYPES)
def test_operands_match_jax(cases, compute, index_dtype, carrier):
    w, jidx, tidx = cases(compute, index_dtype)
    jm, jsq = jcorpus.prep_score_operands(jidx, w.jmodel.compute_dtype,
                                          carrier)
    tm, tsq = tcorpus.prep_score_operands(tidx)
    assert _name(tm.dtype) == index_dtype
    f32_carrier = (carrier == "auto" and index_dtype == compute
                   == "bfloat16")
    assert str(jm.dtype) == ("float32" if f32_carrier else index_dtype)
    np.testing.assert_array_equal(_bits(tm.float() if f32_carrier else tm),
                                  _bits(jm))
    np.testing.assert_array_equal(_bits(tsq), _bits(jsq))


def _stream_queries(tt, tl):
    """Two batches, the second the first's queries in reverse order."""
    return torch.stack([tt, tt.flip(0)]), torch.stack([tl, tl.flip(0)])


@pytest.mark.parametrize("carrier", CARRIERS)
@pytest.mark.parametrize("index_dtype", DTYPES)
@pytest.mark.parametrize("compute", DTYPES)
def test_score_topk_and_stream_match_jax(cases, compute, index_dtype,
                                         carrier):
    w, jidx, tidx = cases(compute, index_dtype)
    tol = _tol(compute, index_dtype)
    tt, tl, jt, jl = _queries(w)
    d_j, r_j = jcorpus.make_score_topk(w.jmodel, jidx, K, "exact",
                                       carrier_dtype=carrier)(
        w.jparams, jt, jl)
    d_t, r_t = tcorpus.make_score_topk(w.tmodel, tidx, K, "exact")(
        w.tparams, tt, tl)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **tol)
    ts, ls = _stream_queries(tt, tl)
    d_js, r_js = jcorpus.make_stream_retriever(
        w.jmodel, jidx, K, "exact", carrier_dtype=carrier)(
        w.jparams, jnp.asarray(ts.numpy()), jnp.asarray(ls.numpy()))
    d_ts, r_ts = tcorpus.make_stream_retriever(
        w.tmodel, tidx, K, "exact")(w.tparams, ts, ls)
    assert r_ts.shape == (2, len(w.toks), K)
    np.testing.assert_array_equal(r_ts.numpy(), np.asarray(r_js))
    np.testing.assert_allclose(d_ts.numpy(), np.asarray(d_js), **tol)
    np.testing.assert_array_equal(r_ts[0].numpy(), r_t.numpy())


@pytest.mark.parametrize("index_dtype", DTYPES)
@pytest.mark.parametrize("compute", DTYPES)
def test_retriever_keeps_stored_dtype(cases, compute, index_dtype):
    """``make_retriever`` (exact, one device) scores the index at its
    stored dtype, as the JAX package's: no carrier; its rows are JAX's."""
    w, jidx, tidx = cases(compute, index_dtype)
    tt, tl, jt, jl = _queries(w)
    seen = []
    real = tcorpus.corpus_topk_shards

    def spy(q, m_sh, *a, **kw):
        seen.extend(_name(t.dtype) for t in m_sh)
        return real(q, m_sh, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcorpus, "corpus_topk_shards", spy)
        d_t, r_t = tcorpus.make_retriever(w.tmodel, tidx, K, "exact")(
            w.tparams, tt, tl)
    assert seen == [index_dtype]
    d_j, r_j = jcorpus.make_retriever(w.jmodel, jidx, K,
                                      topk_method="exact")(w.jparams, jt, jl)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j),
                               **_tol(compute, index_dtype))


@pytest.mark.parametrize("index_dtype", DTYPES)
@pytest.mark.parametrize("compute", DTYPES)
def test_one_device_retrievers_share_one_operand(cases, compute,
                                                 index_dtype):
    """``make_retriever`` (exact), ``make_score_topk`` and
    ``make_stream_retriever`` (M = 2) hand the top-k an operand of the
    index's stored dtype, and return the same rows and distances bit for
    bit."""
    w, _, tidx = cases(compute, index_dtype)
    tt, tl, _, _ = _queries(w)
    ts, ls = _stream_queries(tt, tl)
    seen = []
    real = tcorpus.corpus_topk_shards

    def spy(q, m_sh, *a, **kw):
        seen.extend(_name(t.dtype) for t in m_sh)
        return real(q, m_sh, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcorpus, "corpus_topk_shards", spy)
        outs = [
            tcorpus.make_retriever(w.tmodel, tidx, K, "exact")(
                w.tparams, tt, tl),
            tcorpus.make_score_topk(w.tmodel, tidx, K, "exact")(
                w.tparams, tt, tl),
            *zip(*tcorpus.make_stream_retriever(w.tmodel, tidx, K, "exact")(
                w.tparams, ts, ls))]
    assert seen == [index_dtype] * 4
    for d_t, r_t in outs[1:3]:
        assert torch.equal(r_t, outs[0][1]) and torch.equal(d_t, outs[0][0])
    d_f, r_f = tcorpus.make_retriever(w.tmodel, tidx, K, "exact")(
        w.tparams, ts[1], ls[1])
    assert torch.equal(outs[3][1], r_f) and torch.equal(outs[3][0], d_f)


@pytest.mark.parametrize("carrier", CARRIERS)
@pytest.mark.parametrize("index_dtype", DTYPES)
@pytest.mark.parametrize("compute", DTYPES)
def test_sharded_operands_match_jax(cases, devices8, compute, index_dtype,
                                    carrier):
    """The sharded operands are the JAX package's ``shard_index_operands``
    (the stored dtype, no carrier), bit for bit; the sharded
    ``make_score_topk`` / ``make_stream_retriever`` / ``make_retriever``
    return the rows of the JAX package's sharded operand retriever on
    those operands, and of its one-device ``make_score_topk`` under
    either carrier."""
    w, jidx, tidx = cases(compute, index_dtype)
    tol = _tol(compute, index_dtype)
    jmesh = j_make_mesh(("corpus",), devices=devices8[:2])
    tmesh = make_mesh(("corpus",), devices=[CPU] * 2)
    jm, jsq = jcorpus.shard_index_operands(jidx, jmesh)
    assert jm.shape[0] == jidx.num_rows + 1      # padded to the mesh
    tm, tsq = tcorpus.prep_score_operands(tidx, tmesh)
    assert len(tm) == 2 and all(_name(t.dtype) == index_dtype for t in tm)
    assert str(jm.dtype) == index_dtype
    np.testing.assert_array_equal(_bits(torch.cat(tm)), _bits(jm))
    np.testing.assert_array_equal(_bits(torch.cat(tsq)), _bits(jsq))
    tt, tl, jt, jl = _queries(w)
    d_j, r_j = jcorpus.make_sharded_operand_retriever(
        w.jmodel, jidx.weights, K, jmesh, topk_method="exact")(
        jm, jsq, w.jparams, jt, jl)
    _, r_jc = jcorpus.make_score_topk(w.jmodel, jidx, K, "exact",
                                      carrier_dtype=carrier)(
        w.jparams, jt, jl)
    np.testing.assert_array_equal(np.asarray(r_jc), np.asarray(r_j))
    seen = []
    real = tcorpus.corpus_topk_shards

    def spy(q, m_sh, *a, **kw):
        seen.extend(_name(t.dtype) for t in m_sh)
        return real(q, m_sh, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcorpus, "corpus_topk_shards", spy)
        outs = [
            tcorpus.make_score_topk(w.tmodel, tidx, K, "exact",
                                    mesh=tmesh)(w.tparams, tt, tl),
            [x[0] for x in tcorpus.make_stream_retriever(
                w.tmodel, tidx, K, "exact", mesh=tmesh)(
                w.tparams, tt[None], tl[None])],
            tcorpus.make_retriever(w.tmodel, tidx, K, "exact", mesh=tmesh)(
                w.tparams, tt, tl)]
    assert seen == [index_dtype] * 6
    for d_t, r_t in outs:
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **tol)


def _arena_dtypes(live):
    return {t.dtype for t in tlive._shards(live)[0]}


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("index_dtype", DTYPES)
def test_arena_keeps_index_dtype(cases, tmp_path, index_dtype, shards):
    """Build, append, remove, compact, grow, save and load: the arena's
    rows stay at the index's dtype, on one device and a 2-shard mesh; the
    snapshot's bits are the arena's."""
    w, _, _ = cases("bfloat16", index_dtype)
    mesh = make_mesh(("corpus",), devices=[CPU] * 2) if shards else None
    want = {getattr(torch, index_dtype)}
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=16,
                              index_dtype=index_dtype, mesh=mesh)
    assert _arena_dtypes(t) == want
    d = w.delta
    tlive.live_append(t, w.tparams, w.tmodel, w.tds, d.video_ids[:3],
                      d.rgb_feats[:3], d.flow_feats[:3])
    assert _arena_dtypes(t) == want
    tlive.live_remove(t, [d.video_ids[1], w.tds.video_ids[0]])
    assert _arena_dtypes(t) == want
    assert tlive.live_compact(t) == 2 * w.tds.num_proposals
    assert _arena_dtypes(t) == want
    tlive.live_grow(t, 20)
    assert _arena_dtypes(t) == want
    path = tlive.save_arena(t, str(tmp_path / "a"))
    with np.load(path) as z:
        assert str(z["m_dtype"]) == index_dtype
        stored = z["m_cat"]
    back = tlive.load_arena(path, mesh=mesh, device="cpu")
    assert _arena_dtypes(back) == want
    for live in (t, back):
        np.testing.assert_array_equal(
            _bits(torch.cat(tlive._shards(live)[0])), _bits(stored))
    d_t, r_t = tlive.make_live_retriever(w.tmodel, back, K)(
        w.tparams, torch.from_numpy(w.toks), torch.from_numpy(w.lens))
    d_o, r_o = tlive.make_live_retriever(w.tmodel, t, K)(
        w.tparams, torch.from_numpy(w.toks), torch.from_numpy(w.lens))
    np.testing.assert_array_equal(r_t.numpy(), r_o.numpy())
    np.testing.assert_array_equal(d_t.numpy(), d_o.numpy())


def test_f32_arena_under_bf16_compute_is_unrounded(cases):
    """The arena holds the index's f32 values (those of the batch
    operand), not their bf16 rounding: an f32 snapshot loses nothing."""
    w, _, _ = cases("bfloat16", "float32")
    t = tlive.make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=12)
    idx = tcorpus.build_moment_index(w.tparams, w.tmodel, w.tds,
                                     with_fingerprint=False)
    m_cat, _ = tcorpus.prep_score_operands(idx)
    assert m_cat.dtype == t.m_cat.dtype == torch.float32
    assert torch.equal(t.m_cat[:idx.num_rows], m_cat)
    assert not torch.equal(m_cat, m_cat.to(torch.bfloat16).float())


def test_score_mm_routes_by_device(monkeypatch):
    """CPU tensors: ``mm_f32``, bit for bit.  A tensor elsewhere (here the
    meta device) takes ``aten::mm.dtype`` (bf16 operands, f32 outputs) and
    never falls back: without that overload the call raises."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(5, 24, generator=g)
    b = torch.randn(24, 7, generator=g).to(torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(tsh.score_mm(a, b, dt), mm_f32(a, b, dt))
    out = tsh.score_mm(a.to("meta"), b.to("meta"), torch.bfloat16)
    assert out.device.type == "meta" and out.dtype == torch.float32
    assert out.shape == (5, 7)

    def no_overload(*args, **kw):
        raise TypeError("mm() got an unexpected keyword argument "
                        "'out_dtype'")

    monkeypatch.setattr(torch, "mm", no_overload)
    with pytest.raises(RuntimeError, match="aten::mm.dtype"):
        tsh.score_mm(a.to("meta"), b.to("meta"), torch.bfloat16)
    assert torch.equal(tsh.score_mm(a, b, torch.bfloat16),
                       mm_f32(a, b, torch.bfloat16))
