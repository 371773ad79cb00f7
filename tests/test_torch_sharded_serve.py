"""Sharded retrieval, serving and corpus eval of the port against the JAX
package's mesh paths: a port mesh of ``[cpu] * n`` against
``devices8[:n]``, n in {2, 4, 8}, on one shared index (the JAX build,
loaded bit-exact into the port) and the same numpy weights (small widths).

* ``make_retriever(mesh=)`` / ``corpus_retrieval(mesh=)``: rows equal to
  the JAX package's sharded retriever and to the port's unsharded one
  outside near-ties, distances within atol 1e-4; ``serve_queries(mesh=)``
  returns the JAX package's records; ``topk_method="fused"`` raises
  ``ValueError`` on a mesh in both packages.
* ``make_sharded_coarse_retriever`` on one coarse file (the JAX build):
  at the full quota it equals the exact retriever; at a small quota its
  rows equal the JAX package's outside near-ties.
* ``corpus_evaluate(mesh=)``: the JAX package's metric dict, equal, for
  DiDeMo (official protocol: the sharded GT ranker; exact and coarse) and
  Charades-STA, and equal to the port's unsharded dict.
* ``serve_follow(mesh=)`` over a fixed index: the JAX package's records.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_follow import assert_records_match
from torch_eval_world import charades_world, didemo_world
from vfr_tpu.eval import coarse as jcoarse
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.parallel.mesh import make_mesh as j_make_mesh
from vfr_tpu_torch.eval import coarse as tcoarse
from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
NS = [2, 4, 8]
K = 10
TOL = 1e-4


def _meshes(devices8, n):
    return (j_make_mesh(("corpus",), devices=devices8[:n]),
            make_mesh(("corpus",), devices=[CPU] * n))


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    """A DiDeMo corpus of 315 rows (3 coarse blocks of 128, padded per
    mesh), one index and one coarse file shared by both packages."""
    world = didemo_world(num_videos=40, num_queries=48)
    d = tmp_path_factory.mktemp("sharded")
    jidx = jcorpus.build_moment_index(world.jparams, world.jmodel, world.jds)
    tidx = tcorpus.load_index(jcorpus.save_index(jidx, str(d / "idx")),
                              device="cpu")
    jc = jcoarse.build_coarse_index(jidx, d_coarse=8)
    tc = tcoarse.load_coarse(jcoarse.save_coarse(jc, str(d / "idx.coarse")),
                             tidx)
    b = next(world.tds.eval_batches(16, with_features=False))
    return dict(world=world, jidx=jidx, tidx=tidx, jc=jc, tc=tc,
                toks=b["tokens"], lens=b["lengths"])


def _run(w, jfn, tfn):
    world = w["world"]
    d_j, r_j = jfn(world.jparams, jnp.asarray(w["toks"]),
                   jnp.asarray(w["lens"]))
    d_t, r_t = tfn(world.tparams, torch.from_numpy(w["toks"]),
                   torch.from_numpy(w["lens"]))
    return (np.asarray(d_j), np.asarray(r_j)), (d_t.numpy(), r_t.numpy())


def rows_equal_outside_ties(r_t, r_j, d_j, tol=TOL):
    for rt, rj, dj in zip(r_t, r_j, d_j):
        for i in np.nonzero(rt != rj)[0]:
            near = [abs(dj[i] - dj[n]) for n in (i - 1, i + 1)
                    if 0 <= n < len(dj)]
            assert near and min(near) <= 2 * tol, (i, rt, rj, dj)


@pytest.mark.parametrize("n", NS)
def test_sharded_retriever_equals_jax_and_unsharded(w, devices8, n):
    world = w["world"]
    jmesh, tmesh = _meshes(devices8, n)
    (d_j, r_j), (d_t, r_t) = _run(
        w, jcorpus.make_retriever(world.jmodel, w["jidx"], K, mesh=jmesh),
        tcorpus.make_retriever(world.tmodel, w["tidx"], K, mesh=tmesh))
    np.testing.assert_allclose(d_t, d_j, atol=TOL)
    rows_equal_outside_ties(r_t, r_j, d_j)
    d_1, r_1 = tcorpus.corpus_retrieval(world.tparams, world.tmodel,
                                        w["tidx"], w["toks"], w["lens"], K)
    d_s, r_s = tcorpus.corpus_retrieval(world.tparams, world.tmodel,
                                        w["tidx"], w["toks"], w["lens"], K,
                                        mesh=tmesh)
    np.testing.assert_allclose(d_s, d_1, atol=TOL)
    rows_equal_outside_ties(r_s, r_1, d_1)


def _queries(n=21, seed=5):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{int(rng.integers(0, 150)):04d}"
                     for _ in range(1 + int(rng.integers(0, 10))))
            for _ in range(n)]


@pytest.mark.parametrize("n", NS)
def test_serve_queries_sharded_equals_jax(w, devices8, n):
    world = w["world"]
    jmesh, tmesh = _meshes(devices8, n)
    qs = _queries()
    kw = dict(k=K, batch_size=8, max_query_len=12)
    ref = jcorpus.serve_queries(world.jparams, world.jmodel, world.jds,
                                world.vocab, qs, mesh=jmesh,
                                index=w["jidx"], **kw)
    got = tcorpus.serve_queries(world.tparams, world.tmodel, world.tds,
                                world.vocab, qs, mesh=tmesh,
                                index=w["tidx"], **kw)
    assert_records_match(got, ref)
    plain = tcorpus.serve_queries(world.tparams, world.tmodel, world.tds,
                                  world.vocab, qs, index=w["tidx"], **kw)
    assert_records_match(got, plain)


def test_fused_on_a_mesh_raises(w, devices8):
    world = w["world"]
    jmesh, tmesh = _meshes(devices8, 2)
    with pytest.raises(ValueError, match="fused"):
        jcorpus.serve_queries(world.jparams, world.jmodel, world.jds,
                              world.vocab, ["w0001"], mesh=jmesh,
                              index=w["jidx"], topk_method="fused")
    with pytest.raises(ValueError, match="fused"):
        tcorpus.serve_queries(world.tparams, world.tmodel, world.tds,
                              world.vocab, ["w0001"], mesh=tmesh,
                              index=w["tidx"], topk_method="fused")


@pytest.mark.parametrize("mode", ["blockmax", "centroid"])
@pytest.mark.parametrize("n", NS)
def test_sharded_coarse_equals_jax(w, devices8, n, mode):
    """A quota of 256 rows (2 blocks: 1 a shard) returns the JAX package's
    rows; the full quota returns the exact retriever's."""
    world = w["world"]
    jmesh, tmesh = _meshes(devices8, n)
    (d_j, r_j), (d_t, r_t) = _run(
        w, jcoarse.make_sharded_coarse_retriever(
            world.jmodel, w["jc"], K, jmesh, num_candidates=256, mode=mode),
        tcoarse.make_sharded_coarse_retriever(
            world.tmodel, w["tc"], K, tmesh, num_candidates=256, mode=mode))
    np.testing.assert_allclose(d_t, d_j, atol=TOL)
    rows_equal_outside_ties(r_t, r_j, d_j)
    assert r_t.max() < w["tidx"].num_rows
    full = tcoarse.make_sharded_coarse_retriever(
        world.tmodel, w["tc"], K, tmesh,
        num_candidates=8 * w["tidx"].num_rows, mode=mode)
    exact = tcorpus.make_retriever(world.tmodel, w["tidx"], K)
    args = (world.tparams, torch.from_numpy(w["toks"]),
            torch.from_numpy(w["lens"]))
    (d_f, r_f), (d_e, r_e) = full(*args), exact(*args)
    np.testing.assert_allclose(d_f.numpy(), d_e.numpy(), atol=TOL)
    rows_equal_outside_ties(r_f.numpy(), r_e.numpy(), d_e.numpy())


def test_pad_coarse_blocks_equals_jax(w):
    for multiple in (2, 8):
        jp = jcoarse.pad_coarse_blocks(w["jc"], multiple)
        tp = tcoarse.pad_coarse_blocks(w["tc"], multiple)
        G = w["jc"].num_blocks
        assert tp.num_blocks == jp.num_blocks == G + (-G) % multiple
        for f in ("m_low", "msq_low", "msq_blk", "c_low", "csq", "perm"):
            a = getattr(tp, f)
            a = a.float() if a.dtype == torch.bfloat16 else a
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(getattr(jp, f), np.float32
                                      if a.is_floating_point() else None))
        assert tp.m_blk.shape == jp.m_blk.shape


@pytest.mark.parametrize("name,n,extra", [
    ("didemo", 2, dict(protocol="didemo_official")),
    ("didemo", 8, dict(protocol="didemo_official")),
    ("didemo", 4, dict(protocol="didemo_official", coarse_dim=8,
                       coarse_candidates=256)),
    ("charades", 4, {})])
def test_corpus_evaluate_sharded_equals_jax(devices8, name, n, extra):
    world = didemo_world() if name == "didemo" else charades_world()
    je, te = world.ecfgs(**extra)
    jmesh, tmesh = _meshes(devices8, n)
    ref = jcorpus.corpus_evaluate(world.jparams, world.jmodel, world.jds, je,
                                  mesh=jmesh)
    got = tcorpus.corpus_evaluate(world.tparams, world.tmodel, world.tds, te,
                                  mesh=tmesh)
    assert got == ref
    if "coarse_dim" not in extra:
        assert got == tcorpus.corpus_evaluate(world.tparams, world.tmodel,
                                              world.tds, te)


@pytest.mark.parametrize("mode", ["exact", "coarse"])
def test_serve_follow_sharded_equals_jax(w, devices8, mode):
    world = w["world"]
    jmesh, tmesh = _meshes(devices8, 4)
    lines = _queries(13, seed=8)
    kw = dict(k=K, micro_batch=4, max_query_len=12)
    jkw = dict(kw, index=w["jidx"], mesh=jmesh)
    tkw = dict(kw, index=w["tidx"], mesh=tmesh)
    if mode == "coarse":
        jkw.update(coarse=w["jc"], coarse_candidates=256)
        tkw.update(coarse=w["tc"], coarse_candidates=256)
    ref = list(jcorpus.serve_follow(world.jparams, world.jmodel, world.jds,
                                    world.vocab, iter(lines), **jkw))
    got = list(tcorpus.serve_follow(world.tparams, world.tmodel, world.tds,
                                    world.vocab, iter(lines), **tkw))
    assert len(got) == len(lines)
    assert_records_match(got, ref)
