"""Corpus eval through the PyTorch port against the JAX package's, on the
same numpy weights, fixture and EvalConfig (F=32, H=24, joint 24).

* ``build_moment_index`` on Charades-STA: rows within atol 1e-5, the 1e30
  sentinel on exactly the rows outside each video's window mask, the same
  spans; from device banks as from host arrays.
* ``corpus_retrieval`` / ``make_retriever`` on Charades-STA (exact and
  fused): no invalid window is ever retrieved.
* ``make_gt_ranker``: equal ranks, including exact ties made by
  duplicating index rows.
* ``corpus_evaluate``: equal metric dicts for DiDeMo (exact, fused, coarse
  blockmax; threshold and official protocols) and Charades-STA (exact,
  fused), after checking the fixture has no near-tie (a gap > 1e-5 at every
  top-k boundary and around every GT row).
* ``cli corpus --device cpu`` prints the keys the JAX package's CLI prints;
  ``--shards`` follows the JAX package's rule (sharded where N devices are
  visible, with the unsharded metrics).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.parallel.sharding import fused_corpus_distances as j_distances
from vfr_tpu_torch.data.features import banks_to_device
from vfr_tpu_torch.eval import corpus as tcorpus

from test_torch_eval import run_both_clis
from torch_eval_world import charades_world, didemo_world, min_gap


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name, world in (("didemo", didemo_world()),
                        ("charades", charades_world())):
        out[name] = dict(
            world=world,
            jindex=jcorpus.build_moment_index(world.jparams, world.jmodel,
                                              world.jds),
            tindex=tcorpus.build_moment_index(world.tparams, world.tmodel,
                                              world.tds))
    return out


def _batch(world, n=20):
    b = next(world.tds.eval_batches(n, with_features=False))
    return b["tokens"], b["lengths"]


def test_charades_index_matches_jax(worlds):
    w = worlds["charades"]
    ji, ti, ds = w["jindex"], w["tindex"], w["world"].tds
    np.testing.assert_allclose(ti.m.numpy(), np.asarray(ji.m), atol=1e-5)
    invalid = ~ds.window_mask.reshape(-1)
    assert invalid.any()
    sentinel = np.float32(1e30)
    np.testing.assert_array_equal(ti.m_sq.numpy()[:, invalid], sentinel)
    np.testing.assert_array_equal(np.asarray(ji.m_sq)[:, invalid], sentinel)
    np.testing.assert_allclose(ti.m_sq.numpy()[:, ~invalid],
                               np.asarray(ji.m_sq)[:, ~invalid], atol=1e-5)
    for key in ("video_row", "prop_idx", "spans_sec"):
        np.testing.assert_array_equal(getattr(ti, key), getattr(ji, key))
    assert ti.fingerprint == ji.fingerprint


@pytest.mark.parametrize("name", ["didemo", "charades"])
def test_index_from_device_banks(worlds, name):
    world = worlds[name]["world"]
    banks = dict(world.tds.feature_banks())
    if name == "charades":
        banks["video_tef"] = world.tds.video_tef
    banks = banks_to_device(banks, device="cpu")
    got = tcorpus.build_moment_index(world.tparams, world.tmodel, world.tds,
                                     batch_size=5, feature_banks=banks)
    want = worlds[name]["tindex"]
    np.testing.assert_allclose(got.m.numpy(), want.m.numpy(), atol=1e-6)
    np.testing.assert_array_equal(got.m_sq.numpy() == 1e30,
                                  want.m_sq.numpy() == 1e30)


@pytest.mark.parametrize("topk_method,k", [("exact", 20), ("fused", 20),
                                           ("exact", 100), ("fused", 100)])
def test_invalid_windows_never_retrieved(worlds, topk_method, k):
    """k up to the corpus' count of valid windows (134 of 768 rows)."""
    w = worlds["charades"]
    world, ti = w["world"], w["tindex"]
    assert k <= world.tds.window_mask.sum()
    toks, lens = _batch(world)
    d, rows = tcorpus.corpus_retrieval(world.tparams, world.tmodel, ti, toks,
                                       lens, k=k, topk_method=topk_method)
    assert np.isfinite(d).all() and (d < 1e29).all()
    assert world.tds.window_mask.reshape(-1)[rows.reshape(-1)].all()
    if k == 20:
        _, rj = jcorpus.corpus_retrieval(world.jparams, world.jmodel,
                                         w["jindex"], toks, lens, k=k,
                                         topk_method=topk_method)
        np.testing.assert_array_equal(rows, np.asarray(rj))


def _dup_index(w, dups):
    """The world's DiDeMo index (numpy) with rows ``dst`` set to rows
    ``src`` for each (src, dst) of ``dups``: exact ties."""
    ji = w["jindex"]
    m, m_sq = np.asarray(ji.m).copy(), np.asarray(ji.m_sq).copy()
    for src, dst in dups:
        m[:, dst], m_sq[:, dst] = m[:, src], m_sq[:, src]
    common = dict(video_row=ji.video_row, prop_idx=ji.prop_idx,
                  spans_sec=ji.spans_sec, weights=ji.weights)
    return (jcorpus.MomentIndex(m=jnp.asarray(m), m_sq=jnp.asarray(m_sq),
                                **common),
            tcorpus.MomentIndex(m=torch.from_numpy(m),
                                m_sq=torch.from_numpy(m_sq), **common))


@pytest.mark.parametrize("rnn_kernel", ["scan", "pallas"])
def test_gt_ranker_matches_jax_with_exact_ties(worlds, rnn_kernel):
    w = worlds["didemo"]
    world = w["world"]
    N = w["tindex"].num_rows
    # rows 3, 17 and 200 are one row three times; 40/41 and 7/8 twins
    dups = [(3, 200), (200, 17), (40, 41), (100, 250), (7, 8)]
    jidx, tidx = _dup_index(w, dups)
    toks, lens = _batch(world)
    rng = np.random.default_rng(0)
    gt = rng.integers(0, N, size=(len(toks), 4))
    gt[:, :2] = (200, 17)
    gt[0], gt[1] = (7, 8, 40, 41), (200, 17, 3, 250)
    ref = np.asarray(jcorpus.make_gt_ranker(world.jmodel, jidx, rnn_kernel)(
        world.jparams, jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(gt.astype(np.int32))))
    got = tcorpus.make_gt_ranker(world.tmodel, tidx, rnn_kernel)(
        world.tparams, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(gt)).numpy()
    np.testing.assert_array_equal(got, ref)
    # a copy ranks right after the copies on lower rows (the stable order)
    assert got[0, 1] == got[0, 0] + 1 and got[0, 3] == got[0, 2] + 1
    assert got[1, 1] == got[1, 2] + 1 and got[1, 0] == got[1, 2] + 2


def _corpus_gaps(w, ecfg):
    """Smallest gap at the top-k boundaries (recall ks and kmax) of every
    query's corpus distances, and around every query's GT rows."""
    world, ji = w["world"], w["jindex"]
    ks = tuple(ecfg.recall_ks) + (max(max(ecfg.recall_ks), 10),)
    topk_gap, gt_gap = np.inf, np.inf
    P = world.tds.num_proposals
    for b in world.jds.eval_batches(ecfg.corpus_query_batch, False):
        qs = jcorpus._embed_query_streams(
            world.jparams, world.jmodel, jnp.asarray(b["tokens"]),
            jnp.asarray(b["lengths"]), ecfg.rnn_kernel)
        D = np.asarray(j_distances(qs, ji.m, ji.m_sq,
                                   jnp.asarray(ji.weights)))
        topk_gap = min(topk_gap, min_gap(D, ks))
        for q, gp in enumerate(b.get("gt_prop_idx", [])):
            for g in b["video_idx"][q] * P + gp[gp >= 0]:
                diff = np.abs(np.delete(D[q], g) - D[q, g])
                gt_gap = min(gt_gap, float(diff.min()))
    return topk_gap, gt_gap


@pytest.mark.parametrize("name", ["didemo", "charades"])
@pytest.mark.parametrize("rnn_kernel", ["scan", "pallas"])
def test_corpus_fixture_has_no_near_tie(worlds, name, rnn_kernel):
    je, _ = worlds[name]["world"].ecfgs(protocol="didemo_official",
                                        rnn_kernel=rnn_kernel)
    topk_gap, gt_gap = _corpus_gaps(worlds[name], je)
    assert topk_gap > 1e-5
    assert gt_gap > 1e-5


@pytest.mark.parametrize("name,protocol,kw", [
    ("didemo", "threshold", dict(topk_method="exact")),
    ("didemo", "didemo_official", dict(topk_method="exact")),
    ("didemo", "didemo_official", dict(topk_method="fused")),
    ("didemo", "didemo_official", dict(coarse_dim=8)),
    ("didemo", "threshold", dict(coarse_dim=8, coarse_candidates=256)),
    ("didemo", "threshold", dict(topk_method="exact",
                                 corpus_num_videos=7)),
    ("charades", "threshold", dict(topk_method="exact")),
    ("charades", "didemo_official", dict(topk_method="fused")),
])
def test_corpus_evaluate_matches_jax(worlds, name, protocol, kw):
    world = worlds[name]["world"]
    je, te = world.ecfgs(protocol=protocol, **kw)
    ref = jcorpus.corpus_evaluate(world.jparams, world.jmodel, world.jds, je)
    got = tcorpus.corpus_evaluate(world.tparams, world.tmodel, world.tds, te)
    assert got == ref
    assert got["num_queries"] == world.tds.num_queries


def test_corpus_evaluate_kernel_path_matches_scan(worlds):
    """rnn_kernel="pallas" (the kernel's plain version on the CPU) through
    the fused retriever: the JAX package's Pallas path gives the same."""
    world = worlds["didemo"]["world"]
    je, te = world.ecfgs(protocol="didemo_official", topk_method="fused",
                         rnn_kernel="pallas")
    ref = jcorpus.corpus_evaluate(world.jparams, world.jmodel, world.jds, je)
    got = tcorpus.corpus_evaluate(world.tparams, world.tmodel, world.tds, te)
    assert got == ref


def test_mesh_paths_raise(worlds):
    """The mesh paths no longer raise: on a two-shard CPU mesh the sharded
    GT ranker returns the single-device ranks and ``corpus_evaluate`` the
    single-device metrics (its JAX parity is in
    ``test_torch_sharded_serve.py``)."""
    from vfr_tpu_torch.parallel.mesh import make_mesh

    world = worlds["didemo"]["world"]
    tindex = worlds["didemo"]["tindex"]
    _, te = world.ecfgs(protocol="didemo_official")
    mesh = make_mesh(("corpus",), devices=[torch.device("cpu")] * 2)
    assert tcorpus.corpus_evaluate(world.tparams, world.tmodel, world.tds,
                                   te, mesh=mesh) == \
        tcorpus.corpus_evaluate(world.tparams, world.tmodel, world.tds, te)
    toks, lens = (torch.from_numpy(x) for x in _batch(world))
    gt = torch.randint(0, tindex.num_rows, (toks.shape[0], 3),
                       generator=torch.Generator().manual_seed(0))
    args = (world.tparams, toks, lens, gt)
    assert torch.equal(
        tcorpus.make_gt_ranker(world.tmodel, tindex, mesh=mesh)(*args),
        tcorpus.make_gt_ranker(world.tmodel, tindex)(*args))


@pytest.mark.parametrize("preset,extra", [
    ("didemo_flagship", ["--num-videos", "5"]),
    ("charades_sta", ["--topk-method", "fused"]),
    ("didemo_flagship", ["--coarse-dim", "8", "--coarse-mode", "centroid"])])
def test_cli_corpus_keys_match_jax(monkeypatch, capsys, tmp_path, preset,
                                   extra):
    ref, got = run_both_clis(monkeypatch, capsys, tmp_path,
                             ["corpus", "--preset", preset, *extra])
    assert list(got) == list(ref)
    assert got["corpus_num_rows"] == ref["corpus_num_rows"]
    assert got["num_queries"] == ref["num_queries"]


def test_cli_corpus_shards_rule(monkeypatch, capsys, tmp_path):
    """corpus_didemo asks for 8 shards: with one device visible it runs
    unsharded, as the JAX package does on one chip; where 8 are visible
    it runs sharded over an 8-device mesh (here CPU devices), with the
    same metrics."""
    import ast

    import vfr_tpu_torch.cli as tcli

    from test_torch_eval import narrow

    monkeypatch.setattr(tcli, "get_preset", lambda name: narrow(
        tcli.PRESETS[name], str(tmp_path / "nodata")))
    argv = ["corpus", "--preset", "corpus_didemo", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck")]

    def metrics(*extra):
        assert tcli.main([*argv, *extra]) == 0
        return ast.literal_eval(capsys.readouterr().out.strip())

    plain = metrics()
    assert "corpus_video_R@1" in plain
    monkeypatch.setattr(tcli, "_visible_devices", lambda device: 8)
    monkeypatch.setattr(tcli, "_devices",
                        lambda device: [torch.device("cpu")] * 8)
    built = []
    real = tcli._corpus_mesh
    monkeypatch.setattr(tcli, "_corpus_mesh", lambda cfg, args: built.append(
        real(cfg, args)) or built[-1])
    assert metrics() == plain
    assert built[0].shape == {"corpus": 8}
    assert metrics("--shards", "1") == plain and built[1] is None
