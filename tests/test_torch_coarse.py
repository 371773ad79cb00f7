"""Coarse-to-fine retrieval in the PyTorch port against the JAX package's
``eval/coarse.py``, on one shared index (the JAX build, loaded bit-exact
into the port) and the same numpy weights (small widths).

* ``build_coarse_index``: the PCA basis agrees column by column up to sign
  (atol 1e-4: f32 second moments summed in another order, then the same
  f64 ``eigh``); with an f32 store, msq and the centroids agree at atol
  1e-4; with a bf16 store at atol 5e-3 (a projected value a few f32 ulps
  off can round to the neighbouring bf16, ~2^-8 relative); ``perm`` and the
  stage-2 blocks are identical with ``reorder=False``.
* Coarse files cross between the packages bit for bit, both ways.
* ``make_coarse_retriever`` (blockmax and centroid) on one coarse file:
  rows equal outside near-ties, distances within atol 1e-4.
* ``make_coarse_score_topk`` / ``make_coarse_stream_retriever`` take the
  JAX signature's ``approx_recall`` and give the same answer.
* Full rank (d_coarse = D, f32 store, every block gathered) equals the
  port's exact retriever.
* ``serve_queries(coarse=...)`` returns the JAX package's moments; the CLI
  runs ``index --coarse-dim`` + ``serve --coarse-path`` on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.config import DataConfig as JDataConfig
from vfr_tpu.config import ExperimentConfig as JExperimentConfig
from vfr_tpu.config import ModelConfig as JModelConfig
from vfr_tpu.data.didemo import DidemoDataset as JDidemoDataset
from vfr_tpu.data.synthetic import make_didemo_fixture
from vfr_tpu.eval import coarse as jcoarse
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.models.build import build_model as j_build_model
from vfr_tpu.models.mcn import init_model_params as j_init_model_params
from vfr_tpu_torch.bridge import params_from_numpy
from vfr_tpu_torch.cli import main as cli_main
from vfr_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
from vfr_tpu_torch.data.didemo import DidemoDataset
from vfr_tpu_torch.eval import coarse as tcoarse
from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.models.build import build_model

F, E, H, J = 24, 16, 24, 16          # D = 2 streams x 16 = 32
D_C, C, K = 8, 256, 10


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    fix = make_didemo_fixture(num_videos=48, num_queries=64, feature_dim=F,
                              glove_dim=E, seed=3)
    kw = dict(joint_dim=J, lstm_hidden=H, stream_weights=(0.5, 0.5),
              distance="cosine", query_pool="mean")
    data = dict(feature_dim=F, glove_dim=E, use_flow=True)
    jcfg = JExperimentConfig(name="c", data=JDataConfig(**data),
                             model=JModelConfig(**kw))
    tcfg = ExperimentConfig(name="c", data=DataConfig(**data),
                            model=ModelConfig(**kw))
    jds = JDidemoDataset(fix.annotations, fix.rgb, fix.flow, fix.vocab,
                         jcfg.data)
    tds = DidemoDataset(fix.annotations, fix.rgb, fix.flow, fix.vocab,
                        tcfg.data)
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(j_init_model_params(
        jax.random.PRNGKey(0), jmodel, fix.glove, F)))
    jparams = jax.tree.map(jnp.asarray, tree)
    jidx = jcorpus.build_moment_index(jparams, jmodel, jds)
    d = tmp_path_factory.mktemp("coarse")
    tidx = tcorpus.load_index(jcorpus.save_index(jidx, str(d / "idx")),
                              device="cpu")
    batch = next(jds.eval_batches(16))
    return dict(jmodel=jmodel, tmodel=tmodel, jds=jds, tds=tds,
                vocab=fix.vocab, jparams=jparams,
                tparams=params_from_numpy(tree), jidx=jidx, tidx=tidx,
                toks=batch["tokens"], lens=batch["lengths"], dir=d)


def _signs(a, b):
    s = np.sign((a * b).sum(0))
    s[s == 0] = 1.0
    return s


@pytest.mark.parametrize("store,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
def test_build_matches_jax(world, store, tol):
    jc = jcoarse.build_coarse_index(world["jidx"], d_coarse=D_C,
                                    store_dtype=jnp.dtype(store),
                                    reorder=False)
    tc = tcoarse.build_coarse_index(world["tidx"], d_coarse=D_C,
                                    store_dtype=getattr(torch, store),
                                    reorder=False)
    jp, tp = np.asarray(jc.proj), tc.proj.numpy()
    assert tp.shape == jp.shape == (2 * J, D_C)
    sign = _signs(jp, tp)
    np.testing.assert_allclose(tp * sign, jp, atol=1e-4)
    assert tc.m_low.dtype == getattr(torch, store)
    np.testing.assert_allclose(tc.m_low.float().numpy() * sign,
                               np.asarray(jc.m_low.astype(jnp.float32)),
                               atol=tol)
    np.testing.assert_allclose(tc.msq_low.numpy(), np.asarray(jc.msq_low),
                               atol=tol)
    np.testing.assert_allclose(tc.c_low.numpy() * sign,
                               np.asarray(jc.c_low), atol=tol)
    np.testing.assert_allclose(tc.csq.numpy(), np.asarray(jc.csq), atol=tol)
    np.testing.assert_array_equal(tc.perm.numpy(), np.asarray(jc.perm))
    np.testing.assert_array_equal(tc.m_blk.numpy(), np.asarray(jc.m_blk))
    np.testing.assert_array_equal(tc.msq_blk.numpy(), np.asarray(jc.msq_blk))
    assert (tc.n_rows, tc.block_rows, tc.num_blocks) == \
        (jc.n_rows, jc.block_rows, jc.num_blocks)


def _bits(a):
    """The bit pattern of a bf16 array of either package, as int16."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def test_coarse_file_crosses_bit_exact(world):
    jc = jcoarse.build_coarse_index(world["jidx"], d_coarse=D_C)
    path = jcoarse.save_coarse(jc, str(world["dir"] / "j.coarse"))
    tc = tcoarse.load_coarse(path, world["tidx"])
    assert tc.m_low.dtype == torch.bfloat16
    assert np.array_equal(_bits(tc.m_low), _bits(jc.m_low))
    for name in ("proj", "msq_low", "c_low", "csq", "perm", "m_blk",
                 "msq_blk"):
        assert np.array_equal(getattr(tc, name).numpy(),
                              np.asarray(getattr(jc, name))), name
    back = jcoarse.load_coarse(
        tcoarse.save_coarse(tc, str(world["dir"] / "t.coarse")),
        world["jidx"])
    assert np.array_equal(_bits(back.m_low), _bits(jc.m_low))
    for name in ("proj", "msq_low", "c_low", "csq", "perm"):
        assert np.array_equal(np.asarray(getattr(back, name)),
                              np.asarray(getattr(jc, name))), name
    assert (back.n_rows, back.block_rows) == (jc.n_rows, jc.block_rows)
    with pytest.raises(ValueError, match="different corpus"):
        small = tcorpus.MomentIndex(
            m=world["tidx"].m[:, :100], m_sq=world["tidx"].m_sq[:, :100],
            video_row=world["tidx"].video_row[:100],
            prop_idx=world["tidx"].prop_idx[:100],
            spans_sec=world["tidx"].spans_sec[:100],
            weights=world["tidx"].weights)
        tcoarse.load_coarse(path, small)


def _shared_coarse(world):
    jc = jcoarse.build_coarse_index(world["jidx"], d_coarse=D_C)
    path = jcoarse.save_coarse(jc, str(world["dir"] / "shared.coarse"))
    return jc, tcoarse.load_coarse(path, world["tidx"])


def _rows_equal_outside_ties(r_t, r_j, d_j, tol=1e-4):
    for rt, rj, dj in zip(r_t, r_j, d_j):
        for i in np.nonzero(rt != rj)[0]:
            near = [abs(dj[i] - dj[n]) for n in (i - 1, i + 1)
                    if 0 <= n < len(dj)]
            assert near and min(near) <= 2 * tol, (i, rt, rj, dj)


@pytest.mark.parametrize("mode", ["blockmax", "centroid"])
def test_retriever_matches_jax(world, mode):
    jc, tc = _shared_coarse(world)
    d_j, r_j = jcoarse.make_coarse_retriever(
        world["jmodel"], jc, K, num_candidates=C, mode=mode)(
            world["jparams"], jnp.asarray(world["toks"]),
            jnp.asarray(world["lens"]))
    d_t, r_t = tcoarse.make_coarse_retriever(
        world["tmodel"], tc, K, num_candidates=C, mode=mode)(
            world["tparams"], torch.from_numpy(world["toks"]),
            torch.from_numpy(world["lens"]))
    assert d_t.shape == r_t.shape == (16, K)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4)
    _rows_equal_outside_ties(r_t.numpy(), np.asarray(r_j), np.asarray(d_j))


@pytest.mark.parametrize("mode", ["blockmax", "centroid"])
def test_score_topk_and_stream_take_approx_recall(world, mode):
    """``make_coarse_score_topk`` / ``make_coarse_stream_retriever`` with
    the JAX signature (``approx_recall`` fifth, positional): the JAX
    package's answer, and the port's ``make_coarse_retriever``'s."""
    jc, tc = _shared_coarse(world)
    jt, jl = jnp.asarray(world["toks"]), jnp.asarray(world["lens"])
    tt, tl = torch.from_numpy(world["toks"]), torch.from_numpy(world["lens"])
    d_j, r_j = jcoarse.make_coarse_score_topk(
        world["jmodel"], jc, K, C, 0.9, mode=mode)(world["jparams"], jt, jl)
    d_t, r_t = tcoarse.make_coarse_score_topk(
        world["tmodel"], tc, K, C, 0.9, mode=mode)(world["tparams"], tt, tl)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4)
    _rows_equal_outside_ties(r_t.numpy(), np.asarray(r_j), np.asarray(d_j))
    d_s, r_s = tcoarse.make_coarse_stream_retriever(
        world["tmodel"], tc, K, C, 0.9, mode=mode)(
            world["tparams"], torch.stack([tt, tt]), torch.stack([tl, tl]))
    d_js, r_js = jcoarse.make_coarse_stream_retriever(
        world["jmodel"], jc, K, C, 0.9, mode=mode)(
            world["jparams"], jnp.stack([jt, jt]), jnp.stack([jl, jl]))
    for b in range(2):
        np.testing.assert_allclose(d_s[b].numpy(), np.asarray(d_js[b]),
                                   atol=1e-4)
        _rows_equal_outside_ties(r_s[b].numpy(), np.asarray(r_js[b]),
                                 np.asarray(d_js[b]))
        np.testing.assert_array_equal(r_s[b].numpy(), r_t.numpy())
    d_r, r_r = tcoarse.make_coarse_retriever(
        world["tmodel"], tc, K, C, 0.9, mode=mode)(world["tparams"], tt, tl)
    np.testing.assert_array_equal(r_r.numpy(), r_t.numpy())
    np.testing.assert_array_equal(d_r.numpy(), d_t.numpy())


@pytest.mark.parametrize("mode,cands", [("blockmax", 1), ("centroid", 8)])
def test_full_rank_equals_exact_retriever(world, mode, cands):
    """d_coarse = D with an f32 store and every block gathered: the
    two-stage result is the exact retriever's."""
    tidx = world["tidx"]
    tc = tcoarse.build_coarse_index(tidx, d_coarse=2 * J,
                                    store_dtype=torch.float32)
    toks = torch.from_numpy(world["toks"])
    lens = torch.from_numpy(world["lens"])
    d_e, r_e = tcorpus.make_retriever(world["tmodel"], tidx, K)(
        world["tparams"], toks, lens)
    d_c, r_c = tcoarse.make_coarse_retriever(
        world["tmodel"], tc, K, num_candidates=cands * tidx.num_rows,
        mode=mode)(world["tparams"], toks, lens)
    np.testing.assert_allclose(np.sort(d_c.numpy(), 1),
                               np.sort(d_e.numpy(), 1), rtol=1e-4, atol=1e-4)
    assert (np.sort(r_c.numpy(), 1) == np.sort(r_e.numpy(), 1)).mean() > 0.99


def _queries(n=19, seed=3):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{int(rng.integers(0, 200)):04d}"
                     for _ in range(1 + int(rng.integers(0, 12))))
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["blockmax", "centroid"])
def test_serve_coarse_matches_jax(world, mode):
    jc, tc = _shared_coarse(world)
    qs = _queries()
    kw = dict(k=5, batch_size=8, max_query_len=12, coarse_candidates=C,
              coarse_mode=mode)
    ref = jcorpus.serve_queries(world["jparams"], world["jmodel"],
                                world["jds"], world["vocab"], qs,
                                index=world["jidx"], coarse=jc, **kw)
    got = tcorpus.serve_queries(world["tparams"], world["tmodel"],
                                world["tds"], world["vocab"], qs,
                                index=world["tidx"], coarse=tc, **kw)
    assert [q["query"] for q in got] == qs
    assert [[(r["video"], r["start"], r["end"]) for r in q["results"]]
            for q in got] == \
        [[(r["video"], r["start"], r["end"]) for r in q["results"]]
         for q in ref]
    np.testing.assert_allclose(
        [[r["distance"] for r in q["results"]] for q in got],
        [[r["distance"] for r in q["results"]] for q in ref], atol=1e-4)


def test_serve_coarse_dim_builds_in_process(world):
    """coarse_dim > 0 is the same as passing the prefilter built from the
    same index; coarse takes precedence over topk_method."""
    qs = _queries(11, seed=5)
    kw = dict(k=5, batch_size=8, max_query_len=12, coarse_candidates=C,
              index=world["tidx"])
    built = tcoarse.build_coarse_index(world["tidx"], d_coarse=D_C)
    a = tcorpus.serve_queries(world["tparams"], world["tmodel"], world["tds"],
                              world["vocab"], qs, coarse_dim=D_C, **kw)
    b = tcorpus.serve_queries(world["tparams"], world["tmodel"], world["tds"],
                              world["vocab"], qs, coarse=built,
                              topk_method="fused", **kw)
    assert a == b


def test_cli_coarse_index_and_serve_on_cpu(tmp_path, capsys):
    q = tmp_path / "q.txt"
    q.write_text("w0001 w0002 w0003\nw0010 w0042\n")
    common = ["--preset", "didemo_rgb", "--data-dir", str(tmp_path / "none"),
              "--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu"]
    out = str(tmp_path / "idx.npz")
    assert cli_main(["index", *common, "--out", out, "--coarse-dim", "8"]) == 0
    assert "coarse prefilter rank 8" in capsys.readouterr().out
    cpath = str(tmp_path / "idx.coarse.npz")
    runs = (["--coarse-path", cpath, "--coarse-mode", "blockmax"],
            ["--coarse-path", cpath, "--coarse-mode", "centroid",
             "--coarse-candidates", "512"],
            ["--coarse-dim", "8"])
    for extra in runs:
        assert cli_main(["serve", *common, "--index-path", out, "--queries",
                         str(q), "--topk", "3", *extra]) == 0
        recs = [json.loads(line) for line in
                capsys.readouterr().out.strip().splitlines()]
        assert [r["query"] for r in recs] == ["w0001 w0002 w0003",
                                              "w0010 w0042"]
        for r in recs:
            d = [x["distance"] for x in r["results"]]
            assert len(d) == 3 and d == sorted(d)
    assert cli_main(["serve", *common, "--queries", str(q),
                     "--coarse-path", cpath]) == 2
    assert "--coarse-path needs --index-path" in capsys.readouterr().err
