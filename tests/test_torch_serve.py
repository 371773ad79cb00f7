"""Serving through the PyTorch port against the JAX package, on the same
numpy weights, corpus and index (small widths).

``serve_queries`` must return the same moments as the JAX package for
``exact`` and ``fused`` selection, with the kernels on both sides
(``use_pallas="always"``: Pallas interpreter vs the CUDA kernels' plain
versions) and with the default policy (scan twins on the CPU); distances
within atol 1e-4.  Bucketed serving must be identical to unbucketed.  The
CLI's ``index`` + ``serve --device cpu`` run end to end in a temp dir.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vfr_tpu.config import DataConfig as JDataConfig
from vfr_tpu.config import ExperimentConfig as JExperimentConfig
from vfr_tpu.config import ModelConfig as JModelConfig
from vfr_tpu.data.didemo import DidemoDataset as JDidemoDataset
from vfr_tpu.data.synthetic import make_didemo_fixture
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.models.build import build_model as j_build_model
from vfr_tpu.models.mcn import init_model_params as j_init_model_params
from vfr_tpu_torch.bridge import params_from_numpy, save_params_npz
from vfr_tpu_torch.checkpoint import load_for_eval
from vfr_tpu_torch.cli import main as cli_main
from vfr_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
    get_preset,
)
from vfr_tpu_torch.data.didemo import DidemoDataset
from vfr_tpu_torch.eval.corpus import resolve_length_buckets, serve_queries
from vfr_tpu_torch.models.build import build_model

F, E, H, J = 24, 16, 32, 8


def _world(query_pool="mean", use_pallas="auto"):
    fix = make_didemo_fixture(num_videos=12, num_queries=48, feature_dim=F,
                              glove_dim=E, seed=7)
    kw = dict(joint_dim=J, lstm_hidden=H, stream_weights=(0.5, 0.5),
              distance="cosine", query_pool=query_pool,
              use_pallas=use_pallas)
    data = dict(feature_dim=F, glove_dim=E, use_flow=True)
    jcfg = JExperimentConfig(name="t", data=JDataConfig(**data),
                             model=JModelConfig(**kw))
    tcfg = ExperimentConfig(name="t", data=DataConfig(**data),
                            model=ModelConfig(**kw))
    jds = JDidemoDataset(fix.annotations, fix.rgb, fix.flow, fix.vocab,
                         jcfg.data)
    tds = DidemoDataset(fix.annotations, fix.rgb, fix.flow, fix.vocab,
                        tcfg.data)
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(j_init_model_params(
        jax.random.PRNGKey(4), jmodel, fix.glove, F)))
    return jmodel, tmodel, jds, tds, fix.vocab, tree


def _queries(n=19, seed=3):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{int(rng.integers(0, 200)):04d}"
                     for _ in range(1 + int(rng.integers(0, 12))))
            for _ in range(n)]


def _moments(res):
    return [[(r["video"], r["start"], r["end"]) for r in q["results"]]
            for q in res]


def _dists(res):
    return np.array([[r["distance"] for r in q["results"]] for q in res])


@pytest.mark.parametrize("use_pallas", ["always", "auto"])
@pytest.mark.parametrize("topk_method", ["exact", "fused"])
def test_serve_matches_jax(use_pallas, topk_method):
    jmodel, tmodel, jds, tds, vocab, tree = _world(use_pallas=use_pallas)
    qs = _queries()
    kw = dict(k=5, batch_size=8, max_query_len=12, topk_method=topk_method)
    ref = jcorpus.serve_queries(jax.tree.map(jnp.asarray, tree), jmodel, jds,
                                vocab, qs, **kw)
    got = serve_queries(params_from_numpy(tree), tmodel, tds, vocab, qs, **kw)
    assert [q["query"] for q in got] == qs
    assert _moments(got) == _moments(ref)
    np.testing.assert_allclose(_dists(got), _dists(ref), atol=1e-4)


@pytest.mark.parametrize("query_pool", ["last", "mean"])
def test_bucketed_identical_to_unbucketed(query_pool):
    _, tmodel, _, tds, vocab, tree = _world(query_pool, use_pallas="always")
    params = params_from_numpy(tree)
    qs = _queries(23, seed=9)
    kw = dict(k=4, batch_size=8, max_query_len=12)
    plain = serve_queries(params, tmodel, tds, vocab, qs, **kw)
    for spec in ("auto", "4,8"):
        assert serve_queries(params, tmodel, tds, vocab, qs,
                             length_buckets=spec, **kw) == plain


@pytest.mark.parametrize("spec,want", [
    (None, None), ("", None), ("auto", (8, 16, 24)), ("8,16", (8, 16, 24)),
    ([16, 8], (8, 16, 24)), ("8,99", (8, 24)), ("24", (24,))])
def test_resolve_length_buckets(spec, want):
    assert resolve_length_buckets(spec, 24) == want
    assert resolve_length_buckets(spec, 24) == \
        jcorpus.resolve_length_buckets(spec, 24)


def test_unported_paths_raise(tmp_path, monkeypatch, capsys):
    """--follow now serves (one record per line); --shards 2 follows the JAX
    package's rule: with one device visible it serves unsharded, and it
    raises only where the mesh would be built (the sharded path is not
    ported)."""
    import vfr_tpu_torch.cli as tcli

    _, tmodel, _, tds, vocab, tree = _world()
    with pytest.raises(NotImplementedError):
        serve_queries(params_from_numpy(tree), tmodel, tds, vocab, ["w0001"],
                      mesh=object())
    q = tmp_path / "q.txt"
    q.write_text("w0001\nw0002 w0003\n")
    assert cli_main(["serve", "--queries", str(q), "--device", "cpu",
                     "--data-dir", str(tmp_path / "none"), "--topk", "2",
                     "--follow"]) == 0
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["query"] for r in recs] == ["w0001", "w0002 w0003"]
    assert all(len(r["results"]) == 2 for r in recs)
    q.write_text("w0001\n")
    argv = ["serve", "--queries", str(q), "--device", "cpu", "--topk", "3",
            "--data-dir", str(tmp_path / "none"), "--shards", "2"]
    assert cli_main(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["query"] == "w0001" and len(rec["results"]) == 3
    monkeypatch.setattr(tcli, "_visible_devices", lambda device: 2)
    with pytest.raises(NotImplementedError, match="sharded serving"):
        cli_main(argv)


def test_cli_index_and_serve_on_cpu(tmp_path, capsys):
    q = tmp_path / "q.txt"
    q.write_text("w0001 w0002 w0003\nw0010 w0042\n")
    common = ["--preset", "didemo_rgb", "--data-dir", str(tmp_path / "none"),
              "--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu"]
    out = str(tmp_path / "idx.npz")
    assert cli_main(["index", *common, "--out", out]) == 0
    assert "moments" in capsys.readouterr().out
    assert cli_main(["serve", *common, "--index-path", out, "--queries",
                     str(q), "--topk", "3", "--length-buckets", "auto"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(line) for line in lines]
    assert [r["query"] for r in recs] == ["w0001 w0002 w0003", "w0010 w0042"]
    for r in recs:
        d = [x["distance"] for x in r["results"]]
        assert len(d) == 3 and d == sorted(d)


def test_load_for_eval_reads_params_npz(tmp_path):
    """params.npz in the checkpoint dir is served; its EMA tree when the
    stored train config has ema_decay > 0."""
    _, tmodel, _, _, _, tree = _world()
    cfg = get_preset("didemo_rgb")
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, data_dir=str(tmp_path / "none"), feature_dim=F,
        glove_dim=E, use_flow=True),
        model=tmodel.cfg,
        train=TrainConfig(checkpoint_dir=str(tmp_path), ema_decay=0.9))
    ema = jax.tree.map(lambda a: a + 1.0, tree)
    save_params_npz(str(tmp_path / "params.npz"), tree,
                    config_json=cfg.to_json(), ema=ema)
    params, model, _ = load_for_eval(cfg, device="cpu")
    np.testing.assert_array_equal(params["query_proj"]["w"].numpy(),
                                  ema["query_proj"]["w"])
    seeded, _, _ = load_for_eval(cfg.replace(
        train=TrainConfig(checkpoint_dir=str(tmp_path / "empty"))),
        device="cpu")
    assert seeded["lstm"]["layer0"]["w_hh"].shape == (H, 4 * H)
    with pytest.raises(FileNotFoundError):
        load_for_eval(cfg, prefer_best=True, device="cpu")
