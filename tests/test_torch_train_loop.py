"""The training loop, checkpoints and ``cli train`` of the PyTorch port.

* Against the JAX package's ``train/loop.py::train`` on the same fixture,
  config and initial weights (the port's ``init_train_params`` patched to
  return the JAX init through ``bridge.params_from_numpy``): a 2-epoch
  InfoNCE loop with hard-negative mining from epoch 1 and EMA gives the
  same eval metric dict (DiDeMo; Charades-STA, mined through the
  ``video_tef`` bank); the mined pairs, the logged losses (rtol 1e-4) and
  the final EMA tree (rtol 1e-4, atol 1e-6) agree too.
* Resume: a run stopped after epoch 0 and resumed ends bit-identical to
  the uninterrupted run (params, EMA, optimizer state; query dropout on,
  its masks depend on (seed, absolute step) only); a mid-epoch checkpoint
  resumes at its step and replays only the epoch's unseen tail.
* Retention keeps the newest ``keep`` step checkpoints; ``best.npz`` sits
  outside it and holds the running best; a torn metrics line is skipped
  on resume; an unknown ``best_metric`` fails before training.
* ``cli train --device cpu`` writes what ``cli eval|corpus|serve
  --checkpoint-dir`` open (``--best``: ``best.npz``), serving the EMA
  tree; without ``--device cpu`` and no CUDA it raises; ``--data-parallel``
  with one device visible warns and trains on it (the same records as
  without the flag), and ``train(mesh=)`` runs on a two-device CPU mesh
  (held to the JAX package's in ``test_torch_dp_train.py``).
"""

import ast
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from vfr_tpu.config import get_preset as j_get_preset
from vfr_tpu.train import loop as jloop
from vfr_tpu_torch.bridge import params_from_numpy
from vfr_tpu_torch.config import get_preset
from vfr_tpu_torch.train import checkpoint as tckpt
from vfr_tpu_torch.train import loop as tloop
from vfr_tpu_torch.utils.logging import MetricsLogger
from vfr_tpu_torch.utils.tree import flatten

from test_torch_eval import narrow


def _cfg(get, tmp_path, preset="didemo_flagship", epochs=2, **train_kw):
    cfg = narrow(get(preset), str(tmp_path / "nodata"))
    data = dataclasses.replace(cfg.data, synthetic_num_videos=12,
                               synthetic_num_queries=48)
    tkw = dict(num_epochs=epochs, batch_size=12, learning_rate=3e-3,
               hard_negative_count=3, hard_negative_start_epoch=1,
               ema_decay=0.9, steps_per_call=2, seed=5,
               checkpoint_dir=str(tmp_path / "ck"))
    tkw.update(train_kw)
    return dataclasses.replace(
        cfg, data=data, train=dataclasses.replace(cfg.train, **tkw),
        eval=dataclasses.replace(cfg.eval, eval_batch_size=16,
                                 corpus_query_batch=16))


def _jax_init(monkeypatch, holder):
    """Patch the port's init to the JAX package's draws for the same run."""
    def init(generator, model, glove, feature_dim, tcfg, device="cpu"):
        tree = jax.tree.map(np.asarray, jax.device_get(
            jloop.init_train_params(jax.random.PRNGKey(tcfg.seed),
                                    holder["jmodel"], glove, feature_dim,
                                    holder["jtcfg"])))
        return params_from_numpy(tree, device)
    monkeypatch.setattr(tloop, "init_train_params", init)


def _records(path, tag):
    out = []
    for line in open(path):
        try:
            r = json.loads(line)
        except ValueError:
            continue                    # a torn line
        if r["tag"] == tag:
            out.append(r)
    return out


@pytest.mark.parametrize("preset,kw", [
    ("didemo_flagship", {}),
    ("charades_flagship", {}),
    ("didemo_flagship", dict(temperature_final=0.03)),
    ("didemo_flagship", dict(learn_temperature=True, optimizer="adamw",
                             weight_decay=0.01, grad_clip_norm=5.0,
                             lr_schedule="cosine", warmup_steps=2))],
    ids=["didemo", "charades", "annealed_tau", "learned_tau_adamw"])
def test_two_epoch_mined_ema_loop_matches_jax(monkeypatch, tmp_path, preset,
                                              kw):
    from vfr_tpu.data.loaders import load_datasets as j_load
    from vfr_tpu.models.build import build_model as j_build

    jcfg = _cfg(j_get_preset, tmp_path / "j", preset, **kw)
    tcfg = _cfg(get_preset, tmp_path / "t", preset, **kw)
    jbundle = j_load(jcfg.data)
    holder = {"jmodel": j_build(jcfg, dataset=jbundle.train),
              "jtcfg": jcfg.train}
    _jax_init(monkeypatch, holder)
    mined = {}
    import vfr_tpu.train.hard_negatives as jhn
    j_mine = jhn.mine_hard_negatives

    def spy_j(*a, **k):
        mined["jax"] = j_mine(*a, **k)
        return mined["jax"]
    monkeypatch.setattr(jhn, "mine_hard_negatives", spy_j)
    t_mine = tloop.mine_hard_negatives

    def spy_t(*a, **k):
        mined["torch"] = t_mine(*a, **k)
        return mined["torch"]
    monkeypatch.setattr(tloop, "mine_hard_negatives", spy_t)

    jema, jmetrics = jloop.train(jcfg, bundle=jbundle)
    tema, tmetrics = tloop.train(tcfg, device="cpu")
    assert tmetrics == jmetrics
    for a, b in zip(mined["torch"], mined["jax"]):
        np.testing.assert_array_equal(a, b)
    for x, y in zip(flatten(tema)[1], jax.tree.leaves(jema)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-6)
    jl = _records(tmp_path / "j" / "ck" / "metrics.jsonl", "train")
    tl = _records(tmp_path / "t" / "ck" / "metrics.jsonl", "train")
    assert [r["step"] for r in tl] == [r["step"] for r in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        assert ("tau" in a) == ("tau" in b)
        if "tau" in a:
            np.testing.assert_allclose(a["tau"], b["tau"], rtol=1e-4)
    assert _records(tmp_path / "t" / "ck" / "metrics.jsonl", "mine")


def test_charades_train_batches_match_jax():
    from torch_eval_world import charades_world

    world = charades_world()
    for sample in (False, True):
        jb = list(world.jds.train_batches(10, 7, seed=3,
                                          sample_targets=sample,
                                          with_features=False))
        tb = list(world.tds.train_batches(10, 7, seed=3,
                                          sample_targets=sample,
                                          with_features=False))
        assert len(tb) == 7
        for a, b in zip(tb, jb):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    b = next(world.tds.train_batches(4, 1, seed=0))
    np.testing.assert_array_equal(b["rgb"],
                                  world.tds.rgb_feats[b["video_idx"]])


def _ckpt_tree(path, root):
    from vfr_tpu_torch.bridge import _unflatten

    return _unflatten(tckpt.load_payload(path), root)


def _trees_equal(a, b):
    pa, la = flatten(a)
    pb, lb = flatten(b)
    assert pa == pb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_resume_after_an_epoch_is_bit_identical(tmp_path):
    base = _cfg(get_preset, tmp_path / "a", epochs=3)
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, query_dropout=0.2))
    tloop.train(cfg, device="cpu")
    full = tckpt.latest_checkpoint(cfg.train.checkpoint_dir)
    cut = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "b")))
    tloop.train(dataclasses.replace(cut, train=dataclasses.replace(
        cut.train, num_epochs=1)), device="cpu")
    tloop.train(cut, resume=True, device="cpu")
    resumed = tckpt.latest_checkpoint(cut.train.checkpoint_dir)
    assert os.path.basename(resumed) == os.path.basename(full)
    for root in ("params", "ema", "opt_state"):
        _trees_equal(_ckpt_tree(resumed, root), _ckpt_tree(full, root))
    assert _records(os.path.join(cut.train.checkpoint_dir,
                                 "metrics.jsonl"), "resume")


def test_mid_epoch_resume_replays_only_the_tail(tmp_path):
    """A checkpoint at step spe + 2 resumes there: the loop skips the
    epoch's consumed prefix and ends at the continuous run's step count,
    having run exactly spe - 2 steps of that epoch."""
    from vfr_tpu_torch.data.loaders import load_datasets
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.train.optim import make_optimizer

    cfg = _cfg(get_preset, tmp_path, hard_negative_count=0, ema_decay=0.0,
               steps_per_call=1)
    bundle = load_datasets(cfg.data)
    spe = -(-bundle.train.num_queries // cfg.train.batch_size)
    total = spe * cfg.train.num_epochs
    model = build_model(cfg, dataset=bundle.train)
    params = tloop.init_train_params(
        torch.Generator().manual_seed(0), model, bundle.glove,
        bundle.feature_dim, cfg.train)
    opt = make_optimizer(cfg.train, total)
    tckpt.save_checkpoint(cfg.train.checkpoint_dir, spe + 2, params,
                          opt.init(params), cfg)
    tloop.train(cfg, bundle=bundle, resume=True, device="cpu")
    final = tckpt.latest_checkpoint(cfg.train.checkpoint_dir)
    assert final.endswith(f"ckpt_{total:08d}.npz")
    steps = [r["step"] for r in _records(
        os.path.join(cfg.train.checkpoint_dir, "metrics.jsonl"), "train")]
    assert steps == list(range(spe + 3, total + 1))


def test_retention_best_checkpoint_and_torn_log(tmp_path):
    cfg = _cfg(get_preset, tmp_path, epochs=4, keep_checkpoints=2,
               best_metric="R@1_tiou0.5", hard_negative_count=0)
    tloop.train(cfg, device="cpu")
    d = cfg.train.checkpoint_dir
    steps = sorted(f for f in os.listdir(d) if f.startswith("ckpt_"))
    assert len(steps) == 2 and os.path.exists(os.path.join(d, "best.npz"))
    log = os.path.join(d, "metrics.jsonl")
    best = [r["value"] for r in _records(log, "best")]
    evals = [r["R@1_tiou0.5"] for r in _records(log, "eval")]
    assert best == sorted(best) and best[-1] == max(evals)
    assert tckpt.best_checkpoint(d) == os.path.join(d, "best.npz")
    with open(log, "a") as f:
        f.write('{"tag": "best", "metric": "R@1_tiou0.5", "val')  # torn
    assert tloop._best_from_log(log, "R@1_tiou0.5") == best[-1]
    MetricsLogger(log, echo=False).close()
    assert open(log).read().endswith("\n")          # fresh line after it
    more = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=5))
    tloop.train(more, resume=True, device="cpu")
    assert len(_records(log, "resume")) == 1
    with pytest.raises(KeyError, match="best_metric"):
        tloop.train(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, best_metric="R@1_tiou0.9")), device="cpu")


def test_expected_eval_metrics_match_jax():
    for preset in ("didemo_flagship", "charades_flagship"):
        for protocol in ("threshold", "didemo_official"):
            ecfg = dataclasses.replace(get_preset(preset).eval,
                                       protocol=protocol)
            jecfg = dataclasses.replace(j_get_preset(preset).eval,
                                        protocol=protocol)
            assert tloop.expected_eval_metrics(ecfg) == \
                jloop.expected_eval_metrics(jecfg)


def test_dropout_masks_depend_on_seed_and_step_only():
    a = tloop.dropout_keep_mask(3, 17, (4, 8), 0.25)
    assert a.dtype == bool and a.shape == (4, 8)
    np.testing.assert_array_equal(a, tloop.dropout_keep_mask(3, 17, (4, 8),
                                                             0.25))
    assert not np.array_equal(a, tloop.dropout_keep_mask(3, 18, (4, 8),
                                                         0.25))
    assert not np.array_equal(a, tloop.dropout_keep_mask(4, 17, (4, 8),
                                                         0.25))
    big = tloop.dropout_keep_mask(0, 0, (200, 200), 0.25)
    assert abs(big.mean() - 0.75) < 0.01


def _narrow_cli(monkeypatch, tmp_path):
    import vfr_tpu_torch.cli as tcli

    def get(name):
        cfg = narrow(tcli.PRESETS[name], str(tmp_path / "nodata"))
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, hard_negative_start_epoch=1, hard_negative_count=3,
            batch_size=8, ema_decay=0.9))
    monkeypatch.setattr(tcli, "get_preset", get)
    return tcli


def test_cli_train_then_eval_corpus_serve(monkeypatch, capsys, tmp_path):
    tcli = _narrow_cli(monkeypatch, tmp_path)
    ck = str(tmp_path / "ck")
    common = ["--preset", "didemo_flagship", "--checkpoint-dir", ck,
              "--device", "cpu"]
    assert tcli.main(["train", *common, "--epochs", "2",
                      "--best-metric", "R@1_tiou0.5", "--eval-every", "1",
                      "--steps-per-call", "2",
                      "--trace-dir", str(tmp_path / "trace")]) == 0
    trained = ast.literal_eval(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    assert "R@1_tiou0.5" in trained
    assert os.listdir(tmp_path / "trace")
    from vfr_tpu_torch.checkpoint import load_for_eval

    cfg = tcli.apply_overrides(tcli.get_preset("didemo_flagship"),
                               tcli.build_parser().parse_args(
                                   ["eval", *common]))
    latest = tckpt.latest_checkpoint(ck)
    for best, path in ((False, latest), (True, os.path.join(ck,
                                                            "best.npz"))):
        params, _, _ = load_for_eval(cfg, prefer_best=best, device="cpu")
        _trees_equal(params, _ckpt_tree(path, "ema"))
    for extra in ([], ["--best"]):
        assert tcli.main(["corpus", *common, *extra]) == 0
        got = ast.literal_eval(capsys.readouterr().out.strip()
                               .splitlines()[-1])
        assert "corpus_video_R@1" in got
    assert tcli.main(["eval", *common]) == 0
    assert ast.literal_eval(capsys.readouterr().out.strip()
                            .splitlines()[-1]) == trained
    q = tmp_path / "q.txt"
    q.write_text("w0001 w0002\n")
    assert tcli.main(["serve", *common, "--queries", str(q), "--topk",
                      "3"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rec["results"]) == 3


def test_cli_train_refuses_missing_cuda_and_data_parallel(monkeypatch,
                                                          capsys, tmp_path):
    from vfr_tpu_torch.parallel.mesh import make_mesh

    tcli = _narrow_cli(monkeypatch, tmp_path)
    argv = ["train", "--epochs", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([*argv, "--checkpoint-dir", str(tmp_path / "ck")])
    capsys.readouterr()
    logs = {}
    for name, extra in (("plain", []), ("dp", ["--data-parallel"])):
        ck = tmp_path / name
        assert tcli.main([*argv, "--checkpoint-dir", str(ck), "--device",
                          "cpu", *extra]) == 0
        err = capsys.readouterr().err
        assert ("--data-parallel requested but only 1 device is visible"
                in err) == bool(extra)
        logs[name] = [{k: v for k, v in r.items() if k != "time"
                       and not k.endswith(("_s", "_ms", "per_sec"))}
                      for r in _records(ck / "metrics.jsonl", "train")
                      + _records(ck / "metrics.jsonl", "eval")]
    assert logs["dp"] == logs["plain"] and logs["dp"]
    cfg = _cfg(get_preset, tmp_path / "mesh", epochs=1)
    mesh = make_mesh(("data",), devices=[torch.device("cpu")] * 2)
    _, metrics = tloop.train(cfg, mesh=mesh)
    assert "R@1_tiou0.5" in metrics


def test_cli_train_overrides_match_jax():
    """The train flags map onto the same config fields as the JAX CLI's."""
    import vfr_tpu.cli as jcli
    import vfr_tpu_torch.cli as tcli

    argv = ["train", "--preset", "didemo_flagship", "--data-dir", "d",
            "--checkpoint-dir", "c", "--batch-size", "16", "--seed", "3",
            "--metrics-path", "m.jsonl", "--bank-dtype", "bfloat16",
            "--compute-dtype", "bfloat16", "--epochs", "7", "--lr", "0.01",
            "--margin", "0.3", "--loss-type", "triplet",
            "--temperature", "0.04", "--learn-temperature",
            "--temperature-final", "0.02", "--ema-decay", "0.5",
            "--hard-negatives", "4", "--hard-negative-refresh", "2",
            "--best-metric", "mIoU", "--eval-every", "3",
            "--steps-per-call", "6"]
    j = jcli.apply_overrides(jcli.get_preset("didemo_flagship"),
                             jcli.build_parser().parse_args(argv))
    t = tcli.apply_overrides(tcli.get_preset("didemo_flagship"),
                             tcli.build_parser().parse_args(argv))
    assert json.loads(t.to_json()) == json.loads(j.to_json())
