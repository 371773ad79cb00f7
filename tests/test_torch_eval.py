"""Per-video eval through the PyTorch port against the JAX package's, on the
same numpy weights, fixture and EvalConfig (F=32, H=24, joint 24).

* ``make_scorer``: the [B, P] distances within atol 1e-5 (Charades windows
  outside a video's mask are inf on both sides), through the f32 scan twin
  and through the recurrence kernel (Pallas interpreter vs the CUDA
  kernel's plain version); every value moves by less than half the
  smallest gap between neighbours, so the orders are the same.
* The fixtures have no near-tie: a gap > 1e-5 at every top-k boundary.
* ``evaluate``: equal metric dicts for DiDeMo and Charades-STA, both
  protocols, scan and kernel, and ``pooling="max"`` / the direct moment
  form; the last batch is padded, so the denominators are checked too.
* ``cli eval --device cpu`` prints the keys the JAX package's CLI prints.
"""

import ast
import dataclasses

import numpy as np
import pytest
import torch

from vfr_tpu.data.features import banks_to_device as j_banks_to_device
from vfr_tpu.eval.moment_eval import evaluate as j_evaluate
from vfr_tpu.eval.moment_eval import make_scorer as j_make_scorer
from vfr_tpu_torch.data.features import banks_to_device
from vfr_tpu_torch.eval.moment_eval import evaluate, make_scorer

from torch_eval_world import E, F, H, J, charades_world, didemo_world, min_gap


@pytest.fixture(scope="module")
def worlds():
    return {"didemo": didemo_world(), "charades": charades_world()}


def _distances(world, rnn_kernel):
    """(JAX D, port D) over every eval batch, [num_batches * B, P]."""
    je, te = world.ecfgs(rnn_kernel=rnn_kernel)
    js = j_make_scorer(world.jmodel, j_banks_to_device(
        world.jds.feature_banks()), rnn_kernel=rnn_kernel)
    ts = make_scorer(world.tmodel, banks_to_device(world.tds.feature_banks(),
                                                   device="cpu"),
                     rnn_kernel=rnn_kernel)
    jp, tp = world.jparams, world.tparams
    dj, dt = [], []
    for bj, bt in zip(world.jds.eval_batches(je.eval_batch_size, False),
                      world.tds.eval_batches(te.eval_batch_size, False)):
        dj.append(np.asarray(js(jp, bj)))
        dt.append(ts(tp, bt).numpy())
    return np.concatenate(dj), np.concatenate(dt)


@pytest.mark.parametrize("name", ["didemo", "charades"])
@pytest.mark.parametrize("rnn_kernel", ["scan", "pallas"])
def test_scorer_matches_jax(worlds, name, rnn_kernel):
    dj, dt = _distances(worlds[name], rnn_kernel)
    finite = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), finite)
    if name == "charades":
        assert not finite.all()          # masked windows score inf
        np.testing.assert_array_equal(dt[~finite], np.inf)
    diff = float(np.abs(dj[finite] - dt[finite]).max())
    assert diff <= 1e-5
    assert diff < min_gap(dj) / 2


@pytest.mark.parametrize("name", ["didemo", "charades"])
def test_fixture_has_no_near_tie(worlds, name):
    je, _ = worlds[name].ecfgs()
    for rnn_kernel in ("scan", "pallas"):
        dj, _ = _distances(worlds[name], rnn_kernel)
        assert min_gap(dj, je.recall_ks) > 1e-5


@pytest.mark.parametrize("name", ["didemo", "charades"])
@pytest.mark.parametrize("protocol", ["threshold", "didemo_official"])
@pytest.mark.parametrize("rnn_kernel", ["scan", "pallas"])
def test_evaluate_matches_jax(worlds, name, protocol, rnn_kernel):
    world = worlds[name]
    je, te = world.ecfgs(protocol=protocol, rnn_kernel=rnn_kernel)
    ref = j_evaluate(world.jparams, world.jmodel, world.jds, je)
    got = evaluate(world.tparams, world.tmodel, world.tds, te)
    assert got == ref
    assert got["num_queries"] == world.tds.num_queries


@pytest.mark.parametrize("name,model_kw", [
    ("didemo", dict(pooling="max")),
    ("didemo", dict(moment_impl="direct")),
    ("charades", dict(pooling="max"))])
def test_evaluate_moment_forms_match_jax(worlds, name, model_kw):
    world = worlds[name].with_model(**model_kw)
    je, te = world.ecfgs(protocol="didemo_official")
    ref = j_evaluate(world.jparams, world.jmodel, world.jds, je)
    got = evaluate(world.tparams, world.tmodel, world.tds, te)
    assert got == ref


def test_evaluate_with_given_banks(worlds):
    """Banks passed in (as the training loop will) give the same metrics
    as banks built inside ``evaluate``."""
    world = worlds["charades"]
    _, te = world.ecfgs()
    banks = banks_to_device(world.tds.feature_banks(), device="cpu")
    assert evaluate(world.tparams, world.tmodel, world.tds, te,
                    feature_banks=banks) == \
        evaluate(world.tparams, world.tmodel, world.tds, te)


def narrow(cfg, data_dir: str):
    """A preset of either package at the parity tests' widths, on a
    synthetic fixture of 8 videos (the CLI's code path, small)."""
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(
            cfg.data, data_dir=data_dir, feature_dim=F, glove_dim=E,
            synthetic_num_videos=8, synthetic_num_queries=24),
        model=dataclasses.replace(cfg.model, lstm_hidden=H, joint_dim=J),
        eval=dataclasses.replace(cfg.eval, eval_batch_size=8,
                                 corpus_query_batch=8))


def run_both_clis(monkeypatch, capsys, tmp_path, argv):
    """Metric dicts printed by the JAX CLI and by the port's (--device
    cpu) for the same subcommand on the same narrowed preset."""
    import vfr_tpu.cli as jcli
    import vfr_tpu_torch.cli as tcli

    monkeypatch.setenv("VFR_XLA_CACHE_DIR", "")
    data_dir = str(tmp_path / "nodata")
    for mod in (jcli, tcli):
        monkeypatch.setattr(mod, "get_preset",
                            lambda name, mod=mod: narrow(mod.PRESETS[name],
                                                         data_dir))
    ckpt = ["--checkpoint-dir", str(tmp_path / "ck")]
    assert jcli.main([*argv, *ckpt]) == 0
    ref = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main([*argv, *ckpt, "--device", "cpu"]) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    return ref, got


@pytest.mark.parametrize("preset,extra", [
    ("charades_sta", []), ("didemo_flagship", ["--protocol",
                                               "didemo_official"])])
def test_cli_eval_keys_match_jax(monkeypatch, capsys, tmp_path, preset,
                                 extra):
    ref, got = run_both_clis(monkeypatch, capsys, tmp_path,
                             ["eval", "--preset", preset, *extra])
    assert list(got) == list(ref)
    assert all(np.isfinite(v) for v in got.values())
    assert got["num_queries"] == ref["num_queries"]


def test_cli_eval_needs_cuda_unless_cpu(monkeypatch, tmp_path):
    from vfr_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["eval", "--preset", "charades_sta", "--data-dir",
              str(tmp_path / "nodata")])


def test_eval_modules_import_nothing_of_jax():
    """The eval and Charades-STA modules import neither JAX nor the JAX
    package, in a fresh interpreter."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import vfr_tpu_torch.eval.moment_eval, vfr_tpu_torch.data.charades\n"
        "import vfr_tpu_torch.data.loaders, vfr_tpu_torch.ops.tiou\n"
        "import vfr_tpu_torch.ops.proposals, vfr_tpu_torch.data.synthetic\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vfr_tpu')]\n"
        "sys.exit(1 if bad else 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
