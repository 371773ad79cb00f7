"""Weights and index files carried between the JAX package and the PyTorch
port: parameter trees, the port's params npz, the index npz in both
directions (bit-exact, incl. a bf16 index stored as its uint16 pattern),
fingerprints that validate across packages, and ``build_moment_index``
against the JAX build (f32 atol 1e-5; bf16 within one bf16 ulp, rtol 8e-3:
an f32 value a few ulps off can round to the neighbouring bf16).  Also:
the port imports nothing of JAX, and its entry points refuse to fall back
to the CPU.
"""

import os
import re
import subprocess
import sys

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
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.models.build import build_model as j_build_model
from vfr_tpu.models.mcn import init_model_params as j_init_model_params
from vfr_tpu.utils.io import tree_fingerprint as j_tree_fingerprint
from vfr_tpu_torch import device as tdevice
from vfr_tpu_torch.bridge import (
    load_params_npz,
    params_from_numpy,
    params_to_numpy,
    save_params_npz,
)
from vfr_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
from vfr_tpu_torch.data.didemo import DidemoDataset
from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.utils.io import tree_fingerprint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, E, H, J = 24, 16, 32, 8


def _world(distance="cosine"):
    fix = make_didemo_fixture(num_videos=8, num_queries=24, feature_dim=F,
                              glove_dim=E, seed=2)
    kw = dict(joint_dim=J, lstm_hidden=H, stream_weights=(0.5, 0.5),
              distance=distance)
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
        jax.random.PRNGKey(1), jmodel, fix.glove, F)))
    return jmodel, tmodel, jds, tds, tree


def test_params_round_trip_and_fingerprint(tmp_path):
    _, _, _, _, tree = _world()
    params = params_from_numpy(tree)
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tree_fingerprint(params) == j_tree_fingerprint(
        jax.tree.map(jnp.asarray, tree))
    ema = jax.tree.map(lambda a: a + 1, tree)
    path = save_params_npz(str(tmp_path / "params"), params,
                           config_json='{"x": 1}', ema=ema)
    p2, e2, cj = load_params_npz(path)
    assert cj == '{"x": 1}'
    assert tree_fingerprint(p2) == tree_fingerprint(tree)
    assert tree_fingerprint(e2) == tree_fingerprint(ema)
    p3, e3, _ = load_params_npz(save_params_npz(str(tmp_path / "p3"), tree))
    assert e3 is None and tree_fingerprint(p3) == tree_fingerprint(tree)


@pytest.mark.parametrize("index_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("distance", ["cosine", "sqeuclidean"])
def test_build_index_matches_jax(index_dtype, distance):
    jmodel, tmodel, jds, tds, tree = _world(distance)
    jidx = jcorpus.build_moment_index(jax.tree.map(jnp.asarray, tree),
                                      jmodel, jds, index_dtype=index_dtype)
    tidx = tcorpus.build_moment_index(params_from_numpy(tree), tmodel, tds,
                                      index_dtype=index_dtype)
    assert tidx.m.dtype == getattr(torch, index_dtype)
    jm = np.asarray(jidx.m.astype(jnp.float32))
    tol = dict(atol=1e-5) if index_dtype == "float32" else dict(rtol=8e-3,
                                                                atol=1e-5)
    np.testing.assert_allclose(tidx.m.float().numpy(), jm, **tol)
    np.testing.assert_allclose(tidx.m_sq.numpy(), np.asarray(jidx.m_sq),
                               rtol=1e-4, atol=1e-5)
    for name in ("video_row", "prop_idx", "spans_sec", "weights"):
        np.testing.assert_array_equal(getattr(tidx, name),
                                      getattr(jidx, name))
    assert tidx.fingerprint == jidx.fingerprint


@pytest.mark.parametrize("index_dtype", ["float32", "bfloat16"])
def test_index_npz_both_ways_bit_exact(tmp_path, index_dtype):
    jmodel, tmodel, jds, tds, tree = _world()
    jparams, tparams = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree)
    jidx = jcorpus.build_moment_index(jparams, jmodel, jds,
                                      index_dtype=index_dtype)
    tidx = tcorpus.build_moment_index(tparams, tmodel, tds,
                                      index_dtype=index_dtype)

    def bits(m):
        if isinstance(m, torch.Tensor):
            return m.contiguous().view(torch.int16 if m.dtype ==
                                       torch.bfloat16 else torch.int32).numpy()
        return np.asarray(m).view(np.int16 if m.dtype == jnp.bfloat16
                                  else np.int32)

    # JAX writes, the port reads; the fingerprint validates in the port
    t_from_j = tcorpus.load_index(
        jcorpus.save_index(jidx, str(tmp_path / "j")), device="cpu")
    assert t_from_j.m.dtype == getattr(torch, index_dtype)
    assert np.array_equal(bits(t_from_j.m), bits(jidx.m))
    assert np.array_equal(t_from_j.m_sq.numpy(), np.asarray(jidx.m_sq))
    tcorpus.validate_index(t_from_j, tparams, tmodel, tds)
    # the port writes, JAX reads; the fingerprint validates in JAX
    j_from_t = jcorpus.load_index(tcorpus.save_index(tidx, str(tmp_path / "t")))
    assert np.array_equal(bits(j_from_t.m), bits(tidx.m))
    assert np.array_equal(np.asarray(j_from_t.m_sq), tidx.m_sq.numpy())
    jcorpus.validate_index(j_from_t, jparams, jmodel, jds)
    # the port's own round trip
    again = tcorpus.load_index(
        tcorpus.save_index(tidx, str(tmp_path / "u")), device="cpu")
    assert np.array_equal(bits(again.m), bits(tidx.m))
    assert again.fingerprint == tidx.fingerprint
    for name in ("video_row", "prop_idx", "spans_sec", "weights"):
        np.testing.assert_array_equal(getattr(again, name),
                                      getattr(tidx, name))


def test_fingerprint_mismatch_raises():
    _, tmodel, _, tds, tree = _world()
    tidx = tcorpus.build_moment_index(params_from_numpy(tree), tmodel, tds)
    other = jax.tree.map(lambda a: a * 2, tree)
    with pytest.raises(ValueError, match="checkpoint"):
        tcorpus.validate_index(tidx, params_from_numpy(other), tmodel, tds)


_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|flax|vfr_tpu)(\s|\.|$)",
                        re.M)


def test_port_imports_nothing_of_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vfr_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path, encoding="utf-8") as f:
            assert not _IMPORT_RE.search(f.read()), path
    code = (
        "import importlib, pkgutil, sys\n"
        "import vfr_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    vfr_tpu_torch.__path__, 'vfr_tpu_torch.')]\n"
        "for m in ('train.loop', 'eval.live', 'data.packed',\n"
        "          'data.prefetch'):\n"
        "    assert 'vfr_tpu_torch.' + m in mods, mods\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import importlib.util as u\n"
        "spec = u.spec_from_file_location('cs', 'chip_smoke.py')\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vfr_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device()
    assert tdevice.resolve_device("cpu").type == "cpu"
    from vfr_tpu_torch.checkpoint import load_for_eval
    from vfr_tpu_torch.cli import main
    from vfr_tpu_torch.config import get_preset

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_for_eval(get_preset("didemo_rgb"))
    q = tmp_path / "q.txt"
    q.write_text("w0001\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--data-dir", str(tmp_path / "nodata"),
              "--queries", str(q)])


@pytest.mark.parametrize("loader", ["load_index", "banks_to_device",
                                    "restore_checkpoint", "load_arena"])
def test_loaders_default_to_cuda(monkeypatch, tmp_path, loader):
    """Each public loader places on the card unless told otherwise: with no
    CUDA and no ``device`` it raises; ``device="cpu"`` loads."""
    from vfr_tpu_torch.data.features import banks_to_device
    from vfr_tpu_torch.eval import live as tlive
    from vfr_tpu_torch.train import checkpoint as tckpt

    _, tmodel, _, tds, tree = _world()
    params = params_from_numpy(tree)
    if loader == "load_index":
        path = tcorpus.save_index(tcorpus.build_moment_index(
            params, tmodel, tds), str(tmp_path / "i"))
        fn = lambda **kw: tcorpus.load_index(path, **kw)  # noqa: E731
    elif loader == "banks_to_device":
        fn = lambda **kw: banks_to_device(  # noqa: E731
            {"rgb": tds.rgb_feats}, **kw)
    elif loader == "restore_checkpoint":
        from vfr_tpu_torch.config import TrainConfig
        from vfr_tpu_torch.train.optim import make_optimizer

        opt_state = make_optimizer(TrainConfig(), 10).init(params)
        path = tckpt.save_checkpoint(str(tmp_path), 3, params, opt_state)
        fn = lambda **kw: tckpt.restore_checkpoint(path, **kw)  # noqa: E731
    else:
        live = tlive.make_live_index(params, tmodel, tds, capacity_videos=9)
        path = tlive.save_arena(live, str(tmp_path / "a"))
        fn = lambda **kw: tlive.load_arena(path, **kw)  # noqa: E731
    assert fn(device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke script prints no result and exits non-zero,
    and alone (without the package) it cannot run at all."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
