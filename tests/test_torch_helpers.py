"""The JAX package's last public helpers, ported, against the JAX
functions on the CPU, and a plumbing run of the Charades-STA quality twin.

* ``ops/topk.py::hierarchical_top_k`` against ``vfr_tpu.ops.topk.
  hierarchical_top_k`` (values and indices equal; integer-valued rows so
  that ties are exact and their order, lowest index first, is tested);
* ``data/prefetch.py::device_put_prefetch`` against the JAX generator on
  ``device="cpu"``: the same batches in the same order, and the same
  number of batches pulled from the source before each one is handed
  out (its depth); ``mesh=`` splits each batch by rows; no CUDA and no
  device raises;
* ``train/checkpoint.py::peek_config`` on a port checkpoint: the config
  the run was given, None for a file without one;
* ``vfr_tpu_torch/scripts/quality_run_charades_large.py`` at 24 videos,
  one epoch, on ``--device cpu``: its ``final_metrics.json`` has every key
  of the JAX package's committed artifact
  (``artifacts/quality_charades_large/final_metrics.json``).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.data.prefetch import device_put_prefetch as jax_prefetch
from vfr_tpu.ops.topk import hierarchical_top_k as jax_hierarchical_top_k
from vfr_tpu_torch.config import get_preset
from vfr_tpu_torch.data.prefetch import device_put_prefetch
from vfr_tpu_torch.ops.topk import hierarchical_top_k
from vfr_tpu_torch.parallel.mesh import make_mesh
from vfr_tpu_torch.train.checkpoint import peek_config, save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "quality_charades_large",
                        "final_metrics.json")


# ------------------------------------------------------ hierarchical_top_k

@pytest.mark.parametrize("lead,n,k,chunk,levels", [
    ((3,), 10_000, 10, 512, 20),       # chunked, many ties
    ((2, 2), 5_000, 100, 1_024, 50),   # two leading axes
    ((4,), 3_001, 5, 100, 4),          # a padded last chunk, dense ties
    ((2,), 50, 100, 8, 10),            # k >= n: a flat top-k of n
    ((2,), 4_000, 10, 2_048, 10),      # n <= 2 * chunk: flat
    ((2,), 4_000, 300, 256, 1000),     # chunk <= k: flat
    ((1,), 9_000, 64, 64, 3),          # k == chunk
])
def test_hierarchical_top_k_matches_jax(lead, n, k, chunk, levels):
    rng = np.random.default_rng(n + k)
    x = rng.integers(0, levels, size=(*lead, n)).astype(np.float32)
    v_j, i_j = jax_hierarchical_top_k(jnp.asarray(x), k, chunk)
    v_p, i_p = hierarchical_top_k(torch.from_numpy(x), k, chunk)
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))


def test_hierarchical_top_k_ties_lowest_index_first():
    x = torch.zeros(1, 6_000)
    x[0, [5_999, 10, 4_100, 2_047, 2_048]] = 1.0
    vals, idx = hierarchical_top_k(x, 4, chunk=1_000)
    assert idx.tolist() == [[10, 2_047, 2_048, 4_100]]
    assert vals.tolist() == [[1.0] * 4]


# ----------------------------------------------------- device_put_prefetch

def _source(n, log):
    for i in range(n):
        log.append(i)
        yield {"x": np.full((4, 3), i, np.float32),
               "ids": np.arange(4, dtype=np.int32) + 10 * i}


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
@pytest.mark.parametrize("n", [0, 1, 3, 7])
def test_device_put_prefetch_order_and_depth(depth, n):
    jax_log, port_log = [], []
    jax_seen = [(int(np.asarray(b["x"])[0, 0]), len(jax_log))
                for b in jax_prefetch(_source(n, jax_log), depth)]
    port = []
    for b in device_put_prefetch(_source(n, port_log), depth, device="cpu"):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == \
            "cpu"
        assert b["ids"].dtype == torch.int32
        port.append((int(b["x"][0, 0]), len(port_log)))
    assert port == jax_seen
    assert [i for i, _ in port] == list(range(n))


def test_device_put_prefetch_mesh_splits_rows():
    mesh = make_mesh(("data",), devices=[torch.device("cpu")] * 2)
    out = list(device_put_prefetch(_source(3, []), 1, mesh=mesh))
    assert len(out) == 3
    for i, shards in enumerate(out):
        assert len(shards) == 2
        assert shards[0]["ids"].tolist() == [10 * i, 10 * i + 1]
        assert shards[1]["ids"].tolist() == [10 * i + 2, 10 * i + 3]


def test_device_put_prefetch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(device_put_prefetch(_source(2, []), 1))


# ------------------------------------------------------------ peek_config

def test_peek_config_reads_the_run_config(tmp_path):
    cfg = get_preset("charades_flagship")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=48, seed=7))
    params = {"w": torch.arange(6, dtype=torch.float32).view(2, 3)}
    opt_state = {"count": 3, "mu": {"w": torch.zeros(2, 3)}}
    path = save_checkpoint(str(tmp_path), 3, params, opt_state, cfg)
    got = peek_config(path)
    assert got == cfg
    assert got.train.batch_size == 48 and got.train.seed == 7
    bare = save_checkpoint(str(tmp_path / "bare"), 4, params, opt_state)
    assert peek_config(bare) is None


# -------------------------------------------------- the quality twin

def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_quality_run_charades_large_plumbing(tmp_path):
    from vfr_tpu_torch.scripts import quality_run_charades_large as qrc

    out = tmp_path / "out"
    qrc.main(["--out", str(out), "--num-videos", "24", "--num-queries",
              "192", "--epochs", "1", "--seed", "3", "--device", "cpu"])
    got = json.load(open(out / "final_metrics.json"))
    want = json.load(open(ARTIFACT))
    assert _keys(want) <= _keys(got), _keys(want) - _keys(got)
    assert got["preset"] == "charades_flagship"
    assert got["train_seed"] == 3 and got["epochs"] == 1
    assert got["fixture"]["num_videos"] == 24
    assert got["fixture"]["num_queries_val"] == 24    # one per video
    assert got["corpus"]["corpus_num_rows"] == 24 * 64
    assert got["model"]["distance"] == "cosine" and got["batch_size"] == 64
    assert got["loss"]["temperature"] == 0.02
    assert all(np.isfinite(v) for v in got["corpus"].values())
    assert (out / "metrics.jsonl").exists()
