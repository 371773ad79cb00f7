"""The port's packed feature store (``vfr_tpu_torch.data.packed``) against
the JAX package's ``vfr_tpu.data.packed``: files written by either are
byte-identical and read by the other; the native reader (built with g++
from the port's own copy of the source) and the memmap reader agree;
gathers pad short videos and zero out-of-range indices; the loaders prefer
``features_<stream>.vfrf`` (the flow stream keeps the JAX package's rule:
``.npz`` first); ``cli pack`` writes the file ``pack_features`` writes."""

import json
import os

import numpy as np
import pytest
import torch

from vfr_tpu.data import packed as jpacked
from vfr_tpu_torch.data import packed as tpacked


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    rng = np.random.default_rng(0)
    table = {f"vid{i:04d}": rng.standard_normal((6, 32)).astype(np.float32)
             for i in range(20)}
    table["short"] = rng.standard_normal((3, 32)).astype(np.float32)
    d = tmp_path_factory.mktemp("vfrf")
    path = tpacked.pack_features(table, str(d / "port.vfrf"), rows=6)
    return table, path, d


def test_native_reader_builds_from_the_port_source():
    from vfr_tpu_torch.kernels import build

    lib = tpacked._load_native()
    assert lib is not None, "the port's vfr_io.cc failed to build or load"
    path = build.host_library_path("vfr_io")
    assert os.path.exists(path)
    assert os.path.dirname(path) == build.BUILD_DIR
    assert "native" not in os.path.relpath(path, build.BUILD_DIR)


def test_files_byte_identical_both_ways(packed):
    table, path, d = packed
    jpath = jpacked.pack_features(table, str(d / "jax.vfrf"), rows=6)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    jfs = jpacked.PackedFeatureStore(path)          # the JAX package reads
    tfs = tpacked.PackedFeatureStore(jpath)         # the port reads
    assert tfs.native
    idx = np.arange(len(table), dtype=np.int64)
    np.testing.assert_array_equal(tfs.gather(idx), jfs.gather(idx))
    assert list(tfs.ids()) == list(jfs.ids()) == sorted(table)
    tfs.close()
    jfs.close()


@pytest.mark.parametrize("prefer_native", [True, False])
def test_roundtrip(packed, prefer_native):
    table, path, _ = packed
    fs = tpacked.PackedFeatureStore(path, prefer_native=prefer_native)
    assert fs.native == prefer_native
    assert fs.backend == ("native" if prefer_native else "numpy")
    assert len(fs) == 21 and fs.rows == 6 and fs.dim == 32
    np.testing.assert_array_equal(fs["vid0007"], table["vid0007"])
    got = fs["short"]                 # zero-padded on the static grid
    np.testing.assert_array_equal(got[:3], table["short"])
    assert (got[3:] == 0).all()
    np.testing.assert_array_equal(fs.get_padded("short", 4)[:3],
                                  table["short"])
    assert "vid0000" in fs and "nope" not in fs
    with pytest.raises(KeyError):
        fs["nope"]
    fs.close()


@pytest.mark.parametrize("prefer_native", [True, False])
def test_gather_parity_and_out_of_bounds(packed, prefer_native):
    table, path, _ = packed
    fs = tpacked.PackedFeatureStore(path, prefer_native=prefer_native)
    ids = sorted(table)
    idx = np.asarray([3, 0, 19, 3, -1, 21, 20], np.int64)
    out = fs.gather(idx, threads=4)
    assert out.shape == (7, 6, 32)
    for i, v in enumerate(idx):
        if 0 <= v < 21:
            want = np.zeros((6, 32), np.float32)
            want[:table[ids[v]].shape[0]] = table[ids[v]]
            np.testing.assert_array_equal(out[i], want)
        else:
            assert (out[i] == 0).all()
    fs.close()


def test_native_and_memmap_agree(packed):
    _, path, _ = packed
    a = tpacked.PackedFeatureStore(path, prefer_native=True)
    b = tpacked.PackedFeatureStore(path, prefer_native=False)
    idx = np.random.default_rng(1).integers(0, 21, 64)
    np.testing.assert_array_equal(a.gather(idx), b.gather(idx))
    assert list(a.ids()) == list(b.ids())
    for v in list(a.ids()):
        assert a.find(v) == b.find(v)
    assert a.find("nope") == b.find("nope") == -1


def test_id_too_long_and_bad_file(tmp_path):
    with pytest.raises(ValueError, match="too long"):
        tpacked.pack_features({"x" * 70: np.zeros((2, 4), np.float32)},
                              str(tmp_path / "bad.vfrf"))
    with pytest.raises(ValueError, match="empty"):
        tpacked.pack_features({}, str(tmp_path / "empty.vfrf"))
    junk = tmp_path / "junk.vfrf"
    junk.write_bytes(b"NOTVFRF!" + b"\0" * 40)
    with pytest.raises(ValueError, match="not a VFRF"):
        tpacked.PackedFeatureStore(str(junk))


def test_loader_prefers_vfrf(tmp_path):
    """Both forms present: rgb comes from the .vfrf (scaled by 2 there to
    tell them apart), flow from the .npz (the JAX package's flow rule),
    in both packages."""
    from vfr_tpu.config import DataConfig as JDataConfig
    from vfr_tpu.data.loaders import load_datasets as j_load
    from vfr_tpu.data.synthetic import make_didemo_fixture
    from vfr_tpu_torch.config import DataConfig
    from vfr_tpu_torch.data.loaders import load_datasets

    fix = make_didemo_fixture(num_videos=8, num_queries=24, feature_dim=24,
                              glove_dim=16, seed=2)
    n_val = len(fix.annotations) // 4
    (tmp_path / "train_data.json").write_text(
        json.dumps(fix.annotations[:-n_val]))
    (tmp_path / "val_data.json").write_text(
        json.dumps(fix.annotations[-n_val:]))
    rgb = {v: fix.rgb[v] for v in fix.rgb.ids()}
    flow = {v: fix.flow[v] for v in fix.flow.ids()}
    np.savez(tmp_path / "features_rgb.npz", **rgb)
    np.savez(tmp_path / "features_flow.npz", **flow)
    tpacked.pack_features({v: a * 2 for v, a in rgb.items()},
                          str(tmp_path / "features_rgb.vfrf"))
    tpacked.pack_features({v: a * 3 for v, a in flow.items()},
                          str(tmp_path / "features_flow.vfrf"))
    kw = dict(data_dir=str(tmp_path), feature_dim=24, glove_dim=16,
              use_flow=True)
    got = load_datasets(DataConfig(**kw))
    ref = j_load(JDataConfig(**kw))
    assert got.source == ref.source == "real"
    for a, b in ((got.train, ref.train), (got.val, ref.val)):
        np.testing.assert_array_equal(a.rgb_feats, b.rgb_feats)
        np.testing.assert_array_equal(a.flow_feats, b.flow_feats)
    v0 = got.train.video_ids[0]
    np.testing.assert_array_equal(got.train.rgb_feats[0], rgb[v0] * 2)
    np.testing.assert_array_equal(got.train.flow_feats[0], flow[v0])


def test_cli_pack(tmp_path, capsys, monkeypatch):
    from vfr_tpu_torch.cli import main

    rng = np.random.default_rng(4)
    table = {f"v{i}": rng.standard_normal((5, 8)).astype(np.float32)
             for i in range(6)}
    np.savez(tmp_path / "f.npz", **table)
    out = str(tmp_path / "f.vfrf")
    assert main(["pack", "--npz", str(tmp_path / "f.npz"), "--out", out,
                 "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"packed 6 videos -> {out}"
    ref = jpacked.pack_features(table, str(tmp_path / "ref.vfrf"))
    assert open(out, "rb").read() == open(ref, "rb").read()
    assert main(["pack", "--npz", str(tmp_path / "none.npz"), "--out", out,
                 "--rows", "7", "--device", "cpu"]) == 2
    assert "feature archive not found" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["pack", "--npz", str(tmp_path / "f.npz"), "--out", out])
