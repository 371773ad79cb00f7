"""The PyTorch port's Charades-STA data path against the JAX package's.

Bit for bit: the sliding windows, window bank and pooling matrix, the
validity mask and duration-normalized TEF, ``tiou``, the synthetic fixture
(features, annotations, GloVe table), the annotation parser, and every
array of ``CharadesSTADataset`` (features, durations, masks, TEF, tokens,
targets) and of its eval batches.  Also: the loader's Charades branch (the
synthetic fixture and the real text layout), the packed ``.vfrf`` store
(a packed-only data dir loads what its npz loads; a malformed one raises),
and ``banks_to_device``.
"""

import json
import os

import numpy as np
import pytest
import torch

from vfr_tpu.config import DataConfig as JDataConfig
from vfr_tpu.data import charades as jcharades
from vfr_tpu.data.synthetic import charades_lines as j_charades_lines
from vfr_tpu.data.synthetic import make_charades_fixture as j_fixture
from vfr_tpu.ops import proposals as jprop
from vfr_tpu.ops.tiou import tiou as j_tiou
from vfr_tpu.ops.tiou import tiou_matrix as j_tiou_matrix
from vfr_tpu_torch.config import DataConfig
from vfr_tpu_torch.data import charades as tcharades
from vfr_tpu_torch.data.features import FeatureStore, banks_to_device
from vfr_tpu_torch.data.loaders import load_datasets
from vfr_tpu_torch.data.synthetic import (
    charades_lines,
    make_charades_fixture,
    make_didemo_fixture,
)
from vfr_tpu_torch.ops import proposals as tprop
from vfr_tpu_torch.ops.tiou import tiou, tiou_matrix

F, E = 32, 16


@pytest.mark.parametrize("duration,scales,stride", [
    (40.0, (12.0, 18.0, 24.0), 0.25), (30.0, (8.0,), 0.5),
    (10.0, (12.0, 4.0), 0.3)])
def test_sliding_windows(duration, scales, stride):
    np.testing.assert_array_equal(
        tprop.sliding_windows(duration, scales, stride),
        jprop.sliding_windows(duration, scales, stride))


@pytest.mark.parametrize("max_duration,feature_seconds,max_windows", [
    (40.0, 1.0, 64), (30.0, 0.5, 80)])
def test_window_bank_mask_tef(max_duration, feature_seconds, max_windows):
    args = (max_duration, feature_seconds, (12.0, 18.0, 24.0), 0.25,
            max_windows)
    w_t, pool_t = tprop.charades_window_bank(*args)
    w_j, pool_j = jprop.charades_window_bank(*args)
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(pool_t, pool_j)
    for d in (3.0, 17.3, 24.4, 24.6, max_duration):
        np.testing.assert_array_equal(
            tprop.window_validity_mask(w_t, d, feature_seconds),
            jprop.window_validity_mask(w_j, d, feature_seconds))
        np.testing.assert_array_equal(tprop.window_tef(w_t, d),
                                      jprop.window_tef(w_j, d))


def test_window_bank_too_small_raises():
    with pytest.raises(ValueError, match="max_windows"):
        tprop.charades_window_bank(40.0, 1.0, (12.0, 18.0, 24.0), 0.25, 8)


def test_tiou():
    rng = np.random.default_rng(0)
    a = np.sort(rng.uniform(0, 30, (7, 2)), axis=1).astype(np.float32)
    b = np.sort(rng.uniform(0, 30, (5, 2)), axis=1).astype(np.float32)
    b[0] = (4.0, 4.0)                             # zero-length interval
    np.testing.assert_array_equal(tiou_matrix(a, b),
                                  np.asarray(j_tiou_matrix(a, b)))
    np.testing.assert_array_equal(tiou(a[:, None], b[None]),
                                  np.asarray(j_tiou(a[:, None], b[None])))


@pytest.mark.parametrize("moments,flow", [(1, False), (3, True)])
def test_fixture_bit_identical(moments, flow):
    kw = dict(num_videos=6, num_queries=20, feature_dim=F, glove_dim=E,
              moments_per_video=moments, with_flow=flow, seed=3)
    t, j = make_charades_fixture(**kw), j_fixture(**kw)
    assert t.annotations == j.annotations
    assert charades_lines(t.annotations) == j_charades_lines(j.annotations)
    np.testing.assert_array_equal(t.glove, j.glove)
    assert list(t.rgb.ids()) == list(j.rgb.ids())
    for v in j.rgb.ids():
        np.testing.assert_array_equal(t.rgb[v], j.rgb[v])
        if flow:
            np.testing.assert_array_equal(t.flow[v], j.flow[v])
    assert (t.flow is None) == (j.flow is None)


def test_parse_charades_lines():
    fix = j_fixture(num_videos=3, num_queries=9, feature_dim=F, glove_dim=E)
    lines = j_charades_lines(fix.annotations) + ["", "  "]
    assert (tcharades.parse_charades_lines(lines)
            == jcharades.parse_charades_lines(lines))


def _datasets(durations=None, data_kw=None):
    fix = j_fixture(num_videos=10, num_queries=40, feature_dim=F,
                    glove_dim=E, moments_per_video=2, seed=11)
    kw = dict(dataset="charades_sta", feature_dim=F, glove_dim=E,
              **(data_kw or {}))
    # the annotation-less durations fall back to the feature rows
    anns = ([{k: v for k, v in a.items() if k != "duration"}
             for a in fix.annotations] if durations == "rows"
            else fix.annotations)
    j = jcharades.CharadesSTADataset(anns, fix.rgb, None, fix.vocab,
                                     JDataConfig(**kw))
    t = tcharades.CharadesSTADataset(anns, fix.rgb, None, fix.vocab,
                                     DataConfig(**kw))
    return t, j


@pytest.mark.parametrize("durations,data_kw", [
    (None, None), ("rows", None),
    (None, dict(max_duration=30.0, max_windows=48)),
    (None, dict(window_scales=(30.0,)))])
def test_dataset_arrays_bit_identical(durations, data_kw):
    t, j = _datasets(durations, data_kw)
    assert t.video_ids == j.video_ids
    assert t.num_proposals == j.num_proposals
    assert t.num_feature_rows == j.num_feature_rows
    for name in ("windows", "pool", "rgb_feats", "durations", "window_mask",
                 "video_tef", "tokens", "lengths", "target", "video_idx",
                 "gt_spans", "gt_mask"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert t.window_mask.any(axis=1).all()
    # every target is a valid window of its video
    assert t.window_mask[t.video_idx, t.target].all()


@pytest.mark.parametrize("batch,with_features", [(16, True), (7, False)])
def test_eval_batches_bit_identical(batch, with_features):
    t, j = _datasets()
    bt = list(t.eval_batches(batch, with_features=with_features))
    bj = list(j.eval_batches(batch, with_features=with_features))
    assert len(bt) == len(bj) == -(-t.num_queries // batch)
    for a, b in zip(bt, bj):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert int(sum(b["valid"].sum() for b in bt)) == t.num_queries
    for key, arr in t.feature_banks().items():
        np.testing.assert_array_equal(arr, j.feature_banks()[key])


def test_loader_synthetic_charades():
    kw = dict(dataset="charades_sta", data_dir="/nonexistent", feature_dim=F,
              glove_dim=E, synthetic_num_videos=8, synthetic_num_queries=30,
              synthetic_moments_per_video=2)
    b = load_datasets(DataConfig(**kw))
    from vfr_tpu.data.loaders import load_datasets as j_load

    jb = j_load(JDataConfig(**kw))
    assert b.source == jb.source == "synthetic"
    assert isinstance(b.val, tcharades.CharadesSTADataset)
    for ds, jds in ((b.train, jb.train), (b.val, jb.val)):
        np.testing.assert_array_equal(ds.tokens, jds.tokens)
        np.testing.assert_array_equal(ds.target, jds.target)
        np.testing.assert_array_equal(ds.rgb_feats, jds.rgb_feats)
    np.testing.assert_array_equal(b.glove, jb.glove)


def test_loader_real_charades_layout(tmp_path):
    fix = make_charades_fixture(num_videos=5, num_queries=15, feature_dim=F,
                                glove_dim=E, seed=2)
    lines = charades_lines(fix.annotations)
    (tmp_path / "charades_sta_train.txt").write_text("\n".join(lines[:10]))
    (tmp_path / "charades_sta_test.txt").write_text("\n".join(lines[10:]))
    np.savez(tmp_path / "features_rgb.npz",
             **{v: fix.rgb[v] for v in fix.rgb.ids()})
    b = load_datasets(DataConfig(dataset="charades_sta",
                                 data_dir=str(tmp_path), feature_dim=F,
                                 glove_dim=E))
    assert b.source == "real"
    assert b.train.num_queries == 10 and b.val.num_queries == 5
    assert b.glove.shape == (len(b.vocab), E)


@pytest.mark.parametrize("dataset", ["didemo", "charades_sta"])
def test_loader_refuses_packed_store(tmp_path, dataset):
    """A data dir whose only feature file is a malformed .vfrf raises and
    says so (not a bare 'features_rgb.npz not found')."""
    if dataset == "didemo":
        (tmp_path / "train_data.json").write_text("[]")
    else:
        (tmp_path / "charades_sta_train.txt").write_text("v 0.0 1.0##a b\n")
    (tmp_path / "features_rgb.vfrf").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="not a VFRF file"):
        load_datasets(DataConfig(dataset=dataset, data_dir=str(tmp_path),
                                 feature_dim=F, glove_dim=E))


@pytest.mark.parametrize("dataset", ["didemo", "charades_sta"])
def test_loader_reads_packed_store(tmp_path, dataset):
    """A data dir holding only ``features_rgb.vfrf`` (``cli pack`` of the
    npz) loads the same features, tokens and tables as the npz dir."""
    from vfr_tpu_torch.cli import main

    if dataset == "didemo":
        fix = make_didemo_fixture(num_videos=6, num_queries=18,
                                  feature_dim=F, glove_dim=E, seed=3)
        files = {"train_data.json": json.dumps(fix.annotations[:12]),
                 "val_data.json": json.dumps(fix.annotations[12:])}
    else:
        fix = make_charades_fixture(num_videos=5, num_queries=15,
                                    feature_dim=F, glove_dim=E, seed=2)
        lines = charades_lines(fix.annotations)
        files = {"charades_sta_train.txt": "\n".join(lines[:10]),
                 "charades_sta_test.txt": "\n".join(lines[10:])}
    bundles = []
    for form in ("npz", "vfrf"):
        d = tmp_path / form
        d.mkdir()
        for name, text in files.items():
            (d / name).write_text(text)
        npz = d / "features_rgb.npz"
        np.savez(npz, **{v: fix.rgb[v] for v in fix.rgb.ids()})
        if form == "vfrf":
            assert main(["pack", "--npz", str(npz), "--out",
                         str(d / "features_rgb.vfrf"), "--device",
                         "cpu"]) == 0
            os.remove(npz)
        bundles.append(load_datasets(DataConfig(
            dataset=dataset, data_dir=str(d), feature_dim=F, glove_dim=E,
            use_flow=False)))
    a, b = bundles
    assert a.source == b.source == "real"
    for x, y in ((a.train, b.train), (a.val, b.val)):
        assert x.video_ids == y.video_ids
        np.testing.assert_array_equal(x.rgb_feats, y.rgb_feats)
        np.testing.assert_array_equal(x.tokens, y.tokens)


@pytest.mark.parametrize("bank_dtype", ["float32", "bfloat16"])
def test_banks_to_device(bank_dtype):
    rng = np.random.default_rng(0)
    banks = {"rgb": rng.standard_normal((3, 4, 5)).astype(np.float32),
             "video_tef": rng.uniform(0, 1, (3, 6, 2)).astype(np.float32)}
    out = banks_to_device(banks, bank_dtype, device="cpu")
    want = torch.bfloat16 if bank_dtype == "bfloat16" else torch.float32
    assert out["rgb"].dtype == want
    assert out["video_tef"].dtype == torch.float32
    np.testing.assert_array_equal(out["video_tef"].numpy(), banks["video_tef"])
    np.testing.assert_array_equal(
        out["rgb"].float().numpy(),
        torch.from_numpy(banks["rgb"]).to(want).float().numpy())
    with pytest.raises(ValueError):
        banks_to_device(banks, "float16")


def test_feature_store_get_padded():
    s = FeatureStore({"a": np.ones((3, 2), np.float32)})
    np.testing.assert_array_equal(s.get_padded("a", 5)[3:], 0.0)
    assert s.get_padded("a", 2).shape == (2, 2)
