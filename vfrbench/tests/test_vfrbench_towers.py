"""The query-tower seam of the bulk driver: a tower added as files alone
(a toy GRU tower in a root of its own) runs and is judged by its own
reference, the MCN cells read what they read before the seam, and the
encode counts go through the tower the window's shapes name."""

import os
import shutil
import time

import pytest
import torch

from vfrbench import catalog, metrics_common, run, work
from vfrbench.drivers import _common
from vfrbench.tests import _tiny
from vfrbench.trace import Tracer

CPU = torch.device("cpu")
TOY = os.path.join(os.path.dirname(__file__), "_gru_tower.py")
SEED = 2 ** 33 + 7

# The ``correct`` readings of the tiny bulk cells at SEED over all four of
# their batches, from the harness before the seam (commit 8c6f097).
PINNED = {
    "tiny-s10k-batch": {
        "dist_gap": 2.2730124271674867e-07, "rank_gap": 0.0,
        "set_gap": 0.0, "lower_share": 1.2478697723419688e-06,
        "bad": 0.0, "shared_rows": 0.8248015873015873,
        "lower_share.recurrence": 1.1673885921157462e-06,
        "lower_share.projection": 3.6393587653178363e-07,
        "lower_share.score": 1.2478697723419688e-06},
    "tiny-flagship-batch": {
        "dist_gap": 1.0500893949938472e-06, "rank_gap": 0.0,
        "set_gap": 0.0, "lower_share": 6.769854947002716e-05,
        "bad": 0.0, "shared_rows": 0.15922619047619047,
        "lower_share.recurrence": 3.761805382516734e-05,
        "lower_share.projection": 2.7621154704493582e-05,
        "lower_share.score": 6.769854947002716e-05},
}


def _files(top):
    """(path, size, mtime) of every file under ``top`` but bytecode."""
    out = set()
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            st = os.stat(os.path.join(d, f))
            out.add((os.path.join(d, f), st.st_size, st.st_mtime_ns))
    return out


def _gru_root(tmp_path):
    """A tiny root with the toy tower as ``towers/gru.py``, its
    configuration ``tiny_gru`` (``tiny_s10k`` with a GRU) and its cell."""
    root = _tiny.make_root(str(tmp_path / "root"), towers="copy")
    shutil.copy(TOY, os.path.join(root, "towers", "gru.py"))
    c = _tiny.tiny_config("serving_10k")
    c["tower"] = "gru"
    c["model"]["rnn_cell"] = "gru"
    c["reduced"].append("rnn_cell")
    _tiny.write(root, "configs", "tiny_gru", c)
    _tiny.write(root, "workloads", "tiny-gru-batch", {
        "config": "tiny_gru", "traffic": "bulk", "chips": 1,
        "why": "a tower added as files", "limits": _tiny.SERVE_LIMITS})
    return root


def _run(root, name, seed=SEED):
    bench = {"end_to_end": [{"name": "queries_per_s"}, {"name": "setup_s"}],
             "per_layer": []}
    return run.run_cell(catalog.cell(name, root), seed, 0.3, False, CPU,
                        time.perf_counter(), bench=bench, root=root)


def test_a_tower_added_as_files_runs(tmp_path):
    before = _files(catalog.ROOT)
    root = _gru_root(tmp_path)
    assert catalog.names("towers", root) == ["gru", "mcn"]
    line = _run(root, "tiny-gru-batch")
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"queries_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert _files(catalog.ROOT) == before
    assert catalog.names("towers") == ["mcn"]


def test_a_moved_gate_bias_in_the_toy_reference_fails(tmp_path, monkeypatch):
    """The toy reference with its update gate's input bias moved stands
    against the port's unmoved weights: ``correct`` reads false."""
    root = _gru_root(tmp_path)
    load = catalog.load_module

    def moved(kind, name, root=catalog.ROOT):
        mod = load(kind, name, root)
        if kind == "towers" and name == "gru":
            ref = mod.reference_queries

            def reference_queries(params, s, tokens, lengths, plan):
                layer = dict(params["lstm"]["layer0"])
                b = layer["b_ih"].clone()
                H = s["H"]
                b[H:2 * H] += 0.5
                layer["b_ih"] = b
                p = {**params, "lstm": {**params["lstm"], "layer0": layer}}
                return ref(p, s, tokens, lengths, plan)
            mod.reference_queries = reference_queries
        return mod

    monkeypatch.setattr(catalog, "load_module", moved)
    line = _run(root, "tiny-gru-batch")
    assert line["correct"] is False
    assert line["checks"]["dist_gap"]["value"] > \
        line["checks"]["dist_gap"]["limit"]


def test_the_toy_tower_counts_the_encode(tmp_path):
    """The readers take the encode's work from the tower the window's
    shapes name, in the record's root: the toy's three gates."""
    root = _gru_root(tmp_path)
    cell = catalog.cell("tiny-gru-batch", root)
    drv = catalog.load_module("drivers", cell.driver, root)
    st = drv.setup(cell, catalog.experiment(cell.config), SEED, 0.2, CPU)
    win = drv.window(st, 0.2, Tracer(False, 0.2))
    drv.release(st)
    shapes = win["shapes"]
    assert shapes["tower"] == "gru" and shapes["gates"] == 3
    got = metrics_common.stage_work({"window": win, "root": root}, "encode")
    toy = catalog.tower("gru", root)
    assert got == toy.encode_work(shapes)
    _, lstm_ops = work.encode_work(shapes)
    assert got[1]["bfloat16"] == pytest.approx(0.75 * lstm_ops["bfloat16"])
    assert got[1]["float32"] == lstm_ops["float32"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_readings_are_the_parents(name, tmp_path):
    """Over a fixed set of batches (every batch of the pool, in place of
    the window's seeded sample), the readings equal the parent's."""
    root = _tiny.make_root(str(tmp_path / "root"))
    cell = catalog.cell(name, root)
    drv = catalog.load_module("drivers", cell.driver, root)
    st = drv.setup(cell, catalog.experiment(cell.config), SEED, 0.3, CPU)
    st.kept = [(i, tuple(x.clone() for x in st.retrieve(st.qp, st.toks[i],
                                                         st.lens[i])))
               for i in range(st.toks.shape[0])]
    drv.release(st)
    assert drv.check(st) == PINNED[name]


@pytest.mark.parametrize("name", ["serving_10k", "didemo_flagship"])
def test_mcn_encode_counts_are_works(name):
    """The MCN tower's count is ``work.encode_work``'s, bit for bit, on
    the real configurations' shapes, whether the shapes name the tower or
    not (an older record)."""
    config = catalog.load_json("configs", name)
    cell = catalog.Cell("x", {}, config, {})
    shapes = dict(_common.sizes(cell, catalog.experiment(config)),
                  Q=256, live_steps=14.0 * 256, N=210000, k=100,
                  index_dtype="float32", score_dtype="float32")
    want = work.encode_work(shapes)
    assert catalog.tower("mcn").encode_work(shapes) == want
    for named in (shapes, dict(shapes, tower="mcn")):
        rec = {"window": {"shapes": named}}
        assert metrics_common.stage_work(rec, "encode") == want


def test_an_unknown_tower_is_refused(tmp_path):
    root = _tiny.make_root(str(tmp_path / "root"))
    c = _tiny.tiny_config("serving_10k")
    c["tower"] = "nemotron_h"
    _tiny.write(root, "configs", "tiny_unknown", c)
    _tiny.write(root, "workloads", "tiny-unknown-batch", {
        "config": "tiny_unknown", "traffic": "bulk", "chips": 1,
        "why": "an unknown tower", "limits": _tiny.SERVE_LIMITS})
    with pytest.raises(KeyError, match=r"no towers named 'nemotron_h' "
                                       r"\(have \['mcn'\]\)"):
        _run(root, "tiny-unknown-batch")


def test_sections_are_the_presets_dataclass_fields():
    """Every section the file gives that is a dataclass field of the
    preset's ``ExperimentConfig`` is applied; other keys (``tower``,
    ``corpus``, notes) are not sections."""
    c = catalog.load_json("configs", "serving_10k")
    c["tower"] = "mcn"
    c["train"] = {"batch_size": 32}
    with pytest.raises(ValueError, match="train.batch_size"):
        catalog.experiment(c)
    c["reduced"] = ["batch_size"]
    assert catalog.experiment(c).train.batch_size == 32
