"""Discovery by file name: every cell, configuration, traffic mix, driver
and metric is found from its file, BENCHMARK.json names only what has
files, and a cell or a metric added as files alone is run and read."""

import json
import os
import time

import pytest
import torch

from vfrbench import catalog, run
from vfrbench.tests import _tiny

CELLS = ["flagship-batch", "flagship-daemon", "flagship-train", "s10k-batch"]
E2E = ["queries_per_s", "request_p95_ms", "setup_s", "train_queries_per_s"]
PER_LAYER = ["dispatch_host_us.batch", "encode_roofline.batch",
             "encode_stage_roofline.batch", "idle_share.batch",
             "idle_share.daemon", "idle_share.train", "mfu.batch",
             "mfu.train", "port_setup_s.batch", "request_p50_ms.daemon",
             "score_roofline.batch", "score_stage_roofline.batch",
             "select_roofline.batch", "select_stage_roofline.batch"]


def test_names_are_files():
    assert catalog.names("workloads") == CELLS
    assert catalog.names("configs") == ["didemo_flagship", "serving_10k"]
    assert catalog.names("drivers") == ["batch", "daemon", "train"]
    assert catalog.names("towers") == ["mcn"]
    assert catalog.names("metrics") == sorted(E2E + PER_LAYER)


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_resolve(name):
    cell = catalog.cell(name)
    assert cell.driver in catalog.names("drivers")
    drv = catalog.load_module("drivers", cell.driver)
    assert cell.limits and set(cell.limits) <= set(drv.READINGS)
    cfg = catalog.experiment(cell.config)
    assert cfg.name == cell.config["preset"]


@pytest.mark.parametrize("name", ["serving_10k", "didemo_flagship"])
def test_config_is_the_preset_verbatim(name):
    from vfr_tpu_torch.config import get_preset

    c = catalog.load_json("configs", name)
    assert c["reduced"] == []
    assert catalog.experiment(c) == get_preset(c["preset"])


def test_a_changed_size_must_be_listed():
    c = catalog.load_json("configs", "serving_10k")
    c["model"]["lstm_hidden"] = 512
    with pytest.raises(ValueError, match="reduced"):
        catalog.experiment(c)
    c["reduced"] = ["lstm_hidden"]
    assert catalog.experiment(c).model.lstm_hidden == 512


def test_benchmark_json_names_only_files():
    bench = catalog.benchmark()
    assert bench is not None
    cells = {w["name"]: w for w in bench["workloads"]}
    assert sorted(cells) == ["flagship-batch", "s10k-batch"]
    assert set(cells) <= set(CELLS)
    for name, w in cells.items():
        c = catalog.cell(name)
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            c.cell["config"], c.cell["traffic"], c.cell["chips"],
            c.cell["why"])
    assert sorted(c["name"] for c in bench["configs"]) == \
        catalog.names("configs")
    for c in bench["configs"]:
        assert c["file"] == f"vfrbench/configs/{c['name']}.json"
        assert c["reduced"] == catalog.load_json("configs",
                                                 c["name"])["reduced"]
    metrics = catalog.metric_modules()
    for m in bench["end_to_end"]:
        assert m["unit"] == metrics[m["name"]].UNIT
        assert not metrics[m["name"]].TRACED
    for m in bench["per_layer"]:
        assert m["unit"] == metrics[m["name"]].UNIT
        assert metrics[m["name"]].TRACED
        assert set(m["workloads"]) <= set(cells)


def test_each_cell_reports_its_metrics():
    bench = catalog.benchmark()
    for w in bench["workloads"]:
        e2e = catalog.cell_metrics(bench, w["name"], False, [])
        layer = catalog.cell_metrics(bench, w["name"], True, [])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer


def test_added_cell_and_metric_are_found(tmp_path):
    """A cell and a per-layer metric added as files only: the run finds
    the cell by name and reports the new reader's value."""
    root = _tiny.make_root(str(tmp_path / "root"), metrics="copy")
    _tiny.write(root, "workloads", "tiny-added", {
        "config": "tiny_s10k", "traffic": "bulk", "chips": 1,
        "why": "added as a file", "limits": _tiny.SERVE_LIMITS})
    with open(os.path.join(root, "metrics", "batches.added.py"), "w") as f:
        f.write("UNIT = 'batches'\nTRACED = False\n\n\ndef read(rec):\n"
                "    return float(rec['window']['batches'])\n")
    assert "tiny-added" in catalog.names("workloads", root)
    bench = {"end_to_end": [
        {"name": "setup_s"}, {"name": "batches.added",
                              "workloads": ["tiny-added"]}],
        "per_layer": []}
    line = run.run_cell(catalog.cell("tiny-added", root), 5, 0.3, False,
                        torch.device("cpu"), time.perf_counter(),
                        bench=bench, root=root)
    assert line["correct"]
    assert set(line["metrics"]) == {"setup_s", "batches.added"}
    assert line["metrics"]["batches.added"]["value"] >= 1
    json.dumps(line)
