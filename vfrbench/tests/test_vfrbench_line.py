"""The result line's schema, and the reduction of a traced window."""

import json
import time

import pytest
import torch

from vfrbench import catalog, run, trace
from vfrbench.tests import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(str(tmp_path_factory.mktemp("tiny") / "root"))


@pytest.mark.parametrize("name", sorted(_tiny.CELLS))
def test_line_schema(root, name):
    line = run.run_cell(catalog.cell(name, root), 2 ** 33 + 7, 0.3, False,
                        torch.device("cpu"), time.perf_counter(), root=root)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert "setup_s" in line["metrics"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(line))


def test_busy_union_counts_overlap_once():
    ks = [(0, 10, "a", 1), (5, 10, "b", 1), (30, 5, "c", 2)]
    assert trace.union_ns(ks, 0, 100) == 20
    assert trace.union_ns(ks, 8, 32) == 7 + 2
    gaps = trace.idle_gaps(ks, 0, 40, [("wait", 16, 29)])
    assert gaps[0] == ["wait", 15e-9]
    assert gaps[1] == ["harness", 5e-9]


def test_stage_split_of_a_replay():
    names = ["gather", "to_bf16_padded", "rnn_persistent<LstmCell>",
             "cutlass_80_simt_sgemm", "cublasLt::splitKreduce", "add",
             "sm80_xmma_gemm_f32f32", "elementwise_sub", "mbtopk::gather",
             "bitonicSort"]
    durs = [1, 1, 200, 5, 1, 1, 700, 180, 900, 10]
    rep = [(i * 1000, d, n, 7) for i, (n, d) in enumerate(zip(names, durs))]
    assert trace.replays(rep + [(99999, 3, "Memcpy DtoD", 8)]) == [rep]
    s = trace.stage_seconds(rep)
    assert s["encode"] == pytest.approx(209e-9)
    assert s["score"] == pytest.approx(880e-9)
    assert s["select"] == pytest.approx(910e-9)


def test_short_names():
    assert trace.short_name("void at::native::mbtopk::gatherTopK<int, "
                            "unsigned int, 2>(x)") == \
        "at::native::mbtopk::gatherTopK"
