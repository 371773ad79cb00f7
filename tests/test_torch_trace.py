"""The port's recorder (``vfr_tpu_torch.utils.trace``) on the CPU.

* Off, a hot-path span records nothing; ``enable()`` and a running
  ``torch.profiler.profile`` each turn it on; set-up spans always record.
* The ring keeps its bound and counts what it overwrote; ids and parents
  nest, per thread.
* The registry holds the kernel modules' launch dicts, and ``BatchGraphs``
  replays what a capture counted in any registered counter.
* A capture through the wrapper's CPU stand-ins keeps the stage map its
  marks give (the driver's node count stubbed); outside a capture a mark
  reads nothing.
* ``serve_follow`` with the recorder on gives one ``request`` span per
  query line, each under its pack, and pack sizes that sum to the
  requests; ``cli serve --trace-dir`` writes ``port_spans.json`` beside
  the profiler's trace, on its time base.
"""

import collections
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_graphs import _StandIn
from torch_kernel_route import (
    route_scores_to_the_plain_kernel,
    route_to_the_plain_kernel,
)
from torch_live_world import world
from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.kernels import build
from vfr_tpu_torch.ops import topk
from vfr_tpu_torch.ops.kernels import (
    coarse_kernel,
    gru_kernel,
    lstm_kernel,
    score_kernel,
    select_kernel,
    topk_kernel,
)
from vfr_tpu_torch.parallel import sharding
from vfr_tpu_torch.utils import trace
from vfr_tpu_torch.utils.graphs import BatchGraphs


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    trace.enable(False)
    yield
    trace.enable(False)
    trace.reset()


def _names(spans):
    return [s[0] for s in spans]


# -- on and off --------------------------------------------------------------

def test_off_records_no_hot_span():
    assert not trace.on()
    with trace.span("a", "x"):
        with trace.span("b"):
            pass
    trace.record("c", 1, 2, "y")
    with trace.setup("s"):
        pass
    snap = trace.snapshot()
    assert snap["spans"] == []
    assert _names(snap["setup"]) == ["s"]


def test_enable_turns_it_on():
    trace.enable()
    assert trace.on()
    with trace.span("a", "x"):
        pass
    trace.record("c", 5, 9, "y", "x")
    spans = trace.snapshot()["spans"]
    assert _names(spans) == ["a", "c"]
    assert spans[1] == ("c", "y", "x", 5, 9)
    name, sid, parent, a, b = spans[0]
    assert (sid, parent) == ("x", None) and 0 < a <= b


def test_a_running_profiler_turns_it_on():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.on()
        with trace.span("inside"):
            torch.ones(3).sum()
    assert not trace.on()
    with trace.span("after"):
        pass
    assert _names(trace.snapshot()["spans"]) == ["inside"]


def test_the_flag_read_falls_back_to_off(monkeypatch):
    monkeypatch.setattr(trace, "_profiler", None)
    assert not trace.on()
    trace.enable()
    assert trace.on()


# -- the ring, ids and threads -----------------------------------------------

def test_ring_bound_and_dropped(monkeypatch):
    monkeypatch.setattr(trace, "_spans", collections.deque(maxlen=4))
    trace.enable()
    for i in range(10):
        with trace.span("s", i):
            pass
    snap = trace.snapshot()
    assert [s[1] for s in snap["spans"]] == [6, 7, 8, 9]
    assert snap["dropped"] == 6
    trace.reset()
    assert trace.snapshot()["dropped"] == 0


def test_ids_and_parents_nest():
    trace.enable()
    with trace.span("outer", "req:1"):
        with trace.span("same"):
            with trace.setup("always"):
                pass
        with trace.span("own", "pack:2"):
            with trace.span("leaf"):
                pass
        with trace.span("fresh", trace.NEW):
            pass
    with trace.span("explicit", "a", parent="b"):
        pass
    got = {s[0]: s[1:3] for s in trace.snapshot()["spans"]}
    assert got["outer"] == ("req:1", None)
    assert got["same"] == ("req:1", "req:1")
    assert got["own"] == ("pack:2", "req:1")
    assert got["leaf"] == ("pack:2", "pack:2")
    assert isinstance(got["fresh"][0], int) and got["fresh"][1] == "req:1"
    assert got["explicit"] == ("a", "b")
    assert trace.snapshot()["setup"][0][1:3] == ("req:1", "req:1")
    spans = {s[0]: s for s in trace.snapshot()["spans"]}
    assert spans["outer"][3] <= spans["leaf"][3] <= spans["leaf"][4] \
        <= spans["outer"][4]


def test_spans_from_two_threads():
    trace.enable()
    go = threading.Barrier(2)

    def work(tag):
        go.wait()
        for i in range(50):
            with trace.span("outer", f"{tag}:{i}"):
                with trace.span("inner"):
                    pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = trace.snapshot()["spans"]
    assert len(spans) == 200
    for name, sid, parent, _, _ in spans:
        if name == "inner":
            assert parent == sid and sid.split(":")[0] in "ab"
    for tag in "ab":
        assert sum(s[0] == "inner" and s[1].startswith(tag)
                   for s in spans) == 50


# -- counters and the registry -----------------------------------------------

def test_registry_holds_the_launch_dicts():
    held = trace.counter_dicts()
    for mod in (lstm_kernel, gru_kernel, select_kernel, coarse_kernel):
        for d in (mod.LAUNCHES, mod.VARIANT_LAUNCHES, mod.DEVICE_LAUNCHES):
            assert any(d is h for h in held)
    for mod in (topk_kernel, score_kernel):
        assert any(mod.LAUNCHES is h for h in held)
        assert any(mod.DEVICE_LAUNCHES is h for h in held)
    names = trace.counters()
    assert "lstm_kernel.launches.lstm_pooled" in names
    assert "select_kernel.variant_launches.mma" in names
    assert "topk_kernel.launches.row_topk_filter" in names
    assert "topk_kernel.launches.row_topk_merge" in names
    assert "score_kernel.launches.score_gemm" in names


@pytest.mark.parametrize("n, route", [(100, "select.key64"),
                                      (topk.KEY_MAX + 1,
                                       "select.order32_tie")])
def test_the_select_counts_its_route(monkeypatch, n, route):
    monkeypatch.setattr(topk, "KEY_BATCH", 1)
    topk.topk_lowest_index(torch.randn(2, n), 3)
    assert trace.counters() == {**trace.counters(), route: 1}
    other = ({"select.key64", "select.order32_tie"} - {route}).pop()
    assert other not in trace.counters()


def test_the_kernel_route_is_counted(monkeypatch):
    """Long f32 rows on the card count ``select.kernel`` (here the CPU
    stands for the card, the kernel's plain version in its place)."""
    route_to_the_plain_kernel(monkeypatch)
    topk.topk_lowest_index(torch.randn(2, topk.KEY_MAX + 1), 3)
    counted = trace.counters()
    assert counted["select.kernel"] == 1
    assert "select.key64" not in counted
    assert "select.order32_tie" not in counted


@pytest.mark.parametrize("device, dtype, route", [
    ("card", torch.float32, "score.kernel"),
    ("meta", torch.bfloat16, "score.library"),
    ("cpu", torch.float32, None),
    ("cpu", torch.bfloat16, None),
])
def test_the_score_counts_its_route(monkeypatch, device, dtype, route):
    """An f32 product on the card counts ``score.kernel`` (here the CPU
    stands for the card, the kernel's plain version in its place), a bf16
    one off the CPU ``score.library``; the CPU's plain product counts
    neither."""
    a, b = torch.randn(4, 16), torch.randn(30, 16).T    # index rows, as
    if device == "card":                                # fused_corpus_scores
        route_scores_to_the_plain_kernel(monkeypatch)
    elif device == "meta":
        a, b = a.to("meta"), b.to("meta")
    sharding.score_mm(a, b, dtype)
    counted = {k: n for k, n in trace.counters().items()
               if k.startswith("score.")}
    assert counted == ({route: 1} if route else {})


def _stand_in(graph):
    """The capture step on the CPU: the warm-up, then the recording, with
    ``graph`` (a list that the function under test grows by one item a
    device node) standing for the graph being recorded."""
    def capture(self, warm, record):
        warm()
        graph.clear()
        saved, trace._node_count = trace._node_count, lambda: len(graph)
        try:
            outs = record()
        finally:
            trace._node_count = saved
        return _StandIn(warm, outs), outs
    return capture


@pytest.fixture
def on_card(monkeypatch):
    graph = []          # the device nodes the stand-in graph holds so far
    monkeypatch.setattr(BatchGraphs, "_on_card", lambda self, args: True)
    monkeypatch.setattr(BatchGraphs, "_warm_and_record", _stand_in(graph))
    return graph


def test_replays_add_a_registered_counters_delta(on_card):
    mine = trace.register("test.mine", {})

    def f(x):
        mine["calls"] = mine.get("calls", 0) + 1
        trace.count("test.own", 2)
        return x + 1.0

    g = BatchGraphs(f, (0,), "a counting function")
    for i in range(4):
        g(torch.full((2,), float(i)))
    # the warm-up counted once; the capture was taken back; 4 replays
    assert mine["calls"] == 5
    c = trace.counters()
    assert c["test.own"] == 10 and c["test.mine.calls"] == 5
    assert (c["graphs.calls"], c["graphs.replays"],
            c["graphs.captures"]) == (4, 4, 1)


def test_a_stage_map_from_the_node_count(on_card):
    def batch(x):
        trace.stage("encode")
        on_card.extend("kkk")
        trace.stage("score")
        on_card.extend("km")
        trace.stage("select")
        on_card.extend("kkkk")
        return x * 2.0

    g = BatchGraphs(batch, (0,), "a marked batch")
    g(torch.ones(3))
    (entry,) = g._graphs.values()
    want = [("encode", 3), ("score", 2), ("select", 4)]
    assert entry.stages == want
    maps = trace.snapshot()["stages"]
    assert maps == [{"id": g.id, "name": "a marked batch", "stages": want}]
    capture = [s for s in trace.snapshot()["setup"]
               if s[0] == "graphs.capture"]
    assert len(capture) == 1 and capture[0][1] == g.id
    # the first: the stand-in's replays run the warm-up's function again
    parts = {}
    for s in trace.snapshot()["setup"]:
        parts.setdefault(s[0], s)
    assert parts["graphs.warm"][1:3] == (g.id, g.id)
    assert parts["graphs.record"][1:3] == (g.id, g.id)


def test_a_mark_outside_a_capture_reads_nothing(monkeypatch):
    def boom():
        raise AssertionError("read the node count outside a capture")

    monkeypatch.setattr(trace, "_node_count", boom)
    trace.stage("score")
    assert trace.stage_map([("a", 2), ("b", 5)], 6) == [
        ("unmarked", 2), ("a", 3), ("b", 1)]


def test_batch_call_spans_only_while_on(on_card, monkeypatch):
    monkeypatch.setattr("vfr_tpu_torch.utils.graphs.MAX_GRAPHS", 1)
    g = BatchGraphs(lambda x: x - 1.0, (0,), "minus one")
    g(torch.ones(2))
    assert trace.snapshot()["spans"] == []
    trace.enable()
    g(torch.ones(2))
    g(torch.ones(3))                     # a new key evicts the first
    spans = trace.snapshot()["spans"]
    calls = [s for s in spans if s[0] == "graphs.call"]
    assert len(calls) == 2
    for call in calls:
        kids = [s for s in spans if s[2] == call[1] and s is not call]
        assert _names(kids) == ["graphs.key", "graphs.inputs",
                                "graphs.replay", "graphs.outputs"]
        assert all(call[3] <= k[3] <= k[4] <= call[4] for k in kids)
    capture = [s for s in trace.snapshot()["setup"]
               if s[0] == "graphs.capture"]
    assert capture[-1][2] == calls[1][1]  # captured inside the second call
    assert trace.counters()["graphs.evictions"] == 1


def test_kernel_load_and_build_spans(monkeypatch):
    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    built = []
    monkeypatch.setattr(build, "_start", lambda name: ("job", name))
    monkeypatch.setattr(build, "_finish",
                        lambda name, job: built.append(job))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.delitem(build._libs, "coarse_blockmax", raising=False)
    try:
        build.load("coarse_blockmax")
        build.load("coarse_blockmax")           # cached: no span
    finally:
        build._libs.pop("coarse_blockmax", None)
    spans = trace.snapshot()["setup"]
    assert _names(spans) == ["kernels.build", "kernels.load"]
    assert spans[1][1:3] == ("coarse_blockmax", None)
    assert spans[0][1:3] == ("coarse_blockmax", "coarse_blockmax")
    assert built == [("job", "coarse_blockmax")]


def test_export_is_chrome_trace_on_the_base(tmp_path):
    trace.enable()
    with trace.span("pack.tokens", "pack:0"):
        pass
    trace.count("daemon.packs")
    base = trace.snapshot()["spans"][0][3] - 5000
    doc = json.load(open(trace.export_chrome(str(tmp_path / "p.json"),
                                             base)))
    b, e = doc["traceEvents"]
    assert (b["ph"], e["ph"], b["id"], b["cat"]) == ("b", "e", "pack:0",
                                                     "pack")
    assert b["ts"] == pytest.approx(5.0) and e["ts"] >= b["ts"]
    assert doc["baseTimeNanoseconds"] == base
    assert doc["otherData"]["counters"]["daemon.packs"] == 1


# -- the daemon and the CLI --------------------------------------------------

@pytest.fixture(scope="module")
def w():
    return world()


def test_follow_records_a_request_span_per_line(w):
    trace.enable()
    lines = [f"w{i:04d} w{i + 1:04d}" for i in range(11)]
    recs = list(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                     iter(lines), k=3, micro_batch=4,
                                     max_query_len=12))
    assert [r["query"] for r in recs] == lines
    snap = trace.snapshot()
    req = [s for s in snap["spans"] if s[0] == "request"]
    assert sorted(s[1] for s in req) == sorted(
        f"request:{n}" for n in range(len(lines)))
    packs = {s[1] for s in snap["spans"] if s[0].startswith("pack.")}
    for name, sid, parent, a, b in req:
        assert parent in packs and a <= b
    queue = {s[1]: s for s in snap["spans"] if s[0] == "queue"}
    for name, sid, parent, a, b in req:
        q = queue[sid]
        assert q[2] == sid and a == q[3] <= q[4] <= b
    for pack in packs:
        got = sorted(s[0] for s in snap["spans"] if s[1] == pack)
        assert got == ["pack.dispatch", "pack.records", "pack.tokens",
                       "pack.wait"]
    c = snap["counters"]
    sizes = {int(k.rsplit(".", 1)[1]): n for k, n in c.items()
             if k.startswith("daemon.pack_size.")}
    assert sum(k * n for k, n in sizes.items()) == c["daemon.requests"] \
        == len(lines)
    assert sum(sizes.values()) == c["daemon.packs"] == len(packs)


def test_follow_off_counts_without_spans(w):
    lines = ["w0001", "w0002 w0003"]
    list(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                              iter(lines), k=3, micro_batch=4,
                              max_query_len=12))
    snap = trace.snapshot()
    assert snap["spans"] == []
    assert snap["counters"]["daemon.requests"] == 2


def test_cli_serve_trace_dir(tmp_path, capsys):
    from vfr_tpu_torch import cli

    q = tmp_path / "q.txt"
    q.write_text("w0001 w0002\nw0003\n")
    out = tmp_path / "tr"
    assert cli.main(["serve", "--preset", "didemo_rgb", "--data-dir",
                     str(tmp_path / "none"), "--queries", str(q),
                     "--device", "cpu", "--follow", "--trace-dir",
                     str(out)]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 2
    prof = json.load(open(out / "serve_trace.json"))
    port = json.load(open(out / "port_spans.json"))
    assert port["baseTimeNanoseconds"] == prof["baseTimeNanoseconds"]
    names = {e["name"] for e in port["traceEvents"]}
    assert {"request", "queue", "pack.dispatch", "setup.operands"} <= names
    ops = [e["ts"] for e in prof["traceEvents"] if e.get("ph") == "X"]
    ts = [e["ts"] for e in port["traceEvents"] if e["name"] == "request"]
    assert min(ops) - 1e6 < min(ts) and max(ts) < max(ops) + 1e6
    assert port["otherData"]["counters"]["daemon.requests"] == 2
