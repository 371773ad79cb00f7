"""The readers of the port's recorder (``port_trace.py`` and the five
metrics on it) on synthetic records and snapshots: a replay split by the
stage map its capture kept, a group that matches no map left out, no
match at all read as nothing, spans outside the traced range ignored, and
a port without a recorder read as nothing."""

import pytest

from vfrbench import catalog, port_trace, work

SHAPES = {"Q": 256, "live_steps": 14.0 * 256, "T": 24, "E": 300,
          "H": 1024, "layers": 1, "d": 128, "streams": 2,
          "compute_dtype": "float32", "per_stream_proj": False,
          "N": 210000, "index_dtype": "float32", "score_dtype": "float32",
          "k": 10}
MAP = [("encode", 3), ("score", 2), ("select", 4)]
T0 = 10 ** 12
NEW = ["encode_stage_roofline.batch", "score_stage_roofline.batch",
       "select_stage_roofline.batch", "dispatch_host_us.batch",
       "port_setup_s.batch"]


def _replay(t, corr, durs):
    out = []
    for d in durs:
        out.append((t, d, f"k{len(out)}", corr))
        t += d + 10
    return out


def _record(groups, setup_s=5.0, seconds=10.0):
    kernels = []
    t = T0
    for corr, durs in groups:
        kernels += _replay(t, corr, durs)
        t = kernels[-1][0] + kernels[-1][1] + 1000
    return {"kind": "batch", "setup_s": setup_s,
            "window": {"shapes": SHAPES, "seconds": seconds},
            "trace": {"kernels": sorted(kernels)}}


REPLAY = [100, 200, 300, 1000, 1000, 50, 50, 50, 50]     # 3 / 2 / 4


def _snap(spans=(), setup=(), maps=(MAP,)):
    return {"spans": list(spans), "setup": list(setup), "counters": {},
            "stages": [{"id": "graphs:1", "name": "r", "stages": list(m)}
                       for m in maps], "dropped": 0}


@pytest.fixture
def snap(monkeypatch):
    held = {}
    monkeypatch.setattr(port_trace, "snapshot", lambda: held.get("snap"))
    return held


def _read(name, rec):
    return catalog.load_module("metrics", name).read(rec)


def test_replays_split_by_the_map(snap):
    snap["snap"] = _snap()
    rec = _record([(1, REPLAY), (2, [5]), (3, REPLAY), (4, [1, 2, 3, 4, 5]),
                   (5, [7])])
    split, left = port_trace.stage_split(rec["trace"]["kernels"],
                                         snap["snap"]["stages"])
    assert left == 1                       # the group of five
    assert split == [{"encode": 600e-9, "score": 2000e-9,
                      "select": 200e-9}] * 2
    counts = {"encode": work.encode_work, "score": work.score_work,
              "select": work.select_work}
    for stage, secs in split[0].items():
        least, _ = work.bound(*counts[stage](SHAPES))
        got = _read(f"{stage}_stage_roofline.batch", rec)
        assert got == pytest.approx(100.0 * least / secs)


def test_no_group_matches(snap):
    snap["snap"] = _snap(maps=[[("encode", 2), ("score", 2)]])
    rec = _record([(1, REPLAY), (2, [5])])
    assert port_trace.stage_split(rec["trace"]["kernels"],
                                  snap["snap"]["stages"]) == ([], 1)
    for name in NEW[:3]:
        assert _read(name, rec) is None


def test_two_splits_of_one_total_are_left_out(snap):
    snap["snap"] = _snap(maps=[MAP, [("encode", 4), ("score", 1),
                                     ("select", 4)]])
    rec = _record([(1, REPLAY)])
    assert _read("select_stage_roofline.batch", rec) is None


def test_dispatch_host_us_reads_the_traced_range(snap):
    rec = _record([(1, REPLAY), (3, REPLAY)])
    lo, hi = port_trace.traced_range(rec)
    calls = [("graphs.call", 1, None, lo - 10 ** 6, lo - 10 ** 5),  # before
             ("graphs.call", 2, None, lo - 100, lo + 900),      # overlaps
             ("graphs.key", 2, 2, lo, lo + 10),
             ("graphs.call", 3, None, lo + 1000, lo + 4000),
             ("graphs.call", 4, None, hi + 1, hi + 10 ** 6)]     # after
    snap["snap"] = _snap(spans=calls)
    assert _read("dispatch_host_us.batch", rec) == pytest.approx(
        (1000 + 3000) / 2 / 1e3)
    snap["snap"] = _snap(spans=calls[:1])
    assert _read("dispatch_host_us.batch", rec) is None


def test_port_setup_s_is_the_union_of_this_runs_spans(snap):
    rec = _record([(1, REPLAY)], setup_s=2.0, seconds=1.0)
    lo = T0 - 3 * 10 ** 9
    s = 10 ** 9
    setup = [("setup.operands", None, None, lo - s, lo - s // 2),  # earlier
             ("kernels.load", "a", None, lo + s, lo + 2 * s),
             ("kernels.build", "a", "a", lo + s, lo + 2 * s - 1),
             ("graphs.capture", "g", None, lo + s + s // 2, lo + 2 * s + s
              // 2),
             ("graphs.warm", "g", "g", lo + s + s // 2, lo + 2 * s),
             ("setup.query_params", None, None, lo + 2 * s + s // 2 + 10,
              lo + 2 * s + s // 2 + 20),
             ("graphs.capture", "g", None, T0 + 5, T0 + 50)]       # later
    snap["snap"] = _snap(setup=setup)
    assert _read("port_setup_s.batch", rec) == pytest.approx(1.5 + 10e-9)


def test_without_a_recorder_nothing_is_read(snap):
    rec = _record([(1, REPLAY)])
    for name in NEW:
        assert _read(name, rec) is None
    rec = dict(_record([(1, REPLAY)]), kind="daemon")
    snap["snap"] = _snap()
    for name in NEW:
        assert _read(name, rec) is None


def test_the_port_snapshot_is_read():
    got = port_trace.snapshot()
    assert got is not None
    assert {"spans", "setup", "counters", "stages", "dropped"} <= set(got)
