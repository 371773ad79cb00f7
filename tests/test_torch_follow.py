"""Daemon serving (``serve_follow``, ``cli serve --follow``) of the port
against the JAX package, on the same numpy weights (small widths).

* Records equal the JAX package's ``serve_follow`` records on the same
  lines for exact, fused (K2's plain version) and coarse (one shared index
  and coarse file): moments equal outside near-ties, distances within
  atol 1e-4.
* The scheduler: waiting lines are packed into one dispatch and answered
  in order, an isolated request is flushed without a successor, depth 1
  works, an error of the input comes after the results before it, and the
  reader's lookahead is bounded.
* ``cli serve --follow --live-capacity-videos`` runs one script of queries
  and control lines through both CLIs with equal records, and each boots
  again from the other's ``!save`` snapshot (``--live-arena``).
"""

import io
import json
import threading

import numpy as np
import pytest

from torch_live_world import world
from vfr_tpu.eval import coarse as jcoarse
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu_torch.eval import coarse as tcoarse
from vfr_tpu_torch.eval import corpus as tcorpus

K = 5


@pytest.fixture(scope="module")
def w():
    return world()


def _queries(n=13, seed=3):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{int(rng.integers(0, 150)):04d}"
                     for _ in range(1 + int(rng.integers(0, 10))))
            for _ in range(n)]


def assert_records_match(got, ref, tol=1e-4):
    """Same queries; per query the moments equal outside near-ties (a
    moment whose reference distance lies within 2 tol of a neighbour's)
    and distances within ``tol``."""
    assert [r["query"] for r in got] == [r["query"] for r in ref]
    for a, b in zip(got, ref):
        ma = [(r["video"], r["start"], r["end"]) for r in a["results"]]
        mb = [(r["video"], r["start"], r["end"]) for r in b["results"]]
        da = np.array([r["distance"] for r in a["results"]])
        db = np.array([r["distance"] for r in b["results"]])
        np.testing.assert_allclose(da, db, atol=tol)
        for i in [i for i in range(len(ma)) if ma[i] != mb[i]]:
            near = [abs(db[i] - db[n]) for n in (i - 1, i + 1)
                    if 0 <= n < len(db)]
            assert near and min(near) <= 2 * tol, (i, ma, mb, db)


@pytest.mark.parametrize("mode", ["exact", "fused", "coarse"])
def test_follow_records_match_jax(w, tmp_path, mode):
    lines = _queries()
    kw = dict(k=K, micro_batch=4, max_query_len=12)
    jkw, tkw = dict(kw), dict(kw)
    if mode == "fused":
        jkw["topk_method"] = tkw["topk_method"] = "fused"
    if mode == "coarse":
        jidx = jcorpus.build_moment_index(w.jparams, w.jmodel, w.jds)
        tidx = tcorpus.load_index(
            jcorpus.save_index(jidx, str(tmp_path / "idx")), device="cpu")
        jc = jcoarse.build_coarse_index(jidx, d_coarse=4)
        tc = tcoarse.load_coarse(
            jcoarse.save_coarse(jc, str(tmp_path / "idx.coarse")), tidx)
        jkw.update(index=jidx, coarse=jc, coarse_candidates=64)
        tkw.update(index=tidx, coarse=tc, coarse_candidates=64)
    ref = list(jcorpus.serve_follow(w.jparams, w.jmodel, w.jds, w.vocab,
                                    iter(lines), **jkw))
    got = list(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                    iter(lines), **tkw))
    assert len(got) == len(lines)
    assert all(len(r["results"]) == K for r in got)
    assert_records_match(got, ref)


def test_aggregates_waiting_lines_and_keeps_order(w, monkeypatch):
    calls = []
    real = tcorpus.make_retriever

    def counting(*a, **kw):
        r = real(*a, **kw)

        def wrapped(*ra):
            calls.append(ra[1].shape[0])
            return r(*ra)

        return wrapped

    monkeypatch.setattr(tcorpus, "make_retriever", counting)
    queries = [f"w{i:04d} w{i + 1:04d}" for i in range(10)]
    recs = list(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                     queries, k=3, micro_batch=4))
    assert [r["query"] for r in recs] == queries
    # a list is read ahead at once: packs of 4, not one dispatch per line
    assert len(calls) < 10 and set(calls) == {4}, calls
    oneshot = tcorpus.serve_queries(w.tparams, w.tmodel, w.tds, w.vocab,
                                    queries, k=3, batch_size=4)
    assert_records_match(recs, oneshot, tol=1e-5)


def test_isolated_request_flushes_without_successor(w):
    got_first = threading.Event()

    def lines():
        yield "w0001 w0002"
        assert got_first.wait(timeout=60), \
            "the first result never came: the pipeline held an isolated " \
            "request back"
        yield "w0003 w0004"

    gen = tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab, lines(),
                               k=3, micro_batch=4, pipeline_depth=2)
    assert next(gen)["query"] == "w0001 w0002"
    got_first.set()
    assert next(gen)["query"] == "w0003 w0004"
    assert list(gen) == []


def test_pipeline_depth_one(w):
    queries = [f"w{i:04d}" for i in range(5)]
    recs = list(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                     queries, k=2, micro_batch=2,
                                     pipeline_depth=1))
    assert [r["query"] for r in recs] == queries
    deep = list(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                     queries, k=2, micro_batch=2,
                                     pipeline_depth=3))
    assert recs == deep


def test_input_error_after_served_results(w):
    def broken():
        yield "w0001 w0002"
        raise UnicodeDecodeError("utf-8", b"\xff", 0, 1, "bad byte")

    recs = []
    with pytest.raises(UnicodeDecodeError):
        for rec in tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                        broken(), k=2, micro_batch=4):
            recs.append(rec)
    assert [r["query"] for r in recs] == ["w0001 w0002"]


def test_reader_lookahead_is_bounded(w):
    import itertools
    import time

    pulled = [0]

    def endless():
        for i in itertools.count():
            pulled[0] = i + 1
            yield f"w{i % 20:04d}"

    gen = tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                               endless(), k=2, micro_batch=4)
    next(gen)
    time.sleep(0.5)
    # queue (4 * 4 + 2) + two packs in flight + the put the reader is
    # blocked on
    assert pulled[0] <= (4 * 4 + 2) + 2 * 4 + 1, pulled[0]
    gen.close()


def test_refusals(w):
    import torch

    from vfr_tpu_torch.eval.live import make_live_index
    from vfr_tpu_torch.parallel.mesh import make_mesh

    live = make_live_index(w.tparams, w.tmodel, w.tds, capacity_videos=12)
    # a mesh serves, but a live arena must be built on that same mesh
    mesh = make_mesh(("corpus",), devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="built on that mesh"):
        next(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                  ["w0001"], mesh=mesh, live=live))
    with pytest.raises(ValueError, match="no coarse"):
        next(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                  ["w0001"], live=live, coarse_dim=4))
    # live serving is the exact scan: fused raises at the first pack, as
    # in the JAX package
    with pytest.raises(ValueError, match="fused"):
        next(tcorpus.serve_follow(w.tparams, w.tmodel, w.tds, w.vocab,
                                  ["w0001"], live=live, topk_method="fused"))


# ------------------------------------------------------------ both CLIs

F_CLI = 32


def _cli_preset(data_dir):
    """didemo_rgb narrowed for the CPU (feature 32, hidden 32, joint 16) on
    the synthetic fixture; the same config for both packages."""
    import dataclasses

    from vfr_tpu.config import get_preset as j_get_preset
    from vfr_tpu_torch.config import get_preset as t_get_preset

    out = []
    for get in (j_get_preset, t_get_preset):
        cfg = get("didemo_rgb")
        out.append(dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, data_dir=str(data_dir),
                                     feature_dim=F_CLI,
                                     synthetic_num_videos=16,
                                     synthetic_num_queries=48),
            model=dataclasses.replace(cfg.model, lstm_hidden=32,
                                      joint_dim=16)))
    return out


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """(tmp dir, JAX preset, port preset): the JAX CLI serves its seeded
    weights from an empty checkpoint dir, the port the same tree from
    ``params.npz``."""
    import dataclasses

    import jax

    from vfr_tpu.train.loop import load_for_eval as j_load_for_eval
    from vfr_tpu_torch.bridge import save_params_npz

    d = tmp_path_factory.mktemp("follow_cli")
    jpre, tpre = _cli_preset(d / "none")
    params, _, _ = j_load_for_eval(dataclasses.replace(
        jpre, train=dataclasses.replace(jpre.train,
                                        checkpoint_dir=str(d / "jck"))))
    (d / "tck").mkdir()
    save_params_npz(str(d / "tck" / "params.npz"),
                    jax.tree.map(np.asarray, jax.device_get(params)))
    return d, jpre, tpre


def _run_both(cli_world, monkeypatch, capsys, stdin, extra):
    import vfr_tpu.cli as jcli
    import vfr_tpu_torch.cli as tcli

    d, jpre, tpre = cli_world
    out = {}
    for name, mod, pre, ck, dev in (
            ("jax", jcli, jpre, d / "jck", []),
            ("port", tcli, tpre, d / "tck", ["--device", "cpu"])):
        monkeypatch.setattr(mod, "get_preset", lambda _n, p=pre: p)
        monkeypatch.setattr("sys.stdin",
                            io.StringIO(stdin.replace("{who}", name)))
        rc = mod.main(["serve", "--preset", "didemo_rgb",
                       "--data-dir", str(d / "none"),
                       "--checkpoint-dir", str(ck), "--queries", "-",
                       "--follow", "--topk", "3", *extra(name), *dev])
        assert rc == 0
        out[name] = [json.loads(line) for line in
                     capsys.readouterr().out.splitlines() if line.strip()]
    return out


def test_live_cli_script_both_clis(cli_world, monkeypatch, capsys):
    d = cli_world[0]
    rng = np.random.default_rng(33)
    delta = d / "delta.npz"
    np.savez(delta,
             video_ids=np.asarray([f"fresh{i:04d}" for i in range(4)]),
             rgb=rng.standard_normal((4, 6, F_CLI)).astype(np.float32))
    stdin = ("w0001 w0002\n"
             f"!add {delta}\n"
             "w0003 w0004\n"
             f"!add {delta}\n"            # duplicate: an error record
             "!remove fresh0001\n"
             "w0005 w0006\n"
             "!stats\n"
             "!compact\n"
             "!grow 24\n"
             "!bogus\n"
             f"!save {d}/arena_{{who}}.npz\n"
             "w0007 w0008\n")
    out = _run_both(cli_world, monkeypatch, capsys, stdin,
                    lambda who: ["--live-capacity-videos", "18"])
    got, ref = out["port"], out["jax"]
    assert len(got) == len(ref) == 12
    queries = [0, 2, 5, 11]
    assert_records_match([got[i] for i in queries],
                         [ref[i] for i in queries])
    for i in sorted(set(range(12)) - set(queries)):
        a, b = dict(got[i]), dict(ref[i])
        if "saved" in a:
            assert a.pop("saved").endswith("arena_port.npz")
            assert b.pop("saved").endswith("arena_jax.npz")
            a["command"] = a["command"].replace("port", "jax")
        assert a == b, (i, a, b)
    assert got[1]["added_rows"] == 4 * 21
    assert "already in the corpus" in got[3]["error"]
    assert got[4]["removed_rows"] == 21
    assert got[6]["tombstoned_rows"] == 21
    assert got[7]["reclaimed_rows"] == 21
    assert got[8]["capacity_rows"] == 24 * 21
    assert "unknown control line" in got[9]["error"]
    assert all(r["video"] != "fresh0001" for r in got[5]["results"])

    # each package boots from the OTHER's snapshot
    boot = _run_both(
        cli_world, monkeypatch, capsys, "w0007 w0008\n!stats\n",
        lambda who: ["--live-arena",
                     str(d / ("arena_port.npz" if who == "jax"
                              else "arena_jax.npz"))])
    assert_records_match(boot["port"][:1], [ref[11]])
    assert_records_match(boot["jax"][:1], [ref[11]])
    assert boot["port"][1] == boot["jax"][1] == ref[6] | {
        "tombstoned_rows": 0, "capacity_rows": 24 * 21,
        "used_rows": ref[6]["used_rows"] - 21,
        "free_rows": 24 * 21 - ref[6]["used_rows"] + 21,
        "num_videos": ref[6]["num_videos"] - 1}


def test_follow_cli_non_live_and_refusal(cli_world, monkeypatch, capsys,
                                         tmp_path):
    """Non-live ``--follow`` (one pack per waiting burst) equals the JAX
    CLI; live serving with ``--index-path`` exits 2 with the JAX package's
    message."""
    import vfr_tpu_torch.cli as tcli

    out = _run_both(cli_world, monkeypatch, capsys,
                    "w0001 w0002\nw0003\nw0010 w0011 w0012\n",
                    lambda who: ["--micro-batch", "2"])
    assert len(out["port"]) == 3
    assert_records_match(out["port"], out["jax"])
    d, _, tpre = cli_world
    monkeypatch.setattr(tcli, "get_preset", lambda _n: tpre)
    idx = str(tmp_path / "idx.npz")
    common = ["--preset", "didemo_rgb", "--data-dir", str(d / "none"),
              "--checkpoint-dir", str(d / "tck"), "--device", "cpu"]
    assert tcli.main(["index", *common, "--out", idx]) == 0
    capsys.readouterr()
    monkeypatch.setattr("sys.stdin", io.StringIO("w0001\n"))
    assert tcli.main(["serve", *common, "--queries", "-", "--follow",
                      "--index-path", idx,
                      "--live-capacity-videos", "20"]) == 2
    assert "live serving is exact serving" in capsys.readouterr().err
