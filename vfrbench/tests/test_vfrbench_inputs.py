"""The traffic generators: the same seed gives the same inputs; every seed
gets the same set of gaps in another order; the daemon's lateness is
measured from each request's due time."""

import time

import numpy as np
import torch

from vfrbench import catalog, inputs
from vfrbench.tests import _tiny
from vfrbench.trace import Tracer


def test_schedule_same_seed_same_due():
    a = inputs.poisson_schedule(500.0, 2.0, 2 ** 40 + 3)
    b = inputs.poisson_schedule(500.0, 2.0, 2 ** 40 + 3)
    assert np.array_equal(a, b)
    assert a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < 2.0


def test_schedule_seeds_share_their_gaps():
    a = inputs.poisson_schedule(500.0, 2.0, 1)
    b = inputs.poisson_schedule(500.0, 2.0, 2)
    assert not np.array_equal(a, b)
    ga, gb = np.sort(np.diff(a)), np.sort(np.diff(b))
    n = min(len(ga), len(gb))
    assert abs(len(ga) - len(gb)) <= 10
    assert np.median(np.abs(ga[:n] - gb[:n])) < 1e-4
    # the mean gap is the rate's
    assert abs(np.mean(np.diff(a)) - 1 / 500.0) < 1e-4


def test_tokens_same_seed_same_batches():
    a = inputs.token_batches(3, 5, 8, 50, 2, 8, 11, "cpu")
    b = inputs.token_batches(3, 5, 8, 50, 2, 8, 11, "cpu")
    c = inputs.token_batches(3, 5, 8, 50, 2, 8, 12, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    toks, lens = a
    assert int(lens.min()) >= 2 and int(lens.max()) <= 8
    live = torch.arange(8)[None, None] < lens[..., None]
    assert bool((toks[live] >= 2).all()) and bool((toks[~live] == 0).all())


def test_params_from_seed_on_the_device():
    s = {"E": 4, "H": 8, "d": 3, "vocab": 10, "layers": 1, "F": 5,
         "stream_names": ("rgb", "flow"), "per_stream_proj": False,
         "global_context": True, "tef": True}
    p = inputs.make_params(s, 2 ** 35, "cpu")
    q = inputs.make_params(s, 2 ** 35, "cpu")
    w = [t["lstm"]["layer0"]["w_hh"] for t in (p, q)]
    assert torch.equal(*w)
    assert p["moment_proj_rgb"]["w"].shape == (12, 3)
    b = p["lstm"]["layer0"]["b"]
    assert float(b[8:16].mean()) > 0.5          # the forget gate's +1


def test_texts_are_vocabulary_words():
    t = inputs.query_texts(20, 50, 2, 8, 9)
    assert t == inputs.query_texts(20, 50, 2, 8, 9)
    words = set(inputs.vocab_words(50))
    for text in t:
        assert 2 <= len(text.split()) <= 8
        assert set(text.split()) <= words


def test_daemon_lateness_is_measured(tmp_path):
    root = _tiny.make_root(str(tmp_path / "root"))
    cell = catalog.cell("tiny-flagship-daemon", root)
    drv = catalog.load_module("drivers", "daemon", root)
    cfg = catalog.experiment(cell.config)
    st = drv.setup(cell, cfg, 4, 0.4, torch.device("cpu"))
    t0 = time.perf_counter()
    win = drv.window(st, 0.4, Tracer(False, 0.4))
    drv.release(st)
    assert win["answered"] == win["requests"] == len(st.due)
    assert len(win["late_s"]) == win["requests"]
    # every latency runs from the due time, which the offer never precedes
    assert np.all(win["latency_s"] >= win["late_s"])
    assert np.all(win["late_s"] >= 0)
    assert win["seconds"] <= time.perf_counter() - t0 + 0.01
