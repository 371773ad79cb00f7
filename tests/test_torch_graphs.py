"""The port's captured batches (``vfr_tpu_torch.utils.graphs``) on the CPU.

No test here runs a GPU.  The wrapper's own steps are checked through a
stand-in capture (``graph_path``): the wrapper takes its graph path for CPU
tensors, and the "graph" re-runs the function over the static inputs and
writes the static outputs in place, as a replay does, without moving the
launch counters.  So the key, the LRU bound, the static buffers, the
cloned and ``out=`` outputs and the launch bookkeeping run as on the card.

* The key is equal after an in-place write to an operand, the arena
  (append, remove) or a params leaf, and differs after a reallocation
  (``live_grow``, a new params tree) and a new Q or T.
* The cache keeps at most ``MAX_GRAPHS`` graphs, least recently used out
  first; a dropped retriever frees its graphs.
* The counters a capture moves are taken back, and every replay adds them;
  a failed capture raises, names the function, caches nothing and leaves
  the counters as they were; the record runs on the warm-up's stream.
* Every graphed retriever (exact, stream, live, fused), on the wrapper's
  CPU path and through the stand-in capture over several batches, returns
  bit for bit what its eager function returns, and what the JAX package
  returns on the same inputs: rows equal, distances within rtol 1e-5,
  atol 1e-6, as ``test_torch_live.py`` states.
* A captured exact batch over an f32 index, the CPU standing for the card
  (the score kernel's plain version in its place), counts its score's
  route (``score.kernel``) and the kernel's launch once a replay.
"""

import contextlib
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_kernel_route import route_scores_to_the_plain_kernel
from torch_live_world import world
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.eval import live as jlive
from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.eval import live as tlive
from vfr_tpu_torch.ops.kernels import lstm_kernel, score_kernel, select_kernel
from vfr_tpu_torch.utils import graphs, trace
from vfr_tpu_torch.utils.graphs import BatchGraphs, write_out
from vfr_tpu_torch.utils.tree import tree_map

K = 5
TOL = dict(rtol=1e-5, atol=1e-6)


class _StandIn:
    """A captured graph on the CPU: ``replay`` re-runs the function over
    the static inputs and writes the static outputs in place; the launch
    counters it moves are put back (a replay runs no Python)."""

    def __init__(self, warm, outs):
        self.warm, self.outs = warm, outs

    def replay(self):
        counters = trace.counter_dicts()
        saved = [dict(c) for c in counters]
        res = self.warm()
        for c, s in zip(counters, saved):
            c.clear()
            c.update(s)
        write_out(res, self.outs)


def _stand_in_capture(self, warm, record):
    """The capture step on the CPU; the stand-in graph holds no device
    nodes for the stage marks to count."""
    warm()
    saved, trace._node_count = trace._node_count, lambda: 0
    try:
        outs = record()
    finally:
        trace._node_count = saved
    return _StandIn(warm, outs), outs


@pytest.fixture
def graph_path(monkeypatch):
    monkeypatch.setattr(BatchGraphs, "_on_card", lambda self, args: True)
    monkeypatch.setattr(BatchGraphs, "_warm_and_record", _stand_in_capture)


@pytest.fixture(scope="module")
def w():
    return world()


def _batches(w, n=3):
    bs = list(w.tds.eval_batches(8, with_features=False))[:n]
    return (np.stack([b["tokens"] for b in bs]),
            np.stack([b["lengths"] for b in bs]))


def _index(w):
    return tcorpus.build_moment_index(w.tparams, w.tmodel, w.tds,
                                      with_fingerprint=False)


def _args(w, m_cat, msq):
    return (m_cat, msq, w.tparams, torch.from_numpy(w.toks),
            torch.from_numpy(w.lens))


# -- the key -----------------------------------------------------------------

@pytest.mark.parametrize("write", ["operand", "norms", "params_leaf",
                                   "live_append", "live_remove"])
def test_key_kept_by_in_place_writes(w, write):
    live = tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                                 capacity_videos=24)
    retr = tlive.make_live_retriever(w.tmodel, live, K)
    g = retr.current().graphs
    before = g.key(_args(w, live.m_cat, live.msq_fused))
    if write == "operand":
        live.m_cat.copy_(live.m_cat * 2.0)
    elif write == "norms":
        live.msq_fused.add_(1.0)
    elif write == "params_leaf":
        w.tparams["embeddings"].mul_(1.0)
    elif write == "live_append":
        d = w.delta
        tlive.live_append(live, w.tparams, w.tmodel, w.tds, d.video_ids[:2],
                          d.rgb_feats[:2], flow=d.flow_feats[:2])
    else:
        tlive.live_remove(live, [w.tds.video_ids[0]])
    assert retr.current().graphs is g
    assert g.key(_args(w, live.m_cat, live.msq_fused)) == before


@pytest.mark.parametrize("change", ["live_grow", "params_tree", "Q", "T"])
def test_key_changes_on_reallocation(w, change):
    live = tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                                 capacity_videos=24)
    g = tlive.make_live_retriever(w.tmodel, live, K).current().graphs
    args = _args(w, live.m_cat, live.msq_fused)
    before = g.key(args)
    if change == "live_grow":
        tlive.live_grow(live, 30)
        args = _args(w, live.m_cat, live.msq_fused)
    elif change == "params_tree":
        args = args[:2] + (tree_map(torch.clone, w.tparams),) + args[3:]
    elif change == "Q":
        args = args[:3] + (args[3][:4], args[4][:4])
    else:
        args = args[:3] + (args[3][:, :5].contiguous(), args[4])
    assert g.key(args) != before


# -- the cache -----------------------------------------------------------------

def test_lru_bound(graph_path, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    g = BatchGraphs(lambda x: x * 2.0, (0,), "twice")
    for n in (1, 2, 3):
        assert torch.equal(g(torch.ones(n)), torch.full((n,), 2.0))
    assert len(g) == 2 and g.captures == 3
    g(torch.ones(3))                      # still held
    assert g.captures == 3
    g(torch.ones(1))                      # evicted first: captured again
    assert len(g) == 2 and g.captures == 4
    g(torch.ones(3))                      # used more lately than 2
    g(torch.ones(2))                      # 2 was the least recent: gone
    assert g.captures == 5


@pytest.mark.parametrize("make", ["score_topk", "stream", "fused", "live"])
def test_dropping_a_retriever_frees_its_graphs(w, graph_path, make):
    idx = _index(w)
    if make == "score_topk":
        retr = tcorpus.make_score_topk(w.tmodel, idx, K)
    elif make == "stream":
        retr = tcorpus.make_stream_retriever(w.tmodel, idx, K)
    elif make == "fused":
        retr = tcorpus.make_retriever(w.tmodel, idx, K, topk_method="fused")
    else:
        live = tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                                     capacity_videos=16)
        retr = tlive.make_live_retriever(w.tmodel, live, K)
    toks, lens = (torch.from_numpy(a) for a in _batches(w, 2))
    if make == "stream":
        retr(w.tparams, toks, lens)
        g = retr.graphs
    else:
        retr(w.tparams, toks[0], lens[0])
        g = retr.current().graphs if make == "live" else retr.graphs
    assert len(g) == 1 and g.captures == 1
    ref = weakref.ref(g)
    del retr, g
    gc.collect()
    assert ref() is None


# -- the launch counts -----------------------------------------------------------

def _counting(x):
    lstm_kernel.LAUNCHES["lstm_hs"] += 1
    lstm_kernel.VARIANT_LAUNCHES["persistent"] += 1
    lstm_kernel.DEVICE_LAUNCHES["cpu"] = \
        lstm_kernel.DEVICE_LAUNCHES.get("cpu", 0) + 1
    select_kernel.LAUNCHES["distance_select"] += 2
    return x + 1.0


def _counts():
    return (lstm_kernel.LAUNCHES["lstm_hs"],
            lstm_kernel.VARIANT_LAUNCHES["persistent"],
            lstm_kernel.DEVICE_LAUNCHES.get("cpu", 0),
            select_kernel.LAUNCHES["distance_select"])


def test_replays_add_the_captured_launches(graph_path):
    g = BatchGraphs(_counting, (0,), "a counting function")
    c0 = np.array(_counts())
    step = np.array([1, 1, 1, 2])
    # first call: the warm-up ran (counted), the capture is taken back,
    # the replay adds one call's launches
    assert torch.equal(g(torch.zeros(3)), torch.ones(3))
    assert (np.array(_counts()) - c0 == 2 * step).all()
    for i in range(1, 4):
        g(torch.full((3,), float(i)))
        assert (np.array(_counts()) - c0 == (2 + i) * step).all()
    assert g.captures == 1


def test_replays_add_counts_registered_by_the_warm_up(graph_path,
                                                      monkeypatch):
    """A kernel module imported by the batch's first call registers its
    launch dict during the capture's warm-up: its launches are taken back
    from the recording and added by every replay as the others are."""
    monkeypatch.setattr(trace, "_registry", list(trace._registry))
    late = []

    def first_import_counts(x):
        if not late:
            late.append(trace.register("late_kernel.launches", {"k": 0}))
        late[0]["k"] += 1
        return x + 1.0

    g = BatchGraphs(first_import_counts, (0,), "a lazily imported kernel")
    g(torch.zeros(2))
    launches = trace.counters()["late_kernel.launches.k"]
    assert launches == 2                  # the warm-up and the replay
    for i in range(3):
        g(torch.ones(2))
    assert trace.counters()["late_kernel.launches.k"] == launches + 3
    assert g.captures == 1


def test_failed_capture_raises_and_caches_nothing(monkeypatch):
    monkeypatch.setattr(BatchGraphs, "_on_card", lambda self, args: True)

    def refuse(self, warm, record):
        warm()
        record()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(BatchGraphs, "_warm_and_record", refuse)
    g = BatchGraphs(_counting, (0,), "the counting retriever")
    c0 = np.array(_counts())
    with pytest.raises(RuntimeError, match="the counting retriever.*not "
                       "permitted"):
        g(torch.zeros(3))
    assert len(g) == 0 and g.captures == 0
    # the warm-up's launches ran and stay counted; the capture's do not
    assert (np.array(_counts()) - c0 == np.array([1, 1, 1, 2])).all()


def test_capture_records_on_the_warm_up_stream(monkeypatch):
    """The record runs on the side stream the warm-up made on the current
    card, not on torch's default capture stream (one a process, on the
    card of its first capture, where a capture for another card fails)."""
    ran_on, captured_on = [], []

    class Stream:
        def wait_stream(self, other):
            pass

    class Capture:
        def __init__(self, graph, pool=None, stream=None):
            captured_on.append(stream)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: ran_on.append(s) or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    g = BatchGraphs(lambda x: x, (0,), "f")
    assert g._warm_and_record(lambda: None, lambda: "outs") == ("graph",
                                                                 "outs")
    assert len(ran_on) == 1 and captured_on == ran_on


def test_out_receives_the_results(graph_path):
    g = BatchGraphs(lambda x: (x * 2.0, x + 1.0), (0,), "pair")
    a, b = torch.empty(3), torch.empty(3)
    got = g(torch.arange(3.0), out=(a, b))
    assert got[0] is a and got[1] is b
    assert torch.equal(a, torch.arange(3.0) * 2.0)
    assert torch.equal(b, torch.arange(3.0) + 1.0)


def test_clones_outlive_the_next_replay(graph_path):
    g = BatchGraphs(lambda x: x * 3.0, (0,), "thrice")
    first = g(torch.ones(4))
    g(torch.full((4,), 5.0))
    assert torch.equal(first, torch.full((4,), 3.0))


# -- the retrievers against eager and the JAX package ----------------------------

def _jax_index(w):
    return jcorpus.build_moment_index(w.jparams, w.jmodel, w.jds,
                                      with_fingerprint=False)


@pytest.mark.parametrize("path", ["cpu", "graph"])
@pytest.mark.parametrize("kind", ["exact", "stream", "live", "fused"])
def test_graphed_retrievers_match_eager_and_jax(w, monkeypatch, kind, path):
    if path == "graph":
        monkeypatch.setattr(BatchGraphs, "_on_card", lambda self, a: True)
        monkeypatch.setattr(BatchGraphs, "_warm_and_record",
                            _stand_in_capture)
    toks, lens = _batches(w)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(lens)
    if kind == "live":
        live = tlive.make_live_index(w.tparams, w.tmodel, w.tds,
                                     capacity_videos=16)
        retr = tlive.make_live_retriever(w.tmodel, live, K)
        jl = jlive.make_live_index(w.jparams, w.jmodel, w.jds,
                                   capacity_videos=16)
        jretr = jlive.make_live_retriever(w.jmodel, jl, K,
                                          topk_method="exact")
    else:
        method = "fused" if kind == "fused" else "exact"
        idx = _index(w)
        retr = (tcorpus.make_stream_retriever(w.tmodel, idx, K)
                if kind == "stream"
                else tcorpus.make_retriever(w.tmodel, idx, K,
                                            topk_method=method))
        jretr = jcorpus.make_retriever(w.jmodel, _jax_index(w), K,
                                       topk_method=method)
    if kind == "stream":
        d, r = retr(w.tparams, tt, tl)
        batch = tcorpus.make_score_topk(w.tmodel, idx, K)
        eager = [batch.eager(w.tparams, tt[b], tl[b])
                 for b in range(len(toks))]
        assert retr.graphs.captures == (1 if path == "graph" else 0)
    else:
        outs = [retr(w.tparams, tt[b], tl[b]) for b in range(len(toks))]
        d, r = torch.stack([o[0] for o in outs]), torch.stack(
            [o[1] for o in outs])
        eager = [retr.eager(w.tparams, tt[b], tl[b])
                 for b in range(len(toks))]
        g = retr.current().graphs if kind == "live" else retr.graphs
        assert g.captures == (1 if path == "graph" else 0)
    assert torch.equal(d, torch.stack([e[0] for e in eager]))
    assert torch.equal(r, torch.stack([e[1] for e in eager]))
    for b in range(len(toks)):
        d_j, r_j = jretr(w.jparams, jnp.asarray(toks[b]),
                         jnp.asarray(lens[b]))
        np.testing.assert_array_equal(r[b].numpy(), np.asarray(r_j))
        np.testing.assert_allclose(d[b].numpy(), np.asarray(d_j), **TOL)


def test_a_captured_f32_batch_counts_the_score_route(w, monkeypatch):
    """A graphed exact batch over an f32 index takes the score kernel's
    route, the CPU standing for the card: one ``score.kernel`` and one
    ``score_kernel`` launch a replay, plus the warm-up's, none on the
    library's route; the answers are the eager batch's, bit for bit."""
    route_scores_to_the_plain_kernel(monkeypatch)
    monkeypatch.setattr(BatchGraphs, "_on_card", lambda self, a: True)
    monkeypatch.setattr(BatchGraphs, "_warm_and_record", _stand_in_capture)
    trace.reset()
    launches = score_kernel.LAUNCHES["score_gemm"]
    toks, lens = _batches(w)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(lens)
    retr = tcorpus.make_retriever(w.tmodel, _index(w), K)
    outs = [retr(w.tparams, tt[b], tl[b]) for b in range(len(toks))]
    n = len(toks) + 1                   # the replays and the warm-up
    counted = trace.counters()
    assert counted["score.kernel"] == n
    assert "score.library" not in counted
    assert score_kernel.LAUNCHES["score_gemm"] - launches == n
    assert retr.graphs.captures == 1
    for b, (d, r) in enumerate(outs):
        e_d, e_r = retr.eager(w.tparams, tt[b], tl[b])
        assert torch.equal(d, e_d) and torch.equal(r, e_r)
