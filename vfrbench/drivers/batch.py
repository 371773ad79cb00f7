"""Bulk retrieval: a closed loop of query batches through one retriever.

Set-up builds the configuration's model, its query tower's seeded weights
(``towers/<tower>.py``, named by the configuration) and the index as a
saved one loads, then ``make_retriever`` over it (one CUDA graph replay a
batch on the card) and warms it: the first call captures the batch's
graph.  The window dispatches batch after batch, each a different batch
of a pool drawn from the seed, and copies each batch's distances and rows
to pinned host memory, at most ``results_in_flight`` batches behind: a
client that drains results as they come.  A seeded reservoir keeps
``sample_batches`` of the window's batches for the check.

Traffic keys: ``query_batch``, ``topk``, ``len_min``, ``len_max``,
``distinct_batches``, ``results_in_flight``, ``sample_batches``.
"""

from __future__ import annotations

import collections
import time
from types import SimpleNamespace

import torch

from vfrbench import catalog, inputs
from vfrbench.drivers import _common
from vfrbench.reference import judge, mcn


def setup(cell, cfg, seed: int, seconds: float, dev):
    from vfr_tpu_torch.eval.corpus import make_retriever
    from vfr_tpu_torch.models.build import build_model
    from vfr_tpu_torch.models.mcn import prepare_query_params

    tr = cell.traffic
    tower = catalog.tower(cell.tower, cell.root)
    s = {**_common.sizes(cell, cfg), **tower.sizes(cell, cfg),
         "tower": cell.tower}
    tower.check(s, cfg)
    model = build_model(cfg)
    params = tower.make_params(s, seed, dev)
    index = _common.make_index(s, cfg, seed, dev)
    Q, k = int(tr["query_batch"]), int(tr["topk"])
    toks, lens = inputs.token_batches(int(tr["distinct_batches"]), Q, s["T"],
                                      s["vocab"], int(tr["len_min"]),
                                      int(tr["len_max"]), seed, dev)
    retrieve = make_retriever(model, index, k,
                              topk_method=cfg.eval.topk_method,
                              approx_recall=cfg.eval.approx_recall)
    qp = prepare_query_params(params, model)
    for i in range(3):                    # the capture, then two replays
        retrieve(qp, toks[i], lens[i])
    _common.sync(dev)
    return SimpleNamespace(cell=cell, cfg=cfg, seed=seed, dev=dev, s=s,
                           tower=tower, params=params, index=index,
                           toks=toks, lens=lens, retrieve=retrieve, qp=qp,
                           Q=Q, k=k, kept=None)


def window(st, seconds: float, tracer):
    tr = st.cell.traffic
    depth = int(tr["results_in_flight"])
    card = _common.on_card(st.dev)
    ring = [(torch.empty((st.Q, st.k), dtype=torch.float32, pin_memory=card),
             torch.empty((st.Q, st.k), dtype=torch.int64, pin_memory=card))
            for _ in range(depth + 1)]
    res = _common.Reservoir(int(tr["sample_batches"]), st.seed, 10)
    n_pool = st.toks.shape[0]
    inflight = collections.deque()

    def drain():
        i, done, (d_h, r_h) = inflight.popleft()
        with tracer.span("wait_result"):
            if done is not None:
                done.synchronize()
        slot = res.wants()
        if slot >= 0:
            res.put(slot, i, (d_h.clone(), r_h.clone()))

    i = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        tracer.tick(now)
        b = i % n_pool
        with tracer.span("dispatch"):
            d, r = st.retrieve(st.qp, st.toks[b], st.lens[b])
            d_h, r_h = ring[i % len(ring)]
            d_h.copy_(d, non_blocking=card)
            r_h.copy_(r, non_blocking=card)
            done = None
            if card:
                done = torch.cuda.Event()
                done.record()
        inflight.append((i, done, (d_h, r_h)))
        i += 1
        if len(inflight) > depth:
            drain()
    while inflight:
        drain()
    _common.sync(st.dev)
    t1 = time.perf_counter()
    tracer.stop()
    st.kept = res.sample()
    plan = _common.serving_plan(st.cfg, st.dev)
    return {"batches": i, "queries": i * st.Q, "seconds": t1 - t0,
            "attempted": i * st.Q,
            "shapes": dict(st.s, Q=st.Q, N=st.index.num_rows, k=st.k,
                           live_steps=float(st.lens.float().sum(1).mean()),
                           index_dtype=st.cfg.eval.index_dtype,
                           score_dtype=plan["score"])}


def release(st) -> None:
    """Free the port's objects (the retriever, its graphs and operands, the
    prepared query weights) before the reference runs."""
    st.retrieve = st.qp = None
    if _common.on_card(st.dev):
        torch.cuda.empty_cache()


def _plan(st):
    """The stated precisions: the tower's query stages', then the score's."""
    return {**st.tower.plan(st.cfg, st.dev),
            "score": _common.serving_plan(st.cfg, st.dev)["score"]}


def _queries(st, plan):
    """The reference's query embeddings of the kept batches, stacked
    [S, kept * Q, d], with the kept answers [kept * Q, k]."""
    with mcn.f32_only(), torch.no_grad():
        qs, ds, rs = [], [], []
        for i, (d, r) in st.kept:
            b = i % st.toks.shape[0]
            qs.append(st.tower.reference_queries(st.params, st.s, st.toks[b],
                                                 st.lens[b], plan))
            ds.append(d.to(st.dev))
            rs.append(r.to(st.dev))
        return torch.cat(qs, 1), torch.cat(ds), torch.cat(rs)


def check(st, control=False, fault=""):
    """The retrieval numbers of the kept batches.  With ``control`` the
    reference one precision lower (at every stage, or at the stages
    ``control`` names) stands in for the port's answers; with ``fault``
    the reference at the stated precisions with that select fault
    (``mcn.SELECT_FAULTS``)."""
    plan = _plan(st)
    corpus = mcn.Corpus(st.index.m, st.index.weights)
    q, d, r = _queries(st, plan)
    with mcn.f32_only(), torch.no_grad():
        if control or fault:
            low = mcn.lower(plan, control) if control else plan
            qc = _queries(st, low)[0] if control else q
            d, r = mcn.top_k(corpus, qc, st.k, low["score"], fault=fault)
        q_lower = {stage: _queries(st, mcn.lower(plan, {stage}))[0]
                   for stage in st.tower.STAGES}
        return judge.retrieval_readings(corpus, q, d, r, plan["score"],
                                        q_lower)


READINGS = ("dist_gap", "rank_gap", "set_gap", "lower_share", "bad")
