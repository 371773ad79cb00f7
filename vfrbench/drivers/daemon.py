"""The request daemon: single queries on an open-loop schedule through
``serve_follow`` (``serve --follow``).

Set-up builds the model, the seeded weights and the index as a saved one
loads, the vocabulary of the queries' words, the schedule and the texts,
and starts ``serve_follow`` over an input iterator: warm-up queries first
(the first pack captures the pack's graph), then the scheduled requests,
released only once the warm-up's records are back.  The window offers each
request at its due time (arrivals of a Poisson process at ``rate_per_s``,
the same gaps for every seed in the seed's order) and times it from its
due time to the moment its record comes back; offering stops at the
window's end and the rest are drained.  A request without a record is
missing: it counts as failed and as late beyond any limit.  A seeded
reservoir keeps ``sample_requests`` records for the check.

Traffic keys: ``rate_per_s``, ``topk``, ``micro_batch``,
``pipeline_depth``, ``len_min``, ``len_max``, ``sample_requests``.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from vfrbench import inputs
from vfrbench.drivers import _common
from vfrbench.reference import judge, mcn

WARM_QUERIES = 40       # five full packs of eight, then the singles' path


def setup(cell, cfg, seed: int, seconds: float, dev):
    from vfr_tpu_torch.data.glove import Vocab
    from vfr_tpu_torch.eval.corpus import serve_follow
    from vfr_tpu_torch.models.build import build_model

    tr = cell.traffic
    s = _common.sizes(cell, cfg)
    _common.check_model(s, cfg)
    model = build_model(cfg)
    params = inputs.make_params(s, seed, dev)
    index = _common.make_index(s, cfg, seed, dev)
    lmin, lmax = int(tr["len_min"]), int(tr["len_max"])
    due = inputs.poisson_schedule(float(tr["rate_per_s"]), seconds, seed)
    texts = inputs.query_texts(len(due), s["vocab"], lmin, lmax, seed)
    warm = inputs.query_texts(WARM_QUERIES, s["vocab"], lmin, lmax, seed,
                              stream=11)
    st = SimpleNamespace(cell=cell, cfg=cfg, seed=seed, dev=dev, s=s,
                         params=params, index=index, due=due, texts=texts,
                         k=int(tr["topk"]), gate=threading.Event(), t0=None,
                         offered=0, late=np.zeros(len(due)), kept=None)

    def lines():
        yield from warm
        st.gate.wait()
        for i, text in enumerate(texts):
            at = st.t0 + due[i]
            delay = at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            st.late[i] = time.perf_counter() - at
            st.offered = i + 1
            yield text

    dataset = SimpleNamespace(video_ids=[f"v{i}" for i in
                                         range(s["videos"])])
    st.gen = serve_follow(params, model, dataset,
                          Vocab(inputs.vocab_words(s["vocab"])), lines(),
                          k=st.k, max_query_len=s["T"],
                          topk_method=cfg.eval.topk_method,
                          approx_recall=cfg.eval.approx_recall, index=index,
                          micro_batch=int(tr["micro_batch"]),
                          pipeline_depth=int(tr["pipeline_depth"]))
    for text in warm:
        rec = next(st.gen)
        if rec.get("query") != text or len(rec["results"]) != st.k:
            raise RuntimeError(f"warm-up record out of order: {rec}")
    _common.sync(dev)
    return st


def window(st, seconds: float, tracer):
    n = len(st.due)
    lat = np.full(n, np.inf)
    res = _common.Reservoir(int(st.cell.traffic["sample_requests"]),
                            st.seed, 12)
    got = 0
    st.t0 = time.perf_counter() + 0.001
    st.gate.set()
    try:
        while got < n:
            with tracer.span("serve_follow"):
                rec = next(st.gen)
            t = time.perf_counter()
            lat[got] = t - (st.t0 + st.due[got])
            slot = res.wants()
            if slot >= 0:
                res.put(slot, got, rec)
            got += 1
            tracer.tick(t - st.t0)
    except StopIteration:
        pass
    t1 = time.perf_counter()
    tracer.stop()
    st.kept = res.sample()
    st.got = got
    return {"requests": n, "answered": got, "seconds": t1 - st.t0,
            "attempted": n, "failed": n - got,
            "latency_s": lat, "due_s": st.due, "late_s": st.late[:st.offered],
            "trace_begin_s": tracer.begin if tracer.enabled else None,
            "shapes": dict(st.s, Q=int(st.cell.traffic["micro_batch"]),
                           N=st.index.num_rows, k=st.k)}


def release(st) -> None:
    """End the daemon (its input is exhausted, so the generator has
    returned) and free what it held."""
    st.gen.close()
    st.gen = None
    if _common.on_card(st.dev):
        torch.cuda.empty_cache()


def _rows(st, recs):
    """(tokens [R, T], lengths [R], distances [R, k], rows [R, k]) of the
    kept records: the reference's own reading of each query's text, and
    each result's row from its video, start and end (-1 where none)."""
    s = st.s
    P = s["P"]
    spans = inputs.didemo_spans(s["clips"], s["clip_seconds"])
    prop = {(float(a), float(b)): j for j, (a, b) in enumerate(spans)}
    R = len(recs)
    toks = np.zeros((R, s["T"]), np.int32)
    lens = np.ones(R, np.int32)
    dist = np.full((R, st.k), np.nan, np.float32)
    rows = np.full((R, st.k), -1, np.int64)
    for q, (i, rec) in enumerate(recs):
        words = st.texts[i].split()[:s["T"]]
        toks[q, :len(words)] = [int(w[1:]) for w in words]
        lens[q] = len(words)
        if rec.get("query") != st.texts[i]:
            continue                       # a record of another request
        for j, r in enumerate(rec["results"][:st.k]):
            v = r["video"]
            p = prop.get((float(r["start"]), float(r["end"])))
            if p is None or not v.startswith("v"):
                continue
            rows[q, j] = int(v[1:]) * P + p
            dist[q, j] = r["distance"]
    dev = st.dev
    return (torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(dist).to(dev), torch.from_numpy(rows).to(dev))


def check(st, control=False, fault=""):
    """The retrieval numbers of the kept records.  With ``control`` the
    reference one precision lower (at every stage, or at the stages
    ``control`` names) stands in for the port's answers; with ``fault``
    the reference at the stated precisions with that select fault
    (``mcn.SELECT_FAULTS``)."""
    plan = _common.serving_plan(st.cfg, st.dev)
    corpus = mcn.Corpus(st.index.m, st.index.weights)
    toks, lens, d, r = _rows(st, st.kept)
    with mcn.f32_only(), torch.no_grad():
        q = mcn.retrieval_queries(st.params, st.s, toks, lens, plan)
        if control or fault:
            low = mcn.lower(plan, control) if control else plan
            qc = (mcn.retrieval_queries(st.params, st.s, toks, lens, low)
                  if control else q)
            d, r = mcn.top_k(corpus, qc, st.k, low["score"], fault=fault)
        q_lower = {stage: mcn.retrieval_queries(
            st.params, st.s, toks, lens, mcn.lower(plan, {stage}))
            for stage in mcn.QUERY_STAGES}
        out = judge.retrieval_readings(corpus, q, d, r, plan["score"],
                                       q_lower)
    out["bad"] += float(len(st.due) - st.got)       # missing records
    return out


READINGS = ("dist_gap", "rank_gap", "set_gap", "lower_share", "bad")
