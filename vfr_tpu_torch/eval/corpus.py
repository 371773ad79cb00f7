"""Corpus-level retrieval, serving and corpus eval, single device.

PASS 1 — ``build_moment_index``: embed every moment of every corpus video
once into a cached index: per-stream rows ``[S, V*P, d]`` + ``|m|^2``
(1e30 on invalid rows: Charades windows outside a video's validity mask).
``save_index`` / ``load_index`` persist it in the JAX package's npz format,
bit-exact both ways.

PASS 2 — retrieval: embed a query batch (GloVe -> LSTM kernel -> projection
-> cosine normalization), score it against the whole index and select.
``exact``/``approx``: one score GEMM over the stream-concatenated index
+ an exact top-k (``approx`` is exact in the port).  ``fused``: the CUDA
distance+strided-bin kernel, then an exact top-k over its candidates.

``corpus_evaluate`` reports moment-level corpus R@k at tIoU thresholds (hit
= a top-k row on the right video with tIoU >= thr), video-level R@k and,
under ``protocol="didemo_official"``, the official rank aggregation over
exact corpus ranks of the GT rows (``make_gt_ranker``).

Coarse-to-fine retrieval (the two-stage prefilter for large corpora) lives
in ``eval/coarse.py``; ``serve_queries``, ``serve_follow`` and
``corpus_evaluate`` route to it when asked.  ``serve_follow`` is the
request-at-a-time daemon (micro-batched, pipelined), over a fixed index or
the live arena of ``eval/live.py``, whose retriever is
``make_operand_retriever``.

Every one-GEMM retriever over a fixed index scores operands of the
index's stored dtype, built once by ``prep_score_operands``, so a bf16
operand takes 2 bytes an element on the card.  The JAX package's "auto"
score carrier (a bf16 index held as f32 under bf16 compute) has no
counterpart: its answers are the same, XLA hoists its cast back to bf16
out of the scan, and a graph replayed per batch would repeat that cast on
every replay.  The product dtype follows the operand
(``parallel.sharding.fused_corpus_scores``): bf16 operands multiply into
f32 sums.

On one card a retriever serves a batch (encode, score, select) as one
CUDA graph replay, the counterpart of the JAX package's jitted program
(``utils/graphs.py::BatchGraphs``, one per retriever: a capture per query
shape, params tree and operand buffer); sharded and coarse retrieval run
eagerly.

With a ``mesh`` (``parallel/mesh.py``) the index rows are split over its
"corpus" axis (``prep_score_operands``; the mining refresh's stream
retriever over the axis it names) and every retriever, the GT ranker
and the live arena run the hierarchical top-k of ``parallel/sharding.py``:
each shard scores and selects its own rows, the candidates are merged on
the lead device.  The queries are encoded once, on the params' device.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vfr_tpu_torch.config import EvalConfig
from vfr_tpu_torch.data.glove import tokenize
from vfr_tpu_torch.device import resolve_device
from vfr_tpu_torch.models.mcn import (
    Model,
    decoder_module,
    embed_moments,
    embed_queries_multi,
    prepare_query_params,
)
from vfr_tpu_torch.ops.kernels.select_kernel import distance_select
from vfr_tpu_torch.ops.tiou import tiou
from vfr_tpu_torch.ops.topk import (
    check_topk_method,
    topk_lowest_index,
)
from vfr_tpu_torch.parallel.sharding import (
    corpus_topk_shards,
    fuse_index_cat,
    fused_corpus_distances,
    pad_index,
    shard_rows,
    sharded_gt_ranks,
)
from vfr_tpu_torch.utils import trace
from vfr_tpu_torch.utils.graphs import BatchGraphs, write_out
from vfr_tpu_torch.utils.io import atomic_savez, to_numpy, tree_fingerprint


@dataclass
class MomentIndex:
    m: torch.Tensor          # [S, N, d] per-stream moment embeddings
    m_sq: torch.Tensor       # [S, N] squared norms (1e30 for invalid rows)
    video_row: np.ndarray    # [N] int32 corpus video row per index row
    prop_idx: np.ndarray     # [N] int32 proposal index within the video
    spans_sec: np.ndarray    # [N, 2] float32 second interval of each row
    weights: np.ndarray      # [S] stream fusion weights
    # provenance (model config + params + corpus identity); serve paths
    # validate it so an index from another checkpoint or corpus fails
    # loudly.  None on indexes saved without one (validation skipped).
    fingerprint: Optional[Dict] = None

    @property
    def num_rows(self) -> int:
        return int(self.video_row.shape[0])

    @property
    def num_videos(self) -> int:
        return int(self.video_row.max()) + 1 if len(self.video_row) else 0


def _model_key(model: Model):
    def h(a):
        return (hashlib.sha1(np.asarray(a).tobytes()).hexdigest()
                if a is not None else None)

    return (model.cfg, tuple(model.streams), model.freeze_embeddings,
            h(model.pool_matrix), h(model.tef))


def index_fingerprint(params, model: Model, dataset, num_videos: int) -> Dict:
    """Provenance record stored inside every built index: a hash of the
    model's semantic signature, of the parameter values and of the ordered
    corpus video ids — the same record the JAX package writes for the same
    config, weights and corpus."""
    h = hashlib.sha1()
    h.update(repr(_model_key(model)).encode())
    hv = hashlib.sha1()
    for vid in list(dataset.video_ids)[:num_videos]:
        hv.update(str(vid).encode())
        hv.update(b"\0")
    return {
        "model": h.hexdigest(),
        "params": tree_fingerprint(params),
        "num_videos": int(num_videos),
        "videos": hv.hexdigest(),
        "dataset": "charades" if hasattr(dataset, "windows") else "didemo",
    }


def validate_index(index: MomentIndex, params, model: Model, dataset):
    """Raise when a (loaded) index does not match this process's
    checkpoint, model or corpus; no-op for an index without fingerprint."""
    fp = index.fingerprint
    if fp is None:
        return
    want = index_fingerprint(params, model, dataset, fp.get("num_videos", 0))
    checks = ["model", "params", "dataset"]
    if "videos" in fp:
        checks.append("videos")
    for key in checks:
        if fp.get(key) != want[key]:
            what = {"params": "checkpoint",
                    "videos": "corpus (video ids/order)"}.get(key, key)
            raise ValueError(
                f"moment index fingerprint mismatch on {key!r}: the index "
                f"was built from a different {what} than this serving "
                "process loaded (rebuild with `cli index` or pass the "
                "matching --checkpoint-dir)")
    n_vid = len(dataset.video_ids)
    if fp.get("num_videos", 0) > n_vid:
        raise ValueError(
            f"moment index covers {fp['num_videos']} videos but the dataset "
            f"has only {n_vid}: index/corpus mismatch")


def _params_device(params) -> torch.device:
    return params["embeddings"].device


@torch.no_grad()
def build_moment_index(
    params, model: Model, dataset, batch_size: int = 128,
    num_videos: int = 0, index_dtype: str = "float32",
    with_fingerprint: bool = True,
    feature_banks: Optional[Dict[str, torch.Tensor]] = None,
) -> MomentIndex:
    """Embed the corpus (on the params' device) and finalize the index:
    cosine rows L2-normalized (+1e-8), a bf16 index quantized BEFORE |m|^2
    so the norm matches the stored rows, 1e30 on invalid rows.

    ``feature_banks``: stream -> [V, C, F] tensors already on the params'
    device (and "video_tef" [V, W, 2] for a Charades corpus); clip features
    are then gathered there instead of copied from the host per batch."""
    if index_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown index_dtype {index_dtype!r}")
    dev = _params_device(params)
    V_all = dataset.rgb_feats.shape[0]
    V = min(num_videos, V_all) if num_videos else V_all
    P = dataset.num_proposals
    is_charades = hasattr(dataset, "windows")
    blocks = []
    for start in range(0, V, batch_size):
        sl = slice(start, min(start + batch_size, V))
        if feature_banks is not None:
            feats = {s: feature_banks[s][sl] for s in model.streams}
            tef = feature_banks["video_tef"][sl] if is_charades else None
        else:
            feats = {"rgb": torch.from_numpy(dataset.rgb_feats[sl]).to(dev)}
            if "flow" in model.streams:
                feats["flow"] = torch.from_numpy(
                    dataset.flow_feats[sl]).to(dev)
            tef = dataset.video_tef[sl] if is_charades else None
        m = embed_moments(params, model, feats, tef=tef)
        blocks.append(torch.stack([m[s] for s in model.streams]))
    all_m = torch.cat(blocks, dim=1)                         # [S, V, P, d]
    S, _, _, d = all_m.shape
    flat = all_m.reshape(S, V * P, d)
    del all_m, blocks
    if model.cfg.distance == "cosine":
        flat = flat / (torch.linalg.norm(flat, dim=-1, keepdim=True) + 1e-8)
    if index_dtype == "bfloat16":
        flat = flat.to(torch.bfloat16).float()
    m_sq = (flat * flat).sum(-1)
    if is_charades:
        spans = np.asarray(dataset.windows)                  # [P, 2]
        valid = torch.from_numpy(
            dataset.window_mask[:V].reshape(V * P)).to(dev)
        m_sq = torch.where(valid[None, :], m_sq, torch.full_like(m_sq, 1e30))
    else:
        spans = np.asarray(dataset.span_seconds)
    m = flat.to(torch.bfloat16) if index_dtype == "bfloat16" else flat
    return MomentIndex(
        m=m,
        m_sq=m_sq,
        video_row=np.repeat(np.arange(V, dtype=np.int32), P),
        prop_idx=np.tile(np.arange(P, dtype=np.int32), V),
        spans_sec=np.tile(spans, (V, 1)).astype(np.float32),
        weights=np.asarray(model.cfg.stream_weights, np.float32),
        fingerprint=(index_fingerprint(params, model, dataset, V)
                     if with_fingerprint else None),
    )


def save_index(index: MomentIndex, path: str) -> str:
    """Persist the index as one .npz (the JAX package's format: a bf16 index
    stored as its uint16 bit pattern with ``m_dtype="bfloat16"``); atomic;
    returns the path written."""
    m_dtype = "bfloat16" if index.m.dtype == torch.bfloat16 else "float32"
    m_store = to_numpy(index.m if m_dtype == "bfloat16" else index.m.float())
    extra = {}
    if index.fingerprint is not None:
        extra["fingerprint"] = np.asarray(json.dumps(index.fingerprint))
    return atomic_savez(path, dict(
        m=m_store,
        m_dtype=np.asarray(m_dtype),
        m_sq=to_numpy(index.m_sq.float()),
        video_row=index.video_row,
        prop_idx=index.prop_idx,
        spans_sec=index.spans_sec,
        weights=np.asarray(index.weights, np.float32),
        **extra,
    ))


def load_index(path: str, device=None) -> MomentIndex:
    """Inverse of ``save_index`` (bit-exact, incl. the bf16 pattern); the
    embedding tensors go to ``device`` (CUDA unless asked otherwise; raises
    without CUDA)."""
    device = resolve_device(device)
    with np.load(path) as z:
        if str(z["m_dtype"]) == "bfloat16":
            m = torch.from_numpy(z["m"].view(np.int16)).view(torch.bfloat16)
        else:
            m = torch.from_numpy(np.asarray(z["m"], np.float32))
        fingerprint = (json.loads(str(z["fingerprint"]))
                       if "fingerprint" in z.files else None)
        return MomentIndex(
            m=m.to(device),
            m_sq=torch.from_numpy(np.asarray(z["m_sq"], np.float32)).to(device),
            video_row=z["video_row"],
            prop_idx=z["prop_idx"],
            spans_sec=z["spans_sec"],
            weights=np.asarray(z["weights"], np.float32),
            fingerprint=fingerprint,
        )


def _embed_query_streams(params, model: Model, tokens, lengths,
                         rnn_kernel=None) -> torch.Tensor:
    """[S, Q, d]; cosine mode normalizes (+1e-8) like the index rows.  A
    decoder LM tower (``model.decoder``) is imported here, at its first
    batch, by its ``model_type`` (``models/mcn.py::decoder_module``), so
    that an RNN tower's process never loads it."""
    if model.decoder is not None:
        qs = decoder_module(model.decoder).embed_queries_multi(
            params, model, tokens, lengths)
    else:
        qs = embed_queries_multi(params, model, tokens, lengths,
                                 inference=True, rnn_kernel=rnn_kernel)
    if model.cfg.distance == "cosine":
        qs = qs / (torch.linalg.norm(qs, dim=-1, keepdim=True) + 1e-8)
    return qs


def _check_distance(model: Model):
    if model.cfg.distance == "euclidean" and len(model.streams) > 1:
        raise NotImplementedError(
            "corpus retrieval with distance='euclidean' and multiple streams "
            "is not rank-equivalent to the fused sqeuclidean scorer; use "
            "sqeuclidean/cosine or a single stream")


def fused_bin_size(num_rows: int, k: int) -> int:
    """Bin size of the fused selection: 64, halved until >= 4k candidates
    survive (tiny corpora would otherwise lose recall to coarse bins)."""
    bin_size = 64
    while bin_size > 1 and num_rows // bin_size < 4 * k:
        bin_size //= 2
    return bin_size


def make_retriever(
    model: Model,
    index: MomentIndex,
    k: int,
    topk_method: str = "exact",
    approx_recall: float = 0.95,
    rnn_kernel: Optional[str] = None,
    mesh=None,
):
    """``(params, tokens [Q, T], lengths [Q]) -> (dists [Q, k], rows [Q, k])``.

    ``topk_method="fused"`` runs the distance+selection kernel over the
    per-stream index and an exact top-k over its candidates; otherwise
    ``make_score_topk``: the one-GEMM score path over the index's stored
    dtype.  With ``mesh`` the index is split over its "corpus" axis once
    (``prep_score_operands``) and every call runs the sharded top-k
    ("fused" raises there, as in the JAX package).

    On one card a batch is one CUDA graph replay (``utils/graphs.py``; the
    fused graph reads ``index.m`` / ``index.m_sq`` in place): the retriever
    carries ``eager``, the same batch as eager launches, and ``graphs``,
    its ``BatchGraphs``.  A mesh's batches run eagerly.  The batch marks
    its stages for the recorder (``utils/trace.py``): encode, then score
    (K2 under "fused", else the GEMM), then select."""
    _check_distance(model)
    if topk_method != "fused" or mesh is not None:
        return make_score_topk(model, index, k, topk_method, approx_recall,
                               rnn_kernel, mesh=mesh)
    w = [float(x) for x in model.cfg.stream_weights]
    bin_size = fused_bin_size(index.num_rows, k)

    @torch.no_grad()
    def fused(m, m_sq, params, tokens, lengths):
        trace.stage("encode")
        qs = _embed_query_streams(params, model, tokens, lengths, rnn_kernel)
        trace.stage("score")
        cand_d, cand_rows = distance_select(qs, m, m_sq, w,
                                            bin_size=bin_size)
        trace.stage("select")
        # candidates in K2's order, ties to the lowest candidate position,
        # as the JAX package's lax.top_k over the same candidates
        vals, pos = topk_lowest_index(-cand_d, k)
        return -vals, torch.gather(cand_rows, 1, pos)

    graphs = BatchGraphs(fused, batch_args=(3, 4), name="the fused retriever")

    def retrieve(params, tokens, lengths):
        return graphs(index.m, index.m_sq, params, tokens, lengths)

    retrieve.eager = lambda params, tokens, lengths: fused(
        index.m, index.m_sq, params, tokens, lengths)
    retrieve.graphs = graphs
    return retrieve


def prep_score_operands(index: MomentIndex, mesh=None,
                        axis: str = "corpus"):
    """(m_cat, msq_fused): a fixed index's one-GEMM score operands at its
    stored dtype, built once, under the set-up span ``setup.operands``.
    With no mesh, ``m_cat [N, S*d]`` and ``msq_fused [N]``
    (``parallel.sharding.fuse_index_cat``); with one, both padded to its
    ``axis`` and split over its devices (``parallel.sharding.shard_rows``):
    the shard lists of ``make_operand_retriever``."""
    with trace.setup("setup.operands"):
        if mesh is None:
            return fuse_index_cat(index.m, index.m_sq, index.weights)
        devices = mesh.axis_devices(axis)
        m, m_sq = pad_index(index.m, index.m_sq, len(devices))
        m_cat, msq_fused = fuse_index_cat(m, m_sq, index.weights)
        return shard_rows(m_cat, devices), shard_rows(msq_fused, devices)


def make_operand_retriever(model: Model, weights, k: int,
                           topk_method: str = "exact",
                           approx_recall: float = 0.95,
                           rnn_kernel: Optional[str] = None):
    """The one-GEMM retriever with its index operands as call-time
    arguments: ``(m_cat, msq_fused, params, tokens, lengths) -> (dists
    [Q, k], rows [Q, k])``.  The operands are whole (``m_cat [N, S*d]``,
    ``msq_fused [N]``) or lists of shards, one per device of a mesh
    (``prep_score_operands``): the top-k is ``parallel.sharding.
    corpus_topk_shards``, a whole tensor being one shard.
    ``make_score_topk`` binds a fixed index to it; the live index
    (``eval/live.py``) passes its arena, whose buffers change in place.
    The queries are encoded once, on the params' device, and copied to
    each shard's.  The product dtype follows ``m_cat``'s
    (``parallel.sharding.fused_corpus_scores``).

    Whole operands on the card run a batch as one CUDA graph replay
    (``utils/graphs.py``: one capture per shape, operand and params tree,
    the operands read in place, so the live arena's in-place writes are
    seen and a ``live_grow`` captures once more), the JAX package's one
    jitted program; shard lists run eagerly.  ``out=`` (a pair of [Q, k]
    tensors) receives the results; ``eager`` is the eager batch and
    ``graphs`` the ``BatchGraphs``.

    ``topk_method="fused"`` raises, as in the JAX package: the fused
    kernel reads the per-stream index, not these operands."""
    _check_distance(model)
    if topk_method == "fused":
        raise ValueError(
            "unknown topk method 'fused' for the operand retriever: the "
            "fused distance+select kernel reads the per-stream index "
            "(make_retriever, unsharded); use 'exact' or 'approx'")
    check_topk_method(topk_method)
    weights = np.asarray(weights, np.float32)

    @torch.no_grad()
    def eager(m_cat, msq_fused, params, toks, lens):
        trace.stage("encode")
        qs = _embed_query_streams(params, model, toks, lens, rnn_kernel)
        trace.stage("score")        # corpus_topk_shards marks "select"
        if isinstance(m_cat, torch.Tensor):
            m_cat, msq_fused = [m_cat], [msq_fused]
        return corpus_topk_shards(qs, m_cat, msq_fused, weights, k,
                                  model.compute_dtype, topk_method,
                                  approx_recall)

    graphs = BatchGraphs(eager, batch_args=(3, 4),
                         name="the exact retriever")

    def retrieve(m_cat, msq_fused, params, toks, lens, out=None):
        if isinstance(m_cat, torch.Tensor):
            return graphs(m_cat, msq_fused, params, toks, lens, out=out)
        return write_out(eager(m_cat, msq_fused, params, toks, lens), out)

    retrieve.eager = eager
    retrieve.graphs = graphs
    return retrieve


def make_score_topk(model: Model, index: MomentIndex, k: int,
                    topk_method: str = "exact", approx_recall: float = 0.95,
                    rnn_kernel: Optional[str] = None, mesh=None,
                    axis: str = "corpus"):
    """One query batch: ``(params, tokens [Q, T], lengths [Q]) -> (dists
    [Q, k], rows [Q, k])``: ``make_operand_retriever`` over operands at
    the index's stored dtype, prepared once (``prep_score_operands``),
    split over ``mesh``'s ``axis`` when a mesh is given.  Hand it (and
    every retriever of this module and of ``eval.coarse``) a tree that
    went through ``prepare_query_params`` once, as ``serve_queries`` does,
    and no batch casts the recurrence weights again."""
    m_cat, msq_fused = prep_score_operands(index, mesh, axis)
    fn = make_operand_retriever(model, index.weights, k, topk_method,
                                approx_recall, rnn_kernel)

    def score_topk(params, toks, lens, out=None):
        return fn(m_cat, msq_fused, params, toks, lens, out=out)

    score_topk.eager = lambda params, toks, lens: fn.eager(
        m_cat, msq_fused, params, toks, lens)
    score_topk.graphs = fn.graphs
    return score_topk


def make_stream_retriever(model: Model, index: MomentIndex, k: int,
                          topk_method: str = "exact",
                          approx_recall: float = 0.95,
                          rnn_kernel: Optional[str] = None,
                          mesh=None, axis: str = "corpus"):
    """Throughput serving: ``(params, tokens [M, Q, T], lengths [M, Q]) ->
    (dists [M, Q, k], rows [M, Q, k])`` over one set of operands prepared
    once (``make_score_topk``).  The JAX package scans the M batches
    inside one program; here, on one card, one captured graph of a batch
    (``make_score_topk``'s) is replayed M times, each replay writing its
    batch's rows of the results.  With ``mesh`` the operands are split
    over its ``axis`` once, and every batch runs the sharded top-k
    eagerly: the JAX package's ``make_sharded_stream_retriever``, the
    mining refresh's mesh path ("fused" raises there)."""
    score_topk = make_score_topk(model, index, k, topk_method,
                                 approx_recall, rnn_kernel, mesh, axis)

    def retrieve_stream(params, tokens, lengths):
        d0, r0 = score_topk(params, tokens[0], lengths[0])
        M = tokens.shape[0]
        d_all = d0.new_empty((M, *d0.shape))
        r_all = r0.new_empty((M, *r0.shape))
        d_all[0], r_all[0] = d0, r0
        for b in range(1, M):
            score_topk(params, tokens[b], lengths[b],
                       out=(d_all[b], r_all[b]))
        return d_all, r_all

    retrieve_stream.graphs = score_topk.graphs
    return retrieve_stream


def corpus_retrieval(
    params, model: Model, index: MomentIndex, tokens, lengths, k: int,
    mesh=None, topk_method: str = "exact", approx_recall: float = 0.95,
) -> Tuple[np.ndarray, np.ndarray]:
    """One query batch (host arrays) -> (dists [Q, k], rows [Q, k]) numpy;
    sharded over ``mesh`` when given."""
    retrieve = make_retriever(model, index, k, topk_method=topk_method,
                              approx_recall=approx_recall, mesh=mesh)
    dev = _params_device(params)
    d, rows = retrieve(params, torch.as_tensor(np.asarray(tokens)).to(dev),
                       torch.as_tensor(np.asarray(lengths)).to(dev))
    return d.cpu().numpy(), rows.cpu().numpy()


def resolve_length_buckets(spec, max_query_len: int):
    """Length-bucket spec -> sorted tuple terminated at ``max_query_len``:
    None/"" -> None (off); "auto" -> multiples of 8 below max_query_len;
    "8,16" or an int sequence -> as given.  Values >= max_query_len are
    dropped, and max_query_len is always the last bucket."""
    if spec in (None, "", False):
        return None
    if spec == "auto":
        bs = list(range(8, max_query_len, 8))
    elif isinstance(spec, str):
        bs = [int(s) for s in spec.split(",") if s.strip()]
    else:
        bs = [int(b) for b in spec]
    bs = sorted({b for b in bs if 0 < b < max_query_len})
    bs.append(max_query_len)
    return tuple(bs)


def serve_queries(
    params, model: Model, dataset, vocab, queries, k: int = 10,
    mesh=None, batch_size: int = 128,
    max_query_len: int = 24, num_videos: int = 0,
    topk_method: str = "exact", approx_recall: float = 0.95,
    index_dtype: str = "float32",
    index: Optional[MomentIndex] = None,
    coarse=None, coarse_dim: int = 0, coarse_candidates: int = 2048,
    coarse_mode: str = "blockmax",
    length_buckets=None,
):
    """Answer free-text queries against the moment index; returns a list of
    ``{"query", "results": [{"video", "start", "end", "distance"}]}``.

    ``index``: a prebuilt/loaded MomentIndex (validated against params,
    model and corpus) skips PASS 1.  ``coarse`` (a CoarseIndex of
    ``eval/coarse.py``) or ``coarse_dim > 0`` (build that prefilter
    in-process) routes retrieval through the two-stage coarse-to-fine path
    with ``coarse_candidates`` rows per query and stage 1 ``coarse_mode``;
    it takes precedence over ``topk_method``.  ``length_buckets`` (see
    ``resolve_length_buckets``) groups queries by token length and runs
    each group with the token axis sliced to its bucket; results are
    identical to the unbucketed path (the sliced steps are frozen-carry
    no-ops).  Batch tails are padded with token 0 and length 1.

    With ``mesh`` every batch runs sharded over its "corpus" axis: the
    sharded coarse retriever (``eval.coarse.make_sharded_coarse_retriever``)
    or the sharded exact one (``make_retriever(mesh=)``; "fused" raises)."""
    if len(queries) == 0:
        return []
    owns_index = index is None
    if owns_index:
        index = build_moment_index(params, model, dataset,
                                   num_videos=num_videos,
                                   index_dtype=index_dtype,
                                   with_fingerprint=False)
    else:
        validate_index(index, params, model, dataset)
    if coarse is None and coarse_dim > 0:
        from vfr_tpu_torch.eval.coarse import build_coarse_index

        coarse = build_coarse_index(index, d_coarse=coarse_dim)
    dev = _params_device(params)
    video_ids = dataset.video_ids
    k_eff = min(k, index.num_rows)
    state = {}
    # the recurrence kernel's bf16 weights, cast once for all batches
    params = prepare_query_params(params, model)

    def dispatch(toks_all, lens_all):
        """[M, Q, T] blocks -> (d_all [M, Q, k'], rows_all [M, Q, k'])."""
        toks = torch.from_numpy(toks_all).to(dev)
        lens = torch.from_numpy(lens_all).to(dev)
        if coarse is not None:
            from vfr_tpu_torch.eval.coarse import make_coarse_stream_retriever

            r = state.get("coarse_stream")
            if r is None:
                r = state["coarse_stream"] = make_coarse_stream_retriever(
                    model, coarse, k_eff, num_candidates=coarse_candidates,
                    approx_recall=approx_recall, mode=coarse_mode, mesh=mesh)
            d, rows = r(params, toks, lens)
            return d.cpu().numpy(), rows.cpu().numpy()
        if mesh is None and topk_method != "fused":
            r = state.get("stream")
            if r is None:
                r = state["stream"] = make_stream_retriever(
                    model, index, k_eff, topk_method=topk_method,
                    approx_recall=approx_recall)
                # the retriever holds its own one-matmul operands; drop the
                # per-stream rows of an index this call built, so serving
                # holds the index once (video_row / spans_sec stay for the
                # results; a caller's index is left untouched)
                if owns_index:
                    index.m = index.m_sq = None
            d, rows = r(params, toks, lens)
            return d.cpu().numpy(), rows.cpu().numpy()
        # one batch at a time: fused, and the sharded exact retriever
        r = state.get("single")
        if r is None:
            r = state["single"] = make_retriever(
                model, index, k_eff, topk_method=topk_method,
                approx_recall=approx_recall, mesh=mesh)
        outs = [r(params, toks[b], lens[b]) for b in range(toks.shape[0])]
        return (np.stack([o[0].cpu().numpy() for o in outs]),
                np.stack([o[1].cpu().numpy() for o in outs]))

    Nq = len(queries)
    enc_toks = np.zeros((Nq, max_query_len), np.int32)
    enc_lens = np.ones((Nq,), np.int32)
    for j, text in enumerate(queries):
        enc_toks[j], enc_lens[j] = vocab.encode(tokenize(text), max_query_len)

    buckets = resolve_length_buckets(length_buckets, max_query_len)
    if buckets is None:
        groups = [(max_query_len, list(range(Nq)))]
    else:
        groups = []
        taken = np.zeros(Nq, bool)
        for T_b in buckets:
            idxs = [j for j in range(Nq)
                    if not taken[j] and enc_lens[j] <= T_b]
            taken[idxs] = True
            groups.append((T_b, idxs))

    qd = [None] * Nq
    qr = [None] * Nq
    for T_b, idxs in groups:
        if not idxs:
            continue
        Mb = -(-len(idxs) // batch_size)
        toks = np.zeros((Mb, batch_size, T_b), np.int32)
        lens = np.ones((Mb, batch_size), np.int32)
        for pos, j in enumerate(idxs):
            b, i = divmod(pos, batch_size)
            toks[b, i] = enc_toks[j, :T_b]
            lens[b, i] = enc_lens[j]
        d_all, rows_all = dispatch(toks, lens)
        flat_d = d_all.reshape(-1, d_all.shape[-1])[: len(idxs)]
        flat_r = rows_all.reshape(-1, rows_all.shape[-1])[: len(idxs)]
        for pos, j in enumerate(idxs):
            qd[j], qr[j] = flat_d[pos], flat_r[pos]

    out = []
    for j, text in enumerate(queries):
        results = [
            {
                "video": video_ids[int(index.video_row[r])],
                "start": float(index.spans_sec[r, 0]),
                "end": float(index.spans_sec[r, 1]),
                "distance": float(qd[j][jj]),
            }
            for jj, r in enumerate(qr[j])
        ]
        out.append({"query": text, "results": results})
    return out


def serve_follow(
    params, model: Model, dataset, vocab, lines, k: int = 10,
    max_query_len: int = 24, num_videos: int = 0,
    topk_method: str = "exact", approx_recall: float = 0.95,
    index_dtype: str = "float32",
    index: Optional[MomentIndex] = None,
    micro_batch: int = 8,
    mesh=None,
    pipeline_depth: int = 2,
    coarse=None, coarse_dim: int = 0, coarse_candidates: int = 2048,
    coarse_mode: str = "blockmax",
    live=None,
):
    """Daemon serving: answer an ITERATOR of query strings, yielding one
    result record per query in input order (``serve --follow``).

    * **Aggregation** — a reader thread drains ``lines`` into a bounded
      queue (``4 * micro_batch + 2``); each dispatch packs every waiting
      line, up to ``micro_batch``, into one [micro_batch, T] token block.
    * **Pipelining** — up to ``pipeline_depth`` packs stay in flight.  A
      dispatch launches the retrieval and the non-blocking device->host
      copies of its results into pinned buffers and records an event; the
      fetch waits on that event.  When no input waits, in-flight packs are
      flushed at once, so an isolated request never waits on a successor.
      No path reads a device value on the host inside a dispatch (the
      exact top-k over a corpus of any size included), so packs overlap
      as the JAX package's do.
    * **Tracing** — while the recorder is on (``utils/trace.py``) each
      pack records ``pack.tokens``, ``pack.dispatch``, ``pack.wait`` and
      ``pack.records`` (id ``pack:<n>``), and each request ``request``
      and its child ``queue`` (id ``request:<n>``, ``n`` the input line's
      ordinal; parent its pack's id); the ``daemon.*`` counters are always
      kept.

    ``live`` (an ``eval.live.LiveIndex``): the corpus changes while the
    daemon runs, through control lines ``!add <delta.npz>``, ``!remove
    <id> ...``, ``!save <path>``, ``!stats``, ``!compact`` and ``!grow
    <capacity_videos>``, each answered by one record (an error record for
    a bad one, never a dead daemon).  A control line is an ordering
    barrier: in-flight packs are fetched before it applies, and every
    arena write runs on the retrievals' stream, so a dispatched pack keeps
    the corpus it was dispatched against.  Live serving is the exact (or
    approx) scan: no coarse, no ``fused``.

    Otherwise the index is built (or ``index`` validated) once, and the
    packs go through ``make_coarse_retriever`` (``coarse`` or
    ``coarse_dim > 0``) or ``make_retriever``.  An error of the input
    iterator is re-raised after the results before it were served.

    With ``mesh`` the packs run sharded over its "corpus" axis: the
    sharded coarse or exact retriever over a fixed index, or a live arena
    built on that same mesh (``make_live_index`` / ``load_arena(mesh=)``;
    another arena raises ``ValueError``)."""
    import queue as _queue
    import threading
    from collections import deque

    dev = _params_device(params)
    # the recurrence kernel's bf16 weights, cast once for every pack; the
    # raw tree embeds deltas and fingerprints the index and the arena
    q_params = prepare_query_params(params, model)
    if live is not None:
        if coarse is not None or coarse_dim > 0:
            raise ValueError("live-growth serving is exact (no coarse)")
        if mesh is not None and live.mesh is not mesh:
            raise ValueError("live-growth serving on a mesh needs the "
                             "arena built on that mesh (make_live_index/"
                             "load_arena mesh=...)")
        from vfr_tpu_torch.eval.live import make_live_retriever

        retrieve = make_live_retriever(model, live, k,
                                       topk_method=topk_method,
                                       approx_recall=approx_recall)

        # read at FETCH time: !add grows the tables in place and !grow
        # reallocates them
        def _tables():
            return live.video_ids, live.video_row, live.spans_sec
    else:
        owns_index = index is None
        if owns_index:
            index = build_moment_index(params, model, dataset,
                                       num_videos=num_videos,
                                       index_dtype=index_dtype,
                                       with_fingerprint=False)
        else:
            validate_index(index, params, model, dataset)
        if coarse is None and coarse_dim > 0:
            from vfr_tpu_torch.eval.coarse import build_coarse_index

            coarse = build_coarse_index(index, d_coarse=coarse_dim)
        k_eff = min(k, index.num_rows)
        if coarse is not None:
            from vfr_tpu_torch.eval.coarse import make_coarse_retriever

            retrieve = make_coarse_retriever(
                model, coarse, k_eff, num_candidates=coarse_candidates,
                approx_recall=approx_recall, mode=coarse_mode, mesh=mesh)
        else:
            retrieve = make_retriever(model, index, k_eff,
                                      topk_method=topk_method,
                                      approx_recall=approx_recall, mesh=mesh)
        if owns_index and topk_method != "fused":
            # the retriever holds its own operands; drop the per-stream
            # rows so a long-lived daemon holds the index once ("fused"
            # reads index.m on every call)
            index.m = index.m_sq = None
        video_ids = dataset.video_ids
        row_video, spans_sec = index.video_row, index.spans_sec

        def _tables():
            return video_ids, row_video, spans_sec

    _DONE = object()
    # bounded: a few packs of lookahead keep the aggregation, and a long
    # input is not read into memory ahead of the consumer
    q: "_queue.Queue" = _queue.Queue(maxsize=4 * max(micro_batch, 1) + 2)
    reader_err = []

    def _reader():
        # each item: (text, the line's ordinal, its receipt on the
        # recorder's clock, 0 while the recorder is off)
        try:
            for n, text in enumerate(lines):
                q.put((text, n, time.time_ns() if trace.on() else 0))
        except BaseException as e:   # to the consumer, after its results
            reader_err.append(e)
        finally:
            q.put(_DONE)

    threading.Thread(target=_reader, daemon=True).start()

    def _is_cmd(text) -> bool:
        return live is not None and isinstance(text, str) \
            and text.startswith("!")

    pending: deque = deque()   # items pulled but deferred (cmd ordering)

    def _next_block():
        """Block for one item, then take what else is already waiting; a
        control line is returned alone, in order."""
        first = pending.popleft() if pending else q.get()
        if first is _DONE:
            return None
        if _is_cmd(first[0]):
            return ("cmd", first[0])
        items = [first]
        while len(items) < micro_batch:
            if pending:
                item = pending.popleft()
            else:
                try:
                    item = q.get_nowait()
                except _queue.Empty:
                    break
            if item is _DONE:
                pending.append(_DONE)  # re-post EOF for the outer loop
                break
            if _is_cmd(item[0]):
                pending.append(item)   # keep order; handle next round
                break
            items.append(item)
        return ("queries", items)

    on_cuda = dev.type == "cuda"

    def _to_host(t):
        """Start the copy of ``t`` to (pinned) host memory."""
        if not on_cuda:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    packs = 0

    def _dispatch(items):
        nonlocal packs
        packed = time.time_ns() if trace.on() else 0
        pack = f"pack:{packs}" if packed else None
        packs += 1
        trace.count("daemon.packs")
        trace.count("daemon.requests", len(items))
        trace.count(f"daemon.pack_size.{len(items)}")
        with trace.span("pack.tokens", pack):
            toks = np.zeros((micro_batch, max_query_len), np.int32)
            lens = np.ones(micro_batch, np.int32)
            for i, (text, _, _) in enumerate(items):
                toks[i], lens[i] = vocab.encode(tokenize(text),
                                                max_query_len)
        with trace.span("pack.dispatch", pack):
            toks_t, lens_t = torch.from_numpy(toks), torch.from_numpy(lens)
            if on_cuda:
                toks_t = toks_t.pin_memory().to(dev, non_blocking=True)
                lens_t = lens_t.pin_memory().to(dev, non_blocking=True)
            d, rows = retrieve(q_params, toks_t, lens_t)
            done = None
            if on_cuda:
                # the copies run on the stream of the results' device (the
                # mesh's lead device when sharded)
                done = torch.cuda.Event()
                stream = torch.cuda.current_stream(d.device)
                d, rows = _to_host(d), _to_host(rows)
                done.record(stream)
        return items, pack, packed, d, rows, done

    def _fetch(job):
        items, pack, packed, d, rows, done = job
        with trace.span("pack.wait", pack):
            if done is not None:
                done.synchronize()
        with trace.span("pack.records", pack):
            d, rows = d.numpy(), rows.numpy()
            vids, row_vid, spans = _tables()
            recs = [{
                "query": text,
                "results": [
                    {
                        "video": vids[int(row_vid[r])],
                        "start": float(spans[r, 0]),
                        "end": float(spans[r, 1]),
                        "distance": float(d[i, j]),
                    }
                    for j, r in enumerate(rows[i])
                ],
            } for i, (text, _, _) in enumerate(items)]
        for (_, n, received), rec in zip(items, recs):
            if received and packed:
                rid = f"request:{n}"
                trace.record("request", received, time.time_ns(), rid, pack)
                trace.record("queue", received, packed, rid, rid)
            yield rec

    inflight: deque = deque()
    while True:
        block = _next_block()
        if block is None:
            break
        kind, payload = block
        if kind == "cmd":
            # order barrier: earlier queries see the old corpus, later
            # ones the new
            while inflight:
                yield from _fetch(inflight.popleft())
            yield _apply_cmd(live, params, model, dataset, payload)
            continue
        inflight.append(_dispatch(payload))
        while len(inflight) >= max(pipeline_depth, 1):
            yield from _fetch(inflight.popleft())
        if q.empty() and not pending:
            # nothing waiting: flush now so an isolated request never
            # waits on a successor that may not come
            if inflight:
                trace.count("daemon.idle_flushes")
            while inflight:
                yield from _fetch(inflight.popleft())
    while inflight:
        yield from _fetch(inflight.popleft())
    if reader_err:
        # the input raised mid-stream: the results before it were served;
        # re-raise instead of ending as a clean EOF
        raise reader_err[0]


def _apply_cmd(live, params, model: Model, dataset, line: str) -> Dict:
    """One control line of ``serve_follow``'s live mode -> its record."""
    from vfr_tpu_torch.eval import live as L

    try:
        if line.startswith("!add "):
            vids, rgb, flow, durations = L.load_delta_npz(
                line[len("!add "):].strip())
            n = L.live_append(live, params, model, dataset, vids, rgb,
                              flow=flow, durations=durations)
            return {"command": line, "added_rows": int(n),
                    "num_videos": live.num_videos,
                    "free_rows": live.free_rows}
        if line.startswith("!remove "):
            n = L.live_remove(live, line[len("!remove "):].split())
            return {"command": line, "removed_rows": int(n)}
        if line.startswith("!save "):
            out = L.save_arena(live, line[len("!save "):].strip(),
                               params=params, model=model)
            return {"command": line, "saved": out,
                    "num_videos": live.num_videos}
        if line.strip() == "!stats":
            # the [cap] msq column on the host: a few hundred KB even at
            # 10M rows
            msq = L.msq_host(live)[:live.used_rows]
            return {"command": line,
                    "num_videos": live.num_videos,
                    "capacity_rows": live.capacity,
                    "used_rows": live.used_rows,
                    "free_rows": live.free_rows,
                    "tombstoned_rows": int((msq >= L._INVALID).sum()),
                    "rows_per_video": live.rows_per_video,
                    "index_dtype": live.index_dtype,
                    "shards": (1 if live.mesh is None
                               else int(live.mesh.shape["corpus"]))}
        if line.strip() == "!compact":
            n = L.live_compact(live)
            return {"command": line, "reclaimed_rows": int(n),
                    "num_videos": live.num_videos,
                    "free_rows": live.free_rows}
        if line.startswith("!grow "):
            L.live_grow(live, int(line[len("!grow "):].strip()))
            # the JAX package's record, word for word (one wire format)
            return {"command": line, "capacity_rows": live.capacity,
                    "free_rows": live.free_rows,
                    "note": "next retrieval compiles once for the "
                            "new capacity"}
        raise ValueError(f"unknown control line {line.split()[0]!r}"
                         " (supported: !add <delta.npz>, "
                         "!remove <video_id> [...], !save <path>, "
                         "!compact, !grow <capacity_videos>, !stats)")
    except Exception as e:   # a bad delta must not kill the daemon
        return {"command": line, "error": str(e)}


def make_gt_ranker(model: Model, index: MomentIndex,
                   rnn_kernel: Optional[str] = None, mesh=None):
    """Exact corpus ranks of given index rows (official protocol).

    ``(params, tokens [Q, T], lengths [Q], gt_rows [Q, A]) -> ranks [Q, A]``
    (int64, on the params' device), rank = 0-based position of each GT row
    in the full corpus ordering: #{rows with smaller distance} +
    #{equal-distance rows with a smaller row id}, the stable-argsort
    position, counted without sorting (the two sets are disjoint, so one
    count of their union).  The GT row's distance is gathered from the
    same [Q, N] f32 distance tensor it is compared against, never
    recomputed, so exact ties count as the reference counts them.

    With ``mesh`` the per-stream index is padded to its "corpus" axis and
    split over it once, and the ranks are counted shard by shard and summed
    (``parallel.sharding.sharded_gt_ranks``), with the same arithmetic."""
    compute_dtype = model.compute_dtype
    if mesh is not None:
        devices = mesh.axis_devices("corpus")
        m, m_sq = pad_index(index.m, index.m_sq, len(devices))
        m_sh = shard_rows(m, devices, dim=1)
        sq_sh = shard_rows(m_sq, devices, dim=1)
        del m, m_sq

        @torch.no_grad()
        def ranks_sharded(params, tokens, lengths, gt_rows):
            qs = _embed_query_streams(params, model, tokens, lengths,
                                      rnn_kernel)
            return sharded_gt_ranks(mesh, qs, m_sh, sq_sh, index.weights,
                                    gt_rows,
                                    compute_dtype=compute_dtype)

        return ranks_sharded

    @torch.no_grad()
    def ranks(params, tokens, lengths, gt_rows):
        qs = _embed_query_streams(params, model, tokens, lengths, rnn_kernel)
        D = fused_corpus_distances(qs, index.m, index.m_sq, index.weights,
                                   compute_dtype)             # [Q, N]
        N = D.shape[1]
        row_ids = torch.arange(N, device=D.device)
        out = []
        for a in range(gt_rows.shape[1]):
            g = gt_rows[:, a].long().clamp(0, N - 1)
            d_g = torch.gather(D, 1, g[:, None])              # [Q, 1]
            before = (D < d_g) | ((D == d_g) & (row_ids[None, :] < g[:, None]))
            out.append(before.sum(1))
        return torch.stack(out, dim=1)                        # [Q, A]

    return ranks


@torch.no_grad()
def corpus_evaluate(
    params, model: Model, dataset, ecfg: EvalConfig, mesh=None,
    feature_banks: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, float]:
    """Corpus retrieval metrics over every query of ``dataset`` against the
    index of its first ``ecfg.corpus_num_videos`` videos (0 = all),
    through the exact/approx/fused retriever (``ecfg.topk_method``) or,
    with ``ecfg.coarse_dim > 0``, the coarse-to-fine one.  The official GT
    ranker is exact whatever the retriever.  ``feature_banks``: see
    ``build_moment_index``.  With ``mesh`` the retriever and the GT ranker
    run sharded over its "corpus" axis."""
    from vfr_tpu_torch.eval.moment_eval import _official_hit

    dev = _params_device(params)
    index = build_moment_index(
        params, model, dataset, num_videos=ecfg.corpus_num_videos,
        index_dtype=ecfg.index_dtype,
        with_fingerprint=False,          # transient: never persisted
        feature_banks=feature_banks)
    rnn_kernel = ecfg.rnn_kernel
    # the recurrence kernel's bf16 weights, cast once for all batches
    params = prepare_query_params(params, model, rnn_kernel)
    ks = tuple(ecfg.recall_ks)
    taus = tuple(ecfg.tiou_thresholds)
    kmax = min(max(max(ks), 10), index.num_rows)
    if ecfg.coarse_dim > 0:
        from vfr_tpu_torch.eval.coarse import (
            build_coarse_index,
            make_coarse_retriever,
        )

        coarse = build_coarse_index(index, d_coarse=ecfg.coarse_dim)
        retrieve = make_coarse_retriever(
            model, coarse, kmax, num_candidates=ecfg.coarse_candidates,
            approx_recall=ecfg.approx_recall, mode=ecfg.coarse_mode,
            rnn_kernel=rnn_kernel, mesh=mesh)
    else:
        retrieve = make_retriever(model, index, kmax,
                                  topk_method=ecfg.topk_method,
                                  approx_recall=ecfg.approx_recall,
                                  rnn_kernel=rnn_kernel, mesh=mesh)
    official = (ecfg.protocol == "didemo_official"
                and hasattr(dataset, "num_proposals"))
    if official:
        gt_ranker = make_gt_ranker(model, index, rnn_kernel, mesh=mesh)
        P = dataset.num_proposals
        n_official = 0
        official_rank_sum = {k: 0.0 for k in ks}

    hits = {(k, t): 0.0 for k in ks for t in taus}
    video_hits = {k: 0.0 for k in ks}
    n = 0
    for batch in dataset.eval_batches(ecfg.corpus_query_batch,
                                      with_features=False):
        toks = torch.from_numpy(batch["tokens"]).to(dev)
        lens = torch.from_numpy(batch["lengths"]).to(dev)
        _, rows = retrieve(params, toks, lens)
        rows = rows.cpu().numpy()                             # [Q, kmax]
        valid = batch["valid"]
        vid_ok = index.video_row[rows] == batch["video_idx"][:, None]
        pred_spans = index.spans_sec[rows]                    # [Q, kmax, 2]
        ious = tiou(pred_spans[:, :, None, :],
                    batch["gt_spans"][:, None, :, :])
        ious = np.where(batch["gt_mask"][:, None, :], ious, -1.0).max(axis=2)
        for k in ks:
            for t in taus:
                hit = (vid_ok[:, :k] & (ious[:, :k] >= t)).any(axis=1)
                hits[(k, t)] += float((hit & valid).sum())
            video_hits[k] += float((vid_ok[:, :k].any(axis=1) & valid).sum())
        n += int(valid.sum())

        if official and "gt_prop_idx" in batch:
            gt_prop = batch["gt_prop_idx"]                    # [Q, A], -1 pad
            in_corpus = batch["video_idx"] < index.num_videos
            gt_rows = batch["video_idx"][:, None] * P + np.maximum(gt_prop, 0)
            r = gt_ranker(params, toks, lens, torch.from_numpy(
                gt_rows.astype(np.int64)).to(dev)).cpu().numpy().astype(
                    np.float64)                               # [Q, A]
            r = np.where(gt_prop >= 0, r, np.inf)
            r3 = np.sort(r, axis=1)[:, :3]
            cnt = np.minimum((gt_prop >= 0).sum(axis=1), 3)
            mean_rank = (np.where(np.isfinite(r3), r3, 0.0).sum(axis=1)
                         / np.maximum(cnt, 1))
            q_ok = valid & in_corpus
            for k in ks:
                official_rank_sum[k] += float(
                    (_official_hit(mean_rank, k) & q_ok).sum())
            n_official += int(q_ok.sum())

    out: Dict[str, float] = {"corpus_num_rows": float(index.num_rows)}
    for k in ks:
        for t in taus:
            out[f"corpus_R@{k}_tiou{t}"] = hits[(k, t)] / max(n, 1)
        out[f"corpus_video_R@{k}"] = video_hits[k] / max(n, 1)
    out["num_queries"] = float(n)
    if official:
        for k in ks:
            out[f"corpus_R@{k}_official"] = (
                official_rank_sum[k] / max(n_official, 1))
    return out
