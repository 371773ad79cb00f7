"""Online corpus growth at serving time: the live index (single device).

The index lives in an arena allocated at a fixed CAPACITY up front
(``[cap, S*d]`` one-GEMM operands); rows past ``used_rows`` and removed
rows carry ``msq = 1e30``, the never-retrievable guard every padded row of
this package uses.  Every change but ``live_grow`` writes the arena IN
PLACE, so the tensors a retriever reads are the same objects for the
daemon's whole life:

* ``live_append`` embeds only the new videos (the same
  ``build_moment_index`` as the full build) and ``copy_``s them into the
  free region: O(delta) work and bytes;
* ``live_remove`` tombstones a video's rows (``msq = 1e30``);
* ``live_compact`` packs the surviving rows to the front, in blocks, and
  frees the removed ids;
* ``live_grow`` is the one reallocation (a larger arena).

Snapshot semantics come from CUDA stream order: every arena write and
every retrieval run on the one current stream, so a write is ordered after
every retrieval dispatched before it, and a dispatched retrieval reads the
corpus as it was at dispatch.  ``serve_follow`` also fetches its in-flight
packs before a control line applies.

The arena carries the score operand as f32 holding values rounded to the
product dtype (``eval.corpus.prep_score_operands``, the same rounding for
the initial build and for every delta, so an append equals a rebuild).  A
bf16 arena therefore takes twice the bf16 bytes on the card; its file
(``save_arena``) holds the bf16 bit pattern as the JAX package's does, and
snapshots cross between the two packages bit for bit.

The sharded arena (a ``mesh``) is not ported yet and raises.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from vfr_tpu_torch.device import resolve_device
from vfr_tpu_torch.eval.corpus import (
    build_moment_index,
    index_fingerprint,
    make_operand_retriever,
    prep_score_operands,
    score_in_dtype,
)
from vfr_tpu_torch.models.mcn import Model
from vfr_tpu_torch.utils.io import atomic_savez

_INVALID = 1e29
# rows per block of live_compact's forward copy (the temporary it needs)
COMPACT_BLOCK = 65536


@dataclass
class LiveIndex:
    """Capacity-padded one-GEMM index whose row region changes in place."""
    m_cat: torch.Tensor      # [cap, S*d] f32 carrier of rounded values
    msq_fused: torch.Tensor  # [cap] f32; 1e30 past used_rows / removed
    video_row: np.ndarray    # [cap] int32 (-1 on free rows)
    prop_idx: np.ndarray     # [cap] int32
    spans_sec: np.ndarray    # [cap, 2] f32
    video_ids: List[str]     # grows with appends
    weights: np.ndarray      # [S] f32
    used_rows: int
    rows_per_video: int
    index_dtype: str         # quantization applied to stored rows

    @property
    def capacity(self) -> int:
        return int(self.m_cat.shape[0])

    @property
    def num_videos(self) -> int:
        return len(self.video_ids)

    @property
    def free_rows(self) -> int:
        return self.capacity - self.used_rows


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"the sharded live arena ({what} with a mesh) is not yet ported "
            "to vfr_tpu_torch")


def _pad_host_metadata(cap: int, video_row, prop_idx, spans_sec):
    """Full-capacity host metadata with the free-row convention (video_row
    -1, prop_idx 0, spans 0) past the populated prefix."""
    n = len(video_row)
    vr = np.full(cap, -1, np.int32)
    vr[:n] = video_row
    pi = np.zeros(cap, np.int32)
    pi[:n] = prop_idx
    sp = np.zeros((cap, 2), np.float32)
    sp[:n] = spans_sec
    return vr, pi, sp


def _index_operands(index, compute_dtype: torch.dtype):
    """(m_cat f32 carrier, msq_fused) of a built index: the batch serving
    path's own rounding (``prep_score_operands``)."""
    return prep_score_operands(index, compute_dtype)[:2]


def arena_in_dtype(live: LiveIndex, model: Model) -> torch.dtype:
    """The score GEMM's product dtype over ``live``."""
    return score_in_dtype(live.index_dtype == "bfloat16", model.compute_dtype)


@torch.no_grad()
def make_live_index(
    params, model: Model, dataset,
    capacity_videos: int,
    num_videos: int = 0,
    index_dtype: str = "float32",
    feature_banks: Optional[Dict] = None,
    mesh=None,
) -> LiveIndex:
    """Build the initial corpus into a ``capacity_videos``-sized arena on
    the params' device."""
    _no_mesh(mesh, "make_live_index")
    index = build_moment_index(params, model, dataset,
                               num_videos=num_videos,
                               index_dtype=index_dtype,
                               with_fingerprint=False,
                               feature_banks=feature_banks)
    P = dataset.num_proposals
    V = index.num_videos
    if capacity_videos < V:
        raise ValueError(
            f"capacity_videos={capacity_videos} < initial corpus ({V})")
    cap = capacity_videos * P
    used = index.num_rows
    m_cat, msq_fused = _index_operands(index, model.compute_dtype)
    index.m = index.m_sq = None
    arena = torch.zeros((cap, m_cat.shape[1]), dtype=torch.float32,
                        device=m_cat.device)
    arena[:used].copy_(m_cat)
    msq = torch.full((cap,), 1e30, dtype=torch.float32, device=m_cat.device)
    msq[:used].copy_(msq_fused)
    del m_cat, msq_fused
    video_row, prop_idx, spans_sec = _pad_host_metadata(
        cap, index.video_row, index.prop_idx, index.spans_sec)
    return LiveIndex(
        m_cat=arena,
        msq_fused=msq,
        video_row=video_row,
        prop_idx=prop_idx,
        spans_sec=spans_sec,
        video_ids=list(dataset.video_ids[:V]),
        weights=np.asarray(index.weights, np.float32),
        used_rows=used,
        rows_per_video=P,
        index_dtype=index_dtype,
    )


def delta_corpus(dataset, video_ids, rgb, flow=None, durations=None):
    """A minimal corpus for ``build_moment_index`` over NEW videos,
    inheriting every static table (proposal spans, window bank, TEF) from
    the serving dataset.  ``rgb``/``flow``: [V_new, C, F] arrays in the
    dataset's own feature layout; ``durations`` (seconds, Charades only)
    sizes the per-video window validity mask."""
    rgb = np.asarray(rgb, np.float32)
    n = rgb.shape[0]
    if len(video_ids) != n:
        raise ValueError(f"{len(video_ids)} video ids for {n} feature rows")
    if rgb.shape[1:] != dataset.rgb_feats.shape[1:]:
        raise ValueError(
            f"delta rgb shape {rgb.shape[1:]} != corpus "
            f"{dataset.rgb_feats.shape[1:]}")
    shim = SimpleNamespace(
        video_ids=list(video_ids),
        rgb_feats=rgb,
        flow_feats=(np.asarray(flow, np.float32)
                    if flow is not None else None),
        num_proposals=dataset.num_proposals,
    )
    if hasattr(dataset, "windows"):          # Charades-style window bank
        from vfr_tpu_torch.ops.proposals import (
            window_tef,
            window_validity_mask,
        )

        if durations is None:
            raise ValueError("Charades delta needs per-video durations "
                             "(seconds) for the window validity mask")
        durations = np.asarray(durations, np.float32)
        shim.windows = dataset.windows
        shim.window_mask = np.stack([
            window_validity_mask(dataset.windows, float(d),
                                 dataset.cfg.feature_seconds)
            for d in durations
        ])
        # duration-normalized TEF rows, the dataset's own convention
        shim.video_tef = np.stack([
            window_tef(dataset.windows, float(d)) for d in durations
        ])
        shim.cfg = dataset.cfg
    else:
        shim.span_seconds = dataset.span_seconds
    return shim


@torch.no_grad()
def live_append(
    live: LiveIndex, params, model: Model, dataset,
    video_ids, rgb, flow=None, durations=None,
) -> int:
    """Embed new videos and copy them into the arena's free region in
    place; returns the rows appended.  O(delta) work and bytes.

    ATOMIC: every failure (duplicate id, over capacity, a delta that
    embeds to the wrong row count, changed stream weights) raises before
    the first write to the arena, so a rejected delta leaves it as it
    was."""
    taken = set(live.video_ids)
    for v in video_ids:
        if v in taken:
            raise ValueError(f"video {v!r} is already in the corpus")
    video_ids = list(video_ids)
    n = len(video_ids) * live.rows_per_video
    if n > live.free_rows:
        raise ValueError(
            f"append of {n} rows exceeds capacity: {live.free_rows} free "
            f"of {live.capacity} (reclaim with live_compact/!compact or "
            "grow with live_grow/!grow)")
    shim = delta_corpus(dataset, video_ids, rgb, flow=flow,
                        durations=durations)
    delta = build_moment_index(params, model, shim,
                               index_dtype=live.index_dtype,
                               with_fingerprint=False)
    if delta.num_rows != n:   # static proposal banks make this impossible
        raise ValueError(f"delta embedded {delta.num_rows} rows, expected "
                         f"{n} ({live.rows_per_video} per video)")
    if not np.allclose(np.asarray(delta.weights),
                       np.asarray(live.weights)):
        raise ValueError("stream weights changed between build and append")
    d_cat, d_sq = _index_operands(delta, model.compute_dtype)
    start = live.used_rows
    live.m_cat[start:start + n].copy_(d_cat)
    live.msq_fused[start:start + n].copy_(d_sq)
    base_video = live.num_videos
    live.video_row[start:start + n] = delta.video_row + base_video
    live.prop_idx[start:start + n] = delta.prop_idx
    live.spans_sec[start:start + n] = delta.spans_sec
    live.video_ids.extend(video_ids)
    live.used_rows = start + n
    return n


@torch.no_grad()
def live_remove(live: LiveIndex, video_ids) -> int:
    """Tombstone videos: their rows get msq = 1e30 in place.  Capacity is
    not reclaimed and the ids stay taken (a re-add is rejected) until
    ``live_compact``.  Returns the rows removed."""
    pos = {v: i for i, v in enumerate(live.video_ids)}
    vids = []
    for v in video_ids:
        if v not in pos:
            raise ValueError(f"video {v!r} is not in the corpus")
        vids.append(pos[v])
    mask = np.isin(live.video_row[:live.used_rows], vids)
    if not mask.any():
        return 0
    rows = torch.from_numpy(np.nonzero(mask)[0]).to(live.msq_fused.device)
    live.msq_fused.index_fill_(0, rows, 1e30)
    return int(mask.sum())


@torch.no_grad()
def live_compact(live: LiveIndex) -> int:
    """Reclaim tombstoned rows in place: pack the surviving rows to the
    front of the arena (order kept), renumber videos contiguously and drop
    the removed ids, freeing their capacity and making them re-addable.
    Returns the rows reclaimed.

    The kept rows are increasing and ``kept[i] >= i``, so a forward copy
    in blocks of ``COMPACT_BLOCK`` rows never overwrites a row a later
    block still reads; the temporary is one block.  As in the JAX package
    (a gather with index 0 past the survivors), every row past them then
    holds the old row 0 and msq 1e30.  Tombstones are read from the arena
    itself (msq >= 1e29), so a loaded snapshot compacts too."""
    msq_host = live.msq_fused.cpu().numpy()      # [cap] f32: a small fetch
    used = live.used_rows
    keep = msq_host[:used] < _INVALID
    n_keep = int(keep.sum())
    reclaimed = used - n_keep
    if reclaimed == 0:
        return 0
    kept_rows = np.nonzero(keep)[0]
    old_vids = live.video_row[:used][keep]
    surviving = np.unique(old_vids)              # sorted == original order
    remap = np.full(live.num_videos, -1, np.int32)
    remap[surviving] = np.arange(len(surviving), dtype=np.int32)

    dev = live.m_cat.device
    row0 = live.m_cat[0].clone()
    kept_d = torch.from_numpy(kept_rows.astype(np.int64)).to(dev)
    for lo in range(0, n_keep, COMPACT_BLOCK):
        hi = min(lo + COMPACT_BLOCK, n_keep)
        live.m_cat[lo:hi].copy_(live.m_cat.index_select(0, kept_d[lo:hi]))
    live.m_cat[n_keep:].copy_(row0.expand(live.capacity - n_keep, -1))
    live.msq_fused[:n_keep].copy_(live.msq_fused.index_select(0, kept_d))
    live.msq_fused[n_keep:].fill_(1e30)
    # host metadata permutes in place (the fancy-index right-hand side
    # copies first), so references to these arrays stay valid
    live.video_row[:n_keep] = remap[old_vids]
    live.video_row[n_keep:] = -1
    live.prop_idx[:n_keep] = live.prop_idx[kept_rows]
    live.prop_idx[n_keep:] = 0
    live.spans_sec[:n_keep] = live.spans_sec[kept_rows]
    live.spans_sec[n_keep:] = 0
    live.video_ids[:] = [live.video_ids[int(v)] for v in surviving]
    live.used_rows = n_keep
    return reclaimed


@torch.no_grad()
def live_grow(live: LiveIndex, capacity_videos: int) -> int:
    """Grow the arena's capacity to ``capacity_videos``; returns the new
    capacity in rows.  The one live operation that reallocates the arena
    (and the host tables): an O(capacity) copy, operator-initiated."""
    new_cap = capacity_videos * live.rows_per_video
    if new_cap < live.capacity:
        raise ValueError(
            f"cannot shrink: capacity_videos={capacity_videos} -> "
            f"{new_cap} rows < current {live.capacity} (reclaim tombstones "
            "with live_compact instead)")
    if new_cap == live.capacity:
        return live.capacity
    pad = new_cap - live.capacity
    m, sq = live.m_cat, live.msq_fused
    live.m_cat = torch.cat([m, m.new_zeros((pad, m.shape[1]))])
    live.msq_fused = torch.cat([sq, sq.new_full((pad,), 1e30)])
    del m, sq
    # the host tables are reallocated too: readers go through the
    # LiveIndex, never through references to the old arrays
    live.video_row, live.prop_idx, live.spans_sec = _pad_host_metadata(
        new_cap, live.video_row, live.prop_idx, live.spans_sec)
    return new_cap


def _arena_fingerprint(live: LiveIndex, params, model: Model) -> Dict:
    shim = SimpleNamespace(video_ids=live.video_ids)
    return index_fingerprint(params, model, shim, live.num_videos)


def save_arena(live: LiveIndex, path: str, params=None, model=None) -> str:
    """Snapshot the whole arena (operands, metadata, used region) to one
    .npz, atomically, in the JAX package's format: a bf16 arena as its
    uint16 bit pattern.  With ``params``/``model`` a provenance
    fingerprint is stored and checked at load."""
    if live.index_dtype == "bfloat16":
        # the carrier holds bf16 values: the cast back is exact
        m = live.m_cat.to(torch.bfloat16)
        m_store = m.view(torch.int16).cpu().numpy().view(np.uint16)
        m_dtype = "bfloat16"
    else:
        m_store, m_dtype = live.m_cat.cpu().numpy(), "float32"
    extra = {}
    if params is not None and model is not None:
        extra["fingerprint"] = np.asarray(json.dumps(
            _arena_fingerprint(live, params, model)))
    return atomic_savez(path, dict(
        m_cat=m_store, m_dtype=np.asarray(m_dtype),
        msq_fused=live.msq_fused.cpu().numpy(),
        video_row=live.video_row, prop_idx=live.prop_idx,
        spans_sec=live.spans_sec,
        video_ids=np.asarray(live.video_ids),
        weights=np.asarray(live.weights, np.float32),
        used_rows=np.asarray(live.used_rows),
        rows_per_video=np.asarray(live.rows_per_video),
        index_dtype=np.asarray(live.index_dtype),
        **extra))


def load_arena(path: str, params=None, model=None, mesh=None,
               device=None) -> LiveIndex:
    """Inverse of ``save_arena``, onto ``device`` (CUDA unless asked
    otherwise; raises without CUDA).  With ``params``/``model`` the stored
    fingerprint (if any) is checked: a snapshot from another checkpoint or
    corpus raises instead of serving wrong moments.  With ``model`` the
    carrier is rounded to the score GEMM's product dtype, as the batch
    path's operands are: a no-op but for an f32 arena served with bf16
    compute, whose file then holds the rounded values."""
    _no_mesh(mesh, "load_arena")
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        m_dtype = str(z["m_dtype"])
        if m_dtype == "bfloat16":
            m = torch.from_numpy(z["m_cat"].view(np.int16)).view(
                torch.bfloat16).float()
        else:
            m = torch.from_numpy(np.asarray(z["m_cat"], np.float32))
        live = LiveIndex(
            m_cat=m.to(device),
            msq_fused=torch.from_numpy(
                np.asarray(z["msq_fused"], np.float32)).to(device),
            video_row=z["video_row"].copy(),
            prop_idx=z["prop_idx"].copy(),
            spans_sec=z["spans_sec"].copy(),
            video_ids=[str(v) for v in z["video_ids"]],
            weights=z["weights"],
            used_rows=int(z["used_rows"]),
            rows_per_video=int(z["rows_per_video"]),
            index_dtype=str(z["index_dtype"]),
        )
        fp = (json.loads(str(z["fingerprint"]))
              if "fingerprint" in z.files else None)
    if model is not None:
        in_dtype = arena_in_dtype(live, model)
        if in_dtype != torch.float32:
            live.m_cat = live.m_cat.to(in_dtype).float()
    if fp is not None and params is not None and model is not None:
        want = _arena_fingerprint(live, params, model)
        for key in ("model", "params", "videos"):
            if fp.get(key) != want[key]:
                raise ValueError(
                    f"live arena fingerprint mismatch on {key!r}: the "
                    "snapshot was written from a different "
                    f"{'checkpoint' if key == 'params' else key}")
    return live


def make_live_retriever(
    model: Model, live: LiveIndex, k: int,
    topk_method: str = "exact", approx_recall: float = 0.95,
    rnn_kernel: Optional[str] = None,
):
    """``(params, tokens, lengths) -> (dists [Q, k], rows [Q, k])`` over
    the live arena: reads ``live``'s CURRENT tensors on every call, so
    changes take effect at once, and re-clamps ``k`` to the current
    capacity (a ``live_grow`` lifts a boot-time clamp).  Rows past the
    used region surface only when k exceeds the valid rows: distance >=
    1e29, video_row -1.  ``topk_method="fused"`` raises at the first call,
    as in the JAX package."""
    k_req = int(k)
    built = {}          # the retriever of the current clamped k

    def retrieve(params, tokens, lengths):
        k_eff = int(min(k_req, live.capacity))
        fn = built.get(k_eff)
        if fn is None:
            built.clear()
            fn = built[k_eff] = make_operand_retriever(
                model, live.weights, k_eff, topk_method=topk_method,
                approx_recall=approx_recall, rnn_kernel=rnn_kernel,
                in_dtype=arena_in_dtype(live, model))
        return fn(live.m_cat, live.msq_fused, params, tokens, lengths)

    return retrieve


def load_delta_npz(path: str):
    """Read a delta-corpus .npz: ``video_ids`` [V] str, ``rgb`` [V, C, F]
    f32, optional ``flow`` [V, C, F], optional ``durations`` [V] f32
    (Charades).  The ``!add`` control line of ``serve --follow`` reads
    this format."""
    with np.load(path, allow_pickle=False) as z:
        video_ids = [str(v) for v in z["video_ids"]]
        rgb = z["rgb"]
        flow = z["flow"] if "flow" in z.files else None
        durations = z["durations"] if "durations" in z.files else None
    return video_ids, rgb, flow, durations
