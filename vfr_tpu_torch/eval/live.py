"""Online corpus growth at serving time: the live index.

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

The arena is kept at its index's dtype, as the JAX package's: a bf16
index is a bf16 arena (2 bytes an element on the card), an f32 index an
f32 arena holding the embeddings unrounded, whatever the compute dtype.
The score product follows the arena's dtype (``parallel.sharding.
fused_corpus_scores``): bf16 operands into f32 sums, and an f32 arena
under bf16 compute rounded on every call.  Its file (``save_arena``)
holds the tensor's own values, a bf16 arena as its bit pattern, as the
JAX package's does, and snapshots cross between the two packages bit for
bit.

With a ``mesh`` (``parallel/mesh.py``) the arena is row-sharded over its
"corpus" axis: ``m_cat`` and ``msq_fused`` are lists of per-shard tensors,
global row r on shard ``r // rows_per_shard``, and retrieval is the sharded
top-k of ``parallel/sharding.py``.  The capacity is a multiple of the axis
size with at least one video's rows a shard (``_mesh_capacity``).  Every
operation is written once over the list of shards (one shard without a
mesh): an append writes each shard's overlap with the new rows, a
compaction gathers rows across shards into each destination shard, a grow
lays the rows out again at the new ``rows_per_shard`` (rows move between
shards).  A snapshot is the single-device file whatever the mesh, so it
loads on any mesh or none.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from vfr_tpu_torch.device import resolve_device
from vfr_tpu_torch.eval.corpus import (
    build_moment_index,
    index_fingerprint,
    make_operand_retriever,
)
from vfr_tpu_torch.models.mcn import Model
from vfr_tpu_torch.parallel.sharding import fuse_index_cat
from vfr_tpu_torch.utils.io import atomic_savez

_INVALID = 1e29
# rows per block of live_compact's forward copy (the temporary it needs)
COMPACT_BLOCK = 65536


@dataclass
class LiveIndex:
    """Capacity-padded one-GEMM index whose row region changes in place.
    With ``mesh``, ``m_cat`` and ``msq_fused`` are lists of equal shards
    over the mesh's "corpus" axis (see the module docstring)."""
    # [cap, S*d] at the index's dtype (bf16 or f32) and [cap] f32 norms
    # (1e30 past used_rows and on removed rows); lists of shards with a
    # mesh
    m_cat: Union[torch.Tensor, List[torch.Tensor]]
    msq_fused: Union[torch.Tensor, List[torch.Tensor]]
    video_row: np.ndarray    # [cap] int32 (-1 on free rows)
    prop_idx: np.ndarray     # [cap] int32
    spans_sec: np.ndarray    # [cap, 2] f32
    video_ids: List[str]     # grows with appends
    weights: np.ndarray      # [S] f32
    used_rows: int
    rows_per_video: int
    index_dtype: str         # quantization applied to stored rows
    mesh: Optional[object] = None

    @property
    def capacity(self) -> int:
        return sum(int(t.shape[0]) for t in _shards(self)[1])

    @property
    def num_videos(self) -> int:
        return len(self.video_ids)

    @property
    def free_rows(self) -> int:
        return self.capacity - self.used_rows

    @property
    def rows_per_shard(self) -> int:
        return int(_shards(self)[1][0].shape[0])


def _shards(live: LiveIndex):
    """(m_cat shards, msq shards): one of each without a mesh."""
    if live.mesh is None:
        return [live.m_cat], [live.msq_fused]
    return live.m_cat, live.msq_fused


def _fields(mesh, m_sh, sq_sh):
    """``LiveIndex``'s (m_cat, msq_fused) of lists of shards: the tensors
    themselves without a mesh."""
    return (m_sh[0], sq_sh[0]) if mesh is None else (m_sh, sq_sh)


def msq_host(live: LiveIndex) -> np.ndarray:
    """The [cap] msq column on the host (a small fetch)."""
    return np.concatenate([t.cpu().numpy() for t in _shards(live)[1]])


def _mesh_capacity(cap: int, rows_per_video: int, mesh) -> int:
    """A row capacity rounded up to the sharded arena's invariants:
    divisible by the "corpus" axis size, and ``rows_per_shard >= rows_per_video``
    (a small snapshot on a large mesh still takes whole videos).  Every
    constructor and ``live_grow`` goes through it."""
    if mesh is None:
        return cap
    ndev = mesh.shape["corpus"]
    cap = max(cap, ndev * rows_per_video)
    return cap + (-cap) % ndev


def _alloc(cap: int, width: int, dtype: torch.dtype, devices):
    """Free shards of a ``cap``-row arena of ``dtype`` rows over
    ``devices``: zero rows (exact in bf16 too), msq 1e30."""
    n = cap // len(devices)
    return ([torch.zeros((n, width), dtype=dtype, device=d)
             for d in devices],
            [torch.full((n,), 1e30, dtype=torch.float32, device=d)
             for d in devices])


def _write_rows(shards, start: int, src: torch.Tensor) -> None:
    """Global rows ``[start, start + len(src))`` of a sharded column <- src,
    in place: each shard copies its overlap."""
    rps = int(shards[0].shape[0])
    n = int(src.shape[0])
    for i, t in enumerate(shards):
        lo, hi = max(start, i * rps), min(start + n, (i + 1) * rps)
        if lo < hi:
            t[lo - i * rps:hi - i * rps].copy_(src[lo - start:hi - start],
                                               non_blocking=True)


def _read_rows(shards, rows: np.ndarray, device) -> torch.Tensor:
    """The global ``rows`` (increasing) of a sharded column, gathered from
    the shards that hold them onto ``device``."""
    rps = int(shards[0].shape[0])
    owner = rows // rps
    parts = []
    for s in np.unique(owner):
        a, b = np.searchsorted(owner, [s, s + 1])
        local = torch.from_numpy(rows[a:b] - s * rps).to(shards[s].device)
        parts.append(shards[s].index_select(0, local).to(device,
                                                         non_blocking=True))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


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
    the params' device, or row-sharded over ``mesh``'s "corpus" axis (the
    capacity rounded up by ``_mesh_capacity``; the extra rows are free
    rows)."""
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
    devices = [index.m.device]
    if mesh is not None:
        devices = mesh.axis_devices("corpus")
        if capacity_videos < len(devices):
            raise ValueError(
                f"capacity_videos={capacity_videos} < mesh corpus axis "
                f"({len(devices)}): each shard must hold at least one video")
        cap = _mesh_capacity(cap, P, mesh)
    used = index.num_rows
    m_cat, msq_fused = fuse_index_cat(index.m, index.m_sq, index.weights)
    index.m = index.m_sq = None
    m_sh, sq_sh = _alloc(cap, m_cat.shape[1], m_cat.dtype, devices)
    _write_rows(m_sh, 0, m_cat)
    _write_rows(sq_sh, 0, msq_fused)
    del m_cat, msq_fused
    video_row, prop_idx, spans_sec = _pad_host_metadata(
        cap, index.video_row, index.prop_idx, index.spans_sec)
    m_cat, msq_fused = _fields(mesh, m_sh, sq_sh)
    return LiveIndex(
        m_cat=m_cat,
        msq_fused=msq_fused,
        video_row=video_row,
        prop_idx=prop_idx,
        spans_sec=spans_sec,
        video_ids=list(dataset.video_ids[:V]),
        weights=np.asarray(index.weights, np.float32),
        used_rows=used,
        rows_per_video=P,
        index_dtype=index_dtype,
        mesh=mesh,
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
    place; returns the rows appended.  O(delta) work and bytes.  On a
    sharded arena each shard copies its overlap with the new rows (a delta
    may span several shards).

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
    d_cat, d_sq = fuse_index_cat(delta.m, delta.m_sq, delta.weights)
    start = live.used_rows
    m_sh, sq_sh = _shards(live)
    _write_rows(m_sh, start, d_cat)
    _write_rows(sq_sh, start, d_sq)
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
    rows = np.nonzero(mask)[0]
    sq_sh = _shards(live)[1]
    rps = live.rows_per_shard
    owner = rows // rps
    for s, t in enumerate(sq_sh):
        local = rows[owner == s] - s * rps
        if len(local):
            t.index_fill_(0, torch.from_numpy(local).to(t.device), 1e30)
    return int(mask.sum())


@torch.no_grad()
def live_compact(live: LiveIndex) -> int:
    """Reclaim tombstoned rows in place: pack the surviving rows to the
    front of the arena (order kept), renumber videos contiguously and drop
    the removed ids, freeing their capacity and making them re-addable.
    Returns the rows reclaimed.

    The kept rows are increasing and ``kept[i] >= i``, so a forward copy
    in blocks of ``COMPACT_BLOCK`` rows never overwrites a row a later
    block still reads; the temporary is one block.  On a sharded arena a
    block of one destination shard gathers its rows from whichever shards
    hold them.  As in the JAX package (a gather with index 0 past the
    survivors), every row past them then holds the old row 0 and msq 1e30.
    Tombstones are read from the arena itself (msq >= 1e29), so a loaded
    snapshot compacts too."""
    used = live.used_rows
    keep = msq_host(live)[:used] < _INVALID
    n_keep = int(keep.sum())
    reclaimed = used - n_keep
    if reclaimed == 0:
        return 0
    kept_rows = np.nonzero(keep)[0]
    old_vids = live.video_row[:used][keep]
    surviving = np.unique(old_vids)              # sorted == original order
    remap = np.full(live.num_videos, -1, np.int32)
    remap[surviving] = np.arange(len(surviving), dtype=np.int32)

    m_sh, sq_sh = _shards(live)
    rps = live.rows_per_shard
    row0 = m_sh[0][0].clone()
    for j, (m, sq) in enumerate(zip(m_sh, sq_sh)):
        for lo in range(j * rps, min((j + 1) * rps, n_keep), COMPACT_BLOCK):
            hi = min(lo + COMPACT_BLOCK, (j + 1) * rps, n_keep)
            src = kept_rows[lo:hi]
            blk_m = _read_rows(m_sh, src, m.device)
            blk_sq = _read_rows(sq_sh, src, m.device)
            m[lo - j * rps:hi - j * rps].copy_(blk_m)
            sq[lo - j * rps:hi - j * rps].copy_(blk_sq)
        past = max(n_keep - j * rps, 0)
        if past < rps:
            m[past:].copy_(row0.to(m.device).expand(rps - past, -1))
            sq[past:].fill_(1e30)
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
    """Grow the arena's capacity to ``capacity_videos`` (rounded up by
    ``_mesh_capacity`` on a mesh); returns the new capacity in rows.  The
    one live operation that reallocates the arena (and the host tables):
    an O(capacity) copy, operator-initiated.  On a sharded arena
    ``rows_per_shard`` changes, so rows move between shards: the new
    shards are laid out from the global row order."""
    new_cap = _mesh_capacity(capacity_videos * live.rows_per_video,
                             live.rows_per_video, live.mesh)
    if new_cap < live.capacity:
        raise ValueError(
            f"cannot shrink: capacity_videos={capacity_videos} -> "
            f"{new_cap} rows < current {live.capacity} (reclaim tombstones "
            "with live_compact instead)")
    if new_cap == live.capacity:
        return live.capacity
    m_sh, sq_sh = _shards(live)
    rps = live.rows_per_shard
    new_m, new_sq = _alloc(new_cap, m_sh[0].shape[1], m_sh[0].dtype,
                           [t.device for t in m_sh])
    for i, (m, sq) in enumerate(zip(m_sh, sq_sh)):
        _write_rows(new_m, i * rps, m)
        _write_rows(new_sq, i * rps, sq)
    live.m_cat, live.msq_fused = _fields(live.mesh, new_m, new_sq)
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
    .npz, atomically, in the JAX package's format: the arena's own values,
    a bf16 arena as its uint16 bit pattern.  A sharded arena writes the
    same single-device file (its shards in row order), so snapshots move
    between meshes.
    With ``params``/``model`` a provenance fingerprint is stored and
    checked at load."""
    m_sh = _shards(live)[0]
    if m_sh[0].dtype == torch.bfloat16:
        m_store = np.concatenate([t.view(torch.int16).cpu().numpy()
                                  for t in m_sh]).view(np.uint16)
        m_dtype = "bfloat16"
    else:
        m_store = np.concatenate([t.cpu().numpy() for t in m_sh])
        m_dtype = "float32"
    extra = {}
    if params is not None and model is not None:
        extra["fingerprint"] = np.asarray(json.dumps(
            _arena_fingerprint(live, params, model)))
    return atomic_savez(path, dict(
        m_cat=m_store, m_dtype=np.asarray(m_dtype),
        msq_fused=msq_host(live),
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
    otherwise; raises without CUDA), or row-sharded over ``mesh``'s
    "corpus" axis (its devices; the capacity padded by ``_mesh_capacity`` with
    free rows, so a snapshot from any mesh, or none, loads).  With
    ``params``/``model`` the stored fingerprint (if any) is checked: a
    snapshot from another checkpoint or corpus raises instead of serving
    wrong moments.  The arena keeps the file's dtype and values: a bf16
    file loads as a bf16 arena, an f32 file unrounded."""
    devices = ([resolve_device(device)] if mesh is None
               else mesh.axis_devices("corpus"))
    with np.load(path, allow_pickle=False) as z:
        m_dtype = str(z["m_dtype"])
        if m_dtype == "bfloat16":
            m = torch.from_numpy(z["m_cat"].view(np.int16)).view(
                torch.bfloat16)
        else:
            m = torch.from_numpy(np.asarray(z["m_cat"], np.float32))
        msq = torch.from_numpy(np.asarray(z["msq_fused"], np.float32))
        video_row = z["video_row"].copy()
        prop_idx = z["prop_idx"].copy()
        spans_sec = z["spans_sec"].copy()
        rows_per_video = int(z["rows_per_video"])
        cap = _mesh_capacity(m.shape[0], rows_per_video, mesh)
        if cap > m.shape[0]:
            video_row, prop_idx, spans_sec = _pad_host_metadata(
                cap, video_row, prop_idx, spans_sec)
        m_sh, sq_sh = _alloc(cap, m.shape[1], m.dtype, devices)
        _write_rows(m_sh, 0, m)
        _write_rows(sq_sh, 0, msq)
        del m, msq
        m_cat, msq_fused = _fields(mesh, m_sh, sq_sh)
        live = LiveIndex(
            m_cat=m_cat,
            msq_fused=msq_fused,
            video_row=video_row,
            prop_idx=prop_idx,
            spans_sec=spans_sec,
            video_ids=[str(v) for v in z["video_ids"]],
            weights=z["weights"],
            used_rows=int(z["used_rows"]),
            rows_per_video=rows_per_video,
            index_dtype=str(z["index_dtype"]),
            mesh=mesh,
        )
        fp = (json.loads(str(z["fingerprint"]))
              if "fingerprint" in z.files else None)
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
    as in the JAX package, and at once on a sharded arena (whose shards
    ``eval.corpus.make_operand_retriever`` takes as they are)."""
    k_req = int(k)
    if live.mesh is not None and topk_method == "fused":
        raise ValueError("topk_method='fused' is single-device only; "
                         "a sharded live arena uses exact/approx")
    built = {}          # the retriever of the current clamped k

    def current():
        k_eff = int(min(k_req, live.capacity))
        fn = built.get(k_eff)
        if fn is None:
            built.clear()
            fn = built[k_eff] = make_operand_retriever(
                model, live.weights, k_eff, topk_method=topk_method,
                approx_recall=approx_recall, rnn_kernel=rnn_kernel)
        return fn

    def retrieve(params, tokens, lengths):
        return current()(live.m_cat, live.msq_fused, params, tokens, lengths)

    retrieve.eager = lambda params, tokens, lengths: current().eager(
        live.m_cat, live.msq_fused, params, tokens, lengths)
    retrieve.current = current
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
