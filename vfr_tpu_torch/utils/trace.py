"""The port's recorder: spans, counters and stage marks, in memory, on the
clock torch.profiler stamps its device events with (``time.time_ns``), so
the port's spans and a profile's kernels share one time base.

**Spans** are ``(name, id, parent, start_ns, end_ns)``.  ``id`` names the
unit of work a span belongs to (a request, a pack, a batch call, a graph
wrapper, a kernel library); ``parent`` is the id of the unit that caused
it.  A span opened inside another on the same thread takes the enclosing
span's id as its parent, and shares that id when it is given none.

* **Set-up spans** (``setup``) are always recorded, into a list of their
  own (``SETUP_RING``), so that a long traced run never overwrites them:

  - ``kernels.load`` (id: the source's name): a kernel library loaded,
    with the child ``kernels.build`` when ``nvcc`` compiles it first
    (``kernels/build.py::load``);
  - ``graphs.capture`` (id: the wrapper's ``BatchGraphs.id``): one key's
    capture, with the children ``graphs.warm`` (the eager warm-up on a
    side stream) and ``graphs.record`` (the recording into the graph);
  - ``setup.operands``: a retriever's index operands prepared
    (``eval/corpus.py::prep_score_operands``);
  - ``setup.query_params``: the recurrence weights cast once
    (``models/mcn.py::prepare_query_params``).

* **Hot-path spans** (``span``, ``record``) are recorded only while the
  recorder is on: while a torch profiler records, or after ``enable()``.
  Off, a span site costs one flag test and records nothing.  They go to
  a ring of ``RING`` entries, the oldest overwritten (``dropped`` counts
  them):

  - ``graphs.call`` (a fresh id per call) around ``BatchGraphs.__call__``
    on the card, with the children ``graphs.key`` (the cache key over
    every argument), ``graphs.inputs`` (the per-batch inputs copied into
    the static buffers), ``graphs.replay`` (the replay enqueued) and
    ``graphs.outputs`` (the static outputs cloned or copied to ``out=``);
  - in ``eval/corpus.py::serve_follow``, by pack (id ``pack:<n>``):
    ``pack.tokens`` (tokenizing and ``vocab.encode``), ``pack.dispatch``
    (the pinned copies, the retrieve call, the copies back, the event),
    ``pack.wait`` (the event's ``synchronize``), ``pack.records`` (the
    result dicts built); by request (id ``request:<n>``, ``n`` the input
    line's ordinal; parent the id of the pack that answered it):
    ``request`` (the reader thread's receipt of the line to its record's
    yield) with the child ``queue`` (receipt to being packed).

**Counters** (``count``) are always on: ``graphs.calls``,
``graphs.replays``, ``graphs.captures``, ``graphs.evictions``;
``select.kernel`` / ``select.key64`` / ``select.order32_tie``
(``ops/topk.py``: the route of each top-k); ``daemon.requests``, ``daemon.packs``,
``daemon.pack_size.<n>``, ``daemon.idle_flushes`` (packs fetched at once
because no input waited).  The kernel modules' launch dicts register
theirs (``register``).  A graph replay runs no Python: ``BatchGraphs``
takes back what a capture moved in every registered counter and adds it
at each replay, so a count made inside a captured batch (the select
route, the launches) counts once per replay.

**Stage marks** (``stage``) name the device stages of a batch function
("encode", "score", "select").  Outside a capture a mark is one test.
While ``BatchGraphs`` records a graph (``capturing``) a mark reads how
many kernel, memset and memcpy nodes the graph holds so far, the device
events a profile shows for a replay, and the capture keeps the graph's
**stage map**: ``[(stage, nodes), ...]`` in node order.  A replay costs
nothing more.

``snapshot()`` is the read interface; ``export_chrome`` writes it in
Chrome trace format beside a profiler's trace (``cli serve / train
--trace-dir``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

try:
    from torch.autograd import profiler as _profiler
except ImportError:                     # pragma: no cover
    _profiler = None

RING = 1 << 16          # hot-path spans kept
SETUP_RING = 4096       # set-up spans kept
STAGE_MAPS = 256        # stage maps kept

Span = Tuple[str, object, object, int, int]

NEW = object()          # a span id: a fresh integer when the span records

_spans: "collections.deque" = collections.deque(maxlen=RING)
_setup: "collections.deque" = collections.deque(maxlen=SETUP_RING)
_stage_maps: "collections.deque" = collections.deque(maxlen=STAGE_MAPS)
_counters: Dict[str, int] = {}
_registry: List[Tuple[str, Dict]] = [("", _counters)]
_dropped = 0
_drop_lock = threading.Lock()
_enabled = False
_marks: Optional[List[Tuple[str, int]]] = None
_ids = itertools.count(1)
_local = threading.local()


def on() -> bool:
    """Whether hot-path spans record: after ``enable()``, or while a torch
    profiler records (the flag torch keeps for fast Python checks; off
    where this torch has no such flag)."""
    return _enabled or getattr(_profiler, "_is_profiler_enabled", False)


def enable(flag: bool = True) -> None:
    """Record hot-path spans whether or not a profiler runs (``False``:
    only while one does)."""
    global _enabled
    _enabled = bool(flag)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _keep(ring, item: Span) -> None:
    global _dropped
    if len(ring) == ring.maxlen:
        with _drop_lock:
            _dropped += 1
    ring.append(item)


class _Span:
    __slots__ = ("name", "id", "parent", "ring", "start")

    def __init__(self, name, id, parent, ring):
        self.name, self.id, self.parent, self.ring = name, id, parent, ring

    def __enter__(self):
        stack = _stack()
        if stack:
            top = stack[-1].id
            if self.parent is None:
                self.parent = top
            if self.id is None:
                self.id = top
        if self.id is NEW:
            self.id = next(_ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        _keep(self.ring, (self.name, self.id, self.parent, self.start, end))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, id=None, parent=None):
    """A hot-path span (a context manager): recorded while ``on()``."""
    if not on():
        return _OFF
    return _Span(name, id, parent, _spans)


def setup(name: str, id=None, parent=None):
    """A set-up span (a context manager): always recorded."""
    return _Span(name, id, parent, _setup)


def record(name: str, start_ns: int, end_ns: int, id=None,
           parent=None) -> None:
    """A hot-path span whose ends were stamped elsewhere (``time.time_ns``):
    a request received on one thread and answered on another."""
    if on():
        _keep(_spans, (name, id, parent, int(start_ns), int(end_ns)))


# ------------------------------------------------------------- counters

def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def register(prefix: str, counters: Dict) -> Dict:
    """Add a module's counter dict to the registry (returned as is):
    ``snapshot`` reads it as ``<prefix>.<key>``, and a graph replay adds
    what its capture counted in it."""
    _registry.append((prefix, counters))
    return counters


def counter_dicts() -> List[Dict]:
    """Every registered counter dict, the recorder's own first."""
    return [d for _, d in _registry]


def counters() -> Dict[str, int]:
    out = dict(_counters)
    for prefix, d in _registry[1:]:
        for k, n in d.items():
            out[f"{prefix}.{k}"] = n
    return out


# ---------------------------------------------------------- stage marks

def stage(name: str) -> None:
    """Mark the start of device stage ``name`` inside a batch function."""
    if _marks is not None:
        _marks.append((name, _node_count()))


@contextlib.contextmanager
def capturing(id, name: str):
    """Around the recording of a graph on the current stream: the stage
    marks made inside read the graph's node count, and at the end the
    yielded list holds the graph's stage map (empty when no mark was
    made), which the recorder keeps under ``id`` and ``name``."""
    global _marks
    marks: List[Tuple[str, int]] = []
    out: List[Tuple[str, int]] = []
    _marks = marks
    try:
        yield out
        if marks:
            out.extend(stage_map(marks, _node_count()))
            _stage_maps.append({"id": id, "name": name, "stages": list(out)})
    finally:
        _marks = None


def stage_map(marks: Sequence[Tuple[str, int]], total: int
              ) -> List[Tuple[str, int]]:
    """Marks ``(stage, nodes before it)`` and the final node count as
    ``(stage, nodes in it)``; nodes before the first mark are "unmarked"."""
    marks = list(marks)
    if marks[0][1] > 0:
        marks.insert(0, ("unmarked", 0))
    ends = [n for _, n in marks[1:]] + [total]
    return [(s, e - n) for (s, n), e in zip(marks, ends)]


_KINDS = (0, 1, 2)      # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
_cuda = None


def _driver():
    """The CUDA driver's capture and graph entry points, through ctypes."""
    global _cuda
    if _cuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        P, S = ctypes.c_void_p, ctypes.POINTER
        if hasattr(lib, "cuStreamGetCaptureInfo_v2"):
            info = lib.cuStreamGetCaptureInfo_v2
            info.argtypes = [P, S(ctypes.c_int), S(ctypes.c_uint64), S(P),
                             S(P), S(ctypes.c_size_t)]
            edges = False
        else:
            info = lib.cuStreamGetCaptureInfo_v3
            info.argtypes = [P, S(ctypes.c_int), S(ctypes.c_uint64), S(P),
                             S(P), S(P), S(ctypes.c_size_t)]
            edges = True
        lib.cuGraphGetNodes.argtypes = [P, P, S(ctypes.c_size_t)]
        lib.cuGraphNodeGetType.argtypes = [P, S(ctypes.c_int)]
        _cuda = (lib, info, edges)
    return _cuda


def _node_count() -> int:
    """Kernel, memcpy and memset nodes of the graph the current CUDA
    stream is capturing into."""
    import torch

    lib, info, edges = _driver()
    status, cid = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, edge_data = (ctypes.c_void_p(), ctypes.c_void_p(),
                              ctypes.c_void_p())
    n_deps = ctypes.c_size_t()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ref = ctypes.byref
    args = [stream, ref(status), ref(cid), ref(graph), ref(deps)]
    args += [ref(edge_data)] if edges else []
    err = info(*args, ref(n_deps))
    if err != 0 or status.value != 1:         # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"stage mark outside a capture (CUDA error {err}, "
                           f"capture status {status.value})")
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(graph, None, ref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if err == 0 and n.value:
        err = lib.cuGraphGetNodes(graph, nodes, ref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {err}")
    kind = ctypes.c_int()
    found = 0
    for node in nodes[:n.value]:
        if lib.cuGraphNodeGetType(node, ref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        found += kind.value in _KINDS
    return found


# ---------------------------------------------------------------- reads

def snapshot() -> Dict:
    """What the recorder holds, for readers and exporters:

    * ``spans``: hot-path spans, oldest first, each ``(name, id, parent,
      start_ns, end_ns)`` on the ``time.time_ns`` clock;
    * ``setup``: set-up spans, the same form;
    * ``counters``: every counter by name (a registered dict's keys as
      ``<prefix>.<key>``);
    * ``stages``: the stage maps of the graphs captured, oldest first,
      each ``{"id", "name", "stages": [(stage, nodes), ...]}``;
    * ``dropped``: spans overwritten in a full ring."""
    return {"spans": list(_spans), "setup": list(_setup),
            "counters": counters(),
            "stages": [dict(m, stages=list(m["stages"]))
                       for m in _stage_maps],
            "dropped": _dropped}


def reset() -> None:
    """Forget the spans, stage maps, drops and the recorder's own counters
    (the registered dicts stay as their modules keep them)."""
    global _dropped
    _spans.clear()
    _setup.clear()
    _stage_maps.clear()
    _counters.clear()
    _dropped = 0


def export_chrome(path: str, base_ns: int = 0) -> str:
    """Write ``snapshot()`` to ``path`` in Chrome trace format: each span
    an async slice (category: its name's first part; spans of one id
    nest), ``ts`` in microseconds since ``base_ns``, the time base of a
    torch.profiler trace (its ``baseTimeNanoseconds``), so that both load
    into one view.  The counters and stage maps go under ``otherData``."""
    snap = snapshot()
    events = []
    for kind, spans in (("setup", snap["setup"]), ("hot", snap["spans"])):
        for name, sid, parent, a, b in spans:
            common = {"name": name, "cat": name.split(".")[0],
                      "id": str(sid if sid is not None else name),
                      "pid": "vfr_tpu_torch", "tid": kind}
            args = {"id": sid, "parent": parent}
            events.append(dict(common, ph="b", ts=(a - base_ns) / 1e3,
                               args=args))
            events.append(dict(common, ph="e", ts=(b - base_ns) / 1e3))
    doc = {"traceEvents": events, "baseTimeNanoseconds": base_ns,
           "displayTimeUnit": "ms",
           "otherData": {"counters": snap["counters"],
                         "stages": snap["stages"],
                         "dropped": snap["dropped"]}}
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return path
