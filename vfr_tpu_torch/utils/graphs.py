"""Captured batches: the port's counterpart of the reference's jit cache.

The JAX package compiles a serving batch (encode, score, select) into one
executable, cached per shape (``vfr_tpu/eval/corpus.py:62-72, 504-514``),
so a batch is one dispatch.  ``BatchGraphs`` does the same with CUDA
graphs: it wraps one of the port's eager batch functions and, on the card,
replays one captured graph per key.

* **First call of a key**: the eager function runs once on a side stream
  (the warm-up builds the kernels through ``kernels/build.py::load`` and
  settles cuBLAS and the recurrence's work buffers, so nothing is built
  inside a capture), then is captured with ``torch.cuda.graph`` over
  static copies of the call's per-batch inputs, then replayed.
* **Every later call**: the per-batch inputs (``batch_args``: tokens,
  lengths) are copied into the static buffers, the graph is replayed on
  the current stream, and the static outputs are cloned (or copied into
  ``out=``), so a result kept past the next replay never changes.  The
  copies are queued on the stream: nothing syncs.
* **The key**: shape, stride, dtype and device of every tensor argument,
  the ``data_ptr()`` of every tensor the graph reads in place (every
  argument outside ``batch_args``: the index operands, each leaf of the
  params tree), and every other argument's value.  An in-place write to an
  operand (``live_append``'s ``copy_``, ``live_remove``'s ``index_fill_``,
  a compaction) keeps the key and the replay reads the new contents; a
  reallocation (``live_grow``, a new params tree, a new query shape) is a
  new key and one new capture, as the reference's "same shapes, so the
  compiled program is reused untouched" (``vfr_tpu/eval/corpus.py:
  491-493``).
* **The cache** is bounded (``MAX_GRAPHS``, least recently used out first,
  as the reference's ``_LRUCache``) and belongs to the wrapper, so a
  retriever that is dropped frees its graphs.  Its graphs share one memory
  pool (``torch.cuda.graph_pool_handle()``): they are replayed on one
  stream, never concurrently, and each replay's outputs are cloned before
  any other replay is queued, so no graph's outputs are alive while
  another graph reuses the pool's memory (the torch docs' condition for
  sharing a pool).  The static inputs are allocated outside the pool.
* **Counts and spans** (``utils/trace.py``): the kernel modules count
  launches in Python (``LAUNCHES``, ``VARIANT_LAUNCHES``,
  ``DEVICE_LAUNCHES``) and the select its route, in counters registered
  with the recorder, which a replay does not run.  The capture's change
  of every registered counter is recorded and taken back (nothing ran),
  and each replay adds it.  A call on the card counts ``graphs.calls`` and
  ``graphs.replays`` (``graphs.captures``, ``graphs.evictions`` as they
  happen) and, while the recorder is on, records the span ``graphs.call``
  with its children ``graphs.key``, ``graphs.inputs``, ``graphs.replay``
  and ``graphs.outputs``.  A capture is the set-up span
  ``graphs.capture`` (``graphs.warm``, ``graphs.record``), and the stage
  marks of the wrapped function give the graph's stage map
  (``_Graph.stages``).

On CPU tensors the eager function runs unchanged.  A capture that fails
raises, naming the wrapped function and the error of the operation that
broke it; nothing serves eagerly on the card instead.  ``eager`` is the
eager function itself, for holding a graph against it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
from typing import Callable, Dict, List, Optional, Sequence

import torch

from vfr_tpu_torch.utils import trace

MAX_GRAPHS = 8   # a few length buckets of one retriever, with room to spare
_wrappers = itertools.count(1)


def _arg_key(a, in_place: bool):
    if isinstance(a, torch.Tensor):
        key = (tuple(a.shape), tuple(a.stride()), a.dtype, a.device)
        return key + (a.data_ptr(),) if in_place else key
    if isinstance(a, dict):
        return tuple((k, _arg_key(a[k], in_place)) for k in sorted(a))
    return a


def _clone(outs):
    if isinstance(outs, torch.Tensor):
        return outs.clone()
    return tuple(o.clone() for o in outs)


def write_out(res, out):
    """``res`` copied into the tensors of ``out`` (returned), or ``res``."""
    if out is None:
        return res
    if isinstance(res, torch.Tensor):
        return out.copy_(res)
    for o, r in zip(out, res):
        o.copy_(r)
    return out


class _Graph:
    """One key's capture: the graph, its static inputs and outputs, the
    counts one replay stands for, and its stage map."""

    def __init__(self, graph, static, outs, delta, stages):
        self.graph = graph
        self.static = static      # {argument position: static input}
        self.outs = outs
        self.delta = delta        # [(counter dict, {key: count})]
        self.stages = stages      # [(stage, device nodes)], node order


class BatchGraphs:
    """``fn(*args)`` replayed as one CUDA graph per key (module docstring).

    ``batch_args``: the positions of the per-batch inputs (copied into
    static buffers every call); every other tensor argument is read in
    place.  ``name`` names the function in a capture error.  ``captures``
    counts the captures made; ``id`` is the wrapper's id in the recorder
    (its ``graphs.capture`` spans and stage maps)."""

    def __init__(self, fn: Callable, batch_args: Sequence[int], name: str):
        self.eager = fn
        self.batch_args = tuple(batch_args)
        self.name = name
        self.id = f"graphs:{next(_wrappers)}"
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        self._pool = None
        self.captures = 0

    def __call__(self, *args, out=None):
        if not self._on_card(args):
            return write_out(self.eager(*args), out)
        trace.count("graphs.calls")
        with trace.span("graphs.call", trace.NEW):
            with trace.span("graphs.key"):
                key = self.key(args)
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(key, args)
            else:
                self._graphs.move_to_end(key)
            with self._device(args):
                with trace.span("graphs.inputs"):
                    for i, t in entry.static.items():
                        t.copy_(args[i])
                with trace.span("graphs.replay"):
                    entry.graph.replay()
                trace.count("graphs.replays")
                for counts, d in entry.delta:
                    for k, n in d.items():
                        counts[k] = counts.get(k, 0) + n
                with trace.span("graphs.outputs"):
                    return write_out(entry.outs, out) if out is not None \
                        else _clone(entry.outs)

    def key(self, args) -> tuple:
        return tuple(_arg_key(a, i not in self.batch_args)
                     for i, a in enumerate(args))

    def __len__(self) -> int:
        return len(self._graphs)

    def pool_bytes(self) -> int:
        """Bytes the shared pool holds on the card (its segments in the
        caching allocator's snapshot); 0 before the first capture."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    # the three steps that touch the card, separate so that the CPU tests
    # can stand in for them
    def _on_card(self, args) -> bool:
        return args[self.batch_args[0]].device.type == "cuda"

    def _device(self, args):
        dev = args[self.batch_args[0]].device
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _warm_and_record(self, warm: Callable, record: Callable):
        """(graph, outputs): ``warm`` run on a side stream of the current
        card, then ``record`` captured on that stream into the wrapper's
        pool.  Not on torch's default capture stream: that is one a
        process, made on the card of the process's first capture, so a
        capture on another card would record onto it and fail."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm()
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side):
            outs = record()
        return graph, outs

    def _capture(self, key, args) -> _Graph:
        while len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)
            trace.count("graphs.evictions")
        with trace.setup("graphs.capture", self.id), self._device(args):
            static = {i: args[i].clone() for i in self.batch_args}
            call = [static.get(i, a) for i, a in enumerate(args)]
            counters: List[Dict] = []
            snap: Optional[List[Dict]] = None
            stages: List = []

            def warm():
                with trace.setup("graphs.warm"):
                    return self.eager(*call)

            def record():
                nonlocal counters, snap, stages
                with trace.setup("graphs.record"):
                    # the counts the capture moves are taken back: nothing
                    # ran.  The dicts are listed after the warm-up, which
                    # registers those of kernel modules it imports first.
                    counters = trace.counter_dicts()
                    snap = [dict(c) for c in counters]
                    with trace.capturing(self.id, self.name) as stages:
                        return self.eager(*call)

            try:
                graph, outs = self._warm_and_record(warm, record)
            except Exception as e:
                raise RuntimeError(
                    f"capturing {self.name} as a CUDA graph failed: {e}"
                ) from e
            finally:
                delta = []
                if snap is not None:
                    for c, before in zip(counters, snap):
                        d = {k: n - before.get(k, 0) for k, n in c.items()
                             if n != before.get(k, 0)}
                        c.clear()
                        c.update(before)
                        if d:
                            delta.append((c, d))
        entry = self._graphs[key] = _Graph(graph, static, outs, delta, stages)
        self.captures += 1
        trace.count("graphs.captures")
        return entry
