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
* **Launch counts**: the kernel modules count launches in Python
  (``LAUNCHES``, ``VARIANT_LAUNCHES``, ``DEVICE_LAUNCHES``), which a
  replay does not run.  The capture's change of every counter is recorded
  and taken back (nothing ran), and each replay adds it.

On CPU tensors the eager function runs unchanged.  A capture that fails
raises, naming the wrapped function and the error of the operation that
broke it; nothing serves eagerly on the card instead.  ``eager`` is the
eager function itself, for holding a graph against it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

MAX_GRAPHS = 8   # a few length buckets of one retriever, with room to spare


def _launch_counters() -> List[Dict]:
    """Every launch counter of the kernel modules."""
    from vfr_tpu_torch.ops.kernels import (
        coarse_kernel,
        gru_kernel,
        lstm_kernel,
        select_kernel,
    )

    return [d for mod in (lstm_kernel, gru_kernel, select_kernel,
                          coarse_kernel)
            for d in (mod.LAUNCHES, mod.VARIANT_LAUNCHES,
                      mod.DEVICE_LAUNCHES)]


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
    """One key's capture: the graph, its static inputs and outputs, and
    the launch counts one replay stands for."""

    def __init__(self, graph, static, outs, delta):
        self.graph = graph
        self.static = static      # {argument position: static input}
        self.outs = outs
        self.delta = delta        # [(counter dict, {key: launches})]


class BatchGraphs:
    """``fn(*args)`` replayed as one CUDA graph per key (module docstring).

    ``batch_args``: the positions of the per-batch inputs (copied into
    static buffers every call); every other tensor argument is read in
    place.  ``name`` names the function in a capture error.  ``captures``
    and ``capture_s`` count the captures made and their seconds."""

    def __init__(self, fn: Callable, batch_args: Sequence[int], name: str):
        self.eager = fn
        self.batch_args = tuple(batch_args)
        self.name = name
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        self._pool = None
        self.captures = 0
        self.capture_s: List[float] = []

    def __call__(self, *args, out=None):
        if not self._on_card(args):
            return write_out(self.eager(*args), out)
        key = self.key(args)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, args)
        else:
            self._graphs.move_to_end(key)
        with self._device(args):
            for i, t in entry.static.items():
                t.copy_(args[i])
            entry.graph.replay()
            for counts, d in entry.delta:
                for k, n in d.items():
                    counts[k] = counts.get(k, 0) + n
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
        """(graph, outputs): ``warm`` run on a side stream, then ``record``
        captured into the wrapper's pool."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm()
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            outs = record()
        return graph, outs

    def _capture(self, key, args) -> _Graph:
        while len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)
        t0 = time.perf_counter()
        with self._device(args):
            static = {i: args[i].clone() for i in self.batch_args}
            call = [static.get(i, a) for i, a in enumerate(args)]
            counters = _launch_counters()
            snap: Optional[List[Dict]] = None

            def record():
                nonlocal snap
                # the counts the capture moves are taken back: nothing ran
                snap = [dict(c) for c in counters]
                return self.eager(*call)

            try:
                graph, outs = self._warm_and_record(
                    lambda: self.eager(*call), record)
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
        entry = self._graphs[key] = _Graph(graph, static, outs, delta)
        self.captures += 1
        self.capture_s.append(time.perf_counter() - t0)
        return entry
