"""Background batch assembly with a bounded queue and host -> device copies
off the consumer's stream (the train loop's chunk feed), and
``device_put_prefetch``, the JAX package's generator that keeps a few
batches' copies queued ahead of the consumer.

``Prefetcher(batch_fn, depth, device)`` runs ``batch_fn()`` (an iterator of
dicts of numpy arrays) on a background thread; at most ``depth`` assembled
batches wait in the queue.  On CUDA each array is pinned and copied
``non_blocking`` on a side stream of its device, and an event is recorded
there; each device's consumer stream waits on that event before the batch
is handed out, and ``record_stream`` tells the caching allocator that the
consumer's stream uses the memory, so no copy ever blocks the host or a
step.  ``place`` spreads a batch over several devices (a data-parallel
mesh), each copy landing on its own device directly.  On the CPU the
arrays become tensors and the queue is all there is.

The queue is the only shared state.  A put aborts when the consumer closes
the prefetcher, an error of ``batch_fn`` is re-raised to the consumer after
the batches before it, and ``close`` is idempotent.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from vfr_tpu_torch.device import resolve_device
from vfr_tpu_torch.parallel.mesh import split_batch

_SENTINEL = object()


def _tensor(v) -> torch.Tensor:
    a = np.asarray(v)
    if not a.flags.c_contiguous:
        a = a.copy()
    return torch.from_numpy(a)


def device_put_prefetch(
    it: Iterator[Dict[str, np.ndarray]],
    depth: int = 2,
    device=None,
    mesh=None,
) -> Iterator:
    """Keep ``depth`` batches' copies queued ahead of the consumer: each
    batch of ``it`` is placed when it arrives and handed out ``depth``
    batches later (the JAX package's ``device_put_prefetch``).  On
    ``device`` (CUDA unless asked otherwise) each array is a pinned
    ``non_blocking`` copy on the current stream, so the consumer's work
    is ordered after it and the host does not wait.  With ``mesh`` a
    batch is split by rows over the mesh's first axis instead
    (``parallel.mesh.split_batch``): one dict per position."""
    if mesh is not None:
        devices = mesh.axis_devices(mesh.axis_names[0])

        def put(batch):
            return split_batch(batch, devices, copy=_place)
    else:
        dev = resolve_device(device)

        def put(batch):
            return {k: _place(v, dev) for k, v in batch.items()}
    buf = []
    for batch in it:
        buf.append(put(batch))
        if len(buf) > depth:
            yield buf.pop(0)
    yield from buf


def _place(v, dev) -> torch.Tensor:
    """``v`` as a tensor on ``dev``: on CUDA a pinned ``non_blocking``
    copy on the current stream."""
    dev = torch.device(dev)
    t = _tensor(v)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


class Prefetcher:
    """Background-thread batch assembly + asynchronous host -> device
    copies, bounded queue; iterate it once.

    ``place(batch, copy)`` decides where a batch's arrays go: it returns
    the batch as the consumer takes it, built from ``copy(array, device)``
    calls (default: every array to ``device``; the data-parallel loop
    passes ``train.step.place_batch``, which sends each shard's rows to its
    device and the loss's keys to the lead).  Each device copied to gets
    its own side stream and, per batch, its own event."""

    def __init__(
        self,
        batch_fn: Callable[[], Iterator[Dict[str, np.ndarray]]],
        depth: int = 2,
        device=None,
        place: Optional[Callable] = None,
    ):
        self._stop = threading.Event()
        self._dev = resolve_device(device)
        self._place = place or (lambda batch, copy: {
            k: copy(v, self._dev) for k, v in batch.items()})
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(batch_fn,), daemon=True
        )
        self._thread.start()

    def _copy(self, batch):
        """(placed batch, [(device, event, its tensors)] of the CUDA
        devices copied to)."""
        pending: Dict[torch.device, list] = {}

        def copy(v, dev):
            dev = torch.device(dev)
            if dev.type != "cuda":
                return _place(v, dev)
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(device=dev)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                out = _place(v, dev)
            pending.setdefault(dev, []).append(out)
            return out

        placed = self._place(batch, copy)
        done = []
        for dev, tensors in pending.items():
            ev = torch.cuda.Event()
            ev.record(self._streams[dev])
            done.append((dev, ev, tensors))
        return placed, done

    def _put(self, item) -> bool:
        """Bounded put that aborts when the consumer closed us (a plain
        put would block forever on a full queue the consumer abandoned)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, batch_fn):
        try:
            for batch in batch_fn():
                if self._stop.is_set():
                    return
                if not self._put(self._copy(batch)):
                    return
        except BaseException as e:  # to the consumer
            self._err = e
        finally:
            self._put(_SENTINEL)

    def close(self) -> None:
        """Stop the producer and reap its thread (idempotent); safe while
        the producer is blocked mid-put.  The queue is drained so held
        device buffers are released."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __del__(self):
        # a never-iterated prefetcher: the event alone breaks the put loop
        self._stop.set()

    def __iter__(self):
        try:
            while True:
                try:
                    item = self._q.get(timeout=0.1)
                except queue.Empty:
                    # after close() the sentinel may never arrive: a
                    # stopped, drained queue ends the iteration
                    if self._stop.is_set() and not self._thread.is_alive():
                        return
                    continue
                if item is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                batch, done = item
                for dev, ev, tensors in done:
                    cur = torch.cuda.current_stream(dev)
                    cur.wait_event(ev)
                    for t in tensors:
                        t.record_stream(cur)
                yield batch
        finally:
            self.close()   # consumer abandoned or exhausted: reap producer
