"""Background batch assembly with a bounded queue and host -> device copies
off the consumer's stream (the train loop's chunk feed).

``Prefetcher(batch_fn, depth, device)`` runs ``batch_fn()`` (an iterator of
dicts of numpy arrays) on a background thread; at most ``depth`` assembled
batches wait in the queue.  On CUDA each array is pinned and copied
``non_blocking`` on a side stream, and an event is recorded there; the
consumer's stream waits on that event before the batch is handed out, and
``record_stream`` tells the caching allocator that the consumer's stream
uses the memory, so no copy ever blocks the host or a step.  On the CPU the
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

_SENTINEL = object()


def _tensor(v) -> torch.Tensor:
    a = np.asarray(v)
    if not a.flags.c_contiguous:
        a = a.copy()
    return torch.from_numpy(a)


class Prefetcher:
    """Background-thread batch assembly + asynchronous host -> device
    copies, bounded queue; iterate it once."""

    def __init__(
        self,
        batch_fn: Callable[[], Iterator[Dict[str, np.ndarray]]],
        depth: int = 2,
        device=None,
    ):
        self._stop = threading.Event()
        self._dev = resolve_device(device)
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device=self._dev)
            if self._dev.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(batch_fn,), daemon=True
        )
        self._thread.start()

    def _copy(self, batch):
        """(batch of device tensors, event of its copies or None)."""
        if self._stream is None:
            return {k: _tensor(v).to(self._dev) for k, v in batch.items()}, \
                None
        with torch.cuda.device(self._dev), torch.cuda.stream(self._stream):
            out = {k: _tensor(v).pin_memory().to(self._dev, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

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
                if done is not None:
                    cur = torch.cuda.current_stream(self._dev)
                    cur.wait_event(done)
                    for t in batch.values():
                        t.record_stream(cur)
                yield batch
        finally:
            self.close()   # consumer abandoned or exhausted: reap producer
