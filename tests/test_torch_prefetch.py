"""The port's ``Prefetcher`` (``vfr_tpu_torch.data.prefetch``): the JAX
package's stress cases (bounded queue, owned buffers, abandoned and closed
consumers, concurrent prefetchers, the producer's error re-raised) on the
CPU, where each batch becomes tensors; and the train loop fed by it
(``prefetch_depth`` 2) equal, bit for bit, to the same loop fed
synchronously."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from vfr_tpu_torch.data.prefetch import Prefetcher


def _pf(gen, depth):
    return Prefetcher(gen, depth=depth, device="cpu")


def test_stress_many_batches_slow_consumer():
    N = 200

    def gen():
        for i in range(N):
            yield {"x": np.full((4,), i, np.float32), "i": np.int32(i)}

    seen = []
    for j, b in enumerate(_pf(gen, 3)):
        if j % 37 == 0:
            time.sleep(0.002)  # stall the consumer; the queue absorbs it
        assert isinstance(b["x"], torch.Tensor)
        seen.append(int(b["i"]))
    assert seen == list(range(N))


def test_stress_slow_producer():
    N = 50

    def gen():
        for i in range(N):
            if i % 11 == 0:
                time.sleep(0.002)
            yield {"x": np.full((2,), i, np.float32)}

    out = list(_pf(gen, 2))
    assert len(out) == N
    assert float(out[-1]["x"][0]) == N - 1


def test_bounded_queue_never_overfills():
    """With a parked consumer the producer stages at most depth batches
    (+1 in flight)."""
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield {"x": np.zeros(1, np.float32)}

    pf = _pf(gen, 2)
    time.sleep(0.3)
    assert len(produced) <= 4, produced
    assert len(list(pf)) == 100


def test_consumer_abandons_early_producer_exits():
    def gen():
        for i in range(10_000):
            yield {"x": np.full((2,), i, np.float32)}

    pf = _pf(gen, 2)
    for j, _ in enumerate(pf):
        if j == 3:
            break
    pf.close()                          # idempotent with __iter__'s finally
    pf.close()
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive(), "producer thread leaked after abandon"


def test_close_while_producer_blocked_mid_put():
    def gen():
        for i in range(10_000):
            yield {"x": np.zeros(1, np.float32)}

    pf = _pf(gen, 1)
    time.sleep(0.1)
    pf.close()
    assert not pf._thread.is_alive(), "producer stuck despite close()"


def test_close_then_iterate_yields_nothing_or_tail():
    def gen():
        for i in range(100):
            yield {"x": np.full((1,), i, np.float32)}

    pf = _pf(gen, 2)
    pf.close()
    assert len(list(pf)) <= 2


def test_concurrent_prefetchers_do_not_interfere():
    def gen(tag):
        def g():
            for i in range(40):
                yield {"x": np.full((2,), tag * 1000 + i, np.float32)}
        return g

    pfs = [_pf(gen(t), 2) for t in range(4)]
    results, errs = {}, []

    def drain(t, pf):
        try:
            results[t] = [float(b["x"][0]) for b in pf]
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=drain, args=(t, pf))
               for t, pf in enumerate(pfs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not errs
    for t in range(4):
        assert results[t] == [float(t * 1000 + i) for i in range(40)]


def test_producer_error_reaches_consumer_after_its_batches():
    def gen():
        yield {"x": np.zeros(1, np.float32)}
        yield {"x": np.ones(1, np.float32)}
        raise KeyError("broken batch")

    got = []
    with pytest.raises(KeyError, match="broken batch"):
        for b in _pf(gen, 2):
            got.append(float(b["x"][0]))
    assert got == [0.0, 1.0]


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prefetcher(lambda: iter(()))


def test_train_steps_with_prefetch_equal_synchronous(monkeypatch, tmp_path):
    """The loop's chunks through the prefetcher (depth 2) and through a
    synchronous stand-in give bit-identical params, EMA and losses."""
    from test_torch_train_loop import _cfg, _ckpt_tree, _records, _trees_equal
    from vfr_tpu_torch.config import get_preset
    from vfr_tpu_torch.train import checkpoint as tckpt
    from vfr_tpu_torch.train import loop as tloop

    class Synchronous:
        def __init__(self, batch_fn, depth=2, device=None):
            self._fn, self._dev = batch_fn, device

        def __iter__(self):
            for b in self._fn():
                yield {k: torch.from_numpy(np.asarray(v)).to(self._dev)
                       for k, v in b.items()}

    runs = {}
    for name in ("prefetch", "sync"):
        cfg = _cfg(get_preset, tmp_path / name, epochs=2,
                   hard_negative_count=0, steps_per_call=2)
        assert cfg.train.prefetch_depth == 2
        with monkeypatch.context() as m:
            if name == "sync":
                m.setattr(tloop, "Prefetcher", Synchronous)
            tloop.train(dataclasses.replace(cfg), device="cpu")
        runs[name] = cfg.train.checkpoint_dir
    a, b = (tckpt.latest_checkpoint(runs[n]) for n in ("prefetch", "sync"))
    for root in ("params", "ema", "opt_state"):
        _trees_equal(_ckpt_tree(a, root), _ckpt_tree(b, root))
    la = [r["loss"] for r in _records(f"{runs['prefetch']}/metrics.jsonl",
                                      "train")]
    lb = [r["loss"] for r in _records(f"{runs['sync']}/metrics.jsonl",
                                      "train")]
    assert la == lb and len(la) > 1
