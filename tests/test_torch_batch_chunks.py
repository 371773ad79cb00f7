"""Batch chunks of the PyTorch port's LSTM / GRU recurrence wrappers
(``vfr_tpu_torch/ops/kernels/rnn_plan.py``): the counterpart of the JAX
package's ``batch_chunk`` / ``_run_batch_chunks``
(``vfr_tpu/ops/pallas/lstm_kernel.py``), used by ``pallas_lstm`` and
``pallas_gru`` for a batch too large for the kernel.

On the card a batch runs in chunks when one ``persistent`` grid cannot
hold it (``chip_smoke.py`` checks the launches, the variants and the first
chunk's rows bit for bit there).  Here, on the CPU:

* ``batch_chunk`` is the JAX package's rule, for any ``fits`` (hypothesis
  over B in 1..1,100), and gives the flagship plan's chunks on an H100's
  numbers (132 SMs, 232,448 bytes of shared memory, H=1024): 256 at
  B=512, 152 at B=300, 136 at B=257, 256 at B=1,024; ``device_chunk``
  reads a device's properties into the same rule;
* ``cuda_lstm`` / ``cuda_gru`` with a forced chunk (``device_chunk``
  monkeypatched, as the JAX tests patch the VMEM fit: 8 at B=20 gives two
  chunks and a tail of 4) equal the unchunked chain bit for bit, with bf16
  and f32 weights; a CPU device plans no chunk and the plain layer
  function is never chunked; the wrapper's in-place results are refused
  on CPU tensors;
* the same chunked chain matches ``pallas_lstm`` / ``pallas_gru`` in
  interpret mode with the JAX package's VMEM fit monkeypatched so that it
  chunks too (rtol 1e-5, f32 weights);
* ``Workspace`` hands out views of one buffer per name; ``run_batch_chunks``
  writes each chunk into its rows of one output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vfr_tpu.ops.pallas import gru_kernel as jax_gru_kernel
from vfr_tpu.ops.pallas import lstm_kernel as jax_lstm_kernel
from vfr_tpu.ops.pallas.lstm_kernel import batch_chunk as jax_batch_chunk
from vfr_tpu_torch.ops.kernels import gru_kernel, lstm_kernel, rnn_plan
from vfr_tpu_torch.ops.kernels.rnn_plan import (
    PERSISTENT,
    Workspace,
    batch_chunk,
    device_chunk,
    plan_recurrence,
)

H100_SMS = 132
H100_SMEM = 232_448
B, T, E, H = 20, 6, 12, 16
LENGTHS = np.array([6, 3, 1, 5, 0, 2, 6, 4, 1, 3,
                    5, 6, 0, 2, 4, 6, 1, 3, 5, 2], np.int32)

CELLS = {
    "lstm": (lstm_kernel.cuda_lstm, lstm_kernel.lstm_recurrence_plain,
             jax_lstm_kernel, "pallas_lstm", "pallas_lstm_fits_vmem", 4,
             ("b",)),
    "gru": (gru_kernel.cuda_gru, gru_kernel.gru_recurrence_plain,
            jax_gru_kernel, "pallas_gru", "pallas_gru_fits_vmem", 3,
            ("b_ih", "b_hh")),
}


# ---------------------------------------------------------------- the rule

def _fits_family(kind, a, b):
    """Predicates over a batch size: monotone caps, a multiple rule (not
    monotone) and a band."""
    if kind == "cap":
        return lambda n: n <= a
    if kind == "multiple":
        return lambda n: n % max(b % 16, 1) == 0 and n <= a
    return lambda n: a // 2 <= n <= a


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 1100), kind=st.sampled_from(["cap", "multiple",
                                                     "band"]),
       a=st.integers(0, 1200), b=st.integers(0, 64))
def test_batch_chunk_is_the_jax_rule(n, kind, a, b):
    fits = _fits_family(kind, a, b)
    assert batch_chunk(n, fits) == jax_batch_chunk(n, fits)


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("n,want", [(512, 256), (300, 152), (257, 136),
                                    (1024, 256), (256, 256), (100, 100)])
def test_flagship_plan_chunks(gates, n, want):
    def fits(b):
        return plan_recurrence(b, 1024, gates, H100_SMS, H100_SMEM,
                               E=300).variant in PERSISTENT
    assert batch_chunk(n, fits) == want
    assert fits(want)


def test_device_chunk_reads_the_device(monkeypatch):
    class Props:
        multi_processor_count = H100_SMS
        shared_memory_per_block_optin = H100_SMEM

    seen = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: seen.append(dev) or Props())
    dev = torch.device("cuda", 1)
    assert device_chunk(dev, 512, [(300, 1024)], 4, True) == 256
    assert device_chunk(dev, 300, [(300, 1024), (1024, 1024)], 4,
                        True) == 152
    # "persistent" chunks too, where only the grid was too large
    assert device_chunk(dev, 512, [(300, 1024)], 3, True,
                        "persistent") == 256
    assert seen == [dev, dev, dev]
    # f32 weights, stepwise and a hidden size off the bf16 kernel's rule:
    # no persistent chunk, the chain runs unchunked
    assert device_chunk(dev, 512, [(300, 1024)], 4, False) is None
    assert device_chunk(dev, 512, [(300, 1020)], 4, True) is None
    assert device_chunk(dev, 512, [(300, 1024)], 4, True,
                        "stepwise") is None
    with pytest.raises(ValueError, match="variant"):
        device_chunk(dev, 512, [(300, 1024)], 4, True, "fast")


# ------------------------------------------------------------- the chains

def _np_params(cell, layers, seed=0):
    gates, bias_keys = CELLS[cell][5], CELLS[cell][6]
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    out = {}
    for layer in range(layers):
        p = {"w_ih": rng.uniform(-k, k, (E if layer == 0 else H,
                                         gates * H)),
             "w_hh": rng.uniform(-k, k, (H, gates * H))}
        for key in bias_keys:
            p[key] = rng.uniform(-k, k, (gates * H,))
        out[f"layer{layer}"] = {n: v.astype(np.float32) for n, v in
                                p.items()}
    return out


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, E)).astype(
        np.float32)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _force_chunk(monkeypatch, chunk):
    """Make ``rnn_plan.device_chunk`` plan ``chunk`` on any device, as the
    JAX tests patch the VMEM fit; returns the list of its calls."""
    calls = []
    monkeypatch.setattr(rnn_plan, "device_chunk",
                        lambda *a, **k: calls.append(a) or chunk)
    return calls


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("pool", ["none", "mean"])
@pytest.mark.parametrize("weights", ["bf16", "f32"])
@pytest.mark.parametrize("chunk", [8, 16, 20, 64])
def test_forced_chunks_equal_unchunked(cell, layers, pool, weights, chunk,
                                       monkeypatch):
    chain = CELLS[cell][0]
    p, x, lengths = (_torch(_np_params(cell, layers)),
                     torch.from_numpy(_x()), torch.from_numpy(LENGTHS))
    wd = torch.bfloat16 if weights == "bf16" else torch.float32
    ref = chain(p, x, lengths, pool=pool, weights_dtype=wd)
    calls = _force_chunk(monkeypatch, chunk)
    got = chain(p, x, lengths, pool=pool, weights_dtype=wd)
    assert len(calls) == 1 and calls[0][1] == B
    want_shape = (B, H) if pool == "mean" else (B, T, H)
    assert tuple(got[1].shape) == want_shape
    assert tuple(got[0].shape) == (B, H)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cpu_and_plain_layer_run_whole(cell, monkeypatch):
    """A CPU device plans no chunk, and the plain layer function is never
    chunked, whatever the plan would say."""
    chain, plain = CELLS[cell][:2]
    gates = CELLS[cell][5]
    assert device_chunk(torch.device("cpu"), 512, [(300, 1024)], gates,
                        True) is None
    p, x, lengths = (_torch(_np_params(cell, 2)), torch.from_numpy(_x()),
                     torch.from_numpy(LENGTHS))
    ref = chain(p, x, lengths, layer_fn=plain)
    calls = _force_chunk(monkeypatch, 8)
    got = chain(p, x, lengths, layer_fn=plain)
    assert calls == []
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cpu_layer_refuses_in_place_results(cell):
    layer = lstm_kernel.lstm_layer if cell == "lstm" else gru_kernel.gru_layer
    p = _torch(_np_params(cell, 1))["layer0"]
    x, lengths = torch.from_numpy(_x()), torch.from_numpy(LENGTHS)
    args = (p["w_ih"], p["w_hh"], *(p[k] for k in CELLS[cell][6]))
    with pytest.raises(ValueError, match="CUDA"):
        layer(x, lengths, *args, out=torch.empty(B, T, H))
    with pytest.raises(ValueError, match="CUDA"):
        layer(x, lengths, *args, h_last_out=torch.empty(B, H))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("pool", ["none", "mean"])
def test_chunked_chain_matches_pallas_chunks(cell, layers, pool,
                                             monkeypatch):
    """Both sides in chunks of 8 (the JAX package's tail zero-padded, the
    port's run at its own size of 4)."""
    chain, _, jax_mod, fn_name, fits_name = CELLS[cell][:5]
    calls = []
    monkeypatch.setattr(jax_mod, fits_name,
                        lambda b, *a, **k: calls.append(b) or b <= 8)
    p, x = _np_params(cell, layers), _x()
    ref_last, ref_second = getattr(jax_mod, fn_name)(
        _jax(p), jnp.asarray(x), jnp.asarray(LENGTHS), interpret=True,
        weights_dtype=jnp.float32, pool=pool)
    assert 8 in calls and B in calls        # the reference chunked
    _force_chunk(monkeypatch, 8)
    got_last, got_second = chain(
        _torch(p), torch.from_numpy(x), torch.from_numpy(LENGTHS),
        weights_dtype=torch.float32, pool=pool)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(ref_last),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_second.numpy(), np.asarray(ref_second),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- workspace

def test_workspace_reuses_one_buffer_per_name():
    ws = Workspace(torch.device("cpu"))
    a = ws.take("xb", (4, 6), torch.bfloat16)
    b = ws.take("xb", (2, 6), torch.bfloat16)      # a smaller chunk
    assert b.data_ptr() == a.data_ptr() and tuple(b.shape) == (2, 6)
    assert b.is_contiguous()
    c = ws.take("hb", (2, 3, 5), torch.bfloat16)   # [2, b, H] halves
    assert c.data_ptr() != a.data_ptr() and c.is_contiguous()
    d = ws.take("xb", (8, 6), torch.bfloat16)      # grown
    assert d.numel() == 48
    e = ws.take("xb", (8, 6), torch.float32)       # another dtype
    assert e.dtype == torch.float32


def test_run_batch_chunks_writes_rows_in_place():
    x = torch.arange(10, dtype=torch.float32).view(10, 1, 1).expand(
        10, 3, 1).contiguous()
    lengths = torch.ones(10, dtype=torch.int32)
    spans = []

    def run(xc, lc, h, o):
        spans.append(xc.shape[0])
        h.copy_(xc[:, 0].expand(-1, 2))
        o.copy_(xc[:, :, :1].expand(-1, -1, 2))
    h, o = rnn_plan.run_batch_chunks(run, x, lengths, 4, (10, 3, 2))
    assert spans == [4, 4, 2]
    assert torch.equal(h[:, 0], torch.arange(10, dtype=torch.float32))
    assert torch.equal(o[:, 2, 1], torch.arange(10, dtype=torch.float32))
