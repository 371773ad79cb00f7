"""The PyTorch port's query LSTM against the JAX package's.

* ``ops.lstm.lstm_forward`` / ``masked_mean_pool`` vs the JAX scan twin
  (f32, atol 1e-5: the same f32 arithmetic, summed in another order).
* The CUDA kernel's plain version (what ``lstm_layer`` runs on CPU
  tensors) vs ``pallas_lstm(..., interpret=True)``: atol 1e-5 with f32
  weights, 1e-4 with bf16 weights (bf16-rounded operands, f32 sums; a
  different summation order can flip one bf16 rounding of h downstream).
  The kernel itself runs only on the card; chip_smoke.py holds it against
  this plain version there.

Inputs are numpy arrays from a seed, handed to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.ops.lstm import lstm_forward as jax_lstm_forward
from vfr_tpu.ops.lstm import masked_mean_pool as jax_masked_mean_pool
from vfr_tpu.ops.pallas.lstm_kernel import pallas_lstm
from vfr_tpu_torch.ops.kernels import lstm_kernel
from vfr_tpu_torch.ops.kernels.lstm_kernel import (
    cuda_lstm,
    lstm_layer,
    lstm_recurrence_plain,
)
from vfr_tpu_torch.ops.lstm import (
    init_lstm_params,
    lstm_forward,
    masked_mean_pool,
)

B, T, E, H = 5, 7, 12, 16
LENGTHS = np.array([7, 3, 1, 5, 0], np.int32)   # full, len 1 and len 0


def _np_params(layers, seed=0):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    out = {}
    for layer in range(layers):
        in_dim = E if layer == 0 else H
        out[f"layer{layer}"] = {
            "w_ih": rng.uniform(-k, k, (in_dim, 4 * H)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (H, 4 * H)).astype(np.float32),
            "b": rng.uniform(-k, k, (4 * H,)).astype(np.float32),
        }
    return out


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, E)).astype(
        np.float32)


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_forward_matches_jax(layers):
    p, x = _np_params(layers), _x()
    lengths = np.maximum(LENGTHS, 1)
    ref_last, ref_hs = jax_lstm_forward(_jax(p), jnp.asarray(x),
                                        jnp.asarray(lengths))
    got_last, got_hs = lstm_forward(_torch(p), torch.from_numpy(x),
                                    torch.from_numpy(lengths))
    np.testing.assert_allclose(got_last.numpy(), np.asarray(ref_last),
                               atol=1e-5)
    np.testing.assert_allclose(got_hs.numpy(), np.asarray(ref_hs), atol=1e-5)
    np.testing.assert_allclose(
        masked_mean_pool(got_hs, torch.from_numpy(lengths)).numpy(),
        np.asarray(jax_masked_mean_pool(ref_hs, jnp.asarray(lengths))),
        atol=1e-5)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("pool", ["none", "mean"])
@pytest.mark.parametrize("wdt", ["float32", "bfloat16"])
def test_kernel_plain_matches_pallas_interpret(layers, pool, wdt):
    p, x = _np_params(layers), _x()
    tol = 1e-5 if wdt == "float32" else 1e-4
    ref_last, ref_second = pallas_lstm(
        _jax(p), jnp.asarray(x), jnp.asarray(LENGTHS), interpret=True,
        weights_dtype=jnp.dtype(wdt), pool=pool)
    got_last, got_second = cuda_lstm(
        _torch(p), torch.from_numpy(x), torch.from_numpy(LENGTHS),
        weights_dtype=getattr(torch, wdt), pool=pool)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(ref_last),
                               atol=tol)
    np.testing.assert_allclose(got_second.numpy(), np.asarray(ref_second),
                               atol=tol)
    # a length-0 row keeps the zero state and pools to zero
    assert float(got_last[4].abs().max()) == 0.0


def test_plain_pool_excludes_frozen_carry():
    p, x = _np_params(1), _x()
    lengths = torch.from_numpy(LENGTHS)
    args = (torch.from_numpy(x), lengths, p["layer0"]["w_ih"],
            p["layer0"]["w_hh"], p["layer0"]["b"])
    args = args[:2] + tuple(torch.from_numpy(a) for a in args[2:])
    _, hs = lstm_recurrence_plain(*args, pool="none")
    _, pooled = lstm_recurrence_plain(*args, pool="mean")
    np.testing.assert_allclose(pooled.numpy(),
                               masked_mean_pool(hs, lengths).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(pooled[2].numpy(), hs[2, 0].numpy(),
                               atol=1e-6)


def test_cpu_wrapper_is_plain_and_counts_nothing():
    p, x = _torch(_np_params(1)), torch.from_numpy(_x())
    lengths = torch.from_numpy(LENGTHS)
    before = dict(lstm_kernel.LAUNCHES)
    lp = p["layer0"]
    got = lstm_layer(x, lengths, lp["w_ih"], lp["w_hh"], lp["b"], pool="mean")
    ref = lstm_recurrence_plain(x, lengths, lp["w_ih"], lp["w_hh"], lp["b"],
                                pool="mean")
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert lstm_kernel.LAUNCHES == before


def test_wrapper_rejects_other_devices_and_pools():
    lp = {k: torch.empty(s, device="meta") for k, s in
          (("w_ih", (E, 4 * H)), ("w_hh", (H, 4 * H)), ("b", (4 * H,)))}
    x = torch.empty(B, T, E, device="meta")
    lengths = torch.empty(B, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_layer(x, lengths, lp["w_ih"], lp["w_hh"], lp["b"])
    with pytest.raises(ValueError, match="unknown pool"):
        lstm_layer(x, lengths, lp["w_ih"], lp["w_hh"], lp["b"], pool="max")


def test_init_lstm_params_seeded():
    a = init_lstm_params(torch.Generator().manual_seed(3), E, H, 2)
    b = init_lstm_params(torch.Generator().manual_seed(3), E, H, 2)
    assert a["layer1"]["w_ih"].shape == (H, 4 * H)
    for layer in a:
        for k in a[layer]:
            assert torch.equal(a[layer][k], b[layer][k])
    k = 1.0 / np.sqrt(H)
    fb = a["layer0"]["b"][H : 2 * H]
    assert float(fb.min()) >= 1.0 - k and float(fb.max()) <= 1.0 + k
