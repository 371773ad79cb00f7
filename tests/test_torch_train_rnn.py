"""The port's fused LSTM / GRU layers (``torch.autograd.Function`` with the
hand-written BPTT) against the JAX package's custom-VJP layers, on the
same numpy weights and inputs (E=12, H=16, T=9, ragged lengths including
1 and T).

* forward (h_last, hs): rtol 1e-5 (atol 1e-6);
* gradients of every weight and of the input through both outputs: rtol
  2e-4 / atol 2e-5, the JAX package's own tolerance against torch
  autograd;
* the port's fused layers against autograd through its own step twins
  (``train_rnn_impl="scan"``), the check ``chip_smoke.py`` repeats on the
  card at flagship width;
* padded steps receive no input gradient; ``lengths`` gets none at all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.ops import lstm as jlstm
from vfr_tpu_torch.bridge import params_from_numpy
from vfr_tpu_torch.ops import lstm as tlstm

B, T, E, H = 4, 9, 12, 16
LENGTHS = np.array([T, 5, 1, 7], np.int32)

CELLS = {
    "lstm": (jlstm.init_lstm_params, jlstm.lstm_forward_fused,
             tlstm.lstm_forward_fused, tlstm.lstm_forward),
    "gru": (jlstm.init_gru_params, jlstm.gru_forward_fused,
            tlstm.gru_forward_fused, tlstm.gru_forward),
}


def _setup(cell, layers, seed):
    init = CELLS[cell][0]
    tree = jax.tree.map(np.asarray,
                        init(jax.random.PRNGKey(seed), E, H, layers))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    w_h = rng.standard_normal((B, H)).astype(np.float32)
    w_hs = rng.standard_normal((B, T, H)).astype(np.float32)
    return tree, x, w_h, w_hs


def _torch_grads(fn, tree, x, w_h, w_hs):
    params = params_from_numpy(tree)
    leaves = [v.requires_grad_(True) for d in params.values()
              for v in d.values()]
    xt = torch.from_numpy(x).requires_grad_(True)
    h, hs = fn(params, xt, torch.from_numpy(LENGTHS))
    loss = (h * torch.from_numpy(w_h)).sum() + (
        hs * torch.from_numpy(w_hs)).sum()
    loss.backward()
    return (h.detach().numpy(), hs.detach().numpy(), xt.grad.numpy(),
            {k: {n: v.grad.numpy() for n, v in d.items()}
             for k, d in params.items()}, leaves)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("layers", [1, 2])
def test_fused_forward_and_grads_match_jax_vjp(cell, layers):
    _, jfn, tfn, _ = CELLS[cell]
    tree, x, w_h, w_hs = _setup(cell, layers, seed=3 + layers)
    lens = jnp.asarray(LENGTHS)

    def loss(p, x):
        h, hs = jfn(p, x, lens)
        return jnp.sum(h * w_h) + jnp.sum(hs * w_hs), (h, hs)

    (_, (jh, jhs)), (jg, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    h, hs, gx, g, _ = _torch_grads(tfn, tree, x, w_h, w_hs)
    np.testing.assert_allclose(h, np.asarray(jh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hs, np.asarray(jhs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gx, np.asarray(jgx), rtol=2e-4, atol=2e-5)
    for layer, d in g.items():
        for name, v in d.items():
            np.testing.assert_allclose(
                v, np.asarray(jg[layer][name]), rtol=2e-4, atol=2e-5,
                err_msg=f"{cell} {layer}/{name}")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fused_grads_match_autograd_through_scan_twin(cell):
    _, _, tfn, scan = CELLS[cell]
    tree, x, w_h, w_hs = _setup(cell, 2, seed=11)
    h1, hs1, gx1, g1, _ = _torch_grads(tfn, tree, x, w_h, w_hs)
    h2, hs2, gx2, g2, _ = _torch_grads(scan, tree, x, w_h, w_hs)
    np.testing.assert_allclose(hs1, hs2, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gx1, gx2, rtol=2e-4, atol=2e-5)
    for layer, d in g1.items():
        for name, v in d.items():
            np.testing.assert_allclose(v, g2[layer][name], rtol=2e-4,
                                       atol=2e-5)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("which", ["h_last", "hs"])
def test_padded_steps_get_no_input_gradient(cell, which):
    """Through either output alone (the other's gradient is None)."""
    _, _, tfn, _ = CELLS[cell]
    tree, x, _, _ = _setup(cell, 1, seed=7)
    xt = torch.from_numpy(x).requires_grad_(True)
    lens = torch.from_numpy(LENGTHS)
    h, hs = tfn(params_from_numpy(tree), xt, lens)
    out = h if which == "h_last" else hs
    (out ** 2).sum().backward()
    g = xt.grad.numpy()
    for b in range(B):
        np.testing.assert_array_equal(g[b, LENGTHS[b]:], 0.0)
        assert np.abs(g[b, :LENGTHS[b]]).max() > 0
