"""The PyTorch port's query GRU against the JAX package's.

* ``ops.lstm.gru_forward`` vs the JAX scan twin (f32, atol 1e-5: the same
  f32 arithmetic, summed in another order).
* The CUDA kernel's plain version (what ``gru_layer`` runs on CPU tensors)
  vs ``pallas_gru(..., interpret=True)``: atol 1e-5 with f32 weights, 1e-4
  with bf16 weights (bf16-rounded operands, f32 sums; a different summation
  order can flip one bf16 rounding of h downstream).  The kernel itself
  runs only on the card; chip_smoke.py holds it against this plain version
  there.
* A GRU model end to end: ``embed_queries_multi`` for the last, mean and
  attn pools (scan twins atol 1e-5, kernels atol 1e-4) and
  ``serve_queries`` (same moments, distances atol 1e-4).

Inputs are numpy arrays from a seed, handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.config import DataConfig as JDataConfig
from vfr_tpu.config import ExperimentConfig as JExperimentConfig
from vfr_tpu.config import ModelConfig as JModelConfig
from vfr_tpu.data.didemo import DidemoDataset as JDidemoDataset
from vfr_tpu.data.synthetic import make_didemo_fixture
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu.models.build import build_model as j_build_model
from vfr_tpu.models.mcn import embed_queries_multi as j_embed_queries_multi
from vfr_tpu.models.mcn import init_model_params as j_init_model_params
from vfr_tpu.ops.lstm import gru_forward as jax_gru_forward
from vfr_tpu.ops.pallas.gru_kernel import pallas_gru
from vfr_tpu_torch.bridge import params_from_numpy
from vfr_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
from vfr_tpu_torch.data.didemo import DidemoDataset
from vfr_tpu_torch.eval.corpus import serve_queries
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.models.mcn import embed_queries_multi
from vfr_tpu_torch.ops.kernels import gru_kernel
from vfr_tpu_torch.ops.kernels.gru_kernel import (
    cuda_gru,
    gru_layer,
    gru_recurrence_plain,
)
from vfr_tpu_torch.ops.lstm import gru_forward, init_gru_params

B, T, E, H = 5, 7, 12, 16
LENGTHS = np.array([7, 3, 1, 5, 0], np.int32)   # full, len 1 and len 0
F, J = 24, 8


def _np_params(layers, seed=0):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    out = {}
    for layer in range(layers):
        in_dim = E if layer == 0 else H
        out[f"layer{layer}"] = {
            "w_ih": rng.uniform(-k, k, (in_dim, 3 * H)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (H, 3 * H)).astype(np.float32),
            "b_ih": rng.uniform(-k, k, (3 * H,)).astype(np.float32),
            "b_hh": rng.uniform(-k, k, (3 * H,)).astype(np.float32),
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
def test_gru_forward_matches_jax(layers):
    p, x = _np_params(layers), _x()
    lengths = np.maximum(LENGTHS, 1)
    ref_last, ref_hs = jax_gru_forward(_jax(p), jnp.asarray(x),
                                       jnp.asarray(lengths))
    got_last, got_hs = gru_forward(_torch(p), torch.from_numpy(x),
                                   torch.from_numpy(lengths))
    np.testing.assert_allclose(got_last.numpy(), np.asarray(ref_last),
                               atol=1e-5)
    np.testing.assert_allclose(got_hs.numpy(), np.asarray(ref_hs), atol=1e-5)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("pool", ["none", "mean"])
@pytest.mark.parametrize("wdt", ["float32", "bfloat16"])
def test_kernel_plain_matches_pallas_interpret(layers, pool, wdt):
    p, x = _np_params(layers), _x()
    tol = 1e-5 if wdt == "float32" else 1e-4
    ref_last, ref_second = pallas_gru(
        _jax(p), jnp.asarray(x), jnp.asarray(LENGTHS), interpret=True,
        weights_dtype=jnp.dtype(wdt), pool=pool)
    got_last, got_second = cuda_gru(
        _torch(p), torch.from_numpy(x), torch.from_numpy(LENGTHS),
        weights_dtype=getattr(torch, wdt), pool=pool)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(ref_last),
                               atol=tol)
    np.testing.assert_allclose(got_second.numpy(), np.asarray(ref_second),
                               atol=tol)
    # a length-0 row keeps the zero state and pools to zero
    assert float(got_last[4].abs().max()) == 0.0


def test_b_hn_stays_inside_the_reset_gate():
    """Moving b_hn into b_ih changes the result: n = tanh(gi_n + r * (h
    W_hn + b_hn)) keeps the hidden-side bias under r."""
    p, x = _torch(_np_params(1)), torch.from_numpy(_x())
    lp = p["layer0"]
    lengths = torch.from_numpy(np.maximum(LENGTHS, 1))
    args = (x, lengths, lp["w_ih"], lp["w_hh"])
    h, _ = gru_recurrence_plain(*args, lp["b_ih"], lp["b_hh"],
                                weights_dtype=torch.float32)
    moved_ih, moved_hh = lp["b_ih"].clone(), lp["b_hh"].clone()
    moved_ih[2 * H:] += moved_hh[2 * H:]
    moved_hh[2 * H:] = 0
    h_moved, _ = gru_recurrence_plain(*args, moved_ih, moved_hh,
                                      weights_dtype=torch.float32)
    assert float((h - h_moved).abs().max()) > 1e-3
    ref, _ = jax_gru_forward(_jax(_np_params(1)), jnp.asarray(_x()),
                             jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref), atol=1e-5)


def test_cpu_wrapper_is_plain_and_counts_nothing():
    p, x = _torch(_np_params(1)), torch.from_numpy(_x())
    lengths = torch.from_numpy(LENGTHS)
    before = dict(gru_kernel.LAUNCHES)
    lp = p["layer0"]
    args = (x, lengths, lp["w_ih"], lp["w_hh"], lp["b_ih"], lp["b_hh"])
    got = gru_layer(*args, pool="mean")
    ref = gru_recurrence_plain(*args, pool="mean")
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert gru_kernel.LAUNCHES == before


def test_wrapper_rejects_other_devices_and_pools():
    lp = {k: torch.empty(s, device="meta") for k, s in
          (("w_ih", (E, 3 * H)), ("w_hh", (H, 3 * H)), ("b_ih", (3 * H,)),
           ("b_hh", (3 * H,)))}
    x = torch.empty(B, T, E, device="meta")
    lengths = torch.empty(B, dtype=torch.int32, device="meta")
    args = (x, lengths, lp["w_ih"], lp["w_hh"], lp["b_ih"], lp["b_hh"])
    with pytest.raises(ValueError, match="unsupported device"):
        gru_layer(*args)
    with pytest.raises(ValueError, match="unknown pool"):
        gru_layer(*args, pool="max")


def test_init_gru_params_seeded():
    a = init_gru_params(torch.Generator().manual_seed(3), E, H, 2)
    b = init_gru_params(torch.Generator().manual_seed(3), E, H, 2)
    assert a["layer0"]["w_ih"].shape == (E, 3 * H)
    assert a["layer1"]["w_ih"].shape == (H, 3 * H)
    for layer in a:
        assert sorted(a[layer]) == ["b_hh", "b_ih", "w_hh", "w_ih"]
        for k in a[layer]:
            assert torch.equal(a[layer][k], b[layer][k])
            assert float(a[layer][k].abs().max()) <= 1.0 / np.sqrt(H)


def _world(query_pool="mean", use_pallas="auto", seed=0):
    fix = make_didemo_fixture(num_videos=12, num_queries=48, feature_dim=F,
                              glove_dim=E, seed=7)
    kw = dict(joint_dim=J, lstm_hidden=H, stream_weights=(0.5, 0.5),
              distance="cosine", query_pool=query_pool, rnn_cell="gru",
              use_pallas=use_pallas)
    data = dict(feature_dim=F, glove_dim=E, use_flow=True)
    jcfg = JExperimentConfig(name="t", data=JDataConfig(**data),
                             model=JModelConfig(**kw))
    tcfg = ExperimentConfig(name="t", data=DataConfig(**data),
                            model=ModelConfig(**kw))
    jds = JDidemoDataset(fix.annotations, fix.rgb, fix.flow, fix.vocab,
                         jcfg.data)
    tds = DidemoDataset(fix.annotations, fix.rgb, fix.flow, fix.vocab,
                        tcfg.data)
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(j_init_model_params(
        jax.random.PRNGKey(seed), jmodel, fix.glove, F)))
    if "query_attn" in tree:       # zeros at init: make the pool non-trivial
        tree["query_attn"] = np.random.default_rng(seed + 1).standard_normal(
            H).astype(np.float32)
    return jmodel, tmodel, jds, tds, fix.vocab, tree


@pytest.mark.parametrize("pool", ["last", "mean", "attn"])
@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_gru_query_tower_matches_jax(pool, use_pallas):
    jmodel, tmodel, _, _, _, tree = _world(pool, use_pallas)
    rng = np.random.default_rng(0)
    lens = rng.integers(1, 10, 6).astype(np.int32)
    lens[0] = 1
    toks = rng.integers(1, 40, (6, 9)).astype(np.int32)
    toks[np.arange(9)[None, :] >= lens[:, None]] = 0
    ref = j_embed_queries_multi(jax.tree.map(jnp.asarray, tree), jmodel,
                                jnp.asarray(toks), jnp.asarray(lens),
                                inference=True)
    got = embed_queries_multi(params_from_numpy(tree), tmodel,
                              torch.from_numpy(toks), torch.from_numpy(lens),
                              inference=True)
    assert got.shape == (2, 6, J)
    tol = 1e-5 if use_pallas == "never" else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol)


@pytest.mark.parametrize("pool,use_pallas", [
    ("mean", "always"), ("last", "always"), ("mean", "auto")])
def test_gru_serve_matches_jax(pool, use_pallas):
    jmodel, tmodel, jds, tds, vocab, tree = _world(pool, use_pallas)
    rng = np.random.default_rng(3)
    qs = [" ".join(f"w{int(rng.integers(0, 200)):04d}"
                   for _ in range(1 + int(rng.integers(0, 12))))
          for _ in range(19)]
    kw = dict(k=5, batch_size=8, max_query_len=12)
    ref = jcorpus.serve_queries(jax.tree.map(jnp.asarray, tree), jmodel, jds,
                                vocab, qs, **kw)
    got = serve_queries(params_from_numpy(tree), tmodel, tds, vocab, qs, **kw)
    assert [[(r["video"], r["start"], r["end"]) for r in q["results"]]
            for q in got] == \
        [[(r["video"], r["start"], r["end"]) for r in q["results"]]
         for q in ref]
    np.testing.assert_allclose(
        [[r["distance"] for r in q["results"]] for q in got],
        [[r["distance"] for r in q["results"]] for q in ref], atol=1e-4)
