"""Host side of the PyTorch port's LSTM / GRU recurrence kernels
(``vfr_tpu_torch/ops/kernels/rnn_plan.py``): the plan that picks the
``persistent`` or ``stepwise`` kernel variant from shapes and device
properties, and the once-per-tree weight preparation.

The kernels themselves run only on the card (``chip_smoke.py`` holds both
variants against the plain versions there; the plain versions are held
against the JAX package's Pallas kernels in ``test_torch_lstm.py`` and
``test_torch_gru.py``).  Here, on the CPU:

* the plan is a pure function: the flagship LSTM and GRU shapes on an
  H100's numbers (132 SMs, 232,448 bytes) plan ``persistent`` with a slice
  that fits; what does not fit plans ``stepwise`` with a reason; every
  persistent plan of a sweep keeps its grid within the SMs and its shared
  memory within the limit;
* on CPU tensors the wrappers take the variant arguments and run the plain
  version;
* prepared weights change no query embedding (exactly: the kernel path
  rounds its weights to bf16 itself).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vfr_tpu_torch.config import get_preset
from vfr_tpu_torch.models.build import build_model
from vfr_tpu_torch.models.mcn import (
    embed_queries_multi,
    init_model_params,
    prepare_query_params,
)
from vfr_tpu_torch.ops.kernels import gru_kernel, lstm_kernel, rnn_plan
from vfr_tpu_torch.ops.kernels.rnn_plan import (
    STAGE_BYTES,
    TILE_ROWS,
    UNITS,
    device_plan,
    plan_recurrence,
    prepare_rnn_weights,
)

H100_SMS = 132
H100_SMEM = 232_448


# ------------------------------------------------------------------ plan

@pytest.mark.parametrize("gates", [4, 3])
def test_flagship_shape_plans_persistent(gates):
    plan = plan_recurrence(256, 1024, gates, H100_SMS, H100_SMEM, E=300)
    assert plan.variant == "persistent"
    assert (plan.u, plan.batch_group, plan.grid) == (16, 128, (64, 2))
    assert plan.warpgroups == 2
    assert plan.fuse_input                      # W_ih's slice fits as well
    slice_bytes = (1024 + 320) * 16 * gates * 2
    ring = rnn_plan.STAGES * plan.warpgroups * STAGE_BYTES
    assert slice_bytes + ring < plan.smem_bytes <= H100_SMEM


@pytest.mark.parametrize("kw,why", [
    (dict(B=256, H=2048, sm_count=H100_SMS), "exceeds"),      # grid and slice
    (dict(B=64, H=2048, sm_count=H100_SMS), "shared memory"),
    (dict(B=256, H=1024, sm_count=64), "exceeds 64 SMs"),
    (dict(B=256, H=1024, sm_count=H100_SMS, weights_bf16=False), "f32"),
    (dict(B=256, H=1020, sm_count=H100_SMS), "hidden % 8"),
    (dict(B=512, H=1024, sm_count=H100_SMS), "exceeds 132 SMs"),
])
def test_what_does_not_fit_plans_stepwise(kw, why):
    kw = dict(gates=4, smem_bytes=H100_SMEM, E=300, **kw)
    plan = plan_recurrence(**kw)
    assert plan.variant == "stepwise"
    assert why in plan.reason
    assert plan.grid == (0, 0) and plan.smem_bytes == 0


def test_input_slice_is_held_only_when_it_fits():
    # a second layer's input is the first one's hs: E = H = 1024
    plan = plan_recurrence(256, 1024, 4, H100_SMS, H100_SMEM, E=1024)
    assert plan.variant == "persistent" and not plan.fuse_input
    assert plan_recurrence(256, 1024, 4, H100_SMS, H100_SMEM, E=1024,
                           fuse_input=True).variant == "stepwise"
    off = plan_recurrence(256, 1024, 4, H100_SMS, H100_SMEM, E=300,
                          fuse_input=False)
    assert off.variant == "persistent" and not off.fuse_input
    assert off.smem_bytes < plan_recurrence(256, 1024, 4, H100_SMS, H100_SMEM,
                                            E=300).smem_bytes


@pytest.mark.parametrize("gates", [3, 4])
@pytest.mark.parametrize("sms,smem", [(132, 232_448), (108, 166_912),
                                      (64, 101_376), (16, 49_152)])
@pytest.mark.parametrize("H", [8, 64, 256, 1000, 1024, 1536, 2048])
@pytest.mark.parametrize("B", [1, 63, 64, 65, 200, 256, 1000])
def test_persistent_plans_fit_the_device(B, H, sms, smem, gates):
    plan = plan_recurrence(B, H, gates, sms, smem, E=300)
    if plan.variant == "stepwise":
        assert plan.reason
        return
    gx, gy = plan.grid
    assert gx * gy <= sms
    assert plan.smem_bytes <= smem
    assert plan.u == UNITS and gx * plan.u >= H > (gx - 1) * plan.u
    assert plan.batch_group in (TILE_ROWS, 2 * TILE_ROWS)
    assert gy * plan.batch_group >= B > (gy - 1) * plan.batch_group
    depth = -(-H // 64) * 64 + (320 if plan.fuse_input else 0)
    assert (depth * 16 * gates * 2
            + rnn_plan.STAGES * plan.warpgroups * STAGE_BYTES
            + rnn_plan.ALIGN_SLACK) == plan.smem_bytes


def test_device_plan_checks_the_variant_before_the_device():
    with pytest.raises(ValueError, match="variant must be one of"):
        device_plan(torch.device("cpu"), 4, 6, 8, 4, True, variant="fast")
    plan = device_plan(torch.device("cpu"), 4, 6, 8, 4, True,
                       variant="stepwise")
    assert plan.variant == "stepwise" and plan.reason == "asked for"


# --------------------------------------------------------------- wrappers

B, T, E, H = 9, 7, 12, 16
LENGTHS = np.array([7, 3, 1, 5, 0, 3, 3, 7, 2], np.int32)


def _cell_case(cell, seed=0):
    rng = np.random.default_rng(seed)
    gates = 3 if cell == "gru" else 4
    k = 1.0 / np.sqrt(H)
    p = {"w_ih": rng.uniform(-k, k, (E, gates * H)).astype(np.float32),
         "w_hh": rng.uniform(-k, k, (H, gates * H)).astype(np.float32)}
    for name in (("b_ih", "b_hh") if cell == "gru" else ("b",)):
        p[name] = rng.uniform(-k, k, (gates * H,)).astype(np.float32)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    return p, x


def _plain(cell, p, x, lengths, pool, wdt):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    if cell == "gru":
        return gru_kernel.gru_layer(
            torch.from_numpy(x), torch.from_numpy(lengths), t["w_ih"],
            t["w_hh"], t["b_ih"], t["b_hh"], pool=pool, weights_dtype=wdt)
    return lstm_kernel.lstm_layer(
        torch.from_numpy(x), torch.from_numpy(lengths), t["w_ih"], t["w_hh"],
        t["b"], pool=pool, weights_dtype=wdt)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cpu_wrapper_takes_the_variant_arguments(cell):
    """On a CPU tensor every variant is the plain version, and nothing is
    counted as a launch."""
    p, x = _cell_case(cell)
    mod = gru_kernel if cell == "gru" else lstm_kernel
    before = (dict(mod.LAUNCHES), dict(mod.VARIANT_LAUNCHES))
    ref = _plain(cell, p, x, LENGTHS, "mean", torch.bfloat16)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    biases = [t[k] for k in (("b_ih", "b_hh") if cell == "gru" else ("b",))]
    layer = mod.gru_layer if cell == "gru" else mod.lstm_layer
    for kw in (dict(variant="persistent"), dict(variant="stepwise"),
               dict(fuse_input=False, timeline=None)):
        got = layer(torch.from_numpy(x), torch.from_numpy(LENGTHS),
                    t["w_ih"], t["w_hh"], *biases, pool="mean", **kw)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (dict(mod.LAUNCHES), dict(mod.VARIANT_LAUNCHES)) == before
    assert sorted(mod.VARIANT_LAUNCHES) == ["persistent", "stepwise"]


# ------------------------------------------------------ prepared weights

def test_prepare_rnn_weights_casts_only_the_products_operands():
    p, _ = _cell_case("gru")
    tree = {"layer0": {k: torch.from_numpy(v) for k, v in p.items()}}
    out = prepare_rnn_weights(tree, torch.bfloat16)
    assert out["layer0"]["w_ih"].dtype == torch.bfloat16
    assert out["layer0"]["w_hh"].dtype == torch.bfloat16
    assert out["layer0"]["w_hh"].is_contiguous()
    assert out["layer0"]["b_ih"] is tree["layer0"]["b_ih"]
    assert out["layer0"]["b_hh"] is tree["layer0"]["b_hh"]
    assert tree["layer0"]["w_ih"].dtype == torch.float32   # input untouched
    # the cast round-trips: preparing a prepared tree changes nothing
    again = prepare_rnn_weights(out, torch.bfloat16)
    assert again["layer0"]["w_hh"] is out["layer0"]["w_hh"]
    assert torch.equal(out["layer0"]["w_hh"].float().to(torch.bfloat16),
                       out["layer0"]["w_hh"])


def _model(rnn_cell, query_pool, use_pallas):
    cfg = get_preset("didemo_flagship")
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, feature_dim=24, glove_dim=E),
        model=dataclasses.replace(cfg.model, lstm_hidden=H, joint_dim=8,
                                  rnn_cell=rnn_cell, query_pool=query_pool,
                                  use_pallas=use_pallas))
    model = build_model(cfg)
    glove = np.random.default_rng(5).standard_normal((50, E)).astype(
        np.float32)
    params = init_model_params(torch.Generator().manual_seed(1), model, glove,
                               cfg.data.feature_dim)
    return model, params


@pytest.mark.parametrize("rnn_cell", ["lstm", "gru"])
@pytest.mark.parametrize("query_pool", ["mean", "last"])
def test_prepared_params_give_the_same_query_embeddings(rnn_cell,
                                                        query_pool):
    model, params = _model(rnn_cell, query_pool, "always")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, 50, (B, T)).astype(np.int32))
    lens = torch.from_numpy(np.maximum(LENGTHS, 1))
    prepared = prepare_query_params(params, model)
    assert prepared is not params
    assert prepared["lstm"]["layer0"]["w_hh"].dtype == torch.bfloat16
    assert params["lstm"]["layer0"]["w_hh"].dtype == torch.float32
    assert prepared["embeddings"] is params["embeddings"]
    ref = embed_queries_multi(params, model, toks, lens, inference=True)
    got = embed_queries_multi(prepared, model, toks, lens, inference=True)
    assert torch.equal(got, ref)
    plain = embed_queries_multi(prepared, model, toks, lens, inference=True,
                                rnn_kernel="plain")
    assert torch.equal(plain, ref)


@pytest.mark.parametrize("use_pallas,rnn_kernel,prepared", [
    ("auto", None, False),        # CPU params: the f32 scan twin runs
    ("never", None, False),
    ("never", "pallas", False),
    ("auto", "scan", False),
    ("auto", "plain", True),
    ("always", None, True),
])
def test_params_are_prepared_only_for_the_kernel_path(use_pallas, rnn_kernel,
                                                      prepared):
    model, params = _model("lstm", "mean", use_pallas)
    out = prepare_query_params(params, model, rnn_kernel)
    assert (out is not params) == prepared
    if not prepared:
        assert out["lstm"]["layer0"]["w_hh"].dtype == torch.float32
