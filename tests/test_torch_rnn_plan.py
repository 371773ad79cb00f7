"""Host side of the PyTorch port's LSTM / GRU recurrence kernels
(``vfr_tpu_torch/ops/kernels/rnn_plan.py``): the plan that picks the
``persistent`` or ``stepwise`` kernel variant from shapes and device
properties, and the once-per-tree weight preparation.

The kernels themselves run only on the card (``chip_smoke.py`` holds every
variant against the plain versions there; the plain versions are held
against the JAX package's Pallas kernels in ``test_torch_lstm.py`` and
``test_torch_gru.py``).  Here, on the CPU:

* the plan is a pure function: the flagship LSTM shape on an H100's
  numbers (132 SMs, 232,448 bytes) plans ``persistent_bulk`` and the GRU's
  ``persistent``, with slices that fit; a daemon's packs, the GRU and
  shapes the bulk layout cannot hold keep ``persistent``; what does not
  fit plans
  ``stepwise`` with a reason; every persistent plan of a sweep keeps its
  grid within the SMs and its shared memory within the limit;
* models of the bulk variant's layouts: the chunk-major index map is a
  bijection onto its buffer with the 128-byte swizzle wgmma reads, and the
  W slice's gate rows put a cell's four gates in a pair of lanes;
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
    BULK_ROWS,
    CHUNK,
    PACK_ROWS,
    STAGE_BYTES,
    TILE_ROWS,
    UNITS,
    bulk_smem,
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
    # the LSTM takes the bulk variant, the GRU (48 gate rows) cannot
    assert plan.variant == ("persistent_bulk" if gates == 4
                            else "persistent")
    assert (plan.u, plan.batch_group, plan.grid) == (16, 128, (64, 2))
    assert plan.fuse_input                      # W_ih's slice fits as well
    slice_bytes = (1024 + 320) * 16 * gates * 2
    if gates == 4:
        ring = rnn_plan.BULK_STAGES * rnn_plan.BULK_STAGE_BYTES
        tile = rnn_plan.BULK_TILE_BYTES
        assert plan.smem_bytes == bulk_smem(300, 1024) == 230_448
    else:
        assert plan.warpgroups == 2
        ring = rnn_plan.STAGES * plan.warpgroups * STAGE_BYTES
        tile = 0
    assert slice_bytes + ring + tile < plan.smem_bytes <= H100_SMEM


@pytest.mark.parametrize("kw,variant", [
    (dict(B=1), "persistent"),                    # a daemon's packs
    (dict(B=PACK_ROWS), "persistent"),
    (dict(B=PACK_ROWS + 1), "persistent_bulk"),
    (dict(B=64), "persistent_bulk"),
    (dict(B=200), "persistent_bulk"),
    (dict(B=256, gates=3), "persistent"),         # the GRU
    (dict(B=256, E=1024), "persistent"),          # W_ih's slice does not fit
    (dict(B=256, fuse_input=False), "persistent"),
    (dict(B=256, smem_bytes=bulk_smem(300, 1024) - 1), "persistent"),
    (dict(B=256, H=1000, E=52), "persistent_bulk"),
    (dict(B=384), "stepwise"),                    # both grids exceed the SMs
])
def test_bulk_variant_where_it_fits_past_a_pack(kw, variant):
    kw = {**dict(H=1024, gates=4, sm_count=H100_SMS, smem_bytes=H100_SMEM,
                 E=300), **kw}
    plan = plan_recurrence(**kw)
    assert plan.variant == variant, plan.reason
    if variant == "persistent_bulk":
        assert plan.batch_group == BULK_ROWS and plan.fuse_input
        assert plan.grid == (-(-kw["H"] // UNITS), -(-kw["B"] // BULK_ROWS))
        assert plan.smem_bytes == bulk_smem(kw["E"], kw["H"])


@pytest.mark.parametrize("kw,why", [
    (dict(gates=3), "do not fill"),
    (dict(E=1024), "exceed"),
    (dict(fuse_input=False), "W_ih's slice"),
    (dict(B=384), "exceeds 132 SMs"),
])
def test_bulk_asked_for_is_taken_or_refused_with_a_reason(kw, why):
    kw = {**dict(B=256, H=1024, gates=4, sm_count=H100_SMS,
                 smem_bytes=H100_SMEM, E=300), **kw}
    plan = plan_recurrence(bulk=True, **kw)
    assert plan.variant == "stepwise" and why in plan.reason
    # held to it where it fits, a pack too, or away from it
    assert plan_recurrence(8, 1024, 4, H100_SMS, H100_SMEM, E=300,
                           bulk=True).variant == "persistent_bulk"
    assert plan_recurrence(256, 1024, 4, H100_SMS, H100_SMEM, E=300,
                           bulk=False).variant == "persistent"


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
    if plan.variant == "persistent_bulk":
        assert gates == 4 and B > PACK_ROWS and plan.fuse_input
        assert (depth * 16 * gates * 2
                + rnn_plan.BULK_STAGES * rnn_plan.BULK_STAGE_BYTES
                + rnn_plan.BULK_TILE_BYTES + rnn_plan.BULK_BARRIER_BYTES
                + rnn_plan.ALIGN_SLACK) == plan.smem_bytes
        return
    assert (depth * 16 * gates * 2
            + rnn_plan.STAGES * plan.warpgroups * STAGE_BYTES
            + rnn_plan.ALIGN_SLACK) == plan.smem_bytes


def test_device_plan_checks_the_variant_before_the_device():
    with pytest.raises(ValueError, match="variant must be one of"):
        device_plan(torch.device("cpu"), 4, 6, 8, 4, True, variant="fast")
    plan = device_plan(torch.device("cpu"), 4, 6, 8, 4, True,
                       variant="stepwise")
    assert plan.variant == "stepwise" and plan.reason == "asked for"


def _h100(monkeypatch):
    class Props:
        multi_processor_count = H100_SMS
        shared_memory_per_block_optin = H100_SMEM

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B", [256, 200, 8])
def test_device_plan_holds_a_call_to_the_bulk_variant(monkeypatch, B):
    dev = _h100(monkeypatch)
    plan = device_plan(dev, B, 300, 1024, 4, True,
                       variant="persistent_bulk")
    assert plan.variant == "persistent_bulk"
    auto = device_plan(dev, B, 300, 1024, 4, True)
    assert auto.variant == ("persistent" if B <= PACK_ROWS
                            else "persistent_bulk")
    held = device_plan(dev, B, 300, 1024, 4, True, variant="persistent")
    assert held.variant == "persistent"


@pytest.mark.parametrize("args,why", [
    ((256, 300, 1024, 3), "do not fill"),         # the GRU
    ((256, 1024, 1024, 4), "exceed"),             # an inner layer: E = H
    ((512, 300, 1024, 4), "exceeds 132 SMs"),     # chunked by the chain
])
def test_device_plan_refuses_the_bulk_variant(monkeypatch, args, why):
    dev = _h100(monkeypatch)
    with pytest.raises(ValueError,
                       match=f"persistent_bulk recurrence refused: .*{why}"):
        device_plan(dev, *args, True, variant="persistent_bulk")
    with pytest.raises(ValueError, match="persistent_bulk recurrence"):
        device_plan(dev, 256, 300, 1024, 4, True, variant="persistent_bulk",
                    fuse_input=False)


# ------------------------------------------------------- the bulk layouts
#
# Models of the layouts csrc/lstm_recurrence.cu's persistent_bulk variant
# reads and writes (chunk_byte, bulk_row there).


def chunk_major_index(row, k, depth: int):
    """Element index of (``row``, ``k``) of a [rows, ``depth``] bf16
    operand stored as ``persistent_bulk`` reads it: groups of 128 rows, in
    each the depth's chunks of 64, in each the 128 rows of 128 bytes, the
    16-byte piece k // 8 of row n stored at piece (k // 8) ^ (n % 8).
    Integers or integer arrays."""
    nk = -(-depth // CHUNK)
    group, n = row // BULK_ROWS, row % BULK_ROWS
    chunk, kk = k // CHUNK, k % CHUNK
    return (((group * nk + chunk) * BULK_ROWS + n) * CHUNK
            + (((kk // 8) ^ (n % 8)) * 8) + kk % 8)


def bulk_gate_row(gate, unit):
    """Row of a ``persistent_bulk`` block's W slice (the wgmma's M) holding
    gate ``gate`` (i, f, g, o) of the block's unit ``unit`` (0..15)."""
    return (16 * (unit // 4) + 2 * (unit % 4) + gate // 2
            + 8 * (gate % 2))


@pytest.mark.parametrize("rows,depth", [(128, 64), (256, 1024), (200, 1000),
                                        (70, 300), (384, 52)])
def test_chunk_major_index_is_a_bijection_onto_the_buffer(rows, depth):
    groups, nk = -(-rows // BULK_ROWS), -(-depth // 64)
    r, k = np.meshgrid(np.arange(groups * BULK_ROWS), np.arange(nk * 64),
                       indexing="ij")
    idx = chunk_major_index(r, k, depth)
    assert sorted(idx.ravel().tolist()) == list(range(groups * nk * 8192))
    # a chunk is 16 KB of one row group and one 64-deep slice of k
    assert np.array_equal(idx // 8192, (r // 128) * nk + k // 64)


def test_chunk_major_index_is_the_128_byte_swizzle():
    """The byte offset inside a chunk is the unswizzled [128 x 128 bytes]
    tile's with address bits 4-6 XORed by bits 7-9, as the kernel's
    ``chunk_byte`` states and the wgmma descriptor's 128-byte swizzle
    reads: a 16-byte piece of 8 k stays whole and lands in another piece of
    its own 128-byte row."""
    n, k = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    byte = 2 * chunk_major_index(n, k, 64)
    plain = n * 128 + k * 2
    assert np.array_equal(byte, plain ^ (((plain >> 7) & 7) << 4))
    assert np.array_equal(byte // 128, n)
    assert np.array_equal(byte % 16, (k % 8) * 2)


def test_bulk_gate_rows_give_a_cell_to_a_pair_of_lanes():
    """The W slice's gate rows are a bijection onto the wgmma's M = 64, and
    with the accumulator's row layout (row 16w + q + 8rr: warp w, lanes
    4q..4q+3, half rr) a lane's two rows and lane ^ 4's hold the four gates
    of one unit, lane q // 2 of the warp's four units."""
    rows = {(g, u): bulk_gate_row(g, u) for g in range(4) for u in range(16)}
    assert sorted(rows.values()) == list(range(64))
    for w in range(4):
        for lane in range(32):
            q = lane // 4
            held = {m for m in (16 * w + q, 16 * w + q + 8)}
            partner = {16 * w + (q ^ 1), 16 * w + (q ^ 1) + 8}
            cells = {(g, u) for (g, u), m in rows.items()
                     if m in held | partner}
            assert cells == {(g, 4 * w + q // 2) for g in range(4)}
            mine = sorted(g for (g, u), m in rows.items() if m in held)
            assert mine == [2 * (q % 2), 2 * (q % 2) + 1]


def test_bulk_exchange_model_gives_every_cell_its_gates():
    """A numpy model of the kernel's product and shuffle: D = W_A @ h^T with
    W's gate columns as rows ``bulk_gate_row``, lane (w, q, t4) holding D's
    rows 16w + q + 8rr at columns 8 j8 + 2 t4 + e, each lane keeping the
    columns of j8 % 2 == q % 2 and taking its partner's two gates there:
    every (unit, row) cell gets its four gates, once, equal to h @ W."""
    rng = np.random.default_rng(0)
    w_cols = rng.standard_normal((64, 4, 16))        # [k, gate, unit]
    h = rng.standard_normal((128, 64))               # [row, k]
    a = np.zeros((64, 64))
    for g in range(4):
        for u in range(16):
            a[bulk_gate_row(g, u)] = w_cols[:, g, u]
    d = a @ h.T                                      # [M = 64, N = 128]
    want = np.einsum("rk,kgu->rgu", h, w_cols)
    seen = np.zeros((128, 16), int)
    for w in range(4):
        for lane in range(32):
            q, t4 = lane // 4, lane % 4
            b, unit = q % 2, 4 * w + q // 2
            partner_q = q ^ 1
            for j8 in range(b, 16, 2):
                for e in range(2):
                    n = 8 * j8 + 2 * t4 + e
                    own = [d[16 * w + q + 8 * rr, n] for rr in range(2)]
                    other = [d[16 * w + partner_q + 8 * rr, n]
                             for rr in range(2)]
                    gates = own + other if b == 0 else other + own
                    assert np.allclose(gates, want[n, :, unit])
                    seen[n, unit] += 1
    assert (seen == 1).all()


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
    for kw in (dict(variant="persistent_bulk"), dict(variant="persistent"),
               dict(variant="stepwise"),
               dict(fuse_input=False, timeline=None)):
        got = layer(torch.from_numpy(x), torch.from_numpy(LENGTHS),
                    t["w_ih"], t["w_hh"], *biases, pool="mean", **kw)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (dict(mod.LAUNCHES), dict(mod.VARIANT_LAUNCHES)) == before
    assert sorted(mod.VARIANT_LAUNCHES) == (
        ["persistent", "stepwise"] if cell == "gru"
        else ["persistent", "persistent_bulk", "stepwise"])


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
