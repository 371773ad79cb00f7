"""Host side of the PyTorch port's distance-select (K2) and coarse block-max
(K4) kernels (``vfr_tpu_torch/ops/kernels/select_plan.py``), and the
arithmetic their ``mma`` variants use, on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` holds both
variants of each against the plain versions there).  Here:

* the plans are pure functions: the flagship, serving_10k and coarse shapes
  on an H100's numbers (132 SMs, 232,448 bytes) plan ``mma`` with a geometry
  that fits; refused shapes plan ``simt`` with a reason; every mma plan of a
  sweep keeps its shared memory within the limit and covers all the work;
* the wrappers check the variant argument, and on CPU tensors every variant
  is the plain version and counts nothing;
* K2 on an f32 index: the hi/lo TF32 split with three products per k-step,
  emulated bit for bit in PyTorch (``distance_select_split_tf32``), agrees
  with the plain version and with the Pallas kernel in interpret mode to
  1e-5 absolute at unit-norm inputs of the flagship width (one TF32 pass
  would be off by ~1e-3), with identical rows outside near-ties.

K4's ``mma`` variant keeps the plain version's arithmetic (``2 acc - msq``
rounded once per score), so ``test_torch_coarse_kernel.py`` covers it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.ops.pallas.select_kernel import pallas_distance_select
from vfr_tpu_torch.ops.kernels import coarse_kernel, select_kernel, select_plan
from vfr_tpu_torch.ops.kernels.coarse_kernel import (
    coarse_blockmax,
    coarse_blockmax_plain,
)
from vfr_tpu_torch.ops.kernels.select_kernel import (
    distance_select,
    distance_select_plain,
    distance_select_split_tf32,
)
from vfr_tpu_torch.ops.kernels.select_plan import (
    hold_to_variant,
    plan_coarse_blockmax,
    plan_distance_select,
)

H100_SMS = 132
H100_SMEM = 232_448
F32, BF16 = torch.float32, torch.bfloat16


# ------------------------------------------------------------- K2's plan

def _select(**kw):
    args = dict(S=2, Q=256, N=210_000, d=128, bin_size=64, block_n=4096,
                dtype=F32, smem_bytes=H100_SMEM, sm_count=H100_SMS)
    args.update(kw)
    return plan_distance_select(**args)


@pytest.mark.parametrize("dtype,stages,smem,splits", [
    # f32: unpadded query rows, 3 stages of 2 x (raw | lo) tiles, 5 a ranges
    (F32, 3, 1024 + 2 * 128 * 512 + 3 * 4 * 8192, 5),
    # bf16: padded query rows, 4 stages of a whole a-step, one a range
    (BF16, 4, 1024 + 2 * 128 * (256 + 16) + 4 * 4 * 8192, 1),
])
def test_flagship_select_plans_mma(dtype, stages, smem, splits):
    plan = _select(dtype=dtype)
    assert plan.variant == "mma"
    assert (plan.q_tile, plan.rows, plan.stages) == (128, 64, stages)
    assert plan.chunk * (2 if dtype == BF16 else 4) == 128
    assert plan.smem_bytes == smem <= H100_SMEM
    # 2 query tiles x 1 group x 52 tiles, times the a ranges
    assert plan.a_splits == splits and plan.grid == 104 * splits
    assert (plan.a_splits - 1) * plan.a_per_split < 64 \
        <= plan.a_splits * plan.a_per_split


def test_serving_10k_select_plans_mma():
    # 42,000 bf16 rows, top-100: fused_bin_size gives bin 64
    plan = _select(N=42_000, dtype=BF16)
    assert plan.variant == "mma" and plan.grid == 2 * 11 * plan.a_splits


@pytest.mark.parametrize("kw,why", [
    (dict(d=40), "d % 16"),
    (dict(bin_size=128), "bins 32"),                 # bins below the tile
    (dict(bin_size=4096), "bins 1 "),
    (dict(block_n=96 * 64, bin_size=64), "bins 96"),  # not a multiple of 64
    (dict(d=1024), "shared memory"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(S=3), "stream count"),
    (dict(smem_bytes=48 * 1024), "shared memory"),
])
def test_refused_select_shapes_plan_simt(kw, why):
    plan = _select(**kw)
    assert plan.variant == "simt" and why in plan.reason
    assert plan.grid == 0 and plan.smem_bytes == 0


def test_forced_a_splits():
    assert _select(a_splits=1).a_splits == 1
    assert _select(a_splits=1).a_per_split == 64
    p = _select(a_splits=5)
    assert (p.a_splits, p.a_per_split, p.grid) == (5, 13, 520)
    # 7 ranges of ceil(64 / 7) = 10 cover 64 in 7; 9 would leave one empty
    assert _select(a_splits=9).a_splits == 8
    with pytest.raises(ValueError, match="a_splits"):
        _select(a_splits=65)
    with pytest.raises(ValueError, match="a_splits"):
        _select(a_splits=0)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("sms,smem", [(132, 232_448), (108, 166_912),
                                      (64, 101_376)])
@pytest.mark.parametrize("bin_size", [1, 8, 16, 32, 64])
@pytest.mark.parametrize("S,Q,N,d", [(2, 256, 210_000, 128),
                                     (1, 200, 5_000, 128),
                                     (2, 37, 9_000, 48),
                                     (2, 1000, 42_000, 256),
                                     (1, 1, 1, 16)])
def test_mma_select_plans_fit_and_cover(S, Q, N, d, bin_size, sms, smem,
                                        dtype):
    plan = plan_distance_select(S, Q, N, d, bin_size, 4096, dtype, smem, sms)
    if plan.variant == "simt":
        assert "shared memory" in plan.reason
        return
    assert plan.smem_bytes <= smem
    assert 1 <= plan.a_splits <= min(bin_size, select_plan.SELECT_MAX_SPLITS)
    assert (plan.a_splits - 1) * plan.a_per_split < bin_size \
        <= plan.a_splits * plan.a_per_split
    bins = 4096 // bin_size
    assert plan.grid == (-(-Q // 128) * (bins // 64) * -(-N // 4096)
                         * plan.a_splits)


# ------------------------------------------------------------- K4's plan

def _coarse(**kw):
    args = dict(Q=256, N=212_992, d_c=32, block_rows=128, dtype=BF16,
                smem_bytes=H100_SMEM, sm_count=H100_SMS)
    args.update(kw)
    return plan_coarse_blockmax(**args)


@pytest.mark.parametrize("N", [212_992, 2_113_536])      # 210k, 2.1M padded
@pytest.mark.parametrize("d_c", [32, 64])
def test_coarse_shapes_plan_mma(N, d_c):
    plan = _coarse(N=N, d_c=d_c)
    assert plan.variant == "mma"
    assert (plan.q_tile, plan.rows, plan.stages) == (256, 128, 4)
    assert plan.smem_bytes == 4 * (128 * (2 * d_c + 16) + 512) + 256 * 9 * 4
    assert plan.ctas_per_sm == 2
    gx, gy = plan.grid
    assert gx == 1 and gy <= 2 * H100_SMS
    assert gy * plan.stages_per_cta >= N // 128 > (gy - 1) * plan.stages_per_cta


@pytest.mark.parametrize("kw,why", [
    (dict(dtype=F32), "float32 m_low"),
    (dict(d_c=24), "d_c 24"),
    (dict(d_c=128), "d_c 128"),
    (dict(block_rows=100), "block_rows"),
    (dict(smem_bytes=32 * 1024), "shared memory"),
])
def test_refused_coarse_shapes_plan_simt(kw, why):
    plan = _coarse(**kw)
    assert plan.variant == "simt" and why in plan.reason
    assert plan.grid == (0, 0) and plan.smem_bytes == 0


@pytest.mark.parametrize("sms,smem", [(132, 232_448), (108, 166_912),
                                      (64, 101_376)])
@pytest.mark.parametrize("block_rows", [32, 64, 128])
@pytest.mark.parametrize("d_c", [16, 32, 48, 64])
@pytest.mark.parametrize("Q,N", [(256, 2_113_536), (200, 209_999), (37, 100),
                                 (1000, 50_001), (1, 1)])
def test_mma_coarse_plans_fit_and_cover(Q, N, d_c, block_rows, sms, smem):
    plan = plan_coarse_blockmax(Q, N, d_c, block_rows, BF16, smem, sms)
    if plan.variant == "simt":
        assert "shared memory" in plan.reason and smem < 109_568
        return
    assert plan.smem_bytes <= smem
    gx, gy = plan.grid
    assert gx == -(-Q // 256)
    n_stages = -(-N // 128)
    assert gy * plan.stages_per_cta >= n_stages
    assert (gy - 1) * plan.stages_per_cta < n_stages
    assert plan.ctas_per_sm * (plan.smem_bytes + 1024) <= smem + 1024


# ----------------------------------------------------------- the wrappers

def test_hold_to_variant():
    mma, simt = _select(), _select(d=40)
    assert hold_to_variant(mma, "auto", "x") is mma
    assert hold_to_variant(simt, "auto", "x") is simt
    assert hold_to_variant(mma, "simt", "x").variant == "simt"
    assert hold_to_variant(mma, "simt", "x").reason == "asked for"
    with pytest.raises(ValueError, match="mma x refused: d % 16"):
        hold_to_variant(simt, "mma", "x")


def _k2_inputs(S=2, Q=9, N=700, d=16, seed=0, dtype=F32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((S, Q, d)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((S, N, d)).astype(
        np.float32)).to(dtype)
    return q, m, (m.float() ** 2).sum(-1)


def test_select_wrapper_variants_on_cpu():
    """On a CPU tensor every variant is the plain version and nothing is
    counted; an unknown variant raises before anything runs."""
    q, m, m_sq = _k2_inputs()
    before = (dict(select_kernel.LAUNCHES),
              dict(select_kernel.VARIANT_LAUNCHES), select_kernel.LAST_PLAN)
    ref = distance_select_plain(q, m, m_sq, [0.3, 0.7], 16, 256)
    for kw in (dict(variant="mma"), dict(variant="simt"),
               dict(variant="auto", a_splits=3)):
        got = distance_select(q, m, m_sq, [0.3, 0.7], 16, 256, **kw)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    with pytest.raises(ValueError, match="variant must be one of"):
        distance_select(q, m, m_sq, [0.3, 0.7], 16, 256, variant="wgmma")
    assert (dict(select_kernel.LAUNCHES),
            dict(select_kernel.VARIANT_LAUNCHES),
            select_kernel.LAST_PLAN) == before
    assert sorted(select_kernel.VARIANT_LAUNCHES) == ["mma", "simt"]


def test_coarse_wrapper_variants_on_cpu():
    rng = np.random.default_rng(1)
    m = torch.from_numpy(rng.standard_normal((700, 16)).astype(
        np.float32)).to(BF16)
    msq = (m.float() ** 2).sum(-1)
    q = torch.from_numpy(rng.standard_normal((9, 16)).astype(np.float32))
    before = (dict(coarse_kernel.LAUNCHES),
              dict(coarse_kernel.VARIANT_LAUNCHES), coarse_kernel.LAST_PLAN)
    ref = coarse_blockmax_plain(q, m, msq, 64)
    for variant in ("auto", "mma", "simt"):
        assert torch.equal(coarse_blockmax(q, m, msq, 64, variant=variant),
                           ref)
    with pytest.raises(ValueError, match="variant must be one of"):
        coarse_blockmax(q, m, msq, 64, variant="wgmma")
    assert (dict(coarse_kernel.LAUNCHES),
            dict(coarse_kernel.VARIANT_LAUNCHES),
            coarse_kernel.LAST_PLAN) == before
    assert sorted(coarse_kernel.VARIANT_LAUNCHES) == ["mma", "simt"]


# ------------------------------------------- K2: the split-TF32 arithmetic

def _unit(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-8)


def _rows_agree_outside_near_ties(q, m, m_sq, w, bin_size, block_n, rows,
                                  ref_rows, tol=1e-5):
    """Rows may differ only where the bin's two smallest plain distances
    are within ``tol``."""
    S, Q, _ = q.shape
    N = m.shape[1]
    pad = (-N) % block_n
    mf = torch.nn.functional.pad(m.float(), (0, 0, 0, pad))
    msq = torch.nn.functional.pad(m_sq, (0, pad), value=1e30)
    D = sum(w[s] * (msq[s][None] + (q[s] * q[s]).sum(-1)[:, None]
                    - 2.0 * (q[s] @ mf[s].T)) for s in range(S))
    two = D.view(Q, -1, bin_size, block_n // bin_size).topk(
        2, dim=2, largest=False).values
    clear = ((two[:, :, 1] - two[:, :, 0]) > tol).reshape(Q, -1)
    return int(((rows != ref_rows) & clear).sum()) == 0


@pytest.mark.parametrize("S,w,N,bin_size", [
    (2, [0.5, 0.5], 4096, 64),
    (2, [0.3, 0.7], 3000, 64),       # ragged N, non-power-of-two weights
    (2, [0.7, 0.3], 3000, 32),       # the second stream runs first
    (1, [0.7], 2500, 16),
])
def test_split_tf32_matches_plain_and_pallas(S, w, N, bin_size):
    rng = np.random.default_rng(7)
    Q, d, block_n = 24, 128, 4096
    q = torch.from_numpy(_unit(rng, S, Q, d))
    m = torch.from_numpy(_unit(rng, S, N, d))
    m_sq = (m * m).sum(-1)
    got_v, got_r = distance_select_split_tf32(q, m, m_sq, w, bin_size,
                                              block_n)
    ref_v, ref_r = distance_select_plain(q, m, m_sq, w, bin_size, block_n)
    pal_v, pal_r = pallas_distance_select(
        jnp.asarray(q.numpy()), jnp.asarray(m.numpy()),
        jnp.asarray(m_sq.numpy()), w, bin_size=bin_size, block_n=block_n,
        interpret=True)
    live = ref_v < 1e29                       # bins of padding hold 1e30
    for other_v, other_r in ((ref_v, ref_r),
                             (torch.from_numpy(np.array(pal_v)),
                              torch.from_numpy(np.array(pal_r)))):
        diff = ((got_v - other_v).abs() * live).max()
        assert float(diff) <= 1e-5
        assert _rows_agree_outside_near_ties(q, m, m_sq, w, bin_size,
                                             block_n, got_r, other_r)
    np.testing.assert_allclose(got_v[~live].numpy(), ref_v[~live].numpy(),
                               rtol=1e-6)
    assert torch.equal(got_r[~live], ref_r[~live])     # a = 0: lowest row


def test_one_tf32_pass_would_not_do():
    """Why the split is there: a single TF32 product of the same inputs is
    two orders of magnitude further from the plain distances."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_unit(rng, 1, 24, 128))
    m = torch.from_numpy(_unit(rng, 1, 4096, 128))
    m_sq = (m * m).sum(-1)
    ref_v, _ = distance_select_plain(q, m, m_sq, [1.0], 64, 4096)
    split_v, _ = distance_select_split_tf32(q, m, m_sq, [1.0], 64, 4096)
    one_v, _ = distance_select_plain(select_kernel._tf32_round(q),
                                     select_kernel._tf32_round(m), m_sq,
                                     [1.0], 64, 4096)
    qsq_shift = ((q * q).sum(-1) - (select_kernel._tf32_round(q) ** 2).sum(-1))
    one_err = float((one_v + qsq_shift[0][:, None] - ref_v).abs().max())
    split_err = float((split_v - ref_v).abs().max())
    assert split_err <= 2e-6 < 1e-4 < one_err


def test_tf32_helpers_round_and_truncate():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -11 + 2 ** -12,
                      -(1.0 + 2 ** -11), 3.0, 1e-20], dtype=torch.float32)
    r = select_kernel._tf32_round(x)
    t = select_kernel._tf32_trunc(x)
    # ties away from zero; 10 mantissa bits survive
    assert r[0] == 1.0 + 2 ** -10 and r[2] == -(1.0 + 2 ** -10)
    assert r[1] == 1.0 + 2 ** -10 and t[1] == 1.0
    assert t[0] == 1.0 and r[3] == 3.0 and t[3] == 3.0
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    lo = x - r
    assert (lo.abs() <= x.abs() * 2 ** -11).all()
