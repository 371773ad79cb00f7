"""Host-side plans of the distance-select (K2) and coarse block-max (K4)
kernels: which kernel variant runs, and its launch geometry, from shapes,
dtype and device properties only.  Nothing is decided by trying a launch.

Variants of ``csrc/distance_select.cu`` and ``csrc/coarse_blockmax.cu``:

``mma``   products on the tensor cores (K2: ``wgmma``, K4: ``mma.sync``),
    index rows streamed through a ``cp.async`` ring, the min / max taken on
    the accumulator registers.  K2: a bf16 or f32 index (f32 as three TF32 products of
    hi/lo splits), ``bins = block_n / bin_size`` a multiple of 64, ``d`` a
    multiple of 16, the resident query tile within shared memory.  K4: bf16
    rows, ``d_c`` in 16, 32, 48, 64.
``simt``  the first design, f32 FMAs: every other shape, and f32 ``m_low``.

The constants mirror the kernel sources; the C entry points check the plan
they are handed against their own reckoning and refuse a mismatch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

VARIANTS = ("auto", "mma", "simt")

# csrc/distance_select.cu
SELECT_Q_TILE = 128         # queries per CTA (SQ): 2 warpgroups x 64
SELECT_ROWS = 64            # index rows per a-step (SR): one per bin
SELECT_CHUNK_BYTES = 128    # bytes of a row in one operand tile (SCH)
SELECT_PAD = 16             # padding of a bf16 query row (f32: swizzled)
SELECT_ALIGN = 1024         # the kernel aligns its tiles itself
# ring by element size: (stages, 8 KB tiles per stage).  bf16: 4 chunks a
# stage; f32: 2 chunks, each the raw rows and their lo parts
SELECT_RING = {2: (4, 4), 4: (3, 2 * 2)}
SELECT_MAX_SPLITS = 16
# cost model of the a-split, in a-steps, fitted to the card's times of 1..8
# splits: what a unit pays before its first a-step (~6 us: launch, staging
# its query tile, filling the ring), and what each a range adds to the
# combine pass
_UNIT_OVERHEAD = {2: 3.0, 4: 1.0}
_COMBINE_COST = {2: 1.6, 4: 0.5}

# csrc/coarse_blockmax.cu
COARSE_Q_TILE = 256         # queries per CTA (MQ)
COARSE_ROWS = 128           # index rows per ring stage (MROWS)
COARSE_STAGES = 4           # ring stages (MSTAGES)
COARSE_FLUSH = 8            # stages between two writes of the maxima
COARSE_MIN_STAGES = 4       # a CTA's range is at least this long
COARSE_WIDTHS = (16, 32, 48, 64)

_BLOCK_RESERVE = 1024       # shared memory the system keeps per block


def _ctas_per_sm(smem: int, smem_bytes: int, cap: int) -> int:
    """Blocks of ``smem`` dynamic bytes that fit one SM, whose shared memory
    is the per-block limit plus one block's reserve."""
    return max(1, min(cap, (smem_bytes + _BLOCK_RESERVE)
                      // (smem + _BLOCK_RESERVE)))


@dataclasses.dataclass(frozen=True)
class SelectPlan:
    variant: str                 # "mma" | "simt"
    reason: str                  # why, in words
    q_tile: int = 0              # queries per CTA
    rows: int = 0                # index rows per a-step
    chunk: int = 0               # elements of one ring chunk
    stages: int = 0              # ring stages
    a_splits: int = 0            # a ranges per bin (> 1: a combine pass)
    a_per_split: int = 0         # a values per range
    grid: int = 0                # CTAs = work units, one per SM at a time
    smem_bytes: int = 0          # dynamic shared memory of one CTA


def plan_distance_select(S: int, Q: int, N: int, d: int, bin_size: int,
                         block_n: int, dtype: torch.dtype, smem_bytes: int,
                         sm_count: int,
                         a_splits: Optional[int] = None) -> SelectPlan:
    """The variant and geometry of one distance-select call: ``S`` streams,
    ``Q`` queries, ``N`` index rows of width ``d`` and ``dtype``, on a device
    with ``sm_count`` SMs and ``smem_bytes`` of shared memory per block.
    ``a_splits`` forces the number of a ranges (None: the cost model's)."""
    def simt(reason):
        return SelectPlan("simt", reason)

    if dtype not in (torch.float32, torch.bfloat16):
        return simt(f"index dtype {dtype}")
    if S not in (1, 2) or Q < 1 or N < 1:
        return simt("stream count or empty input")
    if d % 16:
        return simt("d % 16 != 0")
    if bin_size < 1 or block_n % bin_size:
        return simt("block_n is not a multiple of bin_size")
    bins = block_n // bin_size
    if bins % SELECT_ROWS:
        return simt(f"bins {bins} is not a multiple of the {SELECT_ROWS}-row "
                    "tile")
    esize = 2 if dtype == torch.bfloat16 else 4
    chunk = SELECT_CHUNK_BYTES // esize
    stages, tiles_per_stage = SELECT_RING[esize]
    q_row = (-(-d // chunk) * SELECT_CHUNK_BYTES
             + (SELECT_PAD if esize == 2 else 0))
    smem = (SELECT_ALIGN + S * SELECT_Q_TILE * q_row
            + SELECT_ROWS * SELECT_CHUNK_BYTES * stages * tiles_per_stage)
    if smem > smem_bytes:
        return simt(f"query tile [{S} x {SELECT_Q_TILE} x {d}] and the ring "
                    f"exceed {smem_bytes} bytes of shared memory")
    slots = sm_count         # one CTA per SM: 256 threads x <= 255 registers
    units = (-(-Q // SELECT_Q_TILE) * (bins // SELECT_ROWS)
             * -(-N // block_n))

    def geometry(p):
        per = -(-bin_size // p)
        return -(-bin_size // per), per

    if a_splits is not None:
        if not 1 <= a_splits <= bin_size:
            raise ValueError(f"a_splits must be in 1..{bin_size}, got "
                             f"{a_splits}")
        p_best, per_best = geometry(a_splits)
    else:
        best = None
        for p in range(1, min(bin_size, SELECT_MAX_SPLITS) + 1):
            p_eff, per = geometry(p)
            cost = (-(-units * p_eff // slots)
                    * (per + _UNIT_OVERHEAD[esize])
                    + (_COMBINE_COST[esize] * p_eff if p_eff > 1 else 0.0))
            if best is None or cost < best[0]:
                best = (cost, p_eff, per)
        _, p_best, per_best = best
    return SelectPlan("mma", "tensor-core products, a range split "
                      f"{p_best} ways", q_tile=SELECT_Q_TILE,
                      rows=SELECT_ROWS, chunk=chunk, stages=stages,
                      a_splits=p_best, a_per_split=per_best,
                      grid=units * p_best, smem_bytes=smem)


@dataclasses.dataclass(frozen=True)
class CoarsePlan:
    variant: str                 # "mma" | "simt"
    reason: str
    q_tile: int = 0              # queries per CTA
    rows: int = 0                # index rows per ring stage
    stages: int = 0              # ring stages
    stages_per_cta: int = 0      # 128-row stages one CTA walks
    ctas_per_sm: int = 0
    grid: Tuple[int, int] = (0, 0)
    smem_bytes: int = 0


def plan_coarse_blockmax(Q: int, N: int, d_c: int, block_rows: int,
                         dtype: torch.dtype, smem_bytes: int,
                         sm_count: int) -> CoarsePlan:
    """The variant and geometry of one coarse block-max call: ``Q`` queries,
    ``N`` rows of width ``d_c`` and ``dtype``, maxima over ``block_rows``
    rows."""
    def simt(reason):
        return CoarsePlan("simt", reason)

    if dtype != torch.bfloat16:
        return simt(f"{str(dtype).replace('torch.', '')} m_low")
    if Q < 1 or N < 1:
        return simt("empty input")
    if block_rows not in (32, 64, 128):
        return simt(f"block_rows {block_rows}")
    if d_c not in COARSE_WIDTHS:
        return simt(f"d_c {d_c} is not one of {COARSE_WIDTHS}")
    stage = COARSE_ROWS * (2 * d_c + 16) + COARSE_ROWS * 4
    outs = 8 * 32 * (COARSE_FLUSH * (COARSE_ROWS // block_rows) + 1) * 4
    smem = COARSE_STAGES * stage + outs
    if smem > smem_bytes:
        return simt(f"ring and staged maxima exceed {smem_bytes} bytes of "
                    "shared memory")
    ctas = _ctas_per_sm(smem, smem_bytes, 2)
    q_tiles = -(-Q // COARSE_Q_TILE)
    n_stages = -(-N // COARSE_ROWS)
    ranges = max(1, sm_count * ctas // q_tiles)
    per = max(-(-n_stages // ranges), min(COARSE_MIN_STAGES, n_stages))
    return CoarsePlan("mma", "tensor-core products, queries in registers",
                      q_tile=COARSE_Q_TILE, rows=COARSE_ROWS,
                      stages=COARSE_STAGES, stages_per_cta=per,
                      ctas_per_sm=ctas, grid=(q_tiles, -(-n_stages // per)),
                      smem_bytes=smem)


def check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")


def hold_to_variant(plan, variant: str, what: str):
    """``plan`` held to the caller's ``variant``: "simt" replaces an mma
    plan, "mma" raises where the plan refused it."""
    if variant == "simt" and plan.variant != "simt":
        return type(plan)("simt", "asked for")
    if variant == "mma" and plan.variant != "mma":
        raise ValueError(f"mma {what} refused: {plan.reason}")
    return plan


def device_limits(device: torch.device) -> Tuple[int, int]:
    """(shared memory bytes a block may use, SM count) of a CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_block_optin, props.multi_processor_count


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy when its storage offset leaves it off the 16
    bytes that the kernels' vector copies need."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
