"""What the LSTM and GRU recurrence wrappers share on the host: the plan
that picks a kernel variant from shapes and device properties, and the
once-per-tree weight preparation.

Variants of ``csrc/lstm_recurrence.cu`` / ``csrc/gru_recurrence.cu``:

``persistent``  one cooperative launch per layer.  A block owns ``u = 16``
    hidden units x all gates x one batch group of 64 or 128 rows and keeps
    its slice of W_hh (and of W_ih when it fits: ``fuse_input``) in shared
    memory for all T steps.  Needs bf16 weights, ``hidden % 8 == 0``, a
    slice plus a ring of ``STAGES`` stages per warpgroup within the block's
    shared memory, and a grid of at most one block per SM.
``stepwise``    the input product hoisted over T, then one launch per step.
    Takes every shape, and f32 weights.

The choice is a function of (B, E, H, gates, dtype, SM count, shared
memory bytes) only; nothing is decided by trying a launch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

UNITS = 16              # hidden units per block (csrc/rnn_common.cuh PU)
TILE_ROWS = 64          # rows of one warpgroup's tile (one wgmma M)
CHUNK = 64              # depth of one shared-memory chunk (128-byte rows)
STAGE_BYTES = TILE_ROWS * CHUNK * 2
ALIGN_SLACK = 1024      # the kernel aligns its tiles to 1024 bytes itself
STAGES = 3              # ring stages per warpgroup (rnn_common.cuh PSTAGES)
MAX_WARPGROUPS = 2
VARIANTS = ("auto", "persistent", "stepwise")


@dataclasses.dataclass(frozen=True)
class RecurrencePlan:
    variant: str                 # "persistent" | "stepwise"
    reason: str                  # why, in words
    u: int = 0                   # hidden units per block
    batch_group: int = 0         # rows per block
    grid: Tuple[int, int] = (0, 0)
    smem_bytes: int = 0          # dynamic shared memory of one block
    fuse_input: bool = False     # W_ih's slice resident beside W_hh's

    @property
    def warpgroups(self) -> int:
        return self.batch_group // TILE_ROWS


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan_recurrence(B: int, H: int, gates: int, sm_count: int,
                    smem_bytes: int, E: Optional[int] = None,
                    weights_bf16: bool = True,
                    fuse_input: Optional[bool] = None) -> RecurrencePlan:
    """The variant and launch geometry for one layer of ``B`` rows, hidden
    size ``H``, ``gates`` gate columns per unit (LSTM 4, GRU 3) on a device
    with ``sm_count`` SMs and ``smem_bytes`` of shared memory per block.
    ``E`` (the input width) lets W_ih's slice be held beside W_hh's;
    ``fuse_input`` forces that on or off (None: when it fits)."""
    def stepwise(reason):
        return RecurrencePlan("stepwise", reason)

    if not weights_bf16:
        return stepwise("f32 weights")
    if B < 1 or H < 1:
        return stepwise("empty batch or hidden size")
    if H % 8:
        return stepwise("hidden % 8 != 0")
    cols = UNITS * gates
    col_groups = -(-H // UNITS)
    for nwg in range(1, MAX_WARPGROUPS + 1):
        rows = TILE_ROWS * nwg
        grid = (col_groups, -(-B // rows))
        if grid[0] * grid[1] <= sm_count:
            break
    else:
        return stepwise(f"grid {grid[0]}x{grid[1]} of {rows}-row blocks "
                        f"exceeds {sm_count} SMs")

    def smem_for(depth):
        return ALIGN_SLACK + depth * cols * 2 + STAGES * nwg * STAGE_BYTES

    depth_h = _round_up(H, CHUNK)
    fused = False
    if fuse_input is not False and E is not None:
        smem = smem_for(depth_h + _round_up(E, CHUNK))
        fused = smem <= smem_bytes
        if fuse_input and not fused:
            return stepwise("W_ih and W_hh slices do not fit shared memory")
    if not fused:
        smem = smem_for(depth_h)
        if smem > smem_bytes:
            return stepwise(
                f"W_hh slice [{depth_h} x {cols}] bf16 and a {STAGES}-stage "
                f"ring exceed {smem_bytes} bytes of shared memory")
    return RecurrencePlan("persistent", "slice resident in shared memory",
                          u=UNITS, batch_group=rows, grid=grid,
                          smem_bytes=smem, fuse_input=fused)


def device_plan(device: torch.device, B: int, E: int, H: int, gates: int,
                weights_bf16: bool, variant: str = "auto",
                fuse_input: Optional[bool] = None) -> RecurrencePlan:
    """``plan_recurrence`` on ``device``'s properties, held to ``variant``:
    "persistent" raises where the plan says stepwise."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if variant == "stepwise":
        return RecurrencePlan("stepwise", "asked for")
    props = torch.cuda.get_device_properties(device)
    plan = plan_recurrence(B, H, gates, props.multi_processor_count,
                           props.shared_memory_per_block_optin, E=E,
                           weights_bf16=weights_bf16, fuse_input=fuse_input)
    if variant == "persistent" and plan.variant != "persistent":
        raise ValueError(f"persistent recurrence refused: {plan.reason}")
    return plan


RNN_WEIGHT_KEYS = ("w_ih", "w_hh")


def prepare_rnn_weights(
    rnn_params: Dict[str, Dict[str, torch.Tensor]],
    weights_dtype: torch.dtype,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The recurrence tree (``{"layer0": {...}, ...}``) with W_ih / W_hh cast
    once to ``weights_dtype`` and made contiguous, and everything else as
    it was.  ``lstm_layer`` / ``gru_layer`` take such tensors untouched
    (``.to()`` of a tensor already in that dtype returns it), so a retriever
    that prepares its tree when it is built converts no weight per batch."""
    return {
        name: {k: (v.to(weights_dtype).contiguous()
                   if k in RNN_WEIGHT_KEYS else v)
               for k, v in layer.items()}
        for name, layer in rnn_params.items()
    }
