"""Top-k of long f32 rows through the hand-written CUDA kernel
(``csrc/row_topk.cu``), in ``jax.lax.top_k``'s order: value descending in
the total order of the f32 bits, equal values lowest index first.  It
replaces no Pallas kernel; its counterpart in the JAX package is
``jax.lax.top_k`` (XLA).

Every value's key is the unique 64-bit ``ordered_bits(value) * 2^32 + (N
- 1 - column)`` (``ops/topk.py::_key_topk``'s key, here built in
registers), so the k largest keys need no tie pass.  Pass 1 (``P`` slices
a row) keeps each slice's k largest keys; pass 2 takes the k largest of a
row's ``P * k`` candidates and writes the values (bit for bit, from the
key) and the rows.

``row_topk`` launches the kernel on the CUDA device of its input, or
raises: it has no CPU path (``ops/topk.py::select_route`` sends it only
CUDA tensors).  ``row_topk_plain`` is the same algorithm in PyTorch, for
the tests and ``chip_smoke.py``.  ``plan_row_topk`` gives the slices from
shapes and the SM count.  ``LAUNCHES`` counts the two kernels' launches
("row_topk_filter", "row_topk_merge") and ``DEVICE_LAUNCHES`` the filter's
by device; both are registered with the port's recorder
(``utils/trace.py``), so a graph replay adds the launches its capture
counted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from vfr_tpu_torch.ops.kernels.select_plan import device_limits
from vfr_tpu_torch.utils import trace

# the largest k the kernel takes (csrc/row_topk.cu: kKMax)
K_MAX = 256
# a slice is never shorter: a block's fixed work (its first threshold over
# three 2,048-value chunks, its sorts, k more candidates for pass 2) needs
# a few thousand values to pay for itself
MIN_SLICE = 4096
# blocks of pass 1 per SM the plan asks for where the rows allow (four fit
# a SM at 63 registers a thread; at Q = 256 two a SM, P = 2, measured
# faster than P = 1 or 3)
BLOCKS_PER_SM = 2
# slices a row at most: pass 2 merges a row's lists in rounds of 16 (its
# shared buffer at k = 256), each of log2 lists levels, and one block a
# row waits on every level; past 16 a level or a round costs more than the
# shorter slices save (an H100, a pack of 8 rows at k = 100 / 256, as a
# graph replays it: 16 slices 27.4 / 55.3 us, 17 34.7 / 67.7, 33 29.9 /
# 80.6; 16 was the fastest of 8-51 at Q = 1, 2, 8 and 16)
MAX_SLICES = 16

LAUNCHES = trace.register("topk_kernel.launches",
                          {"row_topk_filter": 0, "row_topk_merge": 0})
# the filter's launches by device (each comes with one merge)
DEVICE_LAUNCHES: Dict[str, int] = trace.register(
    "topk_kernel.device_launches", {})


@dataclasses.dataclass(frozen=True)
class RowTopkPlan:
    slices: int         # P: pass-1 blocks a row
    slice_len: int      # columns a slice (a multiple of 4; the last shorter)


def plan_row_topk(Q: int, N: int, k: int, sm_count: int) -> RowTopkPlan:
    """Slices a row for ``Q`` rows of ``N``: enough for ``BLOCKS_PER_SM``
    pass-1 blocks on each of ``sm_count`` SMs, but no more than
    ``MAX_SLICES`` and no slice shorter than ``MIN_SLICE`` or ``k`` (one
    slice where the row is shorter).  A batch of 256 rows takes few slices
    a row; a daemon pack of 1-16 rows 16."""
    if Q < 1 or N < 1 or k < 1:
        raise ValueError(f"plan_row_topk: Q={Q}, N={N}, k={k}")
    want = min(MAX_SLICES, -(-BLOCKS_PER_SM * sm_count // Q))
    most = max(1, N // max(MIN_SLICE, k))
    p = max(1, min(want, most))
    length = -(-N // p)
    length += (-length) % 4
    return RowTopkPlan(-(-N // length), length)


def row_topk_plain(x: torch.Tensor, k: int, plan: RowTopkPlan
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch: each slice's k best by the
    64-bit key (``_key_topk``), then the k best of the candidates by the
    same key over their columns.  (values [..., k] f32, indices [..., k]
    int64)."""
    from vfr_tpu_torch.ops.topk import _key_topk, ordered_bits

    N = x.shape[-1]
    vals, cols = [], []
    for s in range(plan.slices):
        a, b = s * plan.slice_len, min(N, (s + 1) * plan.slice_len)
        v, i = _key_topk(x[..., a:b], min(k, b - a))
        vals.append(v)
        cols.append(i + a)
    cv, ci = torch.cat(vals, -1), torch.cat(cols, -1)
    key = ordered_bits(cv).to(torch.int64) * (1 << 32) + (N - 1 - ci)
    pos = torch.topk(key, k, dim=-1, largest=True, sorted=True).indices
    return torch.gather(cv, -1, pos), torch.gather(ci, -1, pos)


def row_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row of ``x [..., N]`` (f32, contiguous) in
    ``jax.lax.top_k``'s order: (values [..., k] f32, indices [..., k]
    int64).  The kernel launches on the CUDA device of ``x``, on its
    current stream; nothing is read on the host.  Any other input raises."""
    N = x.shape[-1]
    lead = x.shape[:-1]
    Q = x.numel() // N if N else 0
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"row_topk takes contiguous f32 rows, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    if not 1 <= k <= min(K_MAX, N) or N >= 2 ** 31:
        raise ValueError(f"row_topk: k={k} out of 1..{min(K_MAX, N)} or "
                         f"N={N} too long")
    if x.device.type != "cuda":
        raise ValueError(f"row_topk: x on {x.device}, not a CUDA device")
    if Q == 0:
        return (x.new_empty(*lead, k),
                torch.empty(*lead, k, dtype=torch.int64, device=x.device))
    from vfr_tpu_torch.kernels.build import check, load

    dev = x.device
    with torch.cuda.device(dev):
        plan = plan_row_topk(Q, N, k, device_limits(dev)[1])
        cand = torch.empty(Q, plan.slices, k, dtype=torch.int64, device=dev)
        vals = torch.empty(*lead, k, dtype=torch.float32, device=dev)
        idx = torch.empty(*lead, k, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load("row_topk").vfr_row_topk(
            x.data_ptr(), cand.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            Q, N, k, plan.slices, plan.slice_len, stream)
    check(err, "row_topk")
    LAUNCHES["row_topk_filter"] += 1
    LAUNCHES["row_topk_merge"] += 1
    DEVICE_LAUNCHES[str(dev)] = DEVICE_LAUNCHES.get(str(dev), 0) + 1
    return vals, idx
