"""The f32 score product through the hand-written CUDA kernel
(``csrc/score_gemm.cu``): ``a [Q, K] @ m [N, K].T`` into f32 scores, each
product as three TF32 tensor-core products (hi.hi + hi.lo + lo.hi of the
operands split as x = hi + lo), which keeps f32 accuracy.  It replaces no
Pallas kernel; its counterpart in the JAX package is XLA's dot
(``parallel/sharding.py::fused_corpus_scores``).

``score_gemm`` launches the kernel on the CUDA device of its inputs, on
that device's current stream, or raises: it has no CPU path
(``parallel/sharding.py::score_route`` sends it only what ``refusal``
passes).  ``score_gemm_plain`` is the same function in PyTorch, the exact
f32 product (``device.mm_f32``, which the CPU route runs), for the tests
and ``chip_smoke.py``.
``plan_score_gemm`` gives the tile shape and the grid from shapes and the
SM count.  ``LAUNCHES`` counts the kernel's launches and
``DEVICE_LAUNCHES`` them by device; both are registered with the port's
recorder (``utils/trace.py``), so a graph replay adds the launches its
capture counted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from vfr_tpu_torch.device import mm_f32
from vfr_tpu_torch.ops.kernels.select_plan import device_limits
from vfr_tpu_torch.utils import trace

# the longest K the kernel takes: the wide tile holds a thread's query
# fragments of all of K in registers, a pack its queries' hi and lo tiles
# in shared memory beside the ring (csrc/score_gemm.cu: K_MAX)
K_MAX = 256
# the tile shapes of csrc/score_gemm.cu (Wide, Pack): name -> (code,
# queries a tile, index rows a tile).  Past PACK_Q queries a tile holds 128
# queries against 64 index rows ("wide"); up to it the whole pack against
# 128 rows, transposed (index rows on the wgmma's M side, the queries on
# N = 16 up to 16 queries, else 64)
SHAPES = {"wide": (0, 128, 64), "pack16": (1, 16, 128),
          "pack64": (2, 64, 128)}
PACK_Q = 64

LAUNCHES = trace.register("score_kernel.launches", {"score_gemm": 0})
DEVICE_LAUNCHES: Dict[str, int] = trace.register(
    "score_kernel.device_launches", {})


@dataclasses.dataclass(frozen=True)
class ScorePlan:
    shape: str          # a key of SHAPES
    q_tiles: int
    n_tiles: int        # tiles of ``rows`` index rows
    rows: int
    grid: int           # persistent blocks


def plan_score_gemm(Q: int, N: int, K: int, sm_count: int) -> ScorePlan:
    """The tile shape and grid for ``Q`` queries against ``N`` rows of
    ``K``.  Past ``PACK_Q`` queries a tile holds 128 (each of the two
    consumer warpgroups 64 of them, both on the tile's 64 rows), so the
    index is read once per 128 queries; up to it (a daemon's pack) the
    whole pack, padded to 16 or 64, against 128 rows, each warpgroup on
    64 of them.  The grid is one block an SM, rounded down to a multiple
    of the query tiles so that a block keeps its query tile (and the
    blocks of one row tile run at once); never more blocks than (query
    tile, row tile) units."""
    if Q < 1 or N < 1 or K < 1 or sm_count < 1:
        raise ValueError(f"plan_score_gemm: Q={Q}, N={N}, K={K}, "
                         f"sms={sm_count}")
    shape = "wide" if Q > PACK_Q else "pack16" if Q <= 16 else "pack64"
    _, per_tile, rows = SHAPES[shape]
    q_tiles = -(-Q // per_tile)
    n_tiles = -(-N // rows)
    grid = (q_tiles * (sm_count // q_tiles) if q_tiles <= sm_count
            else sm_count)
    return ScorePlan(shape, q_tiles, n_tiles, rows,
                     min(grid, q_tiles * n_tiles))


def refusal(a: torch.Tensor, m: torch.Tensor) -> Optional[str]:
    """Why the kernel cannot take ``a [Q, K] @ m [N, K].T``, or None: both
    f32 on one device, ``a``'s and ``m``'s rows contiguous, K a multiple
    of 8 up to ``K_MAX``, ``m`` 16-byte aligned with rows of a multiple
    of 16 bytes, ``a`` 4-byte aligned."""
    if a.dim() != 2 or m.dim() != 2 or a.shape[1] != m.shape[1]:
        return (f"the score kernel takes a [Q, K] and m [N, K], got "
                f"{tuple(a.shape)} and {tuple(m.shape)}")
    if a.dtype != torch.float32 or m.dtype != torch.float32:
        return (f"the score kernel takes f32 operands, got {a.dtype} and "
                f"{m.dtype}")
    if a.device != m.device:
        return f"operands on {a.device} and {m.device}"
    K = a.shape[1]
    if K % 8 or not 8 <= K <= K_MAX:
        return f"K={K}: the score kernel takes a multiple of 8 up to {K_MAX}"
    if (a.stride(1) != 1 or m.stride(1) != 1 or m.stride(0) % 4
            or (a.shape[0] > 1 and a.stride(0) < K)
            or (m.shape[0] > 1 and m.stride(0) < K)):
        return (f"the score kernel takes contiguous rows, got strides "
                f"{a.stride()} and {m.stride()}")
    if m.data_ptr() % 16 or a.data_ptr() % 4:
        return ("the score kernel takes m 16-byte aligned and a 4-byte "
                "aligned")
    return None


def score_gemm_plain(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``a @ m.T`` [Q, N], the exact f32 product: the kernel's function
    (its split products keep f32 accuracy) in plain PyTorch."""
    return mm_f32(a, m.T, torch.float32)


def score_gemm(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``a [Q, K] @ m [N, K].T`` -> [Q, N] f32 on the CUDA device of the
    operands, on its current stream, in one launch; nothing is read on
    the host.  What ``refusal`` names, or a CPU tensor, raises."""
    why = refusal(a, m)
    if why is None and a.device.type != "cuda":
        why = f"score_gemm: operands on {a.device}, not a CUDA device"
    if why is not None:
        raise ValueError(why)
    Q, K = a.shape
    N = m.shape[0]
    dev = a.device
    if Q == 0 or N == 0:
        return a.new_zeros(Q, N)
    from vfr_tpu_torch.kernels.build import check, load

    with torch.cuda.device(dev):
        plan = plan_score_gemm(Q, N, K, device_limits(dev)[1])
        out = torch.empty(Q, N, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load("score_gemm").vfr_score_gemm(
            a.data_ptr(), m.data_ptr(), out.data_ptr(), Q, N, K,
            a.stride(0) if Q > 1 else K, m.stride(0) if N > 1 else K, N,
            SHAPES[plan.shape][0], plan.grid, stream)
    check(err, "score_gemm")
    LAUNCHES["score_gemm"] += 1
    DEVICE_LAUNCHES[str(dev)] = DEVICE_LAUNCHES.get(str(dev), 0) + 1
    return out
