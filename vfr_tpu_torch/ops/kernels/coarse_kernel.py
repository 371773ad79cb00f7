"""Stage-1 block maxima of the coarse-to-fine retriever through the
hand-written CUDA kernel (``csrc/coarse_blockmax.cu``), the port of the JAX
package's Pallas ``ops/pallas/coarse_kernel.py`` (K4).

``sb[q, g] = max over rows r of the contiguous block g of (2 round(q[q]) .
m[r] - msq[r])``, q rounded once to m's dtype, f32 products and sums.  Rows
past N read as msq = 1e30 (the Pallas path's padding), so a block's padded
rows score -1e30 and never win.  The [Q, N] scores are never stored.

``coarse_blockmax`` launches the kernel for CUDA tensors (or raises) and
runs ``coarse_blockmax_plain`` for CPU tensors.  The kernel has two
variants, ``mma`` (bf16 rows, tensor-core products with the queries held in
registers, an asynchronous ring, one fma and one fmax per score) and ``simt`` (f32 FMAs;
f32 rows and every other width); ``select_plan.plan_coarse_blockmax`` picks
one from shapes, dtype and device properties, and ``variant=`` holds a call
to one.  Nothing falls back: a variant that cannot run raises.

``LAUNCHES`` counts kernel launches under "coarse_blockmax",
``VARIANT_LAUNCHES`` and ``DEVICE_LAUNCHES`` the same launches by variant
and by device, and ``LAST_PLAN`` is the plan of the last one.
The three dicts are registered with the port's recorder
(``utils/trace.py``), so a graph replay adds the launches its capture
counted.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from vfr_tpu_torch.ops.kernels.select_plan import (
    CoarsePlan,
    aligned16,
    check_variant,
    device_limits,
    hold_to_variant,
    plan_coarse_blockmax,
)
from vfr_tpu_torch.utils import trace

# The row alignment a coarse index is padded to at build time
# (``eval.coarse._row_alignment``); it is written into every coarse file, so
# it stays even though the CUDA kernel's tiling does not need it.
KERNEL_BLOCK_N = 16384

LAUNCHES = trace.register("coarse_kernel.launches",
                          {"coarse_blockmax": 0})
VARIANT_LAUNCHES = trace.register("coarse_kernel.variant_launches",
                                  {"mma": 0, "simt": 0})
# the same launches by device
DEVICE_LAUNCHES: Dict[str, int] = trace.register(
    "coarse_kernel.device_launches", {})
LAST_PLAN: Optional[CoarsePlan] = None

_QT = 64                        # queries per CTA (csrc/coarse_blockmax.cu)
_SMEM_LIMIT = 227 * 1024


def coarse_blockmax_plain(
    q_low: torch.Tensor, m_low: torch.Tensor, msq_low: torch.Tensor,
    block_rows: int = 128,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the full [Q, N] scores, rows
    padded to a ``block_rows`` multiple with score -1e30 (m = 0, msq =
    1e30), then the per-block max.  Returns sb [Q, G] f32, G = ceil(N /
    block_rows)."""
    Q = q_low.shape[0]
    N = m_low.shape[0]
    s = 2.0 * (q_low.to(m_low.dtype).float() @ m_low.float().T) \
        - msq_low.float()[None, :]
    pad = (-N) % block_rows
    if pad:
        s = F.pad(s, (0, pad), value=-1e30)
    return s.view(Q, -1, block_rows).amax(dim=-1)


def coarse_blockmax(
    q_low: torch.Tensor,      # [Q, d_c] f32
    m_low: torch.Tensor,      # [N, d_c] bf16 or f32
    msq_low: torch.Tensor,    # [N] f32 (1e30 on invalid rows)
    block_rows: int = 128,
    variant: str = "auto",
) -> torch.Tensor:
    """Per-block maxima of the coarse scores: sb [Q, G].  ``variant``
    ("auto", "mma", "simt") holds the call to one kernel variant ("mma"
    raises where the plan refuses it).  The kernel launches on the CUDA
    device of ``q_low``, which ``m_low`` and ``msq_low`` must share."""
    global LAST_PLAN
    Q, d = q_low.shape
    N = m_low.shape[0]
    check_variant(variant)
    if m_low.shape != (N, d) or msq_low.shape != (N,):
        raise ValueError(
            f"coarse_blockmax shapes: q_low {tuple(q_low.shape)} m_low "
            f"{tuple(m_low.shape)} msq_low {tuple(msq_low.shape)}")
    if block_rows not in (32, 64, 128):
        raise ValueError(f"block_rows must be 32, 64 or 128, got {block_rows}")
    if q_low.device.type == "cpu":
        return coarse_blockmax_plain(q_low, m_low, msq_low, block_rows)
    if q_low.device.type != "cuda" or m_low.device != q_low.device \
            or msq_low.device != q_low.device:
        raise ValueError(f"coarse_blockmax: q_low on {q_low.device}, m_low "
                         f"on {m_low.device}, msq_low on {msq_low.device}")
    if m_low.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"m_low dtype {m_low.dtype} not supported")
    if Q == 0 or N == 0:
        raise ValueError("coarse_blockmax: empty input")
    if variant == "simt":
        plan = CoarsePlan("simt", "asked for")
    else:
        plan = hold_to_variant(
            plan_coarse_blockmax(Q, N, d, block_rows, m_low.dtype,
                                 *device_limits(q_low.device)),
            variant, "coarse_blockmax")
    ld = -(-d // 4) * 4 + 4
    if plan.variant == "simt" \
            and ((_QT + block_rows) * ld + block_rows) * 4 > _SMEM_LIMIT:
        raise ValueError(f"coarse width d={d} too large for the kernel's "
                         "shared-memory tiles")
    from vfr_tpu_torch.kernels.build import check, load

    dev = q_low.device
    with torch.cuda.device(dev):
        q_low = aligned16(q_low.float().contiguous())
        m_low = aligned16(m_low.contiguous())
        msq_low = aligned16(msq_low.float().contiguous())
        out = torch.empty(Q, -(-N // block_rows), dtype=torch.float32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = load("coarse_blockmax")
        if plan.variant == "mma":
            err = lib.vfr_coarse_blockmax_mma(
                q_low.data_ptr(), m_low.data_ptr(), msq_low.data_ptr(),
                out.data_ptr(), Q, N, d, block_rows, plan.stages_per_cta,
                plan.grid[1], plan.smem_bytes, stream)
        else:
            err = lib.vfr_coarse_blockmax(
                q_low.data_ptr(), m_low.data_ptr(), msq_low.data_ptr(),
                out.data_ptr(), Q, N, d, block_rows,
                int(m_low.dtype == torch.bfloat16), stream)
    check(err, f"coarse_blockmax[{plan.variant}]")
    LAUNCHES["coarse_blockmax"] += 1
    VARIANT_LAUNCHES[plan.variant] += 1
    DEVICE_LAUNCHES[str(dev)] = DEVICE_LAUNCHES.get(str(dev), 0) + 1
    LAST_PLAN = plan
    return out
