"""Fused distance + strided-bin candidate selection through the hand-written
CUDA kernel (``csrc/distance_select.cu``), the port of the JAX package's
Pallas ``ops/pallas/select_kernel.py``.

Per query, every strided bin of the reference's ``block_n``-row tiles keeps
its smallest fused distance and that row; the caller finishes with an exact
top-k over the ``C = ceil(N / block_n) * block_n / bin_size`` candidates.
Bins are strided (bin b of a tile holds rows a*bins + b) so that a query's
best rows, which cluster in one video's consecutive rows, land in different
bins.

``distance_select`` launches the kernel for CUDA tensors (or raises) and
runs ``distance_select_plain`` for CPU tensors.  The kernel has two
variants, ``mma`` (tensor-core products, an asynchronous ring, the running
min on the accumulator registers) and ``simt`` (f32 FMAs; every shape);
``select_plan.plan_distance_select`` picks one from shapes, dtype and device
properties, and ``variant=`` holds a call to one.  Nothing falls back: a
variant that cannot run raises.

``LAUNCHES`` counts kernel launches under "distance_select",
``VARIANT_LAUNCHES`` and ``DEVICE_LAUNCHES`` the same launches by variant
and by device, and ``LAST_PLAN`` is the plan of the last one.  ``distance_select_split_tf32`` is the plain-PyTorch
emulation of the arithmetic the ``mma`` variant uses on an f32 index.
The three dicts are registered with the port's recorder
(``utils/trace.py``), so a graph replay adds the launches its capture
counted.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vfr_tpu_torch.ops.kernels.select_plan import (
    SelectPlan,
    aligned16,
    check_variant,
    device_limits,
    hold_to_variant,
    plan_distance_select,
)
from vfr_tpu_torch.utils import trace

LAUNCHES = trace.register("select_kernel.launches",
                          {"distance_select": 0})
VARIANT_LAUNCHES = trace.register("select_kernel.variant_launches",
                                  {"mma": 0, "simt": 0})
# the same launches by device
DEVICE_LAUNCHES: Dict[str, int] = trace.register(
    "select_kernel.device_launches", {})
LAST_PLAN: Optional[SelectPlan] = None


def distance_select_plain(
    q: torch.Tensor, m: torch.Tensor, m_sq: torch.Tensor,
    weights: Sequence[float], bin_size: int = 64, block_n: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: full fused distances
    ``sum_s w_s (|m_s|^2 + |q_s|^2 - 2 m_s . round(q_s))`` (q rounded to m's
    dtype, f32 products), N padded to ``block_n`` with |m|^2 = 1e30, then
    per-bin (min, lowest argmin).  Returns (vals [Q, C] f32, rows [Q, C]
    int32)."""
    S, Q, _ = q.shape
    N = m.shape[1]
    pad = (-N) % block_n
    mf = m.float()
    msq = m_sq.float()
    if pad:
        mf = F.pad(mf, (0, 0, 0, pad))
        msq = F.pad(msq, (0, pad), value=1e30)
    qr = q.to(m.dtype).float()
    D = None
    for s in range(S):
        qm = qr[s] @ mf[s].T
        q_sq = (q[s].float() * q[s].float()).sum(-1)[:, None]
        term = msq[s][None, :] + q_sq - 2.0 * qm
        D = weights[s] * term if D is None else D + weights[s] * term
    return _binned_min(D, bin_size, block_n)


def _binned_min(D: torch.Tensor, bin_size: int, block_n: int):
    """Per strided bin (min, lowest argmin as a row) of D [Q, tiles *
    block_n]."""
    Q = D.shape[0]
    bins = block_n // bin_size
    tiles = D.shape[1] // block_n
    vals, arg = D.reshape(Q, tiles, bin_size, bins).min(dim=2)
    dev = D.device
    rows = (torch.arange(tiles, device=dev)[None, :, None] * block_n
            + arg * bins + torch.arange(bins, device=dev)[None, None, :])
    return (vals.reshape(Q, tiles * bins),
            rows.reshape(Q, tiles * bins).to(torch.int32))


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero, by bit arithmetic: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a 32-bit operand: the low 13 mantissa
    bits ignored."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def distance_select_split_tf32(
    q: torch.Tensor, m: torch.Tensor, m_sq: torch.Tensor,
    weights: Sequence[float], bin_size: int = 64, block_n: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``mma`` variant's arithmetic on an f32 index, emulated in plain
    PyTorch: every operand is split x = hi + lo (hi = tf32(x), lo = x - hi
    read truncated to TF32), each 8-deep k-step adds lo*hi, hi*lo, hi*hi to
    one f32 accumulator in that order, the stream with the smaller |w| runs
    first and is scaled by w_first / w_second, and the result is
    ``(sum_s w_s msq_s) - 2 w_second acc + sum_s w_s |q_s|^2``.  The tensor
    core's own summation order inside a k-step is not modelled (an f32
    matmul of the 8-deep slices stands for it)."""
    S, Q, d = q.shape
    N = m.shape[1]
    w = [float(x) for x in weights]
    pad = (-N) % block_n
    q = q.float()
    mf = F.pad(m.float(), (0, 0, 0, pad))
    msq = F.pad(m_sq.float(), (0, pad), value=1e30)
    first = 1 if S == 2 and abs(w[0]) > abs(w[1]) else 0
    order = [0] if S == 1 else [first, 1 - first]
    w_second = w[order[-1]]
    ratio = (w[order[0]] / w_second if w_second != 0.0 else 0.0) \
        if S == 2 else 0.0
    acc = torch.zeros(Q, N + pad, dtype=torch.float32, device=q.device)
    for i, s in enumerate(order):
        qh = _tf32_round(q[s])
        ql = _tf32_trunc(q[s] - qh)
        mh = _tf32_round(mf[s])
        ml = _tf32_trunc(mf[s] - mh)
        for k in range(0, d, 8):
            ks = slice(k, k + 8)
            acc = acc + ql[:, ks] @ mh[:, ks].T
            acc = acc + qh[:, ks] @ ml[:, ks].T
            acc = acc + qh[:, ks] @ mh[:, ks].T
        if S == 2 and i == 0:
            acc = acc * ratio
    cr = w[0] * msq[0] if S == 1 else w[0] * msq[0] + w[1] * msq[1]
    cq = sum(w[s] * (q[s] * q[s]).sum(-1) for s in range(S))
    vals, rows = _binned_min(acc * (-2.0 * w_second) + cr[None, :], bin_size,
                             block_n)
    return vals + cq[:, None], rows


def distance_select(
    q: torch.Tensor,          # [S, Q, d] f32
    m: torch.Tensor,          # [S, N, d] f32 or bf16
    m_sq: torch.Tensor,       # [S, N] f32
    weights: Sequence[float],
    bin_size: int = 64,
    block_n: int = 4096,
    variant: str = "auto",
    a_splits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused distances + binned min-candidates: (cand_d [Q, C], cand_rows
    [Q, C]).  ``variant`` ("auto", "mma", "simt") holds the call to one
    kernel variant ("mma" raises where the plan refuses it); ``a_splits``
    forces the mma variant's number of a ranges per bin.  The kernel
    launches on the CUDA device of ``q``, which ``m`` and ``m_sq`` must
    share."""
    global LAST_PLAN
    S, Q, d = q.shape
    N = m.shape[1]
    weights = [float(w) for w in weights]
    check_variant(variant)
    if len(weights) != S or m.shape[0] != S or m.shape[2] != d \
            or m_sq.shape != (S, N):
        raise ValueError(
            f"distance_select shapes: q {tuple(q.shape)} m {tuple(m.shape)} "
            f"m_sq {tuple(m_sq.shape)} weights {len(weights)}")
    if bin_size < 1 or block_n % bin_size:
        raise ValueError(f"block_n {block_n} is not a multiple of bin_size "
                         f"{bin_size}")
    if q.device.type == "cpu":
        return distance_select_plain(q, m, m_sq, weights, bin_size, block_n)
    if q.device.type != "cuda" or m.device != q.device \
            or m_sq.device != q.device:
        raise ValueError(f"distance_select: q on {q.device}, m on "
                         f"{m.device}, m_sq on {m_sq.device}")
    if S not in (1, 2):
        raise ValueError(f"distance_select kernel takes 1 or 2 streams, "
                         f"got {S}")
    if m.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"index dtype {m.dtype} not supported")
    if Q == 0 or N == 0:
        raise ValueError("distance_select: empty input")
    if variant == "simt":
        plan = SelectPlan("simt", "asked for")
    else:
        plan = hold_to_variant(
            plan_distance_select(S, Q, N, d, bin_size, block_n, m.dtype,
                                 *device_limits(q.device), a_splits=a_splits),
            variant, "distance_select")
    if plan.variant == "simt" \
            and 4 * (S * d * 64 + S * 64 + 32 * 65) > 227 * 1024:
        raise ValueError(f"embedding width d={d} too large for the kernel's "
                         "resident query tile")
    from vfr_tpu_torch.kernels.build import check, load

    dev = q.device
    with torch.cuda.device(dev):
        q = aligned16(q.float().contiguous())
        m = aligned16(m.contiguous())
        m_sq = aligned16(m_sq.float().contiguous())
        bins = block_n // bin_size
        tiles = -(-N // block_n)
        C = tiles * bins
        vals = torch.empty(Q, C, dtype=torch.float32, device=dev)
        rows = torch.empty(Q, C, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        w1 = weights[1] if S == 2 else 0.0
        bf16 = int(m.dtype == torch.bfloat16)
        lib = load("distance_select")
        if plan.variant == "mma":
            cr = torch.empty(tiles * block_n, dtype=torch.float32, device=dev)
            cq = torch.empty(Q, dtype=torch.float32, device=dev)
            # the kernel's bf16 copy of q, zero padded to whole ring chunks
            qb_ptr = 0
            if bf16:
                qb = torch.empty(S, Q, -(-d // plan.chunk) * plan.chunk,
                                 dtype=torch.bfloat16, device=dev)
                qb_ptr = qb.data_ptr()
            if plan.a_splits > 1:
                pv = torch.empty(plan.a_splits, Q, C, dtype=torch.float32,
                                 device=dev)
                pr = torch.empty(plan.a_splits, Q, C, dtype=torch.int32,
                                 device=dev)
                pv_ptr, pr_ptr = pv.data_ptr(), pr.data_ptr()
            else:
                pv_ptr = pr_ptr = 0
            err = lib.vfr_distance_select_mma(
                q.data_ptr(), m.data_ptr(), m_sq.data_ptr(), weights[0], w1,
                S, Q, N, d, bin_size, block_n, bf16, plan.a_splits,
                plan.a_per_split, plan.smem_bytes, cr.data_ptr(),
                cq.data_ptr(), qb_ptr, pv_ptr, pr_ptr, vals.data_ptr(),
                rows.data_ptr(), stream)
        else:
            err = lib.vfr_distance_select(
                q.data_ptr(), m.data_ptr(), m_sq.data_ptr(), weights[0], w1,
                S, Q, N, d, bin_size, block_n, bf16, vals.data_ptr(),
                rows.data_ptr(), stream)
    check(err, f"distance_select[{plan.variant}]")
    LAUNCHES["distance_select"] += 1
    VARIANT_LAUNCHES[plan.variant] += 1
    DEVICE_LAUNCHES[str(dev)] = DEVICE_LAUNCHES.get(str(dev), 0) + 1
    LAST_PLAN = plan
    return vals, rows
