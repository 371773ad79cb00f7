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
runs ``distance_select_plain`` for CPU tensors.  ``LAUNCHES`` counts kernel
launches under "distance_select".
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

LAUNCHES = {"distance_select": 0}


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
    bins = block_n // bin_size
    tiles = D.shape[1] // block_n
    vals, arg = D.reshape(Q, tiles, bin_size, bins).min(dim=2)
    dev = q.device
    rows = (torch.arange(tiles, device=dev)[None, :, None] * block_n
            + arg * bins + torch.arange(bins, device=dev)[None, None, :])
    return (vals.reshape(Q, tiles * bins),
            rows.reshape(Q, tiles * bins).to(torch.int32))


def distance_select(
    q: torch.Tensor,          # [S, Q, d] f32
    m: torch.Tensor,          # [S, N, d] f32 or bf16
    m_sq: torch.Tensor,       # [S, N] f32
    weights: Sequence[float],
    bin_size: int = 64,
    block_n: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused distances + binned min-candidates: (cand_d [Q, C], cand_rows
    [Q, C])."""
    S, Q, d = q.shape
    N = m.shape[1]
    weights = [float(w) for w in weights]
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
    if 4 * (S * d * 64 + S * 64 + 32 * 65) > 227 * 1024:
        raise ValueError(f"embedding width d={d} too large for the kernel's "
                         "resident query tile")
    from vfr_tpu_torch.kernels.build import check, load

    q = q.float().contiguous()
    m = m.contiguous()
    m_sq = m_sq.float().contiguous()
    bins = block_n // bin_size
    C = -(-N // block_n) * bins
    vals = torch.empty(Q, C, dtype=torch.float32, device=q.device)
    rows = torch.empty(Q, C, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = load("distance_select").vfr_distance_select(
        q.data_ptr(), m.data_ptr(), m_sq.data_ptr(), weights[0],
        weights[1] if S == 2 else 0.0, S, Q, N, d, bin_size, block_n,
        int(m.dtype == torch.bfloat16), vals.data_ptr(), rows.data_ptr(),
        stream)
    check(err, "distance_select")
    LAUNCHES["distance_select"] += 1
    return vals, rows
