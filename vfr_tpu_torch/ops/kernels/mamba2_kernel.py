"""The Mamba-2 mixer between its two GEMMs through one hand-written CUDA
kernel (``csrc/mamba2_scan.cu``, ``mamba2_rnn_scan``): from in_proj's
product zxd to out_proj's operand, the causal conv, SiLU, dt's softplus,
the SSD scan with its D skip and the gated group RMSNorm fused, nothing of
it through device memory.  One block a (sequence, head), a group's heads
one thread-block cluster; the scan in its matrix form over chunks of 32
tokens, in f32.  It replaces no Pallas kernel (the JAX package has no
decoder-LM tower).

The kernel's name marks it a recurrence (``rnn_``) for one reason: the
benchmark's trace reader (``vfrbench/trace.py::replays``) finds a serving
batch's graph replay by such a kernel, and ``mfu.batch`` of the Nemotron-H
cell reads nothing without one.  It takes a plain name once that reader
counts replays by the port's stage maps.

``mamba2_chain`` launches it on the CUDA device of its inputs, runs
``mamba2_chain_plain`` (the same chain as PyTorch passes: ``causal_conv``,
SiLU, softplus, ``ssd_scan_plain``, ``gated_rmsnorm``) on CPU tensors, or
raises; the plain version is also what the kernel is held to on the card.
``check_shapes`` refuses, without a card, the shapes the kernel does not
take.  ``LAUNCHES`` counts the launches, registered with the port's
recorder (``utils/trace.py``), so a graph replay adds what its capture
counted.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vfr_tpu_torch.ops.mamba2 import causal_conv, gated_rmsnorm
from vfr_tpu_torch.utils import trace

LAUNCHES = trace.register("mamba2_kernel.launches", {"mamba2_rnn_scan": 0})
THREADS = 128       # csrc/mamba2_scan.cu: kThreads, the widest head
CLUSTER_MAX = 8     # kMaxCluster: the portable thread-block cluster
TAPS_MAX = 8        # kMaxTaps
CHUNK = 32          # kChunk: tokens a chunk of the matrix form
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def ssd_scan_plain(x, dt, A, Bm, Cm, D, lengths) -> torch.Tensor:
    """y [B, T, H, P] f32 of x [B, T, H, P], dt [B, T, H], A, D [H] and
    Bm, Cm [B, T, G, N] (head h reads group h // (H / G)):
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t from
    a zero state, 0 past each sequence's length."""
    Bsz, T, H, P = x.shape
    rep = H // Bm.shape[2]
    x, dt = x.float(), dt.float()
    Bh = Bm.float().repeat_interleave(rep, dim=2)            # [B, T, H, N]
    Ch = Cm.float().repeat_interleave(rep, dim=2)
    h = x.new_zeros(Bsz, H, P, Bh.shape[-1])
    ys = []
    for t in range(T):
        a = torch.exp(dt[:, t] * A.float())                  # [B, H]
        h = (h * a[..., None, None]
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, 1) + x * D.float()[:, None]
    live = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    return torch.where(live[..., None, None], y, 0.0)


def widths(conv_w, dt_bias, norm_w, groups):
    """(H, P, N, K) of the chain's operands: H from dt_bias, P from
    gate_norm's H P, N from the conv's H P + 2 G N channels."""
    H, di = dt_bias.shape[0], norm_w.shape[0]
    conv, K = conv_w.shape
    if di % H or (conv - di) % (2 * groups):
        raise ValueError(f"mamba2_chain: gate_norm {di} wide over {H} heads,"
                         f" conv {conv} channels over {groups} groups")
    return H, di // H, (conv - di) // (2 * groups), K


def check_shapes(ld: int, H: int, P: int, G: int, N: int, K: int) -> None:
    """Raise ValueError unless the kernel takes a zxd of ``ld`` columns
    over H heads of P, G groups of state N and K conv taps."""
    bad = []
    if G <= 0 or H % G:
        bad.append("H a multiple of G")
    elif H // G > CLUSTER_MAX:
        bad.append(f"at most {CLUSTER_MAX} heads a group (a group's heads "
                   f"are one thread-block cluster)")
    elif N % (H // G):
        bad.append("N a multiple of H / G")
    if P < 8 or P > THREADS or P & (P - 1):
        bad.append(f"P a power of two in 8..{THREADS}")
    if not 1 <= K <= TAPS_MAX:
        bad.append(f"1..{TAPS_MAX} conv taps")
    want = 2 * H * P + 2 * G * N + H
    if ld < want:
        bad.append(f"zxd's {ld} columns at least z, xBC and dt's {want}")
    if bad:
        raise ValueError("mamba2_rnn_scan takes " + "; ".join(bad) +
                         f" (H={H}, P={P}, G={G}, N={N}, K={K}, ld={ld})")


def mamba2_chain_plain(zxd, lengths, conv_w, conv_b, dt_bias, A_log, D,
                       norm_w, groups: int, eps: float) -> torch.Tensor:
    """``mamba2_chain`` as PyTorch passes, in f32 to gate_norm's dtype."""
    Bsz, T, _ = zxd.shape
    H, P, N, _ = widths(conv_w, dt_bias, norm_w, groups)
    di, gn = H * P, groups * N
    conv = di + 2 * gn
    z = zxd[..., :di]
    xbc = F.silu(causal_conv(zxd[..., di:di + conv], conv_w, conv_b))
    dt = F.softplus(zxd[..., di + conv:di + conv + H].float() + dt_bias)
    y = ssd_scan_plain(xbc[..., :di].reshape(Bsz, T, H, P), dt,
                       -torch.exp(A_log),
                       xbc[..., di:di + gn].reshape(Bsz, T, groups, N),
                       xbc[..., di + gn:].reshape(Bsz, T, groups, N), D,
                       lengths)
    return gated_rmsnorm(y.reshape(Bsz, T, di), z, norm_w, di // groups, eps)


def mamba2_chain(zxd: torch.Tensor, lengths: torch.Tensor,
                 conv_w: torch.Tensor, conv_b: Optional[torch.Tensor],
                 dt_bias: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                 norm_w: torch.Tensor, groups: int,
                 eps: float) -> torch.Tensor:
    """out_proj's operand y [B, T, H P] at gate_norm's dtype from in_proj's
    product zxd [B, T, ld]: z, xBC and dt as its columns [0, H P),
    [H P, 2 H P + 2 G N) and the next H; xBC through the causal conv
    (conv_w [conv, K], conv_b or None) and SiLU; dt = softplus(dt +
    dt_bias); the SSD scan with A = -exp(A_log) and the D skip; y silu(z)
    normed over each group's H P / G channels, times gate_norm; 0 past each
    of ``lengths``.  f32 throughout, one rounding at the end."""
    if zxd.device.type == "cpu":
        return mamba2_chain_plain(zxd, lengths, conv_w, conv_b, dt_bias,
                                  A_log, D, norm_w, groups, eps)
    if zxd.device.type != "cuda":
        raise ValueError(f"mamba2_chain: inputs on {zxd.device}")
    Bsz, T, ld = zxd.shape
    H, P, N, K = widths(conv_w, dt_bias, norm_w, groups)
    check_shapes(ld, H, P, groups, N, K)
    dev, dtype = zxd.device, zxd.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"mamba2_chain: zxd at {dtype}, the kernel takes "
                         f"bf16 or f32")
    leaves = {"zxd": zxd, "conv_w": conv_w, "conv_b": conv_b,
              "gate_norm": norm_w}
    for name, t in leaves.items():
        if t is not None and (t.dtype != dtype or not t.is_contiguous()
                              or t.device != dev):
            raise ValueError(f"mamba2_chain: {name} must be contiguous "
                             f"{dtype} on {dev}")
    for name, t in (("dt_bias", dt_bias), ("A_log", A_log), ("D", D)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != dev:
            raise ValueError(f"mamba2_chain: {name} must be contiguous f32 "
                             f"on {dev}")
    from vfr_tpu_torch.kernels.build import check, load

    lens = lengths.to(device=dev, dtype=torch.int64).contiguous()
    y = torch.empty(Bsz, T, H * P, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = load("mamba2_scan").vfr_mamba2_chain(
            zxd.data_ptr(), conv_w.data_ptr(),
            None if conv_b is None else conv_b.data_ptr(),
            dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(),
            norm_w.data_ptr(), lens.data_ptr(), y.data_ptr(), Bsz, T, ld, H,
            P, groups, N, K, _DTYPES[dtype], eps,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "mamba2_rnn_scan")
    LAUNCHES["mamba2_rnn_scan"] += 1
    return y
