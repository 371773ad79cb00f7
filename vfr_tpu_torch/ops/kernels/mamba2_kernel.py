"""The Mamba-2 SSD scan through the hand-written CUDA kernel
(``csrc/mamba2_scan.cu``, ``mamba2_rnn_scan``): the recurrent form, one
block a (sequence, head), the state in registers.  It replaces no Pallas
kernel (the JAX package has no decoder-LM tower).

The kernel's name marks it a recurrence (``rnn_``) for one reason: the
benchmark's trace reader (``vfrbench/trace.py::replays``) finds a serving
batch's graph replay by such a kernel, and ``mfu.batch`` of the Nemotron-H
cell reads nothing without one.  Renaming the kernel, or folding the scan
into another kernel, silences that metric; once the reader counts replays
by the port's stage maps, the kernel takes a plain name (``mamba2_scan``).

``ssd_scan`` launches it on the CUDA device of its inputs, or raises;
``ssd_scan_plain`` is the same recurrence in PyTorch, token by token, for
CPU tensors and for holding the kernel against on the card.  ``LAUNCHES``
counts the launches, registered with the port's recorder
(``utils/trace.py``), so a graph replay adds what its capture counted.
"""

from __future__ import annotations

import torch

from vfr_tpu_torch.utils import trace

LAUNCHES = trace.register("mamba2_kernel.launches", {"mamba2_rnn_scan": 0})
THREADS = 256       # csrc/mamba2_scan.cu: kThreads


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


def ssd_scan(xbc: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             D: torch.Tensor, lengths: torch.Tensor, H: int, P: int, G: int,
             N: int) -> torch.Tensor:
    """``ssd_scan_plain`` of x, B, C read as the column ranges [0, H P),
    [H P, H P + G N) and [H P + G N, H P + 2 G N) of xbc [B, T, ld] (f32,
    contiguous), dt [B, T, H] f32, A, D [H] f32, lengths [B]."""
    Bsz, T, ld = xbc.shape
    if ld < H * P + 2 * G * N:
        raise ValueError(f"ssd_scan: {ld} columns, want {H * P + 2 * G * N}")
    if xbc.device.type == "cpu":
        di = H * P
        return ssd_scan_plain(
            xbc[..., :di].reshape(Bsz, T, H, P), dt, A,
            xbc[..., di:di + G * N].reshape(Bsz, T, G, N),
            xbc[..., di + G * N:di + 2 * G * N].reshape(Bsz, T, G, N), D,
            lengths)
    if xbc.device.type != "cuda":
        raise ValueError(f"ssd_scan: inputs on {xbc.device}")
    for name, t in (("xbc", xbc), ("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous f32")
    if (P < 8 or P > THREADS or P & (P - 1) or N % (THREADS // P)
            or N // (THREADS // P) > 64 or H % G):
        raise ValueError(f"ssd_scan: the kernel takes P a power of two in "
                         f"8..{THREADS}, N a multiple of {THREADS} / P with "
                         f"at most 64 states a thread, H a multiple of G; "
                         f"got P={P}, N={N}, H={H}, G={G}")
    from vfr_tpu_torch.kernels.build import check, load

    dev = xbc.device
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    y = torch.empty(Bsz, T, H, P, dtype=torch.float32, device=dev)
    base, f = xbc.data_ptr(), xbc.element_size()
    with torch.cuda.device(dev):
        err = load("mamba2_scan").vfr_mamba2_scan(
            base, base + H * P * f, base + (H * P + G * N) * f,
            dt.data_ptr(), A.data_ptr(), D.data_ptr(), lens.data_ptr(),
            y.data_ptr(), Bsz, T, H, P, G, N, ld,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "mamba2_rnn_scan")
    LAUNCHES["mamba2_rnn_scan"] += 1
    return y
