"""The elementwise operations of a Mamba-2 mixer (Dao & Gu 2024,
"Transformers are SSMs", arXiv:2405.21060), as the published Nemotron-H
mixer runs them: the causal depthwise convolution and the gated group
RMSNorm, in f32.  They are the plain version's passes
(``ops/kernels/mamba2_kernel.py::mamba2_chain_plain``, with the SSD scan
between them); on the card one kernel fuses them with the scan.  Right
padding is inert: every output reads its own and earlier tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal convolution of x [B, T, C] with w [C, K] (and bias
    b [C]): y[t] = b + sum_j w[:, j] x[t - (K - 1) + j], zeros before the
    first token (the published ``conv1d`` with ``padding=K - 1``, cut to
    T), in f32."""
    K = w.shape[1]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    wf = w.float()
    y = xp[:, K - 1:] * wf[:, K - 1]
    if b is not None:
        y += b.float()
    for j in range(K - 1):
        y.addcmul_(xp[:, j:j + T], wf[:, j])
    return y


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  group: int, eps: float) -> torch.Tensor:
    """The mixer's output norm: y * silu(z), each group of ``group``
    channels scaled to unit RMS, times w; in f32, returned at w's dtype."""
    h = y.float() * F.silu(z.float())
    hg = h.reshape(*h.shape[:-1], h.shape[-1] // group, group)
    hg = hg * torch.rsqrt(hg.pow(2).mean(-1, keepdim=True) + eps)
    return (hg.reshape(h.shape) * w.float()).to(w.dtype)
