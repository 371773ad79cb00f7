"""The sparse expert layer of a Nemotron-H MoE block: DeepSeek-V3's router
(arXiv:2412.19437) over non-gated relu^2 experts, beside one shared expert.

Routing, in f32 from the block's normed input h: scores = sigmoid(h W_r);
the k experts of the largest scores + the correction bias (the bias only
chooses; ``n_group`` = ``topk_group`` = 1 leaves no group stage); each
chosen expert weighs its own score, normalised over the k (+1e-20) when
``norm_topk_prob``, times ``routed_scaling_factor``.  An expert is
down(relu(up(x))^2); the weighted sum of a token's k experts is taken in
f32 and rounded to h's dtype, and the shared expert's output added to it.

The routed products run at the experts' dtype, grouped by expert
(``route_experts``): on the card one grouped product up and one down over
the routings sorted by expert (``torch._grouped_mm``: bf16 operands, the
groups' ends as a device tensor, so that a batch is captured once in a
CUDA graph whatever its routing); on the CPU a loop over the experts.
Each call counts its route in the recorder (``moe.grouped``,
``moe.loop``).  ``live`` [M] leaves a token (right padding) out of the
experts: its routed sum is 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vfr_tpu_torch.utils import trace


def route(h: torch.Tensor, w_router: torch.Tensor, bias: torch.Tensor,
          k: int, scale: float, normalize: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts [M, k] int64, weights [M, k] f32) of tokens h [M, D]."""
    scores = torch.sigmoid(h.float() @ w_router.float())
    idx = torch.topk(scores + bias.float(), k, dim=-1).indices
    w = scores.gather(1, idx)
    if normalize:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scale


def relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x).square()


def route_experts(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                  up: torch.Tensor, down: torch.Tensor,
                  live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_j w[:, j] down_e(relu(up_e(h))^2) at e = idx[:, j]: [M, D] f32,
    for experts stacked up [E, D, F], down [E, F, D]."""
    M, k = idx.shape
    E = up.shape[0]
    e = idx.reshape(-1)
    if live is not None:          # a padding token's routings sort last
        e = torch.where(live.repeat_interleave(k), e, E)
    order = torch.argsort(e, stable=True)
    xs = h.index_select(0, order // k).to(up.dtype)
    if h.device.type == "cpu":
        trace.count("moe.loop")
        y = _loop(xs, e.index_select(0, order), up, down)
    else:
        trace.count("moe.grouped")
        y = _grouped(xs, e, up, down)
    # back to (token, slot) order.  A padding routing reads the first
    # sorted row (a live routing's whenever the batch has a live token: the
    # grouped products leave the padding's rows unwritten) at weight 0.
    at = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    valid = e < E
    at = torch.where(valid, at, 0)
    w = torch.where(valid.view(M, k), w.float(), 0.0)
    return (y.index_select(0, at).view(M, k, -1) * w.view(M, k, 1)).sum(1)


def _grouped(xs, e, up, down):
    """Both products over the sorted routings as grouped products; the
    routings past the last expert's end (padding) come back unwritten."""
    E = up.shape[0]
    counts = torch.zeros(E + 1, dtype=torch.int64, device=e.device)
    counts.scatter_add_(0, e, torch.ones_like(e))
    ends = torch.cumsum(counts[:E], 0).to(torch.int32)
    a = relu2(torch._grouped_mm(xs, up, offs=ends))
    return torch._grouped_mm(a, down, offs=ends)


def _loop(xs, es, up, down):
    """Both products expert by expert over the sorted routings."""
    E = up.shape[0]
    counts = torch.bincount(es, minlength=E + 1).tolist()
    y = xs.new_zeros(xs.shape[0], down.shape[2])
    start = 0
    for ex in range(E):
        n = counts[ex]
        if n:
            part = xs[start:start + n]
            y[start:start + n] = relu2(part @ up[ex]) @ down[ex]
        start += n
    return y


def moe_block(h: torch.Tensor, p: Dict[str, torch.Tensor], k: int,
              scale: float, normalize: bool,
              live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MoE mixer of normed tokens h [M, D]: the routed experts' sum at
    h's dtype plus the shared expert (``p``: ``router`` [D, E] f32,
    ``e_bias`` [E], ``up``, ``down``, ``shared_up`` [D, Fs],
    ``shared_down`` [Fs, D])."""
    idx, w = route(h, p["router"], p["e_bias"], k, scale, normalize)
    routed = route_experts(h, idx, w, p["up"], p["down"], live)
    shared = relu2(h @ p["shared_up"]) @ p["shared_down"]
    return routed.to(h.dtype) + shared
