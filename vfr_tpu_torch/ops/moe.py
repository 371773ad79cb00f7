"""The sparse expert layer of a decoder LM's MoE block: DeepSeek-V3's
router (arXiv:2412.19437) over experts of one of two forms, beside shared
experts (Nemotron-H's and Kimi Linear's MoE blocks).

Routing, in f32 from the block's normed input h: scores = sigmoid(h W_r);
the k experts of the largest scores + the correction bias (the bias only
chooses; one expert group leaves no group stage); each chosen expert
weighs its own score, normalised over the k (+1e-20) when
``norm_topk_prob``, times ``routed_scaling_factor``.  An expert is, by
``act``, down(relu(up x)^2) ("relu2", Nemotron-H: ``up`` [E, D, F]) or
down(silu(gate x) * up x) ("swiglu", Kimi Linear: gate and up stacked as
one ``up`` [E, D, 2F], gate first, so that both are one grouped product).
The weighted sum of a token's k experts is taken in f32 and rounded to
h's dtype, and the shared expert's output added to it.

An expert share (``held`` = (first id, count)): the layer holds experts
first .. first + count - 1 of the router's, as one card of an
expert-parallel deployment does.  It routes over all of them and weighs
each choice as above, over all k chosen; a routing to an expert it does
not hold drops out as a padding token's does, so that the layer returns
its own experts' part of the routed sum.  ``held`` None holds every
expert (``up`` as wide as the router), and runs no step of the share.

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
import torch.nn.functional as F

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


def swiglu(x: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of x = [gate | up] (the last dim split in two), in
    f32, at x's dtype."""
    g, u = x.float().chunk(2, dim=-1)
    return (F.silu(g) * u).to(x.dtype)


ACTS = {"relu2": relu2, "swiglu": swiglu}


def route_experts(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                  up: torch.Tensor, down: torch.Tensor,
                  live: Optional[torch.Tensor] = None, act: str = "relu2",
                  held: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """sum_j w[:, j] down_e(act(up_e h)) at e = idx[:, j]: [M, D] f32, for
    experts stacked up [E, D, F] (relu2) or [E, D, 2F] (swiglu), down
    [E, F, D]; with ``held`` = (first, E) over the routings to experts
    first .. first + E - 1 alone (expert e stacked at e - first)."""
    M, k = idx.shape
    E = up.shape[0]
    e = idx.reshape(-1)
    keep = None if live is None else live.repeat_interleave(k)
    if held is not None:          # a routing to an expert held elsewhere
        first, count = held
        if count != E:
            raise ValueError(f"held {held}: {E} experts stacked")
        e = e - first
        mine = (e >= 0) & (e < E)
        keep = mine if keep is None else keep & mine
    if keep is not None:          # a dropped routing sorts last
        e = torch.where(keep, e, E)
    order = torch.argsort(e, stable=True)
    xs = h.index_select(0, order // k).to(up.dtype)
    fn = ACTS[act]
    if h.device.type == "cpu":
        trace.count("moe.loop")
        y = _loop(xs, e.index_select(0, order), up, down, fn)
    else:
        trace.count("moe.grouped")
        y = _grouped(xs, e, up, down, fn)
    # back to (token, slot) order.  A dropped routing reads the first
    # sorted row (a live routing's whenever the batch has a live token: the
    # grouped products leave the dropped rows unwritten) at weight 0;
    # under a share the batch may route nothing here, so the row read is
    # zeroed as well.
    at = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    valid = e < E
    at = torch.where(valid, at, 0)
    w = torch.where(valid.view(M, k), w.float(), 0.0)
    rows = y.index_select(0, at)
    if held is not None:
        rows = torch.where(valid[:, None], rows, 0.0)
    # rebound, so that the gathered rows are freed before the sum
    rows = rows.view(M, k, -1) * w.view(M, k, 1)
    return rows.sum(1)


def _grouped(xs, e, up, down, fn):
    """Both products over the sorted routings as grouped products; the
    routings past the last expert's end (dropped) come back unwritten."""
    E = up.shape[0]
    counts = torch.zeros(E + 1, dtype=torch.int64, device=e.device)
    counts.scatter_add_(0, e, torch.ones_like(e))
    ends = torch.cumsum(counts[:E], 0).to(torch.int32)
    a = fn(torch._grouped_mm(xs, up, offs=ends))
    return torch._grouped_mm(a, down, offs=ends)


def _loop(xs, es, up, down, fn):
    """Both products expert by expert over the sorted routings."""
    E = up.shape[0]
    counts = torch.bincount(es, minlength=E + 1).tolist()
    y = xs.new_zeros(xs.shape[0], down.shape[2])
    start = 0
    for ex in range(E):
        n = counts[ex]
        if n:
            part = xs[start:start + n]
            y[start:start + n] = fn(part @ up[ex]) @ down[ex]
        start += n
    return y


def moe_block(h: torch.Tensor, p: Dict[str, torch.Tensor], k: int,
              scale: float, normalize: bool,
              live: Optional[torch.Tensor] = None, act: str = "relu2",
              held: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The MoE mixer of normed tokens h [M, D]: the routed experts' sum at
    h's dtype plus the shared expert (``p``: ``router`` [D, E] f32,
    ``e_bias`` [E], ``up``, ``down``, ``shared_up`` [D, Fs] or [D, 2Fs]
    by ``act``, ``shared_down`` [Fs, D]); under ``held`` the routed sum of
    the held experts alone."""
    idx, w = route(h, p["router"], p["e_bias"], k, scale, normalize)
    routed = route_experts(h, idx, w, p["up"], p["down"], live, act, held)
    shared = ACTS[act](h @ p["shared_up"]) @ p["shared_down"]
    return routed.to(h.dtype) + shared
