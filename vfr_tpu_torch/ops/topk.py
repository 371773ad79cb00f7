"""Top-k selection with ``jax.lax.top_k``'s order: largest value first,
equal values by lowest index, and at the k-th place the lowest-index rows
of the tied value enter (``torch.topk`` leaves both unspecified).

``"approx"`` is exact too: that is what the JAX package's
``lax.approx_max_k`` does off the TPU, and the port has no counterpart of
the TPU's PartialReduce yet (a known difference, recorded in ROADMAP.md).
``approx_recall`` is accepted and unused.
"""

from __future__ import annotations

from typing import Tuple

import torch

# rows up to this long (candidate lists, coarse blocks: 16,512 at 2.1M
# rows) select by one torch.topk over a 64-bit (value, -index) key: no host
# sync, a few cheap launches; a longer row (a corpus) would pay for the
# key's bytes, and takes torch.topk and the tie check instead
KEY_MAX = 32768
# row chunk of the tie search on long rows: one count per chunk over the
# row, a prefix scan only inside the chunks that hold the tied rows
TIE_CHUNK = 2048


def topk_lowest_index(x: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest-k along the last axis: (values, indices), ordered by (value
    descending, index ascending), the tied rows at the k-th place taken
    lowest index first.

    A row of at most ``KEY_MAX`` selects by ``torch.topk`` over a unique
    int64 key, the value's order-preserving int32 bits above the reversed
    index (``_key_topk``).  A longer one takes ``torch.topk`` of k + 1 and
    one host sync to learn whether a tie matters: at the k-th place (the
    (k+1)-th value equals the k-th, so a row holding it was left out) the
    positions holding the k-th value get the lowest-index rows equal to it
    (``_lowest_tied``); any tie among the k then puts them in order by a
    stable sort of [.., k].  Without ties it costs one ``torch.topk`` and
    the sync."""
    N = x.shape[-1]
    k = min(k, N)
    if N <= KEY_MAX:
        return _key_topk(x, k)
    vals, idx = torch.topk(x, min(k + 1, N), dim=-1, largest=True,
                           sorted=True)
    if k == 0:
        return vals[..., :0], idx[..., :0]
    kth = vals[..., k - 1 : k]
    left_out = ((vals[..., k:] == kth).any() if N > k
                else torch.zeros((), dtype=torch.bool, device=x.device))
    vals, idx = vals[..., :k], idx[..., :k]
    inside = (vals[..., 1:] == vals[..., :-1]).any()
    left_out, inside = torch.stack([left_out, inside]).tolist()
    if left_out:
        idx = _lowest_tied(x, kth, (vals == kth).sum(-1, keepdim=True), idx)
    if left_out or inside:
        idx, _ = torch.sort(idx, dim=-1)
        vals = torch.gather(x, -1, idx)
        vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
        idx = torch.gather(idx, -1, order)
    return vals, idx


def _key_topk(x: torch.Tensor, k: int):
    """Top-k by (value descending, index ascending) as one ``torch.topk``
    over int64 keys ``ord(x) * 2^32 + (N - 1 - index)``, where ``ord``
    maps f32 bits to an int32 of the same order (negative values' magnitude
    bits flipped)."""
    N = x.shape[-1]
    bits = x.float().contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    rev = N - 1 - torch.arange(N, device=x.device, dtype=torch.int64)
    key = ordered.to(torch.int64) * (1 << 32) + rev
    idx = torch.topk(key, k, dim=-1, largest=True, sorted=True).indices
    return torch.gather(x, -1, idx), idx


def _lowest_tied(x, kth, n_tied, idx):
    """``idx`` [.., k] with its last ``n_tied`` positions (those holding
    the k-th value) replaced by the lowest-index rows of ``x`` equal to
    ``kth``: count them per chunk of ``TIE_CHUNK`` columns, find each
    rank's chunk by ``searchsorted`` over the running counts, then its
    offset by a prefix scan of that chunk alone."""
    lead, N = x.shape[:-1], x.shape[-1]
    k = idx.shape[-1]
    rank = torch.arange(k, device=x.device) - (k - n_tied) + 1  # 1-based
    C = min(TIE_CHUNK, N)
    full = N // C * C
    eq = x == kth                                          # [.., N]
    per = [eq[..., :full].reshape(*lead, -1, C).sum(-1, dtype=torch.int32)]
    if full < N:                                           # the short tail
        per.append(eq[..., full:].sum(-1, keepdim=True, dtype=torch.int32))
    per = torch.cat(per, -1) if len(per) > 1 else per[0]   # [.., G]
    upto = torch.cumsum(per, -1, dtype=torch.int32)
    r = rank.clamp(min=1).to(torch.int32).expand(*lead, k).contiguous()
    g = torch.searchsorted(upto, r).clamp(max=per.shape[-1] - 1)
    within = r - (torch.gather(upto, -1, g) - torch.gather(per, -1, g))
    pos = g[..., None] * C + torch.arange(C, device=x.device)  # [.., k, C]
    chunk = torch.gather(eq, -1, pos.clamp(max=N - 1).view(*lead, k * C))
    chunk = chunk.view(*lead, k, C) & (pos < N)
    inner = torch.searchsorted(torch.cumsum(chunk, -1, dtype=torch.int32),
                               within[..., None]).squeeze(-1)
    return torch.where(rank >= 1, g * C + inner, idx)


def top_k_select(
    x: torch.Tensor, k: int, method: str = "exact", recall: float = 0.95
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest-k along the last axis: (values, indices), largest first,
    ties by lowest index."""
    if method not in ("exact", "approx"):
        raise ValueError(f"unknown topk method {method!r}")
    return topk_lowest_index(x, k)
