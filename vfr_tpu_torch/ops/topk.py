"""Top-k selection with ``jax.lax.top_k``'s order: largest value first,
equal values by lowest index, and at the k-th place the lowest-index rows
of the tied value enter (``torch.topk`` leaves both unspecified).  Values
compare in the total order of their f32 bits (``ordered_bits``), as
``jax.lax.top_k`` sorts them: -NaN below -inf, -0.0 below +0.0, +NaN
above +inf, and NaNs with the same bits equal.

``"approx"`` is exact too: that is what the JAX package's
``lax.approx_max_k`` does off the TPU, and the port has no counterpart of
the TPU's PartialReduce yet (a known difference, recorded in ROADMAP.md).
``approx_recall`` is accepted and unused.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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
    int64 key, the value's ``ordered_bits`` above the reversed index
    (``_key_topk``).  A longer one takes ``torch.topk`` of k + 1 and one
    host sync to learn whether a tie matters: at the k-th place (the
    (k+1)-th value equals the k-th, so a row holding it was left out) the
    positions holding the k-th value get the lowest-index rows equal to it
    (``_lowest_tied``); any tie among the k then puts them in order by a
    stable sort of [.., k].  Float order and equality are the total order
    everywhere but at NaNs and zeros, so the same sync also says whether
    one stands among the k + 1 (``torch.topk`` ranks every NaN first):
    then the select is redone on ``ordered_bits`` (``_settle_ties``).
    Without ties it costs one ``torch.topk`` and the sync."""
    N = x.shape[-1]
    k = min(k, N)
    if N <= KEY_MAX or k == 0:
        return _key_topk(x, k)
    kth, vals, idx, flags = _topk_queued(x, k)
    return _settle_ties(x, kth, vals, idx, *flags.tolist())


def topk_lowest_index_many(xs: Sequence[torch.Tensor], k: int
                           ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``topk_lowest_index`` of each of ``xs`` (which may lie on different
    devices), with ONE host sync for all the rows longer than ``KEY_MAX``:
    every ``torch.topk`` and tie flag is queued first, the flags are read
    together, then each tied row is resolved.  The sharded retrievers
    select their shards' rows so, so that shards on separate cards are
    not run one after another by a sync each.  One row costs exactly what
    ``topk_lowest_index`` costs."""
    if len(xs) == 1:
        return [topk_lowest_index(xs[0], k)]
    out: List = [None] * len(xs)
    long = []
    for i, x in enumerate(xs):
        kk = min(k, x.shape[-1])
        if x.shape[-1] <= KEY_MAX or kk == 0:
            out[i] = _key_topk(x, kk)
        else:
            long.append((i, x, *_topk_queued(x, kk)))
    if long:
        lead = long[0][1].device
        flags = torch.stack([f.to(lead, non_blocking=True)
                             for *_, f in long]).tolist()
        for (i, x, kth, vals, idx, _), fl in zip(long, flags):
            out[i] = _settle_ties(x, kth, vals, idx, *fl)
    return out


def ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 of the same order as ``x``'s f32 values in the total order of
    ``jax.lax.top_k``: the bits themselves for a clear sign bit, the
    magnitude bits flipped for a set one (-NaN < -inf < ... < -0.0 < +0.0
    < ... < +inf < +NaN)."""
    bits = x.float().contiguous().view(torch.int32)
    key = (bits >> 31).bitwise_and_(0x7FFFFFFF)
    return key.bitwise_xor_(bits)


def _topk_queued(x: torch.Tensor, k: int):
    """A long row's select up to its sync: ``torch.topk`` of k + 1, then
    (kth [.., 1], vals [.., k], idx [.., k], flags [3]), the flags (the
    k-th value recurs past the k-th place, a value recurs inside the k, a
    NaN or a zero stands among the k + 1) still on the device."""
    N = x.shape[-1]
    vals, idx = torch.topk(x, min(k + 1, N), dim=-1, largest=True,
                           sorted=True)
    kth = vals[..., k - 1 : k]
    left_out = ((vals[..., k:] == kth).any() if N > k
                else torch.zeros((), dtype=torch.bool, device=x.device))
    special = ((vals != vals) | (vals == 0)).any()
    vals, idx = vals[..., :k], idx[..., :k]
    inside = (vals[..., 1:] == vals[..., :-1]).any()
    return kth, vals, idx, torch.stack([left_out, inside, special])


def _settle_ties(x, kth, vals, idx, left_out: bool, inside: bool,
                 special: bool):
    """A long row's select after its sync: the lowest-index rows of the
    k-th value at the k-th place (``_lowest_tied``), then, on any tie, the
    k put in (value descending, index ascending) order by a stable sort.
    Where a NaN or a zero stood among the k + 1 (``special``), the select
    and both steps run again on ``ordered_bits(x)``, with no second sync:
    on no tie they leave the k as they are.  The values are gathered from
    ``x``, bit for bit."""
    v = x
    if special:
        v = ordered_bits(x)
        kth, vals, idx, _ = _topk_queued(v, idx.shape[-1])
        left_out = inside = True
    if left_out:
        idx = _lowest_tied(v, kth, (vals == kth).sum(-1, keepdim=True), idx)
    if left_out or inside:
        idx, _ = torch.sort(idx, dim=-1)
        vals = torch.gather(v, -1, idx)
        vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
        idx = torch.gather(idx, -1, order)
        vals = torch.gather(x, -1, idx) if special else vals
    return vals, idx


def _key_topk(x: torch.Tensor, k: int):
    """Top-k by (value descending, index ascending) as one ``torch.topk``
    over int64 keys ``ordered_bits(x) * 2^32 + (N - 1 - index)``."""
    N = x.shape[-1]
    rev = N - 1 - torch.arange(N, device=x.device, dtype=torch.int64)
    key = ordered_bits(x).to(torch.int64) * (1 << 32) + rev
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
    check_topk_method(method)
    return topk_lowest_index(x, k)


def hierarchical_top_k(x: torch.Tensor, k: int, chunk: int = 2048
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis of ``x [..., N]`` (largest first, equal
    values lowest index first): the JAX package's ``hierarchical_top_k``,
    a top-k of each ``chunk``-column piece (the last padded with -inf)
    then a top-k of their candidates.  Exact for any chunk size; a flat
    top-k when chunking cannot help.  Candidates are kept chunk by chunk,
    each chunk's in (value, index) order, so the final select's lowest
    position among equal values is their lowest index."""
    n = x.shape[-1]
    if k >= n:
        return topk_lowest_index(x, min(k, n))
    if n <= 2 * chunk or chunk <= k:
        return topk_lowest_index(x, k)
    lead = x.shape[:-1]
    num_chunks = -(-n // chunk)
    pad = num_chunks * chunk - n
    if pad:
        x = torch.cat([x, x.new_full((*lead, pad), float("-inf"))], dim=-1)
    kc = min(k, chunk)
    vals_c, idx_c = topk_lowest_index(x.reshape(*lead, num_chunks, chunk),
                                      kc)                 # [..., C, kc]
    base = torch.arange(num_chunks, device=x.device)[:, None] * chunk
    cand_v = vals_c.reshape(*lead, num_chunks * kc)
    cand_i = (idx_c + base).reshape(*lead, num_chunks * kc)
    vals, pos = topk_lowest_index(cand_v, k)
    return vals, torch.gather(cand_i, -1, pos)


def check_topk_method(method: str) -> None:
    """Raise on a method ``top_k_select`` has not ("fused" is a retriever's
    kernel path, not a selection)."""
    if method not in ("exact", "approx"):
        raise ValueError(f"unknown topk method {method!r}")
