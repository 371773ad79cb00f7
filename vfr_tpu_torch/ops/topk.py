"""Top-k selection with ``jax.lax.top_k``'s order: largest value first,
equal values by lowest index, and at the k-th place the lowest-index rows
of the tied value enter (``torch.topk`` leaves both unspecified).  Values
compare in the total order of their f32 bits (``ordered_bits``), as
``jax.lax.top_k`` sorts them: -NaN below -inf, -0.0 below +0.0, +NaN
above +inf, and NaNs with the same bits equal.

On the card a long f32 row selects through the hand-written kernel
(``ops/kernels/topk_kernel.py``, ``csrc/row_topk.cu``), whose unique
64-bit keys give that order with no tie pass; ``select_route`` says which
input goes where.

``"approx"`` is exact too: that is what the JAX package's
``lax.approx_max_k`` does off the TPU, and the port has no counterpart of
the TPU's PartialReduce yet (a known difference, recorded in ROADMAP.md).
``approx_recall`` is accepted and unused.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from vfr_tpu_torch.ops.kernels.topk_kernel import K_MAX, row_topk
from vfr_tpu_torch.utils import trace

# rows up to this long (candidate lists, coarse blocks: 16,512 at 2.1M
# rows) select by one torch.topk over a 64-bit (value, -index) key: a few
# launches, no tie pass
KEY_MAX = 32768
# a batch of longer rows takes the key too while it holds at most
# KEY_BATCH * KEY_MAX values (a [79, 210,000] batch; 134 MB of key): there
# the tie pass's launches cost the host more than the key's bytes cost the
# card.  A larger batch (a corpus scored for many queries) selects over the
# 32-bit total order and runs the tie pass
KEY_BATCH = 512
# row chunk of the tie pass: one count per chunk over the row, a prefix
# scan only inside the chunks that hold the tied rows.  A chunk's count is
# summed in uint8 (so a chunk is at most 255 columns): a sum in another
# dtype than its input's would copy the whole row first
TIE_CHUNK = 128


def select_route(device_type: str, dtype: torch.dtype, contiguous: bool,
                 N: int, k: int, numel: int) -> str:
    """Which select ``topk_lowest_index`` runs for rows of ``N`` (``numel``
    values in all) and ``k <= N``: "kernel" for contiguous f32 rows longer
    than ``KEY_MAX`` on a CUDA card with ``1 <= k <= K_MAX``
    (``topk_kernel.row_topk``); else "key64" for rows of at most
    ``KEY_MAX``, ``k`` 0 or at most ``KEY_BATCH * KEY_MAX`` values
    (``_key_topk``); else "order32_tie" (``_tie_topk``)."""
    if (device_type == "cuda" and dtype == torch.float32
            and contiguous and N > KEY_MAX and 1 <= k <= K_MAX):
        return "kernel"
    if N <= KEY_MAX or k == 0 or numel <= KEY_BATCH * KEY_MAX:
        return "key64"
    return "order32_tie"


def topk_lowest_index(x: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest-k along the last axis: (values, indices), ordered by (value
    descending, index ascending), the tied rows at the k-th place taken
    lowest index first.  No value is read on the host, at any size.

    ``select_route`` picks the select.  On the card, contiguous f32 rows
    longer than ``KEY_MAX`` with ``k <= K_MAX`` go to the hand-written
    kernel (``topk_kernel.row_topk``), which reads each value once.
    Otherwise a row of at most ``KEY_MAX``, or a batch of at most
    ``KEY_BATCH * KEY_MAX`` values, selects by ``torch.topk`` over a
    unique int64 key, the value's ``ordered_bits`` above the reversed index
    (``_key_topk``).  A larger batch of longer rows selects by
    ``torch.topk`` over ``ordered_bits`` alone, which holds the total order
    but not the index order of equal values, then always runs the tie pass
    (``_tie_topk``).  Each call counts its route in the recorder
    (``select.kernel``, ``select.key64`` or ``select.order32_tie``)."""
    N = x.shape[-1]
    k = min(k, N)
    route = select_route(x.device.type, x.dtype, x.is_contiguous(), N, k,
                         x.numel())
    trace.count("select." + route)
    if route == "kernel":
        return row_topk(x, k)
    if route == "key64":
        return _key_topk(x, k)
    return _tie_topk(x, k)


def topk_lowest_index_many(xs: Sequence[torch.Tensor], k: int
                           ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``topk_lowest_index`` of each of ``xs`` (which may lie on different
    devices): the sharded retrievers select their shards' rows so.  No
    select reads a value on the host, so shards on separate cards never
    wait on each other."""
    return [topk_lowest_index(x, k) for x in xs]


def ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 of the same order as ``x``'s f32 values in the total order of
    ``jax.lax.top_k``: the bits themselves for a clear sign bit, the
    magnitude bits flipped for a set one (-NaN < -inf < ... < -0.0 < +0.0
    < ... < +inf < +NaN)."""
    bits = x.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _key_topk(x: torch.Tensor, k: int):
    """Top-k by (value descending, index ascending) as one ``torch.topk``
    over int64 keys ``ordered_bits(x) * 2^32 + (N - 1 - index)``."""
    N = x.shape[-1]
    rev = N - 1 - torch.arange(N, device=x.device, dtype=torch.int64)
    key = ordered_bits(x).to(torch.int64) * (1 << 32) + rev
    idx = torch.topk(key, k, dim=-1, largest=True, sorted=True).indices
    return torch.gather(x, -1, idx), idx


def _tie_topk(x: torch.Tensor, k: int):
    """Top-k of rows longer than ``KEY_MAX`` by ``torch.topk`` over
    ``ordered_bits(x)``, then the tie pass, always: the positions holding
    the k-th value get the lowest-index rows equal to it (``_lowest_tied``)
    and a stable sort puts the k in (value descending, index ascending)
    order.  Without a tie both steps leave the k as they are (the rows
    equal to the k-th value are those already taken, and the k are
    already in order), so no flag is read to skip them.  The values are
    gathered from ``x``, bit for bit."""
    v = ordered_bits(x)
    vals, idx = torch.topk(v, k, dim=-1, largest=True, sorted=True)
    kth = vals[..., k - 1 : k]
    n_tied = (vals == kth).sum(-1, keepdim=True, dtype=torch.int32)
    idx = _lowest_tied(v, kth, n_tied, idx)
    idx, _ = torch.sort(idx, dim=-1)
    _, order = torch.sort(torch.gather(v, -1, idx), dim=-1, descending=True,
                          stable=True)
    idx = torch.gather(idx, -1, order)
    return torch.gather(x, -1, idx), idx


def _lowest_tied(x, kth, n_tied, idx):
    """``idx`` [.., k] with its last ``n_tied`` (int32) positions (those
    holding the k-th value) replaced by the lowest-index rows of ``x``
    equal to ``kth``: count them per chunk of ``TIE_CHUNK`` columns, find
    each rank's chunk by ``searchsorted`` over the running counts, then
    its offset by a prefix scan of that chunk alone."""
    lead, N = x.shape[:-1], x.shape[-1]
    k = idx.shape[-1]
    C = min(TIE_CHUNK, 255, N)
    G = -(-N // C)
    # equality padded to whole chunks: the pad never ties
    eq = torch.zeros(*lead, G * C, dtype=torch.bool, device=x.device)
    torch.eq(x, kth, out=eq[..., :N])
    per = eq.view(torch.uint8).view(*lead, G, C).sum(-1, dtype=torch.uint8)
    upto = torch.cumsum(per, -1, dtype=torch.int32)        # [.., G]
    rank = torch.arange(1 - k, 1, dtype=torch.int32, device=x.device) + n_tied
    r = rank.clamp(min=1)                                  # 1-based ranks
    g = torch.searchsorted(upto, r)                        # each one's chunk
    within = r - (upto - per).gather(-1, g)                # and place in it
    pos = torch.add(torch.arange(C, device=x.device), g[..., None],
                    alpha=C)                               # [.., k, C]
    chunk = eq.gather(-1, pos.view(*lead, k * C)).view(*lead, k, C)
    inner = torch.searchsorted(torch.cumsum(chunk, -1, dtype=torch.int32),
                               within[..., None])[..., 0]
    return torch.where(rank >= 1, torch.add(inner, g, alpha=C), idx)


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
