"""Top-k selection.

``"exact"`` is ``torch.topk(sorted=True)``.  ``"approx"`` is exact too:
that is what the JAX package's ``lax.approx_max_k`` does off the TPU, and
the port has no counterpart of the TPU's PartialReduce yet (a known
difference, recorded in ROADMAP.md).  ``approx_recall`` is accepted and
unused.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k_select(
    x: torch.Tensor, k: int, method: str = "exact", recall: float = 0.95
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest-k along the last axis: (values, indices), largest first."""
    if method not in ("exact", "approx"):
        raise ValueError(f"unknown topk method {method!r}")
    k = min(k, x.shape[-1])
    return torch.topk(x, k, dim=-1, largest=True, sorted=True)
