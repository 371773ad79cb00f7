"""Device and dtype helpers shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one.  Raises when CUDA is wanted and absent — the port never
    carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vfr_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass --device cpu (or device='cpu') to run on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """"float32" / "bfloat16" (config strings) -> torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


def mm_f32(a: torch.Tensor, b: torch.Tensor, in_dtype: torch.dtype
           ) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``in_dtype`` and f32 products
    and sums — JAX's ``dot(..., preferred_element_type=float32)``.  A
    ``torch.matmul`` on bf16 tensors would return bf16; rounding to bf16
    and back to f32 is exact, so the f32 product of the rounded values is
    the reference's arithmetic."""
    if in_dtype != torch.float32:
        a = a.to(in_dtype)
        b = b.to(in_dtype)
    return torch.matmul(a.float(), b.float())
