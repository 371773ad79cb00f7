"""Query GRU through the hand-written CUDA recurrence (``csrc/
gru_recurrence.cu``), the port of the JAX package's Pallas
``ops/pallas/gru_kernel.py`` (K3a: fused mean pool; K3b: hs-emitting).

``gru_layer`` runs one layer: on a CUDA tensor it launches the kernel (or
raises); on a CPU tensor it runs ``gru_recurrence_plain``, the same
arithmetic step by step in PyTorch.  ``cuda_gru`` chains layers like
``pallas_gru``: inner layers emit hs, the last one pools when
``pool="mean"``.  As for the LSTM kernel there are two variants,
``persistent`` and ``stepwise``, picked by ``rnn_plan.plan_recurrence``
from shapes and device properties or held by ``variant=``; nothing falls
back.

``LAUNCHES`` counts kernel launches (one per layer call on CUDA), keyed
"gru_pooled" (K3a) and "gru_hs" (K3b); ``VARIANT_LAUNCHES`` counts the
same launches by variant, and ``LAST_PLAN`` is the plan of the last one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from vfr_tpu_torch.ops.kernels.rnn_plan import (
    CHUNK,
    RecurrencePlan,
    device_plan,
)
from vfr_tpu_torch.ops.lstm import gru_cell_update

LAUNCHES = {"gru_pooled": 0, "gru_hs": 0}
VARIANT_LAUNCHES = {"persistent": 0, "stepwise": 0}
LAST_PLAN: Optional[RecurrencePlan] = None


def gru_recurrence_plain(
    x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
    w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
    pool: str = "none", weights_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer, the kernel's arithmetic in plain PyTorch.

    x [B, T, E] f32, lengths [B].  x and h are rounded to
    ``weights_dtype`` before each product, f32 products and sums.  The
    input product is hoisted over all T as in the kernel: gi = x W_ih +
    b_ih; each step adds gh = h_{t-1} W_hh + b_hh.  Returns (h_last [B, H],
    hs [B, T, H]) or, with ``pool="mean"``, (h_last, sum_{t<len} h_t /
    max(len, 1))."""
    wi = w_ih.to(weights_dtype).float()
    wh = w_hh.to(weights_dtype).float()
    B, T, _ = x.shape
    H = wh.shape[0]
    gi = x.to(weights_dtype).float() @ wi + b_ih.float()    # [B, T, 3H]
    h = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    acc = torch.zeros_like(h)
    seq = []
    for t in range(T):
        gh = h.to(weights_dtype).float() @ wh + b_hh.float()
        live = (t < lengths)[:, None]
        h = torch.where(live, gru_cell_update(gi[:, t], gh, h), h)
        if pool == "mean":
            acc = acc + torch.where(live, h, torch.zeros_like(h))
        else:
            seq.append(h)
    if pool == "mean":
        return h, acc / torch.clamp(lengths.float(), min=1.0)[:, None]
    return h, torch.stack(seq, dim=1)


def gru_layer(
    x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
    w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
    pool: str = "none", weights_dtype: torch.dtype = torch.bfloat16,
    variant: str = "auto", fuse_input: Optional[bool] = None,
    timeline: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Same results as ``gru_recurrence_plain``; ``variant``,
    ``fuse_input`` and ``timeline`` as for ``lstm_layer``."""
    global LAST_PLAN
    if pool not in ("none", "mean"):
        raise ValueError(f"unknown pool {pool!r}")
    if x.device.type == "cpu":
        return gru_recurrence_plain(x, lengths, w_ih, w_hh, b_ih, b_hh, pool,
                                    weights_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gru_layer: unsupported device {x.device}")
    if weights_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"weights_dtype must be bfloat16 or float32, got "
                         f"{weights_dtype}")
    from vfr_tpu_torch.kernels.build import check, load

    B, T, E = x.shape
    H = w_hh.shape[0]
    if (w_ih.shape != (E, 3 * H) or w_hh.shape != (H, 3 * H)
            or b_ih.shape != (3 * H,) or b_hh.shape != (3 * H,)
            or lengths.shape != (B,)):
        raise ValueError(
            f"gru_layer shapes: x {tuple(x.shape)} w_ih {tuple(w_ih.shape)} "
            f"w_hh {tuple(w_hh.shape)} b_ih {tuple(b_ih.shape)} b_hh "
            f"{tuple(b_hh.shape)} lengths {tuple(lengths.shape)}")
    dev = x.device
    for name, t in (("w_ih", w_ih), ("w_hh", w_hh), ("b_ih", b_ih),
                    ("b_hh", b_hh), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"gru_layer: {name} on {t.device}, x on {dev}")
    x = x.float().contiguous()
    w_ih = w_ih.to(weights_dtype).contiguous()
    w_hh = w_hh.to(weights_dtype).contiguous()
    b_ih = b_ih.float().contiguous()
    b_hh = b_hh.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    bf16 = weights_dtype == torch.bfloat16
    if bf16 and H % 8:
        raise ValueError(f"bf16 GRU kernel needs hidden % 8 == 0, got {H}")
    plan = device_plan(dev, B, E, H, 3, bf16, variant, fuse_input)
    f32 = dict(dtype=torch.float32, device=dev)
    b16 = dict(dtype=torch.bfloat16, device=dev)
    h_last = torch.empty(B, H, **f32)
    pooled = pool == "mean"
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = load("gru_recurrence")
    if plan.variant == "persistent":
        timeline_ptr = 0
        if timeline is not None:
            if (timeline.device != dev or timeline.dtype != torch.int64
                    or tuple(timeline.shape) != (T, 5)
                    or not timeline.is_contiguous()):
                raise ValueError("timeline must be a contiguous CUDA int64 "
                                 f"tensor [{T}, 5]")
            timeline_ptr = timeline.data_ptr()
        out = torch.empty((B, H) if pooled else (B, T, H), **f32)
        if plan.fuse_input:
            xb = torch.empty(B * T, -(-E // CHUNK) * CHUNK, **b16)
            gx_ptr = 0
        else:
            xb = torch.empty(B * T, -(-E // 8) * 8, **b16)
            gx = torch.empty(B, T, 3 * H, **f32)
            gx_ptr = gx.data_ptr()
        hb = torch.empty(2, B, H, **b16)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.vfr_gru_layer_persistent(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), lengths.data_ptr(), xb.data_ptr(), gx_ptr,
            hb.data_ptr(), counter.data_ptr(),
            0 if pooled else out.data_ptr(), h_last.data_ptr(),
            out.data_ptr() if pooled else 0, B, T, E, H, int(pooled),
            plan.warpgroups,
            int(plan.fuse_input), plan.grid[0], plan.grid[1],
            plan.smem_bytes, stream, timeline_ptr)
    else:
        gx = torch.empty(B, T, 3 * H, **f32)
        h_a = torch.zeros(B, H, **f32)
        h_b = torch.empty(B, H, **f32)
        if pooled:
            seq = torch.zeros(B, H, **f32)          # live-step sum
            out = torch.empty(B, H, **f32)
        else:
            seq = torch.empty(B, T, H, **f32)
            out = seq
        if bf16:   # the tensor-core path's bf16 operand copies of x and h
            xb = torch.empty(B * T, -(-E // 8) * 8, **b16)
            hb_a = torch.zeros(B, H, **b16)
            hb_b = torch.empty(B, H, **b16)
            bf16_ptrs = (xb.data_ptr(), hb_a.data_ptr(), hb_b.data_ptr())
        else:
            bf16_ptrs = (0, 0, 0)
        err = lib.vfr_gru_layer(
            x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), lengths.data_ptr(), bf16_ptrs[0], gx.data_ptr(),
            h_a.data_ptr(), h_b.data_ptr(), bf16_ptrs[1], bf16_ptrs[2],
            seq.data_ptr(), h_last.data_ptr(), out.data_ptr() if pooled else 0,
            B, T, E, H, int(bf16), int(pooled), stream)
    check(err, f"gru_recurrence[{plan.variant}]")
    LAUNCHES["gru_pooled" if pooled else "gru_hs"] += 1
    VARIANT_LAUNCHES[plan.variant] += 1
    LAST_PLAN = plan
    return h_last, out


def cuda_gru(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    lengths: torch.Tensor,
    weights_dtype: torch.dtype = torch.bfloat16,
    pool: str = "none",
    layer_fn: Callable = gru_layer,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-layer twin of ``pallas_gru``: returns (h_last, hs [B, T, H])
    or, with ``pool="mean"``, (h_last, pooled [B, H]) from the last layer.
    ``layer_fn=gru_recurrence_plain`` runs the plain version on any device
    (how checks hold the kernel against it on the card)."""
    hs = x
    h_last = None
    n = len(params)
    for layer in range(n):
        p = params[f"layer{layer}"]
        h_last, hs = layer_fn(
            hs, lengths, p["w_ih"], p["w_hh"], p["b_ih"], p["b_hh"],
            pool=pool if layer == n - 1 else "none",
            weights_dtype=weights_dtype)
    return h_last, hs
