"""Query LSTM through the hand-written CUDA recurrence (``csrc/
lstm_recurrence.cu``), the port of the JAX package's Pallas
``ops/pallas/lstm_kernel.py`` (K1a: fused mean pool; K1b: hs-emitting).

``lstm_layer`` runs one layer: on a CUDA tensor it launches the kernel (or
raises); on a CPU tensor it runs ``lstm_recurrence_plain``, the same
arithmetic step by step in PyTorch.  ``cuda_lstm`` chains layers like
``pallas_lstm``: inner layers emit hs, the last one pools when
``pool="mean"``.  The kernel has three variants, ``persistent_bulk`` and
``persistent`` (W_hh resident in shared memory, one cooperative launch per
layer; the first fed by bulk copies, with the second's bits, wherever it
fits past a daemon pack) and
``stepwise`` (one launch per step); ``rnn_plan.plan_recurrence`` picks one
from shapes and device properties, and ``variant=`` holds a call to one.
Nothing falls back: a variant that cannot run raises.

``LAUNCHES`` counts kernel launches (one per layer call on CUDA, so one
per chunk and layer of a chunked batch), keyed "lstm_pooled" (K1a) and
"lstm_hs" (K1b); ``VARIANT_LAUNCHES`` and ``DEVICE_LAUNCHES`` count the
same launches by variant and by device, and ``LAST_PLAN`` is the plan of
the last one.
The three dicts are registered with the port's recorder
(``utils/trace.py``), so a graph replay adds the launches its capture
counted.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from vfr_tpu_torch.ops.kernels.rnn_plan import (
    BULK_ROWS,
    CHUNK,
    PERSISTENT,
    RecurrencePlan,
    Workspace,
    chain_layers,
    check_out,
    device_plan,
)
from vfr_tpu_torch.ops.lstm import cell_update
from vfr_tpu_torch.utils import trace

LAUNCHES = trace.register("lstm_kernel.launches",
                          {"lstm_pooled": 0, "lstm_hs": 0})
VARIANT_LAUNCHES = trace.register(
    "lstm_kernel.variant_launches",
    {"persistent_bulk": 0, "persistent": 0, "stepwise": 0})
# the same launches by device
DEVICE_LAUNCHES: Dict[str, int] = trace.register(
    "lstm_kernel.device_launches", {})
LAST_PLAN: Optional[RecurrencePlan] = None


def lstm_recurrence_plain(
    x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
    w_hh: torch.Tensor, b: torch.Tensor, pool: str = "none",
    weights_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer, the kernel's arithmetic in plain PyTorch.

    x [B, T, E] f32, lengths [B].  x and h are rounded to
    ``weights_dtype`` before each product, f32 products and sums (rounded
    operands are upcast, never multiplied in bf16).  The input product is
    hoisted over all T as in the kernel: gates_t = (x_t W_ih + b) +
    h_{t-1} W_hh.  Returns (h_last [B, H], hs [B, T, H]) or, with
    ``pool="mean"``, (h_last, sum_{t<len} h_t / max(len, 1))."""
    wi = w_ih.to(weights_dtype).float()
    wh = w_hh.to(weights_dtype).float()
    B, T, _ = x.shape
    H = wh.shape[0]
    gx = x.to(weights_dtype).float() @ wi + b.float()      # [B, T, 4H]
    h = torch.zeros(B, H, dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    acc = torch.zeros_like(h)
    seq = []
    for t in range(T):
        gates = gx[:, t] + h.to(weights_dtype).float() @ wh
        h_new, c_new = cell_update(gates, c)
        live = (t < lengths)[:, None]
        h = torch.where(live, h_new, h)
        c = torch.where(live, c_new, c)
        if pool == "mean":
            acc = acc + torch.where(live, h, torch.zeros_like(h))
        else:
            seq.append(h)
    if pool == "mean":
        return h, acc / torch.clamp(lengths.float(), min=1.0)[:, None]
    return h, torch.stack(seq, dim=1)


def lstm_layer(
    x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
    w_hh: torch.Tensor, b: torch.Tensor, pool: str = "none",
    weights_dtype: torch.dtype = torch.bfloat16,
    variant: str = "auto", fuse_input: Optional[bool] = None,
    timeline: Optional[torch.Tensor] = None, *,
    out: Optional[torch.Tensor] = None,
    h_last_out: Optional[torch.Tensor] = None,
    workspace: Optional[Workspace] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Same results as ``lstm_recurrence_plain``.  ``variant``
    ("auto", "persistent_bulk", "persistent", "stepwise") holds the call to
    one kernel variant (either persistent one raises where the plan refuses
    it); ``fuse_input`` forces the persistent variants' resident W_ih on or
    off (off: never ``persistent_bulk``); ``timeline``, a CUDA int64 tensor
    [T, 5], receives a persistent kernel's per-step time stamps
    (``csrc/rnn_common.cuh::stamp``).  ``out`` / ``h_last_out``
    (CUDA tensors only) receive the results in place (a batch chunk's rows
    of the chain's output); ``workspace`` lends the persistent variant its work buffers.
    The kernel launches on the CUDA device of ``x``, which every operand
    must share."""
    global LAST_PLAN
    if pool not in ("none", "mean"):
        raise ValueError(f"unknown pool {pool!r}")
    if x.device.type == "cpu":
        if out is not None or h_last_out is not None:
            raise ValueError("lstm_layer: out= / h_last_out= are for CUDA "
                             "tensors")
        return lstm_recurrence_plain(x, lengths, w_ih, w_hh, b, pool,
                                     weights_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_layer: unsupported device {x.device}")
    if weights_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"weights_dtype must be bfloat16 or float32, got "
                         f"{weights_dtype}")
    from vfr_tpu_torch.kernels.build import check, load

    B, T, E = x.shape
    H = w_hh.shape[0]
    if (w_ih.shape != (E, 4 * H) or w_hh.shape != (H, 4 * H)
            or b.shape != (4 * H,) or lengths.shape != (B,)):
        raise ValueError(
            f"lstm_layer shapes: x {tuple(x.shape)} w_ih {tuple(w_ih.shape)}"
            f" w_hh {tuple(w_hh.shape)} b {tuple(b.shape)} lengths "
            f"{tuple(lengths.shape)}")
    dev = x.device
    for name, t in (("w_ih", w_ih), ("w_hh", w_hh), ("b", b),
                    ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"lstm_layer: {name} on {t.device}, x on {dev}")
    pooled = pool == "mean"
    check_out("h_last_out", h_last_out, (B, H), dev)
    check_out("out", out, (B, H) if pooled else (B, T, H), dev)
    with torch.cuda.device(dev):
        x = x.float().contiguous()
        w_ih = w_ih.to(weights_dtype).contiguous()
        w_hh = w_hh.to(weights_dtype).contiguous()
        b = b.float().contiguous()
        lengths = lengths.to(torch.int32).contiguous()
        bf16 = weights_dtype == torch.bfloat16
        if bf16 and H % 8:
            raise ValueError(f"bf16 LSTM kernel needs hidden % 8 == 0, got "
                             f"{H}")
        plan = device_plan(dev, B, E, H, 4, bf16, variant, fuse_input)
        f32 = dict(dtype=torch.float32, device=dev)
        b16 = dict(dtype=torch.bfloat16, device=dev)
        h_last = (h_last_out if h_last_out is not None
                  else torch.empty(B, H, **f32))
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = load("lstm_recurrence")
        if plan.variant in PERSISTENT:
            timeline_ptr = 0
            if timeline is not None:
                if (timeline.device != dev or timeline.dtype != torch.int64
                        or tuple(timeline.shape) != (T, 5)
                        or not timeline.is_contiguous()):
                    raise ValueError("timeline must be a contiguous CUDA "
                                     f"int64 tensor [{T}, 5] on {dev}")
                timeline_ptr = timeline.data_ptr()
            if out is None:
                out = torch.empty((B, H) if pooled else (B, T, H), **f32)
            ws = workspace if workspace is not None else Workspace(dev)
            # the grid barrier's counters, zeroed for each launch: one a
            # batch group (persistent_bulk; persistent counts in the first)
            counter = ws.take("counter", (plan.grid[1],),
                              torch.int32).zero_()
        if plan.variant == "persistent_bulk":
            # x and the h ping-pong, chunk-major: [chunks, 128 rows, 64]
            groups = plan.grid[1]
            xc = ws.take("xb", (T * groups * -(-E // CHUNK), BULK_ROWS,
                                CHUNK), torch.bfloat16)
            hb = ws.take("hb", (2 * groups * -(-H // CHUNK), BULK_ROWS,
                                CHUNK), torch.bfloat16)
            err = lib.vfr_lstm_layer_persistent_bulk(
                x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
                lengths.data_ptr(), xc.data_ptr(), hb.data_ptr(),
                counter.data_ptr(), 0 if pooled else out.data_ptr(),
                h_last.data_ptr(), out.data_ptr() if pooled else 0, B, T, E,
                H, int(pooled), plan.grid[0], plan.grid[1], plan.smem_bytes,
                stream, timeline_ptr)
        elif plan.variant == "persistent":
            if plan.fuse_input:
                xb = ws.take("xb", (B * T, -(-E // CHUNK) * CHUNK),
                             torch.bfloat16)
                gx_ptr = 0
            else:
                xb = ws.take("xb", (B * T, -(-E // 8) * 8), torch.bfloat16)
                gx_ptr = ws.take("gx", (B, T, 4 * H), torch.float32
                                 ).data_ptr()
            hb = ws.take("hb", (2, B, H), torch.bfloat16)
            err = lib.vfr_lstm_layer_persistent(
                x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
                lengths.data_ptr(), xb.data_ptr(), gx_ptr, hb.data_ptr(),
                counter.data_ptr(), 0 if pooled else out.data_ptr(),
                h_last.data_ptr(), out.data_ptr() if pooled else 0, B, T, E,
                H, int(pooled), plan.warpgroups,
                int(plan.fuse_input), plan.grid[0], plan.grid[1],
                plan.smem_bytes, stream, timeline_ptr)
        else:
            gx = torch.empty(B, T, 4 * H, **f32)
            h_a = torch.zeros(B, H, **f32)
            h_b = torch.empty(B, H, **f32)
            c = torch.zeros(B, H, **f32)
            if pooled:
                seq = torch.zeros(B, H, **f32)          # live-step sum
                if out is None:
                    out = torch.empty(B, H, **f32)
            else:
                seq = out if out is not None else torch.empty(B, T, H, **f32)
                out = seq
            if bf16:   # the tensor-core path's bf16 operand copies of x, h
                xb = torch.empty(B * T, -(-E // 8) * 8, **b16)
                hb_a = torch.zeros(B, H, **b16)
                hb_b = torch.empty(B, H, **b16)
                bf16_ptrs = (xb.data_ptr(), hb_a.data_ptr(), hb_b.data_ptr())
            else:
                bf16_ptrs = (0, 0, 0)
            err = lib.vfr_lstm_layer(
                x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
                lengths.data_ptr(), bf16_ptrs[0], gx.data_ptr(),
                h_a.data_ptr(), h_b.data_ptr(), bf16_ptrs[1], bf16_ptrs[2],
                c.data_ptr(), seq.data_ptr(), h_last.data_ptr(),
                out.data_ptr() if pooled else 0, B, T, E, H, int(bf16),
                int(pooled), stream)
    check(err, f"lstm_recurrence[{plan.variant}]")
    LAUNCHES["lstm_pooled" if pooled else "lstm_hs"] += 1
    VARIANT_LAUNCHES[plan.variant] += 1
    DEVICE_LAUNCHES[str(dev)] = DEVICE_LAUNCHES.get(str(dev), 0) + 1
    LAST_PLAN = plan
    return h_last, out


def cuda_lstm(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,
    lengths: torch.Tensor,
    weights_dtype: torch.dtype = torch.bfloat16,
    pool: str = "none",
    layer_fn: Callable = lstm_layer,
    variant: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-layer twin of ``pallas_lstm``: returns (h_last, hs [B, T, H])
    or, with ``pool="mean"``, (h_last, pooled [B, H]) from the last layer.
    ``layer_fn=lstm_recurrence_plain`` runs the plain version on any
    device (how checks hold the kernel against it on the card).

    A batch the ``persistent`` plan cannot hold in one grid runs in batch
    chunks (``rnn_plan.device_chunk``: the reference's ``batch_chunk`` over
    the device's plan), the layer chain once per chunk, as ``pallas_lstm``
    does; ``variant`` is handed to every layer ("stepwise" runs
    unchunked)."""
    return chain_layers(params, x, lengths, weights_dtype, pool, layer_fn,
                        variant, gates=4, kernel=lstm_layer,
                        bias_keys=("b",))
