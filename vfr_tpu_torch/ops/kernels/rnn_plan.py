"""What the LSTM and GRU recurrence wrappers share on the host: the plan
that picks a kernel variant from shapes and device properties, and the
once-per-tree weight preparation.

Variants of ``csrc/lstm_recurrence.cu`` / ``csrc/gru_recurrence.cu``:

``persistent_bulk``  the LSTM's, with ``persistent``'s bits, wherever it
    fits and the batch is more than a daemon pack (``PACK_ROWS``): one
    cooperative launch per layer, a block owns 16 hidden units x
    4 gates x one group of 128 rows; its W_hh and W_ih slices stay in
    shared memory as the wgmma's A operand (the gate rows as M = 64), and
    h_{t-1} and x_t reach it as bulk copies of 16 KB chunks through a ring
    of ``BULK_STAGES`` stages, from buffers stored chunk-major and
    pre-swizzled.  Needs 4 gates, bf16 weights, ``hidden % 8 == 0``, both
    slices, the ring and an f32 staging tile within the block's shared
    memory, and a grid of at most one block per SM.  The GRU's 3 x 16 gate
    rows do not fill M = 64, so the GRU never takes it.
``persistent``  one cooperative launch per layer.  A block owns ``u = 16``
    hidden units x all gates x one batch group of 64 or 128 rows and keeps
    its slice of W_hh (and of W_ih when it fits: ``fuse_input``) in shared
    memory for all T steps.  Needs bf16 weights, ``hidden % 8 == 0``, a
    slice plus a ring of ``STAGES`` stages per warpgroup within the block's
    shared memory, and a grid of at most one block per SM.
``stepwise``    the input product hoisted over T, then one launch per step.
    Takes every shape, and f32 weights.

The choice is a function of (B, E, H, gates, dtype, SM count, shared
memory bytes) only; nothing is decided by trying a launch.

A batch whose grid exceeds the SMs runs ``persistent`` in batch chunks, as
the JAX package's ``pallas_lstm`` / ``pallas_gru`` run a batch too large
for VMEM (``batch_chunk``, ``run_batch_chunks``): the kernel is
batch-independent, so every row comes out as it would alone in its chunk.
The tail chunk runs at its own size (no padding on the card), every chunk
writes its rows into slices of one output, and the chunks share one set of
work buffers (``Workspace``) on the launching stream.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

UNITS = 16              # hidden units per block (csrc/rnn_common.cuh PU)
TILE_ROWS = 64          # rows of one warpgroup's tile (one wgmma M)
CHUNK = 64              # depth of one shared-memory chunk (128-byte rows)
STAGE_BYTES = TILE_ROWS * CHUNK * 2
ALIGN_SLACK = 1024      # the kernel aligns its tiles to 1024 bytes itself
STAGES = 3              # ring stages per warpgroup (rnn_common.cuh PSTAGES)
MAX_WARPGROUPS = 2
BULK_ROWS = 128         # rows of a persistent_bulk block (lstm_recurrence.cu
BULK_STAGES = 3         # BROWS) and its ring's stages (BSTAGES), of one
BULK_STAGE_BYTES = BULK_ROWS * CHUNK * 2    # [128 x 64] bf16 chunk each
BULK_TILE_BYTES = BULK_ROWS * UNITS * 4     # the f32 h staging tile
BULK_BARRIER_BYTES = 16 * BULK_STAGES       # a full and an empty mbarrier
PACK_ROWS = 8           # batches of at most this many rows keep persistent
VARIANTS = ("auto", "persistent_bulk", "persistent", "stepwise")
PERSISTENT = ("persistent_bulk", "persistent")   # one launch per layer


@dataclasses.dataclass(frozen=True)
class RecurrencePlan:
    variant: str                 # "persistent_bulk" | "persistent" | "stepwise"
    reason: str                  # why, in words
    u: int = 0                   # hidden units per block
    batch_group: int = 0         # rows per block
    grid: Tuple[int, int] = (0, 0)
    smem_bytes: int = 0          # dynamic shared memory of one block
    fuse_input: bool = False     # W_ih's slice resident beside W_hh's

    @property
    def warpgroups(self) -> int:
        """Warpgroups of a ``persistent`` block, one 64-row tile each."""
        return self.batch_group // TILE_ROWS


def bulk_smem(E: int, H: int) -> int:
    """Dynamic shared memory of one ``persistent_bulk`` block."""
    depth = _round_up(H, CHUNK) + _round_up(E, CHUNK)
    return (ALIGN_SLACK + depth * UNITS * 4 * 2
            + BULK_STAGES * BULK_STAGE_BYTES + BULK_TILE_BYTES
            + BULK_BARRIER_BYTES)


def _bulk_refusal(B: int, H: int, gates: int, sm_count: int,
                  smem_bytes: int, E: Optional[int],
                  fuse_input: Optional[bool]) -> Optional[str]:
    """Why ``persistent_bulk`` cannot run this layer; None when it can."""
    if gates != 4:
        return (f"{gates} x {UNITS} gate rows do not fill a wgmma's M of "
                f"{4 * UNITS}")
    if E is None or fuse_input is False:
        return "needs W_ih's slice resident"
    grid = (-(-H // UNITS), -(-B // BULK_ROWS))
    if grid[0] * grid[1] > sm_count:
        return (f"grid {grid[0]}x{grid[1]} of {BULK_ROWS}-row blocks "
                f"exceeds {sm_count} SMs")
    if bulk_smem(E, H) > smem_bytes:
        return (f"W_ih and W_hh slices, a {BULK_STAGES}-stage ring and the "
                f"staging tile exceed {smem_bytes} bytes of shared memory")
    return None


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan_recurrence(B: int, H: int, gates: int, sm_count: int,
                    smem_bytes: int, E: Optional[int] = None,
                    weights_bf16: bool = True,
                    fuse_input: Optional[bool] = None,
                    bulk: Optional[bool] = None) -> RecurrencePlan:
    """The variant and launch geometry for one layer of ``B`` rows, hidden
    size ``H``, ``gates`` gate columns per unit (LSTM 4, GRU 3) on a device
    with ``sm_count`` SMs and ``smem_bytes`` of shared memory per block.
    ``E`` (the input width) lets W_ih's slice be held beside W_hh's;
    ``fuse_input`` forces that on or off (None: when it fits).

    ``persistent_bulk`` is taken where it can run (``_bulk_refusal``) and
    ``B > PACK_ROWS``.  It gives ``persistent``'s bits, so the rule moves
    only time: measured on an H100 (``chip_smoke.py --phases rnn``, in
    turns) it is 10-15% faster from 64 rows on, but at a daemon's packs of
    1 and 8 rows it read from 4% faster to 9% slower by run, so packs keep
    ``persistent``.  ``bulk`` True holds a call to it at any B (stepwise
    with the reason where it cannot run), False to the others."""
    def stepwise(reason):
        return RecurrencePlan("stepwise", reason)

    if not weights_bf16:
        return stepwise("f32 weights")
    if B < 1 or H < 1:
        return stepwise("empty batch or hidden size")
    if H % 8:
        return stepwise("hidden % 8 != 0")
    if bulk is not False:
        why = _bulk_refusal(B, H, gates, sm_count, smem_bytes, E, fuse_input)
        if why is None and (bulk or B > PACK_ROWS):
            return RecurrencePlan(
                "persistent_bulk", "slices resident, operands by bulk copy",
                u=UNITS, batch_group=BULK_ROWS,
                grid=(-(-H // UNITS), -(-B // BULK_ROWS)),
                smem_bytes=bulk_smem(E, H), fuse_input=True)
        if bulk:
            return stepwise(why)
    cols = UNITS * gates
    col_groups = -(-H // UNITS)
    for nwg in range(1, MAX_WARPGROUPS + 1):
        rows = TILE_ROWS * nwg
        grid = (col_groups, -(-B // rows))
        if grid[0] * grid[1] <= sm_count:
            break
    else:
        return stepwise(f"grid {grid[0]}x{grid[1]} of {rows}-row blocks "
                        f"exceeds {sm_count} SMs")

    def smem_for(depth):
        return ALIGN_SLACK + depth * cols * 2 + STAGES * nwg * STAGE_BYTES

    depth_h = _round_up(H, CHUNK)
    fused = False
    if fuse_input is not False and E is not None:
        smem = smem_for(depth_h + _round_up(E, CHUNK))
        fused = smem <= smem_bytes
        if fuse_input and not fused:
            return stepwise("W_ih and W_hh slices do not fit shared memory")
    if not fused:
        smem = smem_for(depth_h)
        if smem > smem_bytes:
            return stepwise(
                f"W_hh slice [{depth_h} x {cols}] bf16 and a {STAGES}-stage "
                f"ring exceed {smem_bytes} bytes of shared memory")
    return RecurrencePlan("persistent", "slice resident in shared memory",
                          u=UNITS, batch_group=rows, grid=grid,
                          smem_bytes=smem, fuse_input=fused)


def _bulk_of(variant: str) -> Optional[bool]:
    """``plan_recurrence``'s ``bulk`` for a variant asked for."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    return {"persistent_bulk": True, "persistent": False}.get(variant)


def device_plan(device: torch.device, B: int, E: int, H: int, gates: int,
                weights_bf16: bool, variant: str = "auto",
                fuse_input: Optional[bool] = None) -> RecurrencePlan:
    """``plan_recurrence`` on ``device``'s properties, held to ``variant``:
    "persistent_bulk" or "persistent" raises where the plan cannot give
    it."""
    bulk = _bulk_of(variant)
    if variant == "stepwise":
        return RecurrencePlan("stepwise", "asked for")
    props = torch.cuda.get_device_properties(device)
    plan = plan_recurrence(B, H, gates, props.multi_processor_count,
                           props.shared_memory_per_block_optin, E=E,
                           weights_bf16=weights_bf16, fuse_input=fuse_input,
                           bulk=bulk)
    if variant != "auto" and plan.variant != variant:
        raise ValueError(f"{variant} recurrence refused: {plan.reason}")
    return plan


def batch_chunk(B: int, fits: Callable[[int], bool]) -> Optional[int]:
    """Largest 8-aligned batch chunk satisfying ``fits`` (None if none):
    the JAX package's rule, halving and rounding up to 8 from ``B``."""
    chunk = B
    while chunk > 8 and not fits(chunk):
        chunk = ((chunk + 1) // 2 + 7) // 8 * 8
    return chunk if fits(chunk) else None


def device_chunk(device: torch.device, B: int,
                 layer_shapes: Sequence[Tuple[int, int]], gates: int,
                 weights_bf16: bool, variant: str = "auto") -> Optional[int]:
    """The batch chunk a chain of layers (``layer_shapes``: (E, H) each)
    runs in on ``device``: the largest ``batch_chunk`` at which every layer
    plans one of ``PERSISTENT`` (as ``variant`` allows) on that device's
    properties; B when the whole batch does, and None when no chunk does,
    ``variant`` is "stepwise" or the device is not CUDA (the chain then
    runs unchunked)."""
    bulk = _bulk_of(variant)
    if variant == "stepwise" or B < 1 or device.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(device)

    def fits(b):
        return all(plan_recurrence(
            b, H, gates, props.multi_processor_count,
            props.shared_memory_per_block_optin, E=E,
            weights_bf16=weights_bf16, bulk=bulk).variant in PERSISTENT
            for E, H in layer_shapes)
    return batch_chunk(B, fits)


class Workspace:
    """Work buffers one launch after another reuses on the same stream:
    ``take(name, shape, dtype)`` is a view of the first elements of one
    flat buffer per name (grown when too small), so the chunks of a batch
    and the layers of a chain allocate each buffer once."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: Dict[str, torch.Tensor] = {}

    def take(self, name: str, shape: Tuple[int, ...],
             dtype: torch.dtype) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= s
        buf = self._bufs.get(name)
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            buf = self._bufs[name] = torch.empty(n, dtype=dtype,
                                                 device=self.device)
        return buf[:n].view(shape)


def run_batch_chunks(run: Callable, x: torch.Tensor, lengths: torch.Tensor,
                     chunk: int, out_shape: Tuple[int, ...]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ``run(xc, lc, h_last_rows, out_rows)`` over batch chunks of
    ``chunk`` rows, the tail at its own size; ``run`` writes each chunk's
    results into its rows of one (h_last [B, H], out ``out_shape``) pair,
    which is returned.  Rows of both are contiguous by batch, so a chunk's
    rows are a contiguous slice and nothing is concatenated."""
    B = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    h_last = torch.empty(B, out_shape[-1], **f32)
    out = torch.empty(out_shape, **f32)
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        run(x[lo:hi], lengths[lo:hi], h_last[lo:hi], out[lo:hi])
    return h_last, out


def check_out(name: str, t: Optional[torch.Tensor], shape, dev) -> None:
    """Refuse an in-place result tensor the kernels cannot write into."""
    if t is not None and (tuple(t.shape) != tuple(shape)
                          or t.dtype != torch.float32 or t.device != dev
                          or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 tensor "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def into(h_last: torch.Tensor, second: torch.Tensor,
         h_last_out: Optional[torch.Tensor] = None,
         out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk's results, copied into its rows ``h_last_out`` / ``out``
    where those are given and are not already the results themselves."""
    if h_last_out is not None and h_last_out is not h_last:
        h_last = h_last_out.copy_(h_last)
    if out is not None and out is not second:
        second = out.copy_(second)
    return h_last, second


def chain_layers(params: Dict[str, Dict[str, torch.Tensor]],
                 x: torch.Tensor, lengths: torch.Tensor,
                 weights_dtype: torch.dtype, pool: str, layer_fn: Callable,
                 variant: str, gates: int, kernel: Callable,
                 bias_keys: Sequence[str]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cuda_lstm`` / ``cuda_gru``: the layers of ``params`` chained
    (inner layers emit hs, the last one pools when ``pool="mean"``) by
    ``layer_fn``, over batch chunks where one grid cannot hold the batch.

    With the kernel wrapper (``layer_fn is kernel``) the chunk is planned
    on the device of ``x`` (``device_chunk``) and ``variant`` goes to every
    layer; on a CUDA tensor each chunk's last layer writes straight into
    its rows of the output and every launch borrows its buffers from one
    ``Workspace`` (inner layers' hs ping-pong between two).  Any other
    layer function (the plain version) runs the batch whole."""
    layers = [params[f"layer{i}"] for i in range(len(params))]
    is_kernel = layer_fn is kernel
    B, T = x.shape[:2]
    chunk = None
    if is_kernel:
        chunk = device_chunk(
            x.device, B, [(p["w_ih"].shape[0], p["w_hh"].shape[0])
                          for p in layers],
            gates, weights_dtype == torch.bfloat16, variant)

    def run(xc, lc, h_dst=None, o_dst=None, ws=None):
        hs, h_last = xc, None
        for i, p in enumerate(layers):
            last = i == len(layers) - 1
            kw = {"variant": variant} if is_kernel else {}
            if ws is not None:
                b, H = xc.shape[0], p["w_hh"].shape[0]
                kw.update(
                    workspace=ws,
                    h_last_out=(h_dst if last else ws.take(
                        "h_inner", (b, H), torch.float32)),
                    out=(o_dst if last else ws.take(
                        f"hs{i % 2}", (b, T, H), torch.float32)))
            h_last, hs = layer_fn(
                hs, lc, p["w_ih"], p["w_hh"], *(p[k] for k in bias_keys),
                pool=pool if last else "none", weights_dtype=weights_dtype,
                **kw)
        return into(h_last, hs, h_dst, o_dst)

    if chunk is None or chunk >= B:
        return run(x, lengths)
    ws = Workspace(x.device) if x.device.type == "cuda" else None
    H = layers[-1]["w_hh"].shape[0]
    return run_batch_chunks(
        lambda xc, lc, h, o: run(xc, lc, h, o, ws), x, lengths, chunk,
        (B, H) if pool == "mean" else (B, T, H))


RNN_WEIGHT_KEYS = ("w_ih", "w_hh")


def prepare_rnn_weights(
    rnn_params: Dict[str, Dict[str, torch.Tensor]],
    weights_dtype: torch.dtype,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The recurrence tree (``{"layer0": {...}, ...}``) with W_ih / W_hh cast
    once to ``weights_dtype`` and made contiguous, and everything else as
    it was.  ``lstm_layer`` / ``gru_layer`` take such tensors untouched
    (``.to()`` of a tensor already in that dtype returns it), so a retriever
    that prepares its tree when it is built converts no weight per batch."""
    return {
        name: {k: (v.to(weights_dtype).contiguous()
                   if k in RNN_WEIGHT_KEYS else v)
               for k, v in layer.items()}
        for name, layer in rnn_params.items()
    }
