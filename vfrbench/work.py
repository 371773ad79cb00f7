"""The yardstick's arithmetic: the card's peaks and each stage's work.

The peaks are NVIDIA's data-sheet rates of one H100 SXM (dense, without
sparsity, at its 700 W limit), frozen here from the port's
``utils/timing.py`` with its ``bound``: the least time the card could take
for a given number of bytes and operations.  An f32 product can run as f32
FMAs or, to the same accuracy, as three TF32 tensor-core products, so the
operations time of "float32" in ``bound`` is the lesser of the two; an
``mfu`` takes each operation at the plain peak of the dtype it runs in.

The work of a stage is counted from shapes alone, the same whatever
implements it: each input byte read once, each output byte written once,
and the recurrence's operations over the live steps only (a query of
length L does L steps), as the port's kernel table counts them.
"""

from __future__ import annotations

from typing import Dict, Tuple

BYTES_PER_S = 3.35e12                # HBM3
PEAK_FLOPS = {"bfloat16": 989e12,    # tensor cores, dense
              "tf32": 495e12,        # tensor cores, dense
              "float32": 67e12}      # f32 outside the tensor cores

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound(bytes_moved: float, ops: Dict[str, float]) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the larger of the bytes over the
    HBM rate and the operations over their peaks (``ops`` maps a dtype to
    its operations)."""
    t_bytes = bytes_moved / BYTES_PER_S
    t_ops = 0.0
    for dtype, n in ops.items():
        t = n / PEAK_FLOPS[dtype]
        if dtype == "float32":
            t = min(t, 3.0 * n / PEAK_FLOPS["tf32"])
        t_ops += t
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def seconds_at_peak(ops: Dict[str, float]) -> float:
    """Seconds the operations take at the plain peak of their dtypes: the
    numerator of an ``mfu``."""
    return sum(n / PEAK_FLOPS[dtype] for dtype, n in ops.items())


def add(*parts: Dict[str, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0.0) + v
    return out


# ------------------------------------------------------------- serving

def encode_work(s: Dict) -> Tuple[float, Dict[str, float]]:
    """(bytes, operations by dtype) of encoding one batch of queries.

    ``s``: ``Q``, ``live_steps`` (the sum of the batch's lengths), ``T``,
    ``E``, ``H``, ``layers``, ``d``, ``streams``, ``compute_dtype``,
    ``per_stream_proj``.  The recurrence multiplies bf16 operands (the
    serving kernel's, whatever the compute dtype); the projection runs at
    the compute dtype, its products in f32."""
    Q, L, E, H = s["Q"], s["live_steps"], s["E"], s["H"]
    d, S, layers = s["d"], s["streams"], s["layers"]
    n_proj = S if s["per_stream_proj"] else 1
    rec = 0.0
    w_bytes = 0.0
    for layer in range(layers):
        e_in = E if layer == 0 else H
        rec += 2.0 * L * 4 * H * (e_in + H)
        w_bytes += (e_in + H) * 4 * H * 2 + 4 * H * 4
    proj = 2.0 * Q * H * d * n_proj
    bytes_ = (L * E * 4                    # the live tokens' embedding rows
              + w_bytes                    # W_ih, W_hh (bf16), bias
              + n_proj * (H * d + d) * 4   # projection
              + S * Q * d * 4)             # the queries out
    return bytes_, {"bfloat16": rec, "float32": proj}


def score_work(s: Dict) -> Tuple[float, Dict[str, float]]:
    """(bytes, operations) of scoring a batch against the index: the index
    rows and their squared norms read once, the queries read once, the
    [Q, N] f32 scores written once; 2 Q N S d operations at the product
    dtype (``score_dtype``)."""
    Q, N, S, d = s["Q"], s["N"], s["streams"], s["d"]
    bytes_ = (S * N * d * DTYPE_BYTES[s["index_dtype"]] + N * 4
              + S * Q * d * 4 + Q * N * 4)
    return bytes_, {s["score_dtype"]: 2.0 * Q * N * S * d}


def select_work(s: Dict) -> Tuple[float, Dict[str, float]]:
    """(bytes, operations) of the top-k: the [Q, N] scores read once, the
    [Q, k] values (f32) and rows (int64) written once; no products."""
    Q, N, k = s["Q"], s["N"], s["k"]
    return Q * N * 4 + Q * k * (4 + 8), {}


# ------------------------------------------------------------ training

def train_work(s: Dict) -> Dict[str, float]:
    """Operations of one train step, forward and backward, in f32.

    ``s``: ``B``, ``live_steps``, ``E``, ``H``, ``layers``, ``d``,
    ``streams``, ``clips`` (C), ``F``, ``P``, ``hard`` (mined negatives per
    query), ``per_stream_proj``.  The moment tower is counted in the
    preset's factored order (one [rows, F] x [F, 2d] product per stream),
    its features being data (no gradient to them); the recurrence over the
    live steps, its inputs frozen embeddings (no gradient to them); the
    cosine cross distances as one [B, d] x [d, B P] product per stream."""
    B, L, E, H = s["B"], s["live_steps"], s["E"], s["H"]
    d, S, C, F, P = s["d"], s["streams"], s["clips"], s["F"], s["P"]
    Hn, layers = s["hard"], s["layers"]
    n_proj = S if s["per_stream_proj"] else 1
    ops = 0.0
    for layer in range(layers):
        e_in = E if layer == 0 else H
        ops += 2.0 * L * 4 * H * (e_in + H)            # forward
        # backward: dW_ih, dW_hh and the carry's gradient; an inner
        # layer's input gradient too
        ops += 2.0 * L * 4 * H * (e_in + 2 * H + (H if layer else 0))
    ops += 3 * 2.0 * B * H * d * n_proj                 # fwd, dW, dh
    rows = B * C * (1 + Hn)
    ops += S * 2 * (2.0 * rows * F * 2 * d)             # fwd + dW
    ops += S * 3 * (2.0 * B * P * C * d + 2.0 * B * Hn * C * d)  # pool mix
    ops += S * 3 * (2.0 * B * B * P * d + 2.0 * B * Hn * d)      # distances
    return {"float32": ops}
