"""LSTM and GRU over token embeddings: the plain step-by-step twins of the
JAX package's ``ops/lstm.py::lstm_forward`` / ``gru_forward`` (f32 training
precision by default).

Gate layouts follow torch's chunk orders, (i, f, g, o) for the LSTM and
(r, z, n) for the GRU; padded steps (t >= length) freeze the carry, so
``h_last`` is the state after each sequence's last real token.  The
serving kernels live in ``ops/kernels/lstm_kernel.py`` and
``ops/kernels/gru_kernel.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from vfr_tpu_torch.device import mm_f32


def init_lstm_params(
    generator: torch.Generator, input_dim: int, hidden: int,
    num_layers: int = 1, forget_bias: float = 1.0,
    dtype: torch.dtype = torch.float32, device="cpu",
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Uniform(-k, k) init with k = 1/sqrt(hidden) (torch-compatible), +1
    on the forget-gate bias.  Draws come from ``generator`` (CPU) and are
    then moved to ``device``."""
    k = 1.0 / math.sqrt(hidden)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * (2 * k) - k).to(dtype)

    params = {}
    for layer in range(num_layers):
        in_dim = input_dim if layer == 0 else hidden
        w_ih = uniform(in_dim, 4 * hidden)
        w_hh = uniform(hidden, 4 * hidden)
        b = uniform(4 * hidden)
        if forget_bias:
            b[hidden : 2 * hidden] += forget_bias
        params[f"layer{layer}"] = {"w_ih": w_ih.to(device),
                                   "w_hh": w_hh.to(device),
                                   "b": b.to(device)}
    return params


def cell_update(gates: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i, f, g, o) gate pre-activations [B, 4H] + c -> (h', c')."""
    H = c.shape[-1]
    i = torch.sigmoid(gates[:, 0 * H : 1 * H])
    f = torch.sigmoid(gates[:, 1 * H : 2 * H])
    g = torch.tanh(gates[:, 2 * H : 3 * H])
    o = torch.sigmoid(gates[:, 3 * H : 4 * H])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def init_gru_params(
    generator: torch.Generator, input_dim: int, hidden: int,
    num_layers: int = 1, dtype: torch.dtype = torch.float32, device="cpu",
) -> Dict[str, Dict[str, torch.Tensor]]:
    """GRU params in torch layout: gates (r, z, n), ``w_ih [E, 3H]``,
    ``w_hh [H, 3H]`` and separate ``b_ih``, ``b_hh [3H]`` (the n gate needs
    r * (h W_hn + b_hn), so the two biases do not merge).  Uniform(-k, k),
    k = 1/sqrt(hidden); draws come from ``generator`` (CPU)."""
    k = 1.0 / math.sqrt(hidden)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * (2 * k) - k).to(dtype).to(device)

    params = {}
    for layer in range(num_layers):
        in_dim = input_dim if layer == 0 else hidden
        params[f"layer{layer}"] = {
            "w_ih": uniform(in_dim, 3 * hidden),
            "w_hh": uniform(hidden, 3 * hidden),
            "b_ih": uniform(3 * hidden),
            "b_hh": uniform(3 * hidden),
        }
    return params


def gru_cell_update(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor
                    ) -> torch.Tensor:
    """(r, z, n) pre-activations gi = x W_ih + b_ih and gh = h W_hh + b_hh
    [B, 3H] + h -> h'.  b_hn stays inside r * (...)."""
    H = h.shape[-1]
    r = torch.sigmoid(gi[:, 0 * H : 1 * H] + gh[:, 0 * H : 1 * H])
    z = torch.sigmoid(gi[:, 1 * H : 2 * H] + gh[:, 1 * H : 2 * H])
    n = torch.tanh(gi[:, 2 * H : 3 * H] + r * gh[:, 2 * H : 3 * H])
    return (1.0 - z) * n + z * h


def gru_forward(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,                 # [B, T, E]
    lengths: torch.Tensor,           # [B] int
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU twin of ``lstm_forward``: (h_last [B, H], hs [B, T, H]), x, h and
    the weights rounded to ``compute_dtype`` before each product, f32 sums,
    frozen carry on padded steps."""
    B, T, _ = x.shape
    hs = x
    h_last = None
    for layer in range(len(params)):
        p = params[f"layer{layer}"]
        H = p["w_hh"].shape[0]
        h = torch.zeros(B, H, dtype=torch.float32, device=x.device)
        seq = []
        for t in range(T):
            gi = mm_f32(hs[:, t], p["w_ih"], compute_dtype) + p["b_ih"]
            gh = mm_f32(h, p["w_hh"], compute_dtype) + p["b_hh"]
            h = torch.where((t < lengths)[:, None],
                            gru_cell_update(gi, gh, h), h)
            seq.append(h)
        hs = torch.stack(seq, dim=1)
        h_last = h
    return h_last, hs


def lstm_forward(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,                 # [B, T, E]
    lengths: torch.Tensor,           # [B] int
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h_last [B, H], hs [B, T, H]); x, h and the weights are
    rounded to ``compute_dtype`` before each product, f32 accumulation."""
    B, T, _ = x.shape
    hs = x
    h_last = None
    for layer in range(len(params)):
        p = params[f"layer{layer}"]
        H = p["w_hh"].shape[0]
        h = torch.zeros(B, H, dtype=torch.float32, device=x.device)
        c = torch.zeros_like(h)
        seq = []
        for t in range(T):
            gates = (mm_f32(hs[:, t], p["w_ih"], compute_dtype)
                     + mm_f32(h, p["w_hh"], compute_dtype) + p["b"])
            h_new, c_new = cell_update(gates, c)
            live = (t < lengths)[:, None]
            h = torch.where(live, h_new, h)
            c = torch.where(live, c_new, c)
            seq.append(h)
        hs = torch.stack(seq, dim=1)
        h_last = h
    return h_last, hs


def masked_mean_pool(hs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Length-masked mean over hidden states: [B, T, H] -> [B, H].  hs at
    t >= length holds the frozen carry, so the mask is required."""
    T = hs.shape[1]
    mask = (torch.arange(T, device=hs.device)[None, :]
            < lengths[:, None]).to(hs.dtype)
    return (hs * mask[:, :, None]).sum(dim=1) / torch.clamp(
        lengths[:, None].to(hs.dtype), min=1.0)
