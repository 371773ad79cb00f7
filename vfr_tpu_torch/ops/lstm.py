"""LSTM and GRU over token embeddings: the plain step-by-step twins of the
JAX package's ``ops/lstm.py::lstm_forward`` / ``gru_forward`` (f32 training
precision by default), and the trainable fused layers
``lstm_forward_fused`` / ``gru_forward_fused``.

Gate layouts follow torch's chunk orders, (i, f, g, o) for the LSTM and
(r, z, n) for the GRU; padded steps (t >= length) freeze the carry, so
``h_last`` is the state after each sequence's last real token.  The
serving kernels live in ``ops/kernels/lstm_kernel.py`` and
``ops/kernels/gru_kernel.py``.

The fused layers are ``torch.autograd.Function``s with the JAX package's
hand-written BPTT (its custom VJPs): forward hoists the input projection
into one sequence-sized product and keeps time-major residuals (hidden and
cell states, post-activation gates; the GRU's hidden-side n pre-activation);
backward walks the steps in reverse with the elementwise gate math and one
``[B, G·H] @ [G·H, H]`` product per step, then forms dW_ih, dW_hh, the
biases and dx each as one sequence-sized product.  The factors of the gate
derivatives that do not depend on the carried gradient, and the liveness
mask of padded steps, are formed for all steps at once before the loop, so
a reverse step is a handful of launches.  Always f32.
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


def _live(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[T, B, 1] f32: 1 where step t < length, else 0."""
    t = torch.arange(T, device=lengths.device)[:, None]
    return (t < lengths[None, :]).to(torch.float32)[..., None]


def _shift(seq: torch.Tensor) -> torch.Tensor:
    """[T, B, H] -> the carries before each step: zeros, seq[:-1]."""
    return torch.cat([torch.zeros_like(seq[:1]), seq[:-1]], dim=0)


def _input_grads(ctx, x, w_ih, dG):
    """(dx, dW_ih, db) of the hoisted input product from the gate
    gradients dG [T, B, G]: sequence-sized products."""
    T, B, G = dG.shape
    dGf = dG.reshape(T * B, G)
    xt = x.transpose(0, 1).reshape(T * B, -1)
    dw_ih = xt.t() @ dGf
    dx = None
    if ctx.needs_input_grad[0]:
        dx = (dGf @ w_ih.t()).view(T, B, -1).transpose(0, 1)
    return dx, dw_ih, dGf.sum(0)


class _LSTMLayer(torch.autograd.Function):
    """One fused LSTM layer: (x [B, T, E], lengths [B], W_ih [E, 4H],
    W_hh [H, 4H], b [4H]) -> (h_last [B, H], hs [B, T, H])."""

    @staticmethod
    def forward(ctx, x, lengths, w_ih, w_hh, b):
        B, T, _ = x.shape
        H = w_hh.shape[0]
        gx = torch.matmul(x.transpose(0, 1), w_ih) + b      # [T, B, 4H]
        live = _live(lengths, T) > 0
        h = x.new_zeros(B, H)
        c = x.new_zeros(B, H)
        hs, cs, acts = [], [], []
        for t in range(T):
            gates = torch.addmm(gx[t], h, w_hh)
            a = torch.sigmoid(gates)
            a[:, 2 * H : 3 * H] = torch.tanh(gates[:, 2 * H : 3 * H])
            i, f, g, o = a.split(H, dim=1)
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            h = torch.where(live[t], h_new, h)
            c = torch.where(live[t], c_new, c)
            hs.append(h)
            cs.append(c)
            acts.append(a)
        hs, cs, acts = torch.stack(hs), torch.stack(cs), torch.stack(acts)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, lengths, w_ih, w_hh, hs, cs, acts)
        return h, hs.transpose(0, 1)

    @staticmethod
    def backward(ctx, dh_last, dhs_bt):
        x, lengths, w_ih, w_hh, hs, cs, acts = ctx.saved_tensors
        T, B, H = hs.shape
        live = _live(lengths, T)
        dead = 1.0 - live
        i, f, g, o = acts.view(T, B, 4, H).unbind(2)
        tanh_c = torch.tanh(cs)
        # dc_tot = dc + dh * a_c; the gate pre-activation gradients are
        # dc_tot * k[i, f, g] and dh * k[o], zero on padded steps
        a_c = o * (1.0 - tanh_c * tanh_c)
        k = torch.stack([g * i * (1.0 - i),
                         _shift(cs) * f * (1.0 - f),
                         i * (1.0 - g * g),
                         tanh_c * o * (1.0 - o)], dim=2) * live[..., None]
        f_live = f * live
        dhs = None if dhs_bt is None else dhs_bt.transpose(0, 1)
        dh = hs.new_zeros(B, H) if dh_last is None else dh_last
        dc = hs.new_zeros(B, H)
        dG = hs.new_empty(T, B, 4, H)
        w_hh_t = w_hh.t()
        for t in range(T - 1, -1, -1):
            if dhs is not None:
                dh = dh + dhs[t]
            dc_tot = torch.addcmul(dc, dh, a_c[t])
            torch.mul(torch.stack([dc_tot, dc_tot, dc_tot, dh], dim=1), k[t],
                      out=dG[t])
            # live: dG W_hh^T and dc_tot f; padded: the carry passes through
            dh = torch.addmm(dh * dead[t], dG[t].view(B, 4 * H), w_hh_t)
            dc = torch.addcmul(dc * dead[t], dc_tot, f_live[t])
        dG = dG.view(T, B, 4 * H)
        dx, dw_ih, db = _input_grads(ctx, x, w_ih, dG)
        dw_hh = _shift(hs).reshape(T * B, H).t() @ dG.reshape(T * B, 4 * H)
        return dx, None, dw_ih, dw_hh, db


class _GRULayer(torch.autograd.Function):
    """One fused GRU layer: (x [B, T, E], lengths [B], W_ih [E, 3H],
    W_hh [H, 3H], b_ih, b_hh [3H]) -> (h_last [B, H], hs [B, T, H])."""

    @staticmethod
    def forward(ctx, x, lengths, w_ih, w_hh, b_ih, b_hh):
        B, T, _ = x.shape
        H = w_hh.shape[0]
        gi = torch.matmul(x.transpose(0, 1), w_ih) + b_ih   # [T, B, 3H]
        live = _live(lengths, T) > 0
        h = x.new_zeros(B, H)
        hs, acts, gh_ns = [], [], []
        for t in range(T):
            gh = torch.addmm(b_hh, h, w_hh)
            rz = torch.sigmoid(gi[t, :, : 2 * H] + gh[:, : 2 * H])
            r, z = rz.split(H, dim=1)
            gh_n = gh[:, 2 * H :]
            n = torch.tanh(gi[t, :, 2 * H :] + r * gh_n)
            h_new = (1.0 - z) * n + z * h
            h = torch.where(live[t], h_new, h)
            hs.append(h)
            acts.append(torch.cat([rz, n], dim=1))
            gh_ns.append(gh_n)
        hs, acts, gh_ns = torch.stack(hs), torch.stack(acts), \
            torch.stack(gh_ns)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, lengths, w_ih, w_hh, hs, acts, gh_ns)
        return h, hs.transpose(0, 1)

    @staticmethod
    def backward(ctx, dh_last, dhs_bt):
        x, lengths, w_ih, w_hh, hs, acts, gh_ns = ctx.saved_tensors
        T, B, H = hs.shape
        live = _live(lengths, T)
        r, z, n = acts.view(T, B, 3, H).unbind(2)
        # every gate gradient is dh times a factor known before the loop
        k_n = (1.0 - z) * (1.0 - n * n)                    # -> dn_pre
        k_r = k_n * gh_ns * r * (1.0 - r)                  # -> dr_pre
        k_z = (_shift(hs) - n) * z * (1.0 - z)             # -> dz_pre
        k_gi = torch.stack([k_r, k_z, k_n], dim=2) * live[..., None]
        k_gh = torch.stack([k_r, k_z, k_n * r], dim=2) * live[..., None]
        z_live = z * live + (1.0 - live)
        dhs = None if dhs_bt is None else dhs_bt.transpose(0, 1)
        dh = hs.new_zeros(B, H) if dh_last is None else dh_last
        dGI = hs.new_empty(T, B, 3, H)
        dGH = hs.new_empty(T, B, 3, H)
        w_hh_t = w_hh.t()
        for t in range(T - 1, -1, -1):
            if dhs is not None:
                dh = dh + dhs[t]
            torch.mul(dh[:, None, :], k_gi[t], out=dGI[t])
            torch.mul(dh[:, None, :], k_gh[t], out=dGH[t])
            # live: dh z + dGH W_hh^T; padded: the carry passes through
            dh = torch.addmm(dh * z_live[t], dGH[t].view(B, 3 * H), w_hh_t)
        dGI = dGI.view(T, B, 3 * H)
        dGH = dGH.view(T * B, 3 * H)
        dx, dw_ih, db_ih = _input_grads(ctx, x, w_ih, dGI)
        dw_hh = _shift(hs).reshape(T * B, H).t() @ dGH
        return dx, None, dw_ih, dw_hh, db_ih, dGH.sum(0)


def lstm_forward_fused(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,                 # [B, T, E]
    lengths: torch.Tensor,           # [B] int (>= 1)
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trainable twin of ``lstm_forward`` (same values up to f32
    reassociation); gradients by the hand-written BPTT of ``_LSTMLayer``.
    ``compute_dtype`` is accepted for the signature; this path is f32."""
    hs, h_last = x, None
    for layer in range(len(params)):
        p = params[f"layer{layer}"]
        h_last, hs = _LSTMLayer.apply(hs, lengths, p["w_ih"], p["w_hh"],
                                      p["b"])
    return h_last, hs


def gru_forward_fused(
    params: Dict[str, Dict[str, torch.Tensor]],
    x: torch.Tensor,                 # [B, T, E]
    lengths: torch.Tensor,           # [B] int (>= 1)
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trainable twin of ``gru_forward``; gradients by ``_GRULayer``'s
    hand-written BPTT.  Always f32."""
    hs, h_last = x, None
    for layer in range(len(params)):
        p = params[f"layer{layer}"]
        h_last, hs = _GRULayer.apply(hs, lengths, p["w_ih"], p["w_hh"],
                                     p["b_ih"], p["b_hh"])
    return h_last, hs


def masked_mean_pool(hs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Length-masked mean over hidden states: [B, T, H] -> [B, H].  hs at
    t >= length holds the frozen carry, so the mask is required."""
    T = hs.shape[1]
    mask = (torch.arange(T, device=hs.device)[None, :]
            < lengths[:, None]).to(hs.dtype)
    return (hs * mask[:, :, None]).sum(dim=1) / torch.clamp(
        lengths[:, None].to(hs.dtype), min=1.0)
