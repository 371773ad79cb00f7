"""Two-tower joint-embedding model (MCN lineage), inference towers.

Query tower:  GloVe lookup -> LSTM or GRU -> Linear -> joint space R^d.
Moment tower: per stream (rgb / flow), the factored form: because segment
              pooling and the projection are both linear,
              ``concat(local, global, tef) @ W`` = ``poolmix(feats @
              W_local) + mean(feats @ W_global) + tef @ W_tef``.

Parameters are a nested dict of tensors with the JAX package's keys and
layouts (``bridge.params_from_numpy`` converts its trees).  Not ported yet:
the direct moment form, ``pooling="max"`` and training-time dropout.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vfr_tpu_torch.config import ModelConfig
from vfr_tpu_torch.device import mm_f32, torch_dtype
from vfr_tpu_torch.ops.lstm import (
    gru_forward,
    init_gru_params,
    init_lstm_params,
    lstm_forward,
    masked_mean_pool,
)


class Model(NamedTuple):
    """Static model context: config + constant tables, passed alongside
    params.  The tables stay numpy (moved to the params' device on use)."""
    cfg: ModelConfig
    streams: Sequence[str]            # e.g. ("rgb",) or ("rgb", "flow")
    pool_matrix: np.ndarray           # [P, C] mean-pooling matrix
    tef: Optional[np.ndarray]         # [P, 2] static TEF or None
    freeze_embeddings: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.compute_dtype)


def _linear_init(generator, in_dim, out_dim, dtype, device):
    k = 1.0 / math.sqrt(in_dim)
    u = torch.rand((in_dim, out_dim), generator=generator,
                   dtype=torch.float32)
    return {"w": (u * (2 * k) - k).to(dtype).to(device),
            "b": torch.zeros(out_dim, dtype=dtype, device=device)}


def _linear(p, x, compute_dtype):
    return mm_f32(x, p["w"], compute_dtype) + p["b"]


def moment_input_dim(cfg: ModelConfig, feature_dim: int) -> int:
    d = feature_dim
    if cfg.use_global_context:
        d += feature_dim
    if cfg.use_tef:
        d += 2
    return d


def init_model_params(
    generator: torch.Generator,
    model: Model,
    glove_table: np.ndarray,          # [V, E]
    feature_dim: int,
    device="cpu",
) -> Dict:
    """Seeded parameters (draw order: recurrence, query projection(s),
    moment projections).  The recurrence sits under "lstm" for both cells,
    as in the JAX package.  ``torch.Generator`` draws differ from
    ``jax.random``'s at the same seed: the same seed gives different
    weights in the two packages; carry weights across with
    ``bridge.params_from_numpy``."""
    cfg = model.cfg
    dtype = torch_dtype(cfg.param_dtype)
    init_rnn = init_gru_params if cfg.rnn_cell == "gru" else init_lstm_params
    params: Dict = {
        "embeddings": torch.as_tensor(
            np.asarray(glove_table, np.float32)).to(dtype).to(device),
        "lstm": init_rnn(generator, glove_table.shape[1], cfg.lstm_hidden,
                         cfg.lstm_layers, dtype=dtype, device=device),
    }
    if cfg.per_stream_query_proj:
        for s in model.streams:
            params[f"query_proj_{s}"] = _linear_init(
                generator, cfg.lstm_hidden, cfg.joint_dim, dtype, device)
    else:
        params["query_proj"] = _linear_init(
            generator, cfg.lstm_hidden, cfg.joint_dim, dtype, device)
    if cfg.query_pool == "attn":
        params["query_attn"] = torch.zeros(cfg.lstm_hidden, dtype=dtype,
                                           device=device)
    in_dim = moment_input_dim(cfg, feature_dim)
    for s in model.streams:
        params[f"moment_proj_{s}"] = _linear_init(
            generator, in_dim, cfg.joint_dim, dtype, device)
    return params


def use_pallas(cfg: ModelConfig, device: torch.device) -> bool:
    """Kernel dispatch (the config keeps the JAX package's field name):
    "auto" runs the CUDA kernel for CUDA tensors, "always" / "never"
    override (on the CPU "always" runs the kernel's plain version)."""
    if cfg.use_pallas == "never":
        return False
    if cfg.use_pallas == "always":
        return True
    return torch.device(device).type == "cuda"


def prepare_query_params(params: Dict, model: Model,
                         rnn_kernel: Optional[str] = None) -> Dict:
    """``params`` with the recurrence weights the inference kernel path
    multiplies with (W_ih, W_hh of every layer) cast once to the kernel's
    bf16, so that no batch converts them again; the tree itself when that
    path would not run (``rnn_kernel``, ``use_pallas`` and the params'
    device decide, as in ``_query_hidden``).  Results are those of the
    unprepared tree: the kernel and its plain version round to bf16
    themselves.  Every other path (the f32 scan twin, training) needs the
    original tree."""
    from vfr_tpu_torch.ops.kernels.rnn_plan import prepare_rnn_weights

    cfg = model.cfg
    if rnn_kernel is None:
        want = use_pallas(cfg, params["embeddings"].device)
    else:
        want = rnn_kernel in ("pallas", "plain") and cfg.use_pallas != "never"
    if not want:
        return params
    return {**params,
            "lstm": prepare_rnn_weights(params["lstm"], torch.bfloat16)}


def _query_hidden(
    params: Dict, model: Model, tokens: torch.Tensor, lengths: torch.Tensor,
    inference: bool, rnn_kernel: Optional[str] = None,
) -> torch.Tensor:
    """GloVe -> LSTM or GRU trunk (cfg.rnn_cell); the pooled query
    representation [B, H] (cfg.query_pool: last, mean or attn).

    ``rnn_kernel``: None = the ``use_pallas`` policy on inference paths;
    "scan" = the f32 step twin (``ops.lstm.lstm_forward`` /
    ``gru_forward``); "pallas" = the CUDA kernel (its plain version for CPU
    tensors); "plain" = the kernel's plain version on any device, for
    holding the kernel against it on the card."""
    from vfr_tpu_torch.ops.kernels import gru_kernel, lstm_kernel

    cfg = model.cfg
    if cfg.rnn_cell == "gru":
        kernel_fn, plain_fn, scan_fn = (gru_kernel.cuda_gru,
                                        gru_kernel.gru_recurrence_plain,
                                        gru_forward)
    else:
        kernel_fn, plain_fn, scan_fn = (lstm_kernel.cuda_lstm,
                                        lstm_kernel.lstm_recurrence_plain,
                                        lstm_forward)
    x = params["embeddings"][tokens.long()]                  # [B, T, E]
    if rnn_kernel is None:
        want_kernel = inference and use_pallas(cfg, x.device)
    elif rnn_kernel in ("pallas", "plain"):
        want_kernel = inference and cfg.use_pallas != "never"
    elif rnn_kernel == "scan":
        want_kernel = False
    else:
        raise ValueError(f"unknown rnn_kernel {rnn_kernel!r}")
    # with the mean pool the kernel fuses the pooling into the recurrence
    kernel_pool = "mean" if cfg.query_pool == "mean" else "none"
    if want_kernel:
        layer_fn = {}
        if rnn_kernel == "plain":
            layer_fn["layer_fn"] = plain_fn
        h_last, hs = kernel_fn(params["lstm"], x, lengths, pool=kernel_pool,
                               **layer_fn)
    else:
        h_last, hs = scan_fn(params["lstm"], x, lengths, model.compute_dtype)
    if cfg.query_pool == "mean":
        return hs if want_kernel else masked_mean_pool(hs, lengths)
    if cfg.query_pool == "attn":
        T = hs.shape[1]
        mask = torch.arange(T, device=hs.device)[None, :] < lengths[:, None]
        scores = torch.einsum("bth,h->bt", hs,
                              params["query_attn"].to(hs.dtype))
        w = torch.softmax(torch.where(mask, scores,
                                      torch.full_like(scores, -1e30)), dim=1)
        return torch.einsum("bt,bth->bh", w, hs)
    if cfg.query_pool == "last":
        return h_last
    raise ValueError(f"unknown query_pool {cfg.query_pool!r}")


def _maybe_normalize(cfg: ModelConfig, v: torch.Tensor) -> torch.Tensor:
    if cfg.normalize_embeddings:
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-8)
    return v


def embed_queries(
    params: Dict, model: Model, tokens: torch.Tensor, lengths: torch.Tensor,
    inference: bool = False, rnn_kernel: Optional[str] = None,
) -> torch.Tensor:
    """tokens [B, T], lengths [B] -> [B, d] f32 (shared projection)."""
    if model.cfg.per_stream_query_proj:
        raise ValueError("per_stream_query_proj=True: use embed_queries_multi()")
    h = _query_hidden(params, model, tokens, lengths, inference, rnn_kernel)
    return _maybe_normalize(model.cfg,
                            _linear(params["query_proj"], h,
                                    model.compute_dtype))


def embed_queries_multi(
    params: Dict, model: Model, tokens: torch.Tensor, lengths: torch.Tensor,
    inference: bool = False, rnn_kernel: Optional[str] = None,
) -> torch.Tensor:
    """Per-stream query embeddings [S, B, d]: per-stream projections over
    the shared trunk, or the shared projection repeated."""
    h = _query_hidden(params, model, tokens, lengths, inference, rnn_kernel)
    cfg = model.cfg
    cdt = model.compute_dtype
    if cfg.per_stream_query_proj:
        return torch.stack([
            _maybe_normalize(cfg, _linear(params[f"query_proj_{s}"], h, cdt))
            for s in model.streams])
    q = _maybe_normalize(cfg, _linear(params["query_proj"], h, cdt))
    return torch.stack([q for _ in model.streams])


def _global_context(f, context_mask):
    if context_mask is not None:
        m = context_mask.float()
        return (f * m[:, :, None]).sum(1) / (m.sum(1, keepdim=True) + 1e-6)
    return f.mean(dim=1)


def _split_moment_proj(cfg: ModelConfig, w: torch.Tensor):
    """Split the [D_in, d] projection into (W_local, W_global, W_tef) rows
    matching the concat order local | global | tef."""
    F = (w.shape[0] - (2 if cfg.use_tef else 0)) // (
        2 if cfg.use_global_context else 1)
    w_local = w[:F]
    off = F
    w_global = None
    if cfg.use_global_context:
        w_global = w[off : off + F]
        off += F
    w_tef = w[off:] if cfg.use_tef else None
    return w_local, w_global, w_tef


def embed_moments(
    params: Dict,
    model: Model,
    feats: Dict[str, torch.Tensor],             # stream -> [B, C, F]
    tef: Optional[torch.Tensor] = None,         # [B, P, 2] overrides static
    context_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Per-stream moment embeddings, stream -> [B, P, d] (factored form)."""
    cfg = model.cfg
    if cfg.pooling != "mean" or cfg.moment_impl != "factored":
        raise NotImplementedError(
            "only the factored mean-pool moment tower is ported to "
            f"vfr_tpu_torch (pooling={cfg.pooling!r}, "
            f"moment_impl={cfg.moment_impl!r})")
    cdt = model.compute_dtype
    out = {}
    for s in model.streams:
        f = feats[s]
        B, C, F = f.shape
        dev = f.device
        pm = torch.as_tensor(model.pool_matrix, dtype=torch.float32,
                             device=dev)
        P = pm.shape[-2]
        p = params[f"moment_proj_{s}"]
        w_local, w_global, w_tef = _split_moment_proj(cfg, p["w"])
        flat = f.reshape(B * C, F)
        if w_global is not None:
            w_cat = torch.cat([w_local, w_global], dim=1)
            z = mm_f32(flat, w_cat, cdt).reshape(B, C, -1)
            d = z.shape[-1] // 2
            z_local, z_global = z[..., :d], z[..., d:]
        else:
            z_local = mm_f32(flat, w_local, cdt).reshape(B, C, -1)
            z_global = None
        m_emb = torch.einsum("pc,bcd->bpd", pm, z_local)
        if z_global is not None:
            m_emb = m_emb + _global_context(z_global, context_mask)[:, None, :]
        if cfg.use_tef:
            t = tef if tef is not None else model.tef
            if t is None:
                raise ValueError("use_tef=True but no TEF table provided")
            t = torch.as_tensor(t, dtype=torch.float32, device=dev)
            if t.ndim == 2:
                t = t[None].expand(B, P, 2)
            m_emb = m_emb + torch.einsum("bpt,td->bpd", t, w_tef.float())
        m_emb = m_emb + p["b"]
        if cfg.normalize_embeddings:
            m_emb = m_emb / (torch.linalg.norm(m_emb, dim=-1, keepdim=True)
                             + 1e-8)
        out[s] = m_emb
    return out
