"""Two-tower joint-embedding model (MCN lineage).

Query tower:  GloVe lookup -> LSTM or GRU -> Linear -> joint space R^d.
Moment tower: per stream (rgb / flow), segment pooling over the proposals
              (mean: the ``[P, C]`` or per-video ``[B, P, C]`` pooling
              matrix as a matmul; max: ``_segment_max``) + optional global
              context + optional TEF -> Linear -> R^{P x d}, in the direct
              order or, for mean pooling, the factored one.
Fusion:       per-stream distances combined by fixed stream weights
              (``fused_distances``; ``cross_distances`` for the training
              loss's query x batch tensor).

Parameters are a nested dict of tensors with the JAX package's keys and
layouts (``bridge.params_from_numpy`` converts its trees).  Training runs
the trunk through the fused autograd layers (``cfg.train_rnn_impl="fused"``)
or autograd through the step twins (``"scan"``); query dropout takes an
explicit keep mask, since ``jax.random``'s bits cannot be reproduced.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from vfr_tpu_torch.config import ModelConfig
from vfr_tpu_torch.device import mm_f32, torch_dtype
from vfr_tpu_torch.ops.lstm import (
    gru_forward,
    gru_forward_fused,
    init_gru_params,
    init_lstm_params,
    lstm_forward,
    lstm_forward_fused,
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
    dropout_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GloVe -> LSTM or GRU trunk (cfg.rnn_cell); the pooled query
    representation [B, H] (cfg.query_pool: last, mean or attn).

    ``rnn_kernel``: None = the ``use_pallas`` policy on inference paths;
    "scan" = the f32 step twin (``ops.lstm.lstm_forward`` /
    ``gru_forward``); "pallas" = the CUDA kernel (its plain version for CPU
    tensors); "plain" = the kernel's plain version on any device, for
    holding the kernel against it on the card.  Training
    (``inference=False``) runs the fused autograd layers when
    ``cfg.train_rnn_impl == "fused"``, else the step twin.

    ``dropout_keep`` [B, H] bool: the keep mask of query dropout
    (``cfg.query_dropout``), applied to the pooled representation in
    training only."""
    from vfr_tpu_torch.ops.kernels import gru_kernel, lstm_kernel

    cfg = model.cfg
    if cfg.rnn_cell == "gru":
        kernel_fn, plain_fn, scan_fn, fused_fn = (
            gru_kernel.cuda_gru, gru_kernel.gru_recurrence_plain,
            gru_forward, gru_forward_fused)
    else:
        kernel_fn, plain_fn, scan_fn, fused_fn = (
            lstm_kernel.cuda_lstm, lstm_kernel.lstm_recurrence_plain,
            lstm_forward, lstm_forward_fused)
    trunk_fn = (fused_fn if not inference and cfg.train_rnn_impl == "fused"
                else scan_fn)
    table = params["embeddings"]
    if model.freeze_embeddings:
        table = table.detach()
    x = table[tokens.long()]                                 # [B, T, E]
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
        h_last, hs = trunk_fn(params["lstm"], x, lengths, model.compute_dtype)
    if cfg.query_pool == "mean":
        h = hs if want_kernel else masked_mean_pool(hs, lengths)
    elif cfg.query_pool == "attn":
        T = hs.shape[1]
        mask = torch.arange(T, device=hs.device)[None, :] < lengths[:, None]
        scores = torch.einsum("bth,h->bt", hs,
                              params["query_attn"].to(hs.dtype))
        w = torch.softmax(torch.where(mask, scores,
                                      torch.full_like(scores, -1e30)), dim=1)
        h = torch.einsum("bt,bth->bh", w, hs)
    elif cfg.query_pool == "last":
        h = h_last
    else:
        raise ValueError(f"unknown query_pool {cfg.query_pool!r}")
    rate = cfg.query_dropout
    if dropout_keep is not None and rate > 0.0 and not inference:
        h = torch.where(dropout_keep, h / (1.0 - rate), torch.zeros_like(h))
    return h


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
    dropout_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-stream query embeddings [S, B, d]: per-stream projections over
    the shared trunk, or the shared projection repeated."""
    h = _query_hidden(params, model, tokens, lengths, inference, rnn_kernel,
                      dropout_keep)
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


Table = Union[np.ndarray, torch.Tensor]

# bytes of the [B, p, C, F] masked block one step of _segment_max holds
SEGMENT_MAX_BYTES = 1 << 28


def _table(t: Table, device) -> torch.Tensor:
    """A static table (numpy or tensor) as f32 on ``device``."""
    return torch.as_tensor(t, dtype=torch.float32, device=device)


def _pool_segments(pool_matrix: torch.Tensor, feats: torch.Tensor,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """[P, C] (or per-video [B, P, C]) x [B, C, F] -> [B, P, F]: segment
    mean pooling as one matmul, operands rounded to ``compute_dtype``, f32
    products and sums."""
    eq = "pc,bcf->bpf" if pool_matrix.ndim == 2 else "bpc,bcf->bpf"
    return torch.einsum(eq, pool_matrix.to(compute_dtype).float(),
                        feats.to(compute_dtype).float())


def _segment_max(pool_matrix: torch.Tensor, feats: torch.Tensor,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """Segment max pooling [B, P, F] (``ModelConfig.pooling="max"``).

    The span membership is the (mean or per-video) pooling matrix's
    nonzero pattern; rows outside a span count as -inf, and a span with no
    member rows (a padded bank window) pools to 0.  The reference masks
    all of [B, P, C, F] at once; here ``chunk`` proposals at a time (by
    default as many as fit ``SEGMENT_MAX_BYTES``), which gives the same
    maxima bit for bit."""
    ind = pool_matrix > 0                                # [P, C] or [B, P, C]
    B, C, F = feats.shape
    P = ind.shape[-2]
    if chunk is None:
        chunk = max(1, SEGMENT_MAX_BYTES // max(1, B * C * F
                                                * feats.element_size()))
    neg = torch.tensor(float("-inf"), dtype=feats.dtype, device=feats.device)
    outs = []
    for p0 in range(0, P, chunk):
        sel = ind[..., p0 : p0 + chunk, :]
        sel = sel[None, :, :, None] if sel.ndim == 2 else sel[..., None]
        outs.append(torch.where(sel, feats[:, None], neg).amax(dim=2))
    out = torch.cat(outs, dim=1)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def tables_on(model: Model, device) -> Model:
    """``model`` with its static tables (pooling matrix, TEF) as f32
    tensors on ``device``, so that a step reading them copies nothing from
    the host (a copy from pageable host memory waits for the device)."""
    return model._replace(
        pool_matrix=_table(model.pool_matrix, device),
        tef=None if model.tef is None else _table(model.tef, device))


def _resolve_tef(model: Model, tef: Optional[Table], B: int, P: int,
                 device) -> torch.Tensor:
    t = tef if tef is not None else model.tef
    if t is None:
        raise ValueError("use_tef=True but no TEF table provided")
    t = _table(t, device)
    if t.ndim == 2:
        t = t[None].expand(B, P, 2)
    return t


def embed_moments(
    params: Dict,
    model: Model,
    feats: Dict[str, torch.Tensor],             # stream -> [B, C, F]
    tef: Optional[Table] = None,                # [B, P, 2] overrides static
    context_mask: Optional[torch.Tensor] = None,   # [B, C] valid-row mask
    pool_matrix: Optional[Table] = None,        # [B?, P, C] override
    impl: Optional[str] = None,                 # override cfg.moment_impl
) -> Dict[str, torch.Tensor]:
    """Per-stream moment embeddings: stream -> [B, P, d].

    "factored": because segment pooling and the projection are both
    linear, ``concat(local, global, tef) @ W`` = ``poolmix(feats @
    W_local) + mean(feats @ W_global) + tef @ W_tef``: one [B*C, F] GEMM
    whatever P is.  "direct": the textbook order (pool in feature space,
    concat, project).  ``pooling="max"`` is nonlinear and always runs
    direct."""
    cfg = model.cfg
    which = impl or cfg.moment_impl
    if cfg.pooling == "max":
        which = "direct"
    if which == "factored":
        return _embed_moments_factored(params, model, feats, tef,
                                       context_mask, pool_matrix)
    if which != "direct":
        raise ValueError(f"unknown moment_impl {which!r}")
    cdt = model.compute_dtype
    out = {}
    for s in model.streams:
        f = feats[s]
        B = f.shape[0]
        pm = _table(pool_matrix if pool_matrix is not None
                    else model.pool_matrix, f.device)
        if cfg.pooling == "max":
            local = _segment_max(pm, f)                        # [B, P, F]
        else:
            local = _pool_segments(pm, f, cdt)                 # [B, P, F]
        P = local.shape[1]
        parts = [local]
        if cfg.use_global_context:
            parts.append(_global_context(f, context_mask)[:, None, :]
                         .expand(local.shape))
        if cfg.use_tef:
            parts.append(_resolve_tef(model, tef, B, P, f.device))
        x = torch.cat(parts, dim=-1)                           # [B, P, D_in]
        out[s] = _maybe_normalize(
            cfg, _linear(params[f"moment_proj_{s}"], x, cdt))  # [B, P, d]
    return out


def _embed_moments_factored(params, model: Model, feats, tef, context_mask,
                            pool_matrix):
    cfg = model.cfg
    cdt = model.compute_dtype
    out = {}
    for s in model.streams:
        f = feats[s]
        B, C, F = f.shape
        pm = _table(pool_matrix if pool_matrix is not None
                    else model.pool_matrix, f.device)
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
        # pool mix in joint space: [B?, P, C] x [B, C, d] -> [B, P, d]
        m_emb = torch.einsum("pc,bcd->bpd" if pm.ndim == 2 else
                             "bpc,bcd->bpd", pm, z_local)
        if z_global is not None:
            m_emb = m_emb + _global_context(z_global, context_mask)[:, None, :]
        if cfg.use_tef:
            t = _resolve_tef(model, tef, B, P, f.device)
            m_emb = m_emb + torch.einsum("bpt,td->bpd", t, w_tef.float())
        m_emb = m_emb + p["b"]
        out[s] = _maybe_normalize(cfg, m_emb)
    return out


def _sq_dist(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """q [..., d], m [..., d] -> squared euclidean distance [...]."""
    diff = q - m
    return (diff * diff).sum(-1)


def _stream_distance(cfg: ModelConfig, q: torch.Tensor,
                     m: torch.Tensor) -> torch.Tensor:
    if cfg.distance == "sqeuclidean":
        return _sq_dist(q, m)
    if cfg.distance == "euclidean":
        return torch.sqrt(_sq_dist(q, m) + 1e-12)
    if cfg.distance == "cosine":
        qn = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-8)
        mn = m / (torch.linalg.norm(m, dim=-1, keepdim=True) + 1e-8)
        return 1.0 - (qn * mn).sum(-1)
    raise ValueError(f"unknown distance {cfg.distance!r}")


def fused_distances(
    model: Model,
    q: torch.Tensor,                        # [B, d] or per-stream [S, B, d]
    moments: Dict[str, torch.Tensor],       # stream -> [B, P, d]
) -> torch.Tensor:
    """Fused per-proposal distance D [B, P]; smaller = better match."""
    cfg = model.cfg
    D = None
    for i, (w, s) in enumerate(zip(cfg.stream_weights, model.streams)):
        q_s = q[i] if q.ndim == 3 else q
        d_s = _stream_distance(cfg, q_s[:, None, :], moments[s])
        D = w * d_s if D is None else D + w * d_s
    return D


def cross_distances(
    model: Model,
    q: torch.Tensor,                        # [Q, d] or per-stream [S, Q, d]
    moments: Dict[str, torch.Tensor],       # stream -> [V, P, d]
) -> torch.Tensor:
    """Query x corpus distance tensor [Q, V, P], one matmul per stream:
    ||q - m||^2 = |q|^2 + |m|^2 - 2 q.m, floored at 0 with
    ``torch.maximum`` (which, like ``jnp.maximum``, splits the gradient at
    a tie; ``clamp`` would not)."""
    cfg = model.cfg
    cdt = model.compute_dtype
    per_stream_q = q.ndim == 3
    Q = q.shape[1] if per_stream_q else q.shape[0]
    out = None
    for i, (w, s) in enumerate(zip(cfg.stream_weights, model.streams)):
        m = moments[s]
        q_i = q[i] if per_stream_q else q
        V, P, d = m.shape
        flat = m.reshape(V * P, d)
        if cfg.distance == "cosine":
            qn = q_i / (torch.linalg.norm(q_i, dim=-1, keepdim=True) + 1e-8)
            fn = flat / (torch.linalg.norm(flat, dim=-1, keepdim=True)
                         + 1e-8)
            d_s = 1.0 - mm_f32(qn, fn.t(), cdt)
        else:
            qm = mm_f32(q_i, flat.t(), cdt)                     # [Q, V*P]
            q_sq = (q_i * q_i).sum(-1)[:, None]
            m_sq = (flat * flat).sum(-1)[None, :]
            d_s = torch.maximum(q_sq + m_sq - 2.0 * qm,
                                qm.new_zeros(()))
            if cfg.distance == "euclidean":
                d_s = torch.sqrt(d_s + 1e-12)
        out_s = d_s.reshape(Q, V, P)
        out = w * out_s if out is None else out + w * out_s
    return out
