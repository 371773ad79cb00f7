"""The core of a KDA token mixer (Kimi Delta Attention, Kimi Linear,
arXiv:2510.26692) through one hand-written CUDA kernel
(``csrc/kda_chunk.cu``, ``kda_rnn_chunk``): from the conv'd q, k, v, the
per-channel log decay g and beta to the gated delta rule's output

    q, k <- q / sqrt(|q|^2 + eps), k / sqrt(|k|^2 + eps)     (per head)
    S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
    o_t = scale S_t^T q_t,  S_0 = 0

in f32.  On the card a query is one chunk of at most ``CHUNK`` tokens and
the kernel takes the recurrence's matrix form over it (the state is never
formed); ``kda_chunk_plain`` is that form in PyTorch.  On the CPU
``kda_attend`` runs ``kda_recurrence_plain``, the recurrence token by
token, at any length.  It replaces no Pallas kernel (the JAX package has
no decoder-LM tower).

The kernel's name marks it a recurrence (``rnn_``) for one reason: the
benchmark's trace reader (``vfrbench/trace.py::replays``) finds a serving
batch's graph replay by such a kernel, and ``mfu.batch`` of the Kimi
Linear cell reads nothing without one.

``check_shapes`` refuses, without a card, the shapes the kernel does not
take.  ``LAUNCHES`` counts the launches, registered with the port's
recorder (``utils/trace.py``), so a graph replay adds what its capture
counted.
"""

from __future__ import annotations

import torch

from vfr_tpu_torch.utils import trace

LAUNCHES = trace.register("kda_kernel.launches", {"kda_rnn_chunk": 0})
CHUNK = 64          # csrc/kda_chunk.cu: kChunk, the longest sequence
DIMS = (32, 64, 96, 128)
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def l2norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x / sqrt(|x|^2 + eps) over the last dim, in f32."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + eps)


def _live(o: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    T = o.shape[1]
    live = torch.arange(T, device=o.device)[None, :] < lengths[:, None]
    return torch.where(live[..., None, None], o, 0.0)


def kda_recurrence_plain(q, k, v, g, beta, lengths, scale: float,
                         eps: float) -> torch.Tensor:
    """o [B, T, H, D] f32 of q, k, v, g [B, T, H, D] and beta [B, T, H]:
    the recurrence token by token from S_0 = 0 (a [B, H, D, D] f32 state),
    0 past each sequence's length."""
    B, T, H, D = q.shape
    qn, kn = l2norm(q, eps), l2norm(k, eps)
    v, g, beta = v.float(), g.float(), beta.float()
    S = qn.new_zeros(B, H, D, v.shape[-1])
    out = []
    for t in range(T):
        S = S * torch.exp(g[:, t])[..., None]
        kt = kn[:, t]
        u = beta[:, t, :, None] * (v[:, t] - (kt[..., None] * S).sum(-2))
        S = S + kt[..., None] * u[..., None, :]
        out.append((qn[:, t, ..., None] * S).sum(-2) * scale)
    return _live(torch.stack(out, 1), lengths)


def kda_chunk_plain(q, k, v, g, beta, lengths, scale: float,
                    eps: float) -> torch.Tensor:
    """``kda_recurrence_plain`` as the kernel computes it, one chunk of all
    T tokens: with G the running sum of g, A_ts = sum_c k_t k_s
    exp(G_t - G_s) (s < t), B_ts = sum_c q_t k_s exp(G_t - G_s) (s <= t),
    (I + Diag(beta) A) U = Diag(beta) V, o = scale B U."""
    B, T, H, D = q.shape
    qn, kn = l2norm(q, eps), l2norm(k, eps)
    G = torch.cumsum(g.float(), 1)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    diff = G[:, :, None] - G[:, None, :]                 # [B, t, s, H, D]
    decay = torch.exp(torch.where(causal[None, :, :, None, None], diff,
                                  float("-inf")))
    ke = kn[:, None] * decay                             # k_s exp(G_t - G_s)
    A = (kn[:, :, None] * ke).sum(-1).permute(0, 3, 1, 2)   # [B, H, t, s]
    Bm = (qn[:, :, None] * ke).sum(-1).permute(0, 3, 1, 2)
    bt = beta.float().permute(0, 2, 1)                   # [B, H, T]
    eye = torch.eye(T, device=q.device)
    lower = eye + bt[..., None] * A.tril(-1)
    U = torch.linalg.solve_triangular(
        lower, bt[..., None] * v.float().permute(0, 2, 1, 3), upper=False,
        unitriangular=True)
    o = scale * (Bm * causal) @ U                        # [B, H, T, D]
    return _live(o.permute(0, 2, 1, 3), lengths)


def check_shapes(T: int, ld: int, H: int, D: int) -> None:
    """Raise ValueError unless the kernel takes a qkv of ``ld`` columns
    over H heads of D at T tokens."""
    bad = []
    if T > CHUNK:
        bad.append(f"at most {CHUNK} tokens (one chunk: every query starts "
                   f"from a zero state and is one chunk long)")
    if D not in DIMS:
        bad.append(f"a head width of {DIMS}")
    if ld < 3 * H * D:
        bad.append(f"qkv's {ld} columns at least q, k and v's {3 * H * D}")
    if bad:
        raise ValueError("kda_rnn_chunk takes " + "; ".join(bad) +
                         f" (T={T}, H={H}, D={D}, ld={ld})")


def kda_attend(qkv: torch.Tensor, g: torch.Tensor, beta: torch.Tensor,
               lengths: torch.Tensor, heads: int, scale: float,
               eps: float) -> torch.Tensor:
    """o [B, T, H, D] f32 of qkv [B, T, ld] (q, k, v as its columns
    [0, H D), [H D, 2 H D), [2 H D, 3 H D)), g [B, T, H D] and beta
    [B, T, H]; 0 past each of ``lengths``."""
    B, T, ld = qkv.shape
    HD = g.shape[-1]
    D = HD // heads
    if qkv.device.type == "cpu":
        q, k, v = (qkv[..., i * HD:(i + 1) * HD].reshape(B, T, heads, D)
                   for i in range(3))
        return kda_recurrence_plain(q, k, v, g.reshape(B, T, heads, D),
                                    beta, lengths, scale, eps)
    if qkv.device.type != "cuda":
        raise ValueError(f"kda_attend: inputs on {qkv.device}")
    check_shapes(T, ld, heads, D)
    dev, dtype = qkv.device, qkv.dtype
    if dtype not in _DTYPES or qkv.stride(-1) != 1 or \
            qkv.stride(1) != ld or qkv.stride(0) != T * ld:
        raise ValueError("kda_attend: qkv must be contiguous bf16 or f32")
    for name, t in (("g", g), ("beta", beta)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != dev:
            raise ValueError(f"kda_attend: {name} must be contiguous f32 "
                             f"on {dev}")
    from vfr_tpu_torch.kernels.build import check, load

    lens = lengths.to(device=dev, dtype=torch.int64).contiguous()
    o = torch.empty(B, T, heads, D, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = load("kda_chunk").vfr_kda_chunk(
            qkv.data_ptr(), g.data_ptr(), beta.data_ptr(), lens.data_ptr(),
            o.data_ptr(), B, T, ld, heads, D, _DTYPES[dtype], scale, eps,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "kda_rnn_chunk")
    LAUNCHES["kda_rnn_chunk"] += 1
    return o
