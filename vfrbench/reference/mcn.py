"""The plain MCN two-tower model, its InfoNCE objective, Adam and the
Polyak average: the reference of every cell.

Query tower: GloVe rows -> an LSTM (gates i, f, g, o; the carry frozen past
a query's length) -> the last state or the mean of the live states -> a
linear projection; for cosine retrieval the query is L2-normalised.
Moment tower (training): per stream, each proposal's mean over its clips'
features, the mean over all clips, the proposal's two temporal endpoints,
concatenated and projected.  Distances: per stream squared euclidean (or
one minus the cosine), fused by the stream weights.

Products run at a stated precision (``round_to``): "float32" (TF32 off),
"tf32" or "bfloat16" (operands rounded, f32 products and sums), "float8"
(operands rounded to e4m3).  A serving model states the recurrence's
operands in bf16 (the serving kernel's), the projection at its compute
dtype and the score at its product dtype; the control lowers each one
step (``lower``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

LOWER = {"float32": "tf32", "tf32": "bfloat16", "bfloat16": "float8"}
# the stages of a serving plan before the score's products
QUERY_STAGES = ("recurrence", "projection")


def round_to(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` (f32) rounded to ``prec`` and held in f32."""
    if prec == "float32":
        return x
    if prec == "bfloat16":
        return x.to(torch.bfloat16).float()
    if prec == "float8":
        return x.to(torch.float8_e4m3fn).float()
    if prec == "tf32":
        # round to nearest even at 10 mantissa bits
        bits = x.float().contiguous().view(torch.int32)
        bias = ((bits >> 13) & 1) + 0xFFF
        return ((bits + bias) & ~0x1FFF).view(torch.float32)
    raise ValueError(f"unknown precision {prec!r}")


class _RoundedMM(torch.autograd.Function):
    """a @ b with both operands rounded to ``prec`` in the forward product
    and in both backward products."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        return round_to(a, prec) @ round_to(b, prec)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.prec
        gr = round_to(g, r)
        return gr @ round_to(b, r).mT, round_to(a, r).mT @ gr, None


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "float32":
        return a @ b
    return _RoundedMM.apply(a, b, prec)


def lower(plan: Dict[str, str], stages=True) -> Dict[str, str]:
    """The control's plan: every stated precision one step lower, or only
    those of ``stages`` (a collection of stage names)."""
    return {k: LOWER[v] if stages is True or k in stages else v
            for k, v in plan.items()}


def f32_only():
    """A context in which f32 products are f32 (TF32 off)."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.saved
    return _Ctx()


# --------------------------------------------------------- query tower

def lstm(x: torch.Tensor, lengths: torch.Tensor, layer: Dict, prec: str):
    """One LSTM layer over x [B, T, E]: (h_last [B, H], hs [B, T, H]); the
    state frozen at t >= length."""
    B, T, _ = x.shape
    H = layer["w_hh"].shape[0]
    gx = mm(x.reshape(B * T, -1), layer["w_ih"], prec).reshape(B, T, 4 * H)
    gx = gx + layer["b"]
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    hs = []
    for t in range(T):
        z = gx[:, t] + mm(h, layer["w_hh"], prec)
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H:2 * H])
        g = torch.tanh(z[:, 2 * H:3 * H])
        o = torch.sigmoid(z[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        live = (t < lengths)[:, None]
        h = torch.where(live, h_new, h)
        c = torch.where(live, c_new, c)
        hs.append(h)
    return h, torch.stack(hs, 1)


def query_vectors(params: Dict, spec: Dict, tokens, lengths,
                  plan: Dict[str, str]) -> torch.Tensor:
    """[S, B, d] query embeddings (one projection shared by the streams, or
    one a stream)."""
    x = params["embeddings"][tokens.long()]
    lengths = lengths.long()
    hs = x
    for i in range(spec["layers"]):
        h_last, hs = lstm(hs, lengths, params["lstm"][f"layer{i}"],
                          plan["recurrence"])
    if spec["query_pool"] == "last":
        h = h_last
    elif spec["query_pool"] == "mean":
        live = (torch.arange(hs.shape[1], device=hs.device)[None, :]
                < lengths[:, None]).float()
        h = (hs * live[..., None]).sum(1) / lengths.clamp(min=1)[:, None]
    else:
        raise ValueError(f"no reference for query_pool "
                         f"{spec['query_pool']!r}")
    names = ([f"query_proj_{s}" for s in spec["stream_names"]]
             if spec["per_stream_proj"] else
             ["query_proj"] * len(spec["stream_names"]))
    return torch.stack([mm(h, params[n]["w"], plan["projection"])
                        + params[n]["b"] for n in names])


def l2n(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-8)


# ------------------------------------------------------------- serving

class Corpus:
    """The index rows as the reference reads them: f32 copies of the
    stored values, one stream at a time, with their squared norms."""

    def __init__(self, m: torch.Tensor, weights):
        self.m = [m[s].float() for s in range(m.shape[0])]
        self.msq = [(r * r).sum(-1) for r in self.m]
        self.w = [float(x) for x in np.asarray(weights, np.float32)]

    def distances(self, q: torch.Tensor, prec: str) -> torch.Tensor:
        """[Q, N] fused distances sum_s w_s |q_s - m_s|^2 of queries
        [S, Q, d], the products q.m at ``prec``."""
        out = None
        for s, (m, msq, w) in enumerate(zip(self.m, self.msq, self.w)):
            qs = q[s]
            d_s = ((qs * qs).sum(-1)[:, None] + msq[None, :]
                   - 2.0 * mm(qs, m.T, prec))
            out = w * d_s if out is None else out + w * d_s
        return out

    def pair_distances(self, q: torch.Tensor, rows: torch.Tensor,
                       prec: str) -> torch.Tensor:
        """[Q, k] fused distances of queries [S, Q, d] to their own rows
        [Q, k] alone, the products q.m at ``prec``."""
        out = None
        for s, (m, msq, w) in enumerate(zip(self.m, self.msq, self.w)):
            qs = round_to(q[s], prec)
            mr = round_to(m[rows], prec)                    # [Q, k, d]
            cross = (qs[:, None, :] * mr).sum(-1)
            d_s = (q[s] * q[s]).sum(-1)[:, None] + msq[rows] - 2.0 * cross
            out = w * d_s if out is None else out + w * d_s
        return out


def retrieval_queries(params, spec, tokens, lengths, plan) -> torch.Tensor:
    """[S, Q, d]: the query embeddings as the retrieval scores them (unit
    length under the cosine distance)."""
    q = query_vectors(params, spec, tokens, lengths, plan)
    return l2n(q) if spec["distance"] == "cosine" else q


SELECT_FAULTS = ("offbyone", "key16")


def top_k(corpus: Corpus, q: torch.Tensor, k: int, prec: str,
          block: int = 64, fault: str = ""):
    """(distances [Q, k] ascending, rows [Q, k]) by the reference's own
    distances, ``block`` queries at a time.  ``fault`` plants a select
    fault: "offbyone" returns the (k+1)-th nearest row in place of the
    k-th; "key16" selects and orders by the distances rounded to bfloat16
    (a 16-bit key), returning each chosen row's own distance."""
    ds, rs = [], []
    for i in range(0, q.shape[1], block):
        D = corpus.distances(q[:, i:i + block], prec)
        if fault == "offbyone":
            v, r = torch.topk(D, k + 1, dim=1, largest=False, sorted=True)
            keep = [j for j in range(k + 1) if j != k - 1]
            v, r = v[:, keep], r[:, keep]
        elif fault == "key16":
            _, r = torch.topk(round_to(D, "bfloat16"), k, dim=1,
                              largest=False, sorted=True)
            v = D.gather(1, r)
        elif not fault:
            v, r = torch.topk(D, k, dim=1, largest=False, sorted=True)
        else:
            raise ValueError(f"unknown select fault {fault!r}")
        ds.append(v)
        rs.append(r)
    return torch.cat(ds), torch.cat(rs)


# ------------------------------------------------------------ training

def moment_vectors(params: Dict, spec: Dict, feats: torch.Tensor,
                   pool: torch.Tensor, tef: torch.Tensor, stream: str,
                   prec: str) -> torch.Tensor:
    """Moments of clip features [R, C, F]: ``pool`` [R, P, C] (each
    proposal's mean over its clips), ``tef`` [R, P, 2]; -> [R, P, d]."""
    local = pool @ feats
    parts = [local]
    if spec["global_context"]:
        parts.append(feats.mean(1, keepdim=True).expand_as(local))
    if spec["tef"]:
        parts.append(tef)
    x = torch.cat(parts, -1)
    p = params[f"moment_proj_{stream}"]
    R, P, D = x.shape
    return (mm(x.reshape(R * P, D), p["w"], prec) + p["b"]).reshape(R, P, -1)


def cosine_dist(q: torch.Tensor, m: torch.Tensor, prec: str) -> torch.Tensor:
    """1 - cos of q [B, d] against m [M, d]: [B, M]."""
    return 1.0 - mm(l2n(q), l2n(m).T, prec)


def infonce_loss(params: Dict, spec: Dict, batch: Dict, banks: Dict,
                 plan: Dict[str, str]) -> torch.Tensor:
    """The flagship objective of one batch: InfoNCE over -D / tau, the
    intra-video term over the query's own proposals, the inter-video term
    over every proposal of every other video of the batch (the query's own
    row kept) and the mined negatives."""
    if spec["distance"] != "cosine":
        raise ValueError("the train reference covers the cosine distance")
    prec = plan["all"]
    pool = spec["pool"]
    tef = spec["tef_table"]
    B = batch["tokens"].shape[0]
    P = pool.shape[0]
    vid = batch["video_idx"].long()
    hv = batch["hard_neg_video"].long()
    hp = batch["hard_neg_prop"].long()
    Hn = hv.shape[1]
    q = query_vectors(params, spec, batch["tokens"], batch["lengths"],
                      {"recurrence": prec, "projection": prec})
    D = None
    d_hard = None
    for s, (name, w) in enumerate(zip(spec["stream_names"],
                                      spec["stream_weights"])):
        f = banks[name][vid]
        m = moment_vectors(params, spec, f, pool.expand(B, -1, -1),
                           tef.expand(B, -1, -1), name, prec)
        d_s = cosine_dist(q[s], m.reshape(B * P, -1), prec).reshape(B, B, P)
        fh = banks[name][hv.reshape(-1)]
        mh = moment_vectors(params, spec, fh, pool[hp.reshape(-1)][:, None],
                            tef[hp.reshape(-1)][:, None], name, prec)
        mh = mh.reshape(B, Hn, -1)
        dh = 1.0 - (l2n(q[s])[:, None, :] * l2n(mh)).sum(-1)
        D = w * d_s if D is None else D + w * d_s
        d_hard = w * dh if d_hard is None else d_hard + w * dh
    tau = spec["temperature"]
    logits = -D / tau
    idx = torch.arange(B, device=D.device)
    tgt = batch["target"].long()
    own = logits[idx, idx]                                  # [B, P]
    pos = own[idx, tgt]
    l_intra = (torch.logsumexp(own, 1) - pos).mean()
    same = vid[:, None] == vid[None, :]
    keep = torch.eye(B, dtype=torch.bool, device=D.device) | ~same
    flat = torch.where(keep[:, :, None], logits,
                       torch.full_like(logits, float("-inf"))).reshape(B, -1)
    flat = torch.cat([flat, -d_hard / tau], 1)
    l_inter = (torch.logsumexp(flat, 1) - pos).mean()
    return spec["lambda_intra"] * l_intra + spec["lambda_inter"] * l_inter


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _unflatten(items):
    out: Dict = {}
    for path, leaf in items:
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def train_steps(params0: Dict, spec: Dict, batches: List[Dict], banks: Dict,
                plan: Dict[str, str]) -> Dict:
    """The flagship recipe over ``batches`` from ``params0``: each step's
    loss, every leaf's first gradient, and the params and Polyak average
    after the last step.  Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
    root, bias-corrected at f32 powers) at a constant learning rate; the
    frozen GloVe table takes no step; the average starts at ``params0``."""
    lr, d = spec["learning_rate"], spec["ema_decay"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    items = list(_leaves(params0))
    train = [n for n, _ in items if n != "embeddings"]
    p = {n: v.detach().clone() for n, v in items}
    ema = {n: v.detach().clone() for n, v in items}
    mu = {n: torch.zeros_like(p[n]) for n in train}
    nu = {n: torch.zeros_like(p[n]) for n in train}
    c = float(np.float32(1.0) - np.float32(d))
    losses, first_grads = [], None
    for t, batch in enumerate(batches, start=1):
        req = {n: (p[n].requires_grad_(True) if n in train else p[n])
               for n in p}
        loss = infonce_loss(_unflatten(req.items()), spec, batch, banks, plan)
        grads = torch.autograd.grad(loss, [req[n] for n in train])
        losses.append(float(loss.detach()))
        g = dict(zip(train, grads))
        if first_grads is None:
            first_grads = {n: x.detach().clone() for n, x in g.items()}
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        with torch.no_grad():
            for n in train:
                mu[n] = (1.0 - b1) * g[n] + b1 * mu[n]
                nu[n] = (1.0 - b2) * g[n] * g[n] + b2 * nu[n]
                upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps)
                p[n] = (p[n].detach() - lr * upd)
            for n in p:
                p[n] = p[n].detach()
                ema[n] = ema[n] + c * (p[n] - ema[n])
    return {"losses": losses, "grads": first_grads, "params": p, "ema": ema}


def flatten(tree) -> Dict[str, torch.Tensor]:
    """{"a/b": leaf} of a nested dict."""
    return dict(_leaves(tree))


def spec_tables(num_clips: int, device) -> Dict[str, torch.Tensor]:
    """DiDeMo's proposals as tables: ``pool`` [P, C] (a proposal's mean over
    its clips) and ``tef_table`` [P, 2] (start / C, (end + 1) / C)."""
    spans = [(s, e) for s in range(num_clips) for e in range(s, num_clips)]
    pool = torch.zeros(len(spans), num_clips)
    for i, (s, e) in enumerate(spans):
        pool[i, s:e + 1] = 1.0 / (e - s + 1)
    tef = torch.tensor([[s / num_clips, (e + 1) / num_clips]
                        for s, e in spans])
    return {"pool": pool.to(device), "tef_table": tef.to(device)}
