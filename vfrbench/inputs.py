"""Inputs and weights made from the seed: the traffic generators.

Everything large is drawn on the run's device by a ``torch.Generator`` in
a few large calls; the host draws only what the host consumes (the
daemon's request texts and arrival schedule).  The same seed gives the
same inputs, on both sides of a comparison.

Every seed gets the same set of sizes and arrivals in another order where
that set shapes the work: the daemon's inter-arrival gaps are the same
quantiles of the exponential distribution, permuted by the seed, so that
two seeds differ in which gap comes when, not in how busy the window is.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# seeds above a generator's range fold into it (the driver's seeds can
# exceed 32 bits)
_SEED_MOD = 2 ** 62


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named draw of the seed: ``stream``
    keeps the draws of one run independent of each other's sizes."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % _SEED_MOD)
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % _SEED_MOD, stream])


# ------------------------------------------------------------- weights

def param_shapes(sizes: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                            str, float]]:
    """(path, shape, init, scale) of every leaf of the port's parameter
    tree (the JAX package's layout: ``embeddings``, ``lstm/layer<i>``,
    ``query_proj``, ``moment_proj_<stream>``).  ``init`` is "normal",
    "uniform" (scale k: U(-k, k)), "forget" (uniform, +1 on the forget
    gate's quarter) or "zeros"."""
    E, H, d = sizes["E"], sizes["H"], sizes["d"]
    k_h = 1.0 / math.sqrt(H)
    leaves = [(("embeddings",), (sizes["vocab"], E), "normal", 1.0)]
    for layer in range(sizes["layers"]):
        e_in = E if layer == 0 else H
        leaves += [
            (("lstm", f"layer{layer}", "w_ih"), (e_in, 4 * H), "uniform", k_h),
            (("lstm", f"layer{layer}", "w_hh"), (H, 4 * H), "uniform", k_h),
            (("lstm", f"layer{layer}", "b"), (4 * H,), "forget", k_h)]
    projs = ([f"query_proj_{s}" for s in sizes["stream_names"]]
             if sizes["per_stream_proj"] else ["query_proj"])
    for name in projs:
        leaves += [((name, "w"), (H, d), "uniform", k_h),
                   ((name, "b"), (d,), "zeros", 0.0)]
    d_in = sizes["F"] * (2 if sizes["global_context"] else 1) + (
        2 if sizes["tef"] else 0)
    for s in sizes["stream_names"]:
        leaves += [((f"moment_proj_{s}", "w"), (d_in, d), "uniform",
                    1.0 / math.sqrt(d_in)),
                   ((f"moment_proj_{s}", "b"), (d,), "zeros", 0.0)]
    return leaves


def make_params(sizes: Dict, seed: int, device) -> Dict:
    """The parameter tree, f32, drawn on ``device``: one normal draw for
    the embedding table, one uniform draw for every other leaf."""
    leaves = param_shapes(sizes)
    g = generator(seed, device, 1)
    n_uniform = sum(math.prod(shape) for _, shape, init, _ in leaves
                    if init in ("uniform", "forget"))
    u = torch.rand(n_uniform, generator=g, device=device) * 2.0 - 1.0
    tree: Dict = {}
    off = 0
    for path, shape, init, scale in leaves:
        n = math.prod(shape)
        if init == "normal":
            x = torch.randn(shape, generator=g, device=device) * scale
        elif init == "zeros":
            x = torch.zeros(shape, device=device)
        else:
            x = (u[off:off + n] * scale).reshape(shape).clone()
            off += n
            if init == "forget":
                H = shape[0] // 4
                x[H:2 * H] += 1.0
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return tree


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


# ------------------------------------------------------------- queries

def token_batches(n: int, Q: int, T: int, vocab: int, len_min: int,
                  len_max: int, seed: int, device, stream: int = 2):
    """(tokens [n, Q, T] int32, lengths [n, Q] int32): ids uniform over the
    vocabulary's words (2 .. vocab-1: 0 pads, 1 is unknown), lengths
    uniform over [len_min, len_max], zero past each length."""
    g = generator(seed, device, stream)
    toks = torch.randint(2, vocab, (n, Q, T), generator=g, device=device,
                         dtype=torch.int32)
    lens = torch.randint(len_min, len_max + 1, (n, Q), generator=g,
                         device=device, dtype=torch.int32)
    live = torch.arange(T, device=device)[None, None, :] < lens[..., None]
    return toks * live.to(torch.int32), lens


def word(i: int) -> str:
    """The vocabulary's word of id ``i`` (ids from 2)."""
    return f"t{i}"


def vocab_words(vocab: int) -> List[str]:
    return [word(i) for i in range(2, vocab)]


def poisson_schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of an open loop at ``rate``
    requests per second over ``seconds``: n = rate x seconds gaps, the
    midpoint quantiles of Exp(rate), in an order drawn from the seed."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    host_rng(seed, 3).shuffle(gaps)
    due = np.cumsum(gaps) - gaps[0]
    return due[due < seconds]


def query_texts(n: int, vocab: int, len_min: int, len_max: int, seed: int,
                stream: int = 4) -> List[str]:
    """``n`` query texts of words of the vocabulary, lengths uniform over
    [len_min, len_max]."""
    rng = host_rng(seed, stream)
    lens = rng.integers(len_min, len_max + 1, n)
    ids = rng.integers(2, vocab, int(lens.sum()))
    out, off = [], 0
    for L in lens:
        out.append(" ".join(word(int(i)) for i in ids[off:off + L]))
        off += L
    return out


# --------------------------------------------------------------- index

def index_rows(streams: int, N: int, d: int, cosine: bool, dtype: torch.dtype,
               seed: int, device, std: float = 1.0):
    """(m [S, N, d] at ``dtype``, m_sq [S, N] f32): normal rows of
    per-element standard deviation ``std``, L2-normalised per stream
    (+1e-8) for the cosine preset, rounded to the index dtype before their
    squared norms are taken, as a saved index holds them."""
    g = generator(seed, device, 5)
    m = torch.randn(streams, N, d, generator=g, device=device) * std
    if cosine:
        m = m / (torch.linalg.norm(m, dim=-1, keepdim=True) + 1e-8)
    m = m.to(dtype)
    mf = m.float()
    return m, (mf * mf).sum(-1)


def didemo_spans(num_clips: int, clip_seconds: float) -> np.ndarray:
    """[P, 2] second intervals of DiDeMo's proposals: every contiguous run
    of clips, ordered by (start, end)."""
    spans = [(s * clip_seconds, (e + 1) * clip_seconds)
             for s in range(num_clips) for e in range(s, num_clips)]
    return np.asarray(spans, np.float32)


# --------------------------------------------------------------- train

def train_batches(n: int, B: int, T: int, vocab: int, len_min: int,
                  len_max: int, videos: int, P: int, hard: int, seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """``n`` train batches stacked on a leading axis: tokens, lengths, the
    target proposal, the batch's video rows of the banks and ``hard`` mined
    negatives a query (another video's row, any proposal)."""
    toks, lens = token_batches(n, B, T, vocab, len_min, len_max, seed,
                               device, stream=6)
    g = generator(seed, device, 7)
    vid = torch.randint(0, videos, (n, B), generator=g, device=device,
                        dtype=torch.int32)
    other = torch.randint(1, videos, (n, B, hard), generator=g,
                          device=device, dtype=torch.int32)
    return {
        "tokens": toks, "lengths": lens,
        "target": torch.randint(0, P, (n, B), generator=g, device=device,
                                dtype=torch.int32),
        "video_idx": vid,
        "hard_neg_video": (vid[..., None] + other) % videos,
        "hard_neg_prop": torch.randint(0, P, (n, B, hard), generator=g,
                                       device=device, dtype=torch.int32),
    }


def feature_banks(streams, videos: int, clips: int, F: int, seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """stream -> [videos, clips, F] f32 standard-normal clip features."""
    g = generator(seed, device, 8)
    return {s: torch.randn(videos, clips, F, generator=g, device=device)
            for s in streams}
