"""A toy query tower for the CPU tests: MCN's with a GRU in the LSTM's
place, gates (r, z, n) with b_hn inside r * (...), in the layout of the
port's ``ops/lstm.py::gru_forward`` (``lstm/layer<i>``: ``w_ih`` [E, 3H],
``w_hh`` [H, 3H], ``b_ih``, ``b_hh`` [3H]).  A test copies this file into a
root of its own as ``towers/gru.py``: a tower added by files alone."""

import math

import torch

from vfrbench import inputs
from vfrbench.drivers import _common
from vfrbench.reference import mcn

STAGES = mcn.QUERY_STAGES


def sizes(cell, cfg):
    return {"gates": 3}


def check(s, cfg):
    m = cfg.model
    if (m.rnn_cell != "gru" or m.pooling != "mean"
            or m.normalize_embeddings or m.query_dropout
            or s["query_pool"] not in ("last", "mean")
            or s["distance"] not in ("sqeuclidean", "cosine")):
        raise ValueError("the toy tower's reference covers a GRU query "
                         "tower (last or mean pool), mean segment pooling "
                         "and the sqeuclidean or cosine distance")


def make_params(s, seed, dev):
    """MCN's seeded tree with the recurrence drawn anew as a GRU's: one
    uniform draw of U(-1/sqrt(H), 1/sqrt(H)) for every layer's leaves."""
    tree = inputs.make_params(s, seed, dev)
    E, H, G = s["E"], s["H"], s["gates"]
    shapes = []
    for layer in range(s["layers"]):
        e_in = E if layer == 0 else H
        shapes += [(layer, "w_ih", (e_in, G * H)), (layer, "w_hh", (H, G * H)),
                   (layer, "b_ih", (G * H,)), (layer, "b_hh", (G * H,))]
    n = sum(math.prod(shape) for _, _, shape in shapes)
    g = inputs.generator(seed, dev, 11)
    u = (torch.rand(n, generator=g, device=dev) * 2.0 - 1.0) / math.sqrt(H)
    tree["lstm"], off = {}, 0
    for layer, name, shape in shapes:
        k = math.prod(shape)
        tree["lstm"].setdefault(f"layer{layer}", {})[name] = (
            u[off:off + k].reshape(shape).clone())
        off += k
    return tree


def plan(cfg, dev):
    full = _common.serving_plan(cfg, dev)
    return {stage: full[stage] for stage in STAGES}


def gru(x, lengths, layer, prec):
    """One GRU layer over x [B, T, E]: (h_last [B, H], hs [B, T, H]); the
    state frozen at t >= length."""
    B, T, _ = x.shape
    H = layer["w_hh"].shape[0]
    gi = mcn.mm(x.reshape(B * T, -1), layer["w_ih"], prec).reshape(
        B, T, 3 * H) + layer["b_ih"]
    h = x.new_zeros(B, H)
    hs = []
    for t in range(T):
        gh = mcn.mm(h, layer["w_hh"], prec) + layer["b_hh"]
        r = torch.sigmoid(gi[:, t, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, t, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, t, 2 * H:] + r * gh[:, 2 * H:])
        h = torch.where((t < lengths)[:, None], (1.0 - z) * n + z * h, h)
        hs.append(h)
    return h, torch.stack(hs, 1)


def reference_queries(params, s, tokens, lengths, plan):
    """[S, Q, d]: GRU, pool, projection; unit length under the cosine."""
    x = params["embeddings"][tokens.long()]
    lengths = lengths.long()
    hs = x
    for i in range(s["layers"]):
        h, hs = gru(hs, lengths, params["lstm"][f"layer{i}"],
                    plan["recurrence"])
    if s["query_pool"] == "mean":
        live = (torch.arange(hs.shape[1], device=hs.device)[None, :]
                < lengths[:, None]).float()
        h = (hs * live[..., None]).sum(1) / lengths.clamp(min=1)[:, None]
    names = ([f"query_proj_{st}" for st in s["stream_names"]]
             if s["per_stream_proj"] else
             ["query_proj"] * len(s["stream_names"]))
    q = torch.stack([mcn.mm(h, params[n]["w"], plan["projection"])
                     + params[n]["b"] for n in names])
    return mcn.l2n(q) if s["distance"] == "cosine" else q


def encode_work(s):
    """As ``work.encode_work`` with G = 3 gates and two biases a layer."""
    Q, L, E, H = s["Q"], s["live_steps"], s["E"], s["H"]
    d, S, G = s["d"], s["streams"], s["gates"]
    n_proj = S if s["per_stream_proj"] else 1
    rec = w_bytes = 0.0
    for layer in range(s["layers"]):
        e_in = E if layer == 0 else H
        rec += 2.0 * L * G * H * (e_in + H)
        w_bytes += (e_in + H) * G * H * 2 + 2 * G * H * 4
    bytes_ = (L * E * 4 + w_bytes + n_proj * (H * d + d) * 4
              + S * Q * d * 4)
    return bytes_, {"bfloat16": rec, "float32": 2.0 * Q * H * d * n_proj}
