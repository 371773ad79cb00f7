"""Index-based hard inter-video negative mining (the port of the JAX
package's ``train/hard_negatives.py``), on one device or over a mesh.

Every refresh embeds the training corpus into the moment index
(``eval.corpus.build_moment_index``), retrieves each training query's
nearest rows exactly at training precision (the f32 scan twin), drops the
query's own video and the 1e30 sentinel rows (Charades' invalid windows,
and a mesh's pad rows), and keeps the ``count`` nearest as explicit
negatives for the loss.  With a mesh the index rows are split over one of
its axes and the scan runs the sharded exact top-k; the mined pairs are
the single-device refresh's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vfr_tpu_torch.models.mcn import Model


def mine_hard_negatives(
    params,
    model: Model,
    dataset,
    count: int,
    batch_size: int = 256,
    rnn_kernel: str = "scan",
    feature_banks=None,
    mesh=None,
    axis=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (videos [Nq, count], props [Nq, count]) int32, -1-padded:
    for each training query the ``count`` nearest index rows of another
    video, in retrieval order (ties by lowest row).

    With ``mesh`` the index (built on the params' device, the mesh's lead
    in training) is row-split over ``axis`` (default: the mesh's first,
    so data-parallel training's "data" axis doubles as the corpus axis)
    and each query batch runs the sharded exact top-k."""
    from vfr_tpu_torch.eval.corpus import (
        _params_device,
        build_moment_index,
        make_stream_retriever,
    )

    dev = _params_device(params)
    index = build_moment_index(params, model, dataset,
                               with_fingerprint=False,
                               feature_banks=feature_banks)
    P = dataset.num_proposals
    # enough rows to survive the own-video filter: the query's own video
    # holds at most P of them
    k0 = min(count + P, index.num_rows)
    batches = list(dataset.eval_batches(batch_size, with_features=False))
    toks = torch.from_numpy(np.stack([b["tokens"] for b in batches])).to(dev)
    lens = torch.from_numpy(np.stack([b["lengths"] for b in batches])).to(dev)
    if mesh is not None:
        axis = axis or mesh.axis_names[0]
    retrieve_stream = make_stream_retriever(
        model, index, k0, topk_method="exact", rnn_kernel=rnn_kernel,
        mesh=mesh, axis=axis)
    dists_all, rows_all = retrieve_stream(params, toks, lens)
    rows_all = rows_all.cpu().numpy()                     # [M, B, k0]
    dists_all = dists_all.cpu().numpy()
    # sentinel rows (Charades' invalid windows and a mesh's pad rows, m_sq =
    # 1e30) are never mined: their distance dwarfs any real one
    in_range = (rows_all < index.num_rows) & (dists_all < 1e20)
    rows_all = np.minimum(rows_all, index.num_rows - 1)

    videos = np.full((dataset.num_queries, count), -1, np.int32)
    props = np.full((dataset.num_queries, count), -1, np.int32)
    for batch, rows, ok in zip(batches, rows_all, in_range):
        vid = index.video_row[rows]                       # [B, k0]
        wrong = (vid != batch["video_idx"][:, None]) & ok
        # a stable argsort on ~wrong keeps the retrieval order among
        # wrong-video rows and pushes own-video rows to the tail
        keep = np.argsort(~wrong, axis=1, kind="stable")[:, :count]
        got = np.take_along_axis(wrong, keep, axis=1)
        v = np.take_along_axis(vid, keep, axis=1)
        p = np.take_along_axis(index.prop_idx[rows], keep, axis=1)
        v = np.where(got, v, -1)
        p = np.where(got, p, -1)
        q_idx = batch["query_idx"][batch["valid"]]
        videos[q_idx] = v[batch["valid"]]
        props[q_idx] = p[batch["valid"]]
    return videos, props
