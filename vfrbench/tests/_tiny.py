"""Tiny cells for the CPU tests: the real configurations with their widths
cut (every cut listed in ``reduced``), written with traffic and cells into
a root of their own beside links to the real drivers, towers and
metrics."""

from __future__ import annotations

import json
import os
import shutil

from vfrbench import catalog

CUT_DATA = {"glove_dim": 12, "feature_dim": 24, "max_query_len": 8,
            "vocab_size": 50}
CUT_MODEL = {"joint_dim": 16, "lstm_hidden": 32}
CORPUS = {"videos": 30, "train_videos": 20, "vocab": 50}

TRAFFIC = {
    "bulk": {"driver": "batch", "query_batch": 16, "topk": 5, "len_min": 2,
             "len_max": 8, "distinct_batches": 4, "results_in_flight": 2,
             "sample_batches": 3},
    "follow": {"driver": "daemon", "rate_per_s": 200, "topk": 5,
               "micro_batch": 4, "pipeline_depth": 2, "len_min": 2,
               "len_max": 8, "sample_requests": 20},
    "steps": {"driver": "train", "len_min": 2, "len_max": 8,
              "staged_batches": 6},
}
SERVE_LIMITS = {"dist_gap": 1e-5, "rank_gap": 1e-5, "set_gap": 1e-5,
                "lower_share": 1e-2, "bad": 0}
TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-5, "step_gap": 1e-5,
                "ema_gap": 1e-5}
CELLS = {
    "tiny-s10k-batch": ("tiny_s10k", "bulk", SERVE_LIMITS),
    "tiny-flagship-batch": ("tiny_flagship", "bulk", SERVE_LIMITS),
    "tiny-flagship-daemon": ("tiny_flagship", "follow", SERVE_LIMITS),
    "tiny-flagship-train": ("tiny_flagship", "steps", TRAIN_LIMITS),
}


def tiny_config(name: str) -> dict:
    c = catalog.load_json("configs", name)
    c["data"].update(CUT_DATA)
    c["model"].update(CUT_MODEL)
    reduced = list(CUT_DATA) + list(CUT_MODEL)
    if "train" in c:
        c["train"]["batch_size"] = 8
        reduced.append("batch_size")
    c["reduced"] = reduced
    c["corpus"] = dict(CORPUS)
    return c


def write(root: str, kind: str, name: str, obj: dict) -> None:
    os.makedirs(os.path.join(root, kind), exist_ok=True)
    with open(os.path.join(root, kind, name + ".json"), "w") as f:
        json.dump(obj, f)


def make_root(root: str, metrics: str = "link", towers: str = "link") -> str:
    """A root holding the tiny cells; ``metrics`` and ``towers`` "link"
    point at the real readers and towers, "copy" copies them (so that a
    test can add one)."""
    os.makedirs(root, exist_ok=True)
    os.symlink(os.path.join(catalog.ROOT, "drivers"),
               os.path.join(root, "drivers"))
    for kind, how in (("metrics", metrics), ("towers", towers)):
        src = os.path.join(catalog.ROOT, kind)
        if how == "copy":
            shutil.copytree(src, os.path.join(root, kind),
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            os.symlink(src, os.path.join(root, kind))
    write(root, "configs", "tiny_s10k", tiny_config("serving_10k"))
    write(root, "configs", "tiny_flagship", tiny_config("didemo_flagship"))
    for name, t in TRAFFIC.items():
        write(root, "traffic", name, t)
    for name, (config, traffic, limits) in CELLS.items():
        write(root, "workloads", name, {"config": config, "traffic": traffic,
                                        "chips": 1, "why": "a CPU test",
                                        "limits": limits})
    return root
