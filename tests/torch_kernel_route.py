"""The long-row top-k and score kernels' routes with the CPU standing for
the card.

``route_to_the_plain_kernel`` has ``ops/topk.py::select_route`` asked as
for a CUDA tensor and puts the kernel's plain version (``row_topk_plain``,
at an H100's plan) where ``topk_lowest_index`` calls ``row_topk``.  The
kernel itself runs only on the card, where ``chip_smoke.py --phases
row_topk`` holds it to the plain version bit for bit.
``route_scores_to_the_plain_kernel`` does the same for the f32 score
product (``parallel/sharding.py::score_route``, ``score_gemm``), whose
kernel ``chip_smoke.py --phases score_gemm`` holds to its plain version
and to an f64 product on the card.
"""

from vfr_tpu_torch.ops import topk
from vfr_tpu_torch.ops.kernels import score_kernel
from vfr_tpu_torch.ops.kernels.topk_kernel import plan_row_topk, row_topk_plain
from vfr_tpu_torch.parallel import sharding

H100_SMS = 132


def plain_row_topk(x, k):
    """``row_topk``'s answer on the CPU: the plain version at the plan the
    wrapper takes on an H100."""
    N = x.shape[-1]
    return row_topk_plain(x, k, plan_row_topk(x.numel() // N, N, k,
                                              H100_SMS))


def route_to_the_plain_kernel(monkeypatch):
    real = topk.select_route
    monkeypatch.setattr(topk, "select_route",
                        lambda device_type, *a: real("cuda", *a))
    monkeypatch.setattr(topk, "row_topk", plain_row_topk)


def plain_score_gemm(a, m):
    """``score_gemm``'s answer on the CPU (its plain version, the exact f32
    product), counted as a launch of the kernel."""
    score_kernel.LAUNCHES["score_gemm"] += 1
    return score_kernel.score_gemm_plain(a, m)


def route_scores_to_the_plain_kernel(monkeypatch):
    """``parallel/sharding.py::score_route`` asked as for a CUDA tensor and
    the score kernel's plain version (``plain_score_gemm``) where
    ``score_mm`` calls ``score_gemm``."""
    real = sharding.score_route
    monkeypatch.setattr(sharding, "score_route",
                        lambda device_type, *a: real("cuda", *a))
    monkeypatch.setattr(sharding, "score_gemm", plain_score_gemm)
