"""The long-row top-k kernel's route with the CPU standing for the card.

``route_to_the_plain_kernel`` has ``ops/topk.py::select_route`` asked as
for a CUDA tensor and puts the kernel's plain version (``row_topk_plain``,
at an H100's plan) where ``topk_lowest_index`` calls ``row_topk``.  The
kernel itself runs only on the card, where ``chip_smoke.py --phases
row_topk`` holds it to the plain version bit for bit.
"""

from vfr_tpu_torch.ops import topk
from vfr_tpu_torch.ops.kernels.topk_kernel import plan_row_topk, row_topk_plain

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
