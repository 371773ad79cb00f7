"""On the card: each cell of BENCHMARK.json at its own size, one seed
with a short window, passes its limits, and each control (the reference
one precision lower in the port's place: at every stage, and for a
serving cell at the projection or the score alone) and each planted
select fault fails one of them.  Skips without a card; run on the card with

    python3 -m pytest -q vfrbench/tests/test_vfrbench_card.py
"""

import pytest
import torch

from vfrbench import calibrate, catalog
from vfrbench.reference import judge, mcn


@pytest.mark.parametrize("name", [w["name"] for w in
                                  (catalog.benchmark() or {}).get(
                                      "workloads", [])])
def test_cell_passes_and_its_controls_fail(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = catalog.cell(name)
    serving = cell.driver != "train"
    sides = calibrate.readings(
        cell, 2 ** 31 + 11, 1.0, torch.device("cuda", 0),
        controls=("all", "projection", "score") if serving else ("all",),
        faults=mcn.SELECT_FAULTS if serving else ())
    assert len(sides) == (6 if serving else 2)
    for side, r, failed in sides:
        ok, rows = judge.verdict(r, cell.limits)
        assert ok == (side == "port") and not failed, (side, rows)
