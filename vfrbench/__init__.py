"""The benchmark of the PyTorch and CUDA port (``vfr_tpu_torch``).

One command runs one cell once::

    python3 -m vfrbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name, from files:

* ``configs/<config>.json``: a preset of the port and every size it runs at,
  and the query tower it names (``mcn`` where it names none);
* ``traffic/<traffic>.json``: a traffic mix, the parameters one driver reads;
* ``workloads/<cell>.json``: a cell, one configuration under one traffic mix,
  with the limits of its check;
* ``drivers/<driver>.py``: the code that sets a cell up, runs its window and
  hands back what the window produced;
* ``towers/<tower>.py``: a query tower's sizes, seeded weights, stated
  precisions, plain reference and encode count, which the bulk driver and
  the encode's readers take;
* ``metrics/<metric>.py``: one reader per metric, over a run's record.

The yardstick lives here too: the card's peaks and each stage's operations
and bytes (``work.py``), the traffic generators (``inputs.py``), the trace
reduction (``trace.py``) and the plain references with the comparison that
decides ``correct`` (``reference/``).
"""
