"""request_p50_ms.daemon: the median latency (due time to record) of the
traced run's requests due before its traced window opens, so that the
profiler's own cost to the host does not enter it: the request
scheduler's steady time beside the untraced run's tail."""

import numpy as np

UNIT = "ms"
TRACED = True


def read(rec):
    w = rec["window"]
    if rec["kind"] != "daemon" or w.get("trace_begin_s") is None:
        return None
    early = w["latency_s"][w["due_s"] < w["trace_begin_s"]]
    if len(early) == 0:
        return None
    return 1e3 * float(np.quantile(early, 0.5))
