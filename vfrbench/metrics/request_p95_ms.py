"""request_p95_ms: the 95th percentile over every request offered in the
window, each timed from its due time to its record's return; a request
without a record counts as infinitely late."""

import numpy as np

UNIT = "ms"
TRACED = False


def read(rec):
    if rec["kind"] != "daemon":
        return None
    return 1e3 * float(np.quantile(rec["window"]["latency_s"], 0.95))
