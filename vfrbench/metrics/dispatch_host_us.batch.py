"""dispatch_host_us.batch: the host microseconds the port spends on one
batch call (its recorder's ``graphs.call`` span: the cache key, the
static input copies, the replay's enqueue and the outputs' clones), the
mean over the calls inside the traced range."""

from vfrbench.port_trace import dispatch_host_us

UNIT = "us"
TRACED = True


def read(rec):
    return dispatch_host_us(rec)
