"""mfu.batch: the batch's model operations (the encode's and the score's,
each at the plain peak of the dtype it runs in) over the traced window's
time per batch: the whole batch's share of the card's peak."""

from vfrbench.metrics_common import batch_mfu

UNIT = "%"
TRACED = True


def read(rec):
    return batch_mfu(rec)
