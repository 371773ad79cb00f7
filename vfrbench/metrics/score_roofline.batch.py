"""score_roofline.batch: the score stage's least time on the card (the larger
of its bytes over the HBM rate and its operations over their peaks, from
shapes) over its device time, averaged over the traced window's batches
(each one graph replay; its stages split as ``trace.stage_seconds`` says)."""

from vfrbench.metrics_common import roofline

UNIT = "%"
TRACED = True


def read(rec):
    return roofline(rec, "score")
