"""score_stage_roofline.batch: the score stage's least time on the card (the
larger of its bytes over the HBM rate and its operations over their
peaks, from shapes) over its mean device time a replay, each traced replay
split where the port marked its stages when it captured the graph
(``port_trace.stage_split``: the stage maps of the port's recorder)."""

from vfrbench.port_trace import stage_roofline

UNIT = "%"
TRACED = True


def read(rec):
    return stage_roofline(rec, "score")
