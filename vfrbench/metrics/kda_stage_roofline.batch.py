"""kda_stage_roofline.batch: the KDA token mixers' least time on the card
(their input products, the convolutions, the gates, the recurrence as the
KDA kernel computes it, the gated output norm, o_proj), over their device
time a replay: the larger of their bytes over the HBM rate and their
operations over their peaks (the window's query tower's ``stage_work``),
over the mean device time of the nodes the port marked ``encode.kda`` when
it captured the graph (``port_trace.stage_split``).  None where the tower
counts no such stage or the port marked none."""

from vfrbench import catalog, port_trace, work

UNIT = "%"
TRACED = True
STAGE, MARK = "kda", "encode.kda"


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "batch" or not t:
        return None
    shapes = rec["window"]["shapes"]
    tower = catalog.tower(shapes.get("tower"), rec.get("root", catalog.ROOT))
    snap = port_trace.snapshot()
    if not hasattr(tower, "stage_work") or not snap:
        return None
    split, _ = port_trace.stage_split(t["kernels"], snap["stages"])
    times = [s[MARK] for s in split if MARK in s]
    if not times or sum(times) <= 0:
        return None
    least, _ = work.bound(*tower.stage_work(shapes, STAGE))
    return 100.0 * least / (sum(times) / len(times))
