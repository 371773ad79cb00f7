"""kda_kernel_roofline.batch: the KDA kernel's share of its roofline: its
least time on the card over all KDA layers (the window's query tower's
``stage_work("kda_kernel")``: q, k, v, g and beta read once, o written
once, the operations of the form it computes), over its own device time a
replay (the kernels named ``kda_rnn_chunk`` of each serving batch's graph
replay, ``trace.replays``).  None where the tower counts no such kernel or
the trace holds none."""

from vfrbench import catalog, trace, work

UNIT = "%"
TRACED = True
KERNEL = "kda_rnn_chunk"


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "batch" or not t:
        return None
    shapes = rec["window"]["shapes"]
    tower = catalog.tower(shapes.get("tower"), rec.get("root", catalog.ROOT))
    if not hasattr(tower, "stage_work"):
        return None
    times = [sum(k[1] for k in g if KERNEL in k[2]) / 1e9
             for g in trace.replays(t["kernels"])]
    times = [x for x in times if x > 0]
    if not times:
        return None
    try:
        least, _ = work.bound(*tower.stage_work(shapes, "kda_kernel"))
    except KeyError:
        return None
    return 100.0 * least / (sum(times) / len(times))
