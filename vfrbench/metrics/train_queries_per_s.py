"""train_queries_per_s: training queries (the batch size a step) over the
window's seconds, the state carried from step to step."""

UNIT = "queries/s"
TRACED = False


def read(rec):
    if rec["kind"] != "train":
        return None
    w = rec["window"]
    return w["queries"] / w["seconds"]
