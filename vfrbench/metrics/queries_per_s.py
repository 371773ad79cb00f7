"""queries_per_s: the queries a bulk cell answered in its window over the
window's seconds, from the first dispatch to the final sync."""

UNIT = "queries/s"
TRACED = False


def read(rec):
    if rec["kind"] != "batch":
        return None
    w = rec["window"]
    return w["queries"] / w["seconds"]
