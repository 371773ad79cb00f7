"""Readers of the port's own recorder (``vfr_tpu_torch.utils.trace``): the
stage maps its graph captures keep, the spans of its batch calls and of
its set-up, each read through ``snapshot()`` after the window.

A traced run's range is that of its traced device events, from the first
kernel's start to the last one's end; a hot-path span counts when it
overlaps that range.  Where the port has no recorder (a commit before
it), or it recorded nothing of the kind, each reader returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from vfrbench import trace, work

SETUP_SPANS = ("kernels.load", "graphs.capture")   # and every "setup.*"
_WORK = {"encode": work.encode_work, "score": work.score_work,
         "select": work.select_work}


def snapshot() -> Optional[Dict]:
    try:
        from vfr_tpu_torch.utils import trace as recorder
    except ImportError:
        return None
    return recorder.snapshot()


def traced_range(rec: Dict) -> Optional[Tuple[int, int]]:
    """(first kernel start, last kernel end) in ns of a traced batch run."""
    t = rec.get("trace")
    if rec["kind"] != "batch" or not t or not t["kernels"]:
        return None
    ks = t["kernels"]
    return min(k[0] for k in ks), max(k[0] + k[1] for k in ks)


def stage_split(kernels: Sequence, maps: Sequence[Dict]
                ) -> Tuple[List[Dict[str, float]], int]:
    """(device seconds of each stage of every replay matched, groups left
    out).  The device events are grouped by correlation id; a group of
    more than one event is a graph replay (a copy or a clone is one
    event).  A group whose size is the node total of exactly one stage
    map's split is split by that map's counts, its events in start order;
    any other group of more than one event is left out."""
    splits: Dict[int, set] = {}
    for m in maps:
        counts = tuple((str(s), int(n)) for s, n in m["stages"])
        splits.setdefault(sum(n for _, n in counts), set()).add(counts)
    groups: Dict[int, list] = {}
    for k in kernels:
        groups.setdefault(k[3], []).append(k)
    out, left = [], 0
    for g in groups.values():
        if len(g) < 2:
            continue
        cands = splits.get(len(g), set())
        if len(cands) != 1:
            left += 1
            continue
        (counts,) = cands
        g = sorted(g)
        secs: Dict[str, float] = {}
        i = 0
        for stage, n in counts:
            secs[stage] = secs.get(stage, 0.0) + sum(
                k[1] for k in g[i:i + n]) / 1e9
            i += n
        out.append(secs)
    return out, left


def stage_roofline(rec: Dict, stage: str) -> Optional[float]:
    """The stage's least time (``work.py``) over its mean device time a
    replay, the replays split by the port's stage maps."""
    t = rec.get("trace")
    snap = snapshot()
    if rec["kind"] != "batch" or not t or not snap:
        return None
    split, _ = stage_split(t["kernels"], snap["stages"])
    times = [s[stage] for s in split if stage in s]
    if not times or sum(times) <= 0:
        return None
    bytes_, ops = _WORK[stage](rec["window"]["shapes"])
    least, _ = work.bound(bytes_, ops)
    return 100.0 * least / (sum(times) / len(times))


def spans_in(spans: Sequence, name: str, lo: int, hi: int) -> List:
    return [s for s in spans if s[0] == name and s[4] > lo and s[3] < hi]


def dispatch_host_us(rec: Dict) -> Optional[float]:
    """Mean microseconds of the port's ``graphs.call`` spans overlapping
    the traced range: the host time the port spends on a batch."""
    rng, snap = traced_range(rec), snapshot()
    if rng is None or not snap:
        return None
    calls = spans_in(snap["spans"], "graphs.call", *rng)
    if not calls:
        return None
    return sum(b - a for _, _, _, a, b in calls) / len(calls) / 1e3


def port_setup_s(rec: Dict) -> Optional[float]:
    """Seconds of the union of the port's top-level set-up spans
    (``kernels.load``, ``graphs.capture``, ``setup.*``) of this run: those
    that end before the first traced kernel and start after the run
    began (no earlier than its set-up and window seconds before it)."""
    rng, snap = traced_range(rec), snapshot()
    if rng is None or not snap:
        return None
    hi = rng[0]
    lo = hi - int((rec["setup_s"] + rec["window"]["seconds"]) * 1e9)
    iv = sorted((a, b - a, name, 0) for name, _, _, a, b in snap["setup"]
                if (name in SETUP_SPANS or name.startswith("setup."))
                and lo <= a and b <= hi)
    return trace.union_ns(iv, lo, hi) / 1e9 if iv else None
