"""The depth round's cost calls: their least time (``roofline/counts.py``,
from each call's arguments) over the device's busy time inside their spans,
over the profiled stretch."""

READS = ("profile:busy_in.cost", "work:cost")


def value(rec):
    p = rec.get("profile") or {}
    busy = p.get("busy_in", {}).get("cost", 0.0)
    work = p.get("work", {}).get("cost", 0.0)
    return 100.0 * work / busy if busy > 0 and work > 0 else None
