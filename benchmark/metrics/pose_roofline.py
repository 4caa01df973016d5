"""The pose solve (P4P, meanshift, the robust-Gaussian refit: _solve_and_fuse): their least time (``roofline/counts.py``,
from each call's arguments) over the device's busy time inside their spans,
over the profiled stretch."""

READS = ("profile:busy_in.pose", "work:pose")


def value(rec):
    p = rec.get("profile") or {}
    busy = p.get("busy_in", {}).get("pose", 0.0)
    work = p.get("work", {}).get("pose", 0.0)
    return 100.0 * work / busy if busy > 0 and work > 0 else None
