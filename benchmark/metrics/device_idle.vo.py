"""Share of the profiled stretch (a fixed number of process_vo calls) in
which no operation ran on the device: the union of the trace's device
intervals against the stretch's wall."""

READS = ("profile:busy_s", "profile:window_s")


def value(rec):
    p = rec.get("profile") or {}
    if not p.get("window_s") or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
