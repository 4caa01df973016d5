"""Median, over the mapping thread's keyframe registrations in the drive,
of the keyframes published and not yet registered when a registration
began (the ``map_backlog_kf`` count of each ``map.register`` pass): how far
the mapping thread runs behind VO."""

READS = ("program:map_pass.counts",)


def value(rec):
    v = sorted(e["counts"]["map_backlog_kf"] for e in rec.get("events", ())
               if e.get("event") == "map_pass" and "map_backlog_kf" in e.get("counts", {}))
    if not v:
        return None
    n = len(v)
    return float(v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2]))
