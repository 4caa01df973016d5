"""Share of the mapped drive's wall (its VO and the mapping thread's
finish) in which the mapping thread ran PGO: the program's ``pgo.solve``
spans (``map_pass`` events: a snapshot under the map lock, the solve, the
write-back) over ``window_s``. A program without the mapping thread's
trace logs no such event, and gives nothing."""

READS = ("program:map_pass.spans", "window_s")


def value(rec):
    t = [e["spans"]["pgo.solve"][0] for e in rec.get("events", ())
         if e.get("event") == "map_pass" and "pgo.solve" in e.get("spans", {})]
    return 100.0 * sum(t) / rec["window_s"] if t else None
