"""Share of the mapped drive's wall that loop closure's host work takes in
the VO thread: the self time of the program's ``lc.query`` spans (a
keyframe's ORB features, the retriever's query and add, the geometry
checks; ``vo_window`` events) over ``window_s``."""

READS = ("program:vo_window.spans", "window_s")


def value(rec):
    t = [e["spans"]["lc.query"][1] for e in rec.get("events", ())
         if e.get("event") == "vo_window" and "lc.query" in e.get("spans", {})]
    return 100.0 * sum(t) / rec["window_s"] if t else None
