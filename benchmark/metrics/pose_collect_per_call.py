"""Mean launches of the pose collect kernel a ``process_vo`` call made while
it was traced (the ``pose.collect`` count of its ``vo_window`` event: one a
target of the sequential sweep and one a Jacobi sweep,
``ops/pose_collect.py``), over the measured window's calls. A program
without the kernel counts none, and gives nothing."""

READS = ("program:vo_window.counts",)


def value(rec):
    counts = [e["counts"] for e in rec.get("events", ())
              if e.get("event") == "vo_window" and "counts" in e]
    if not any("pose.collect" in c for c in counts):
        return None
    return sum(c.get("pose.collect", 0) for c in counts) / len(counts)
