"""Mean blocking reads of the device a ``process_vo`` call made while it
was traced (its ``vo_window`` event's ``host_reads``: every read the
program's tracer counted, ``utils/profiling.py``), over the measured
window's calls."""

READS = ("program:vo_window.host_reads",)


def value(rec):
    v = [e["host_reads"] for e in rec.get("events", ())
         if e.get("event") == "vo_window" and "host_reads" in e]
    return sum(v) / len(v) if v else None
