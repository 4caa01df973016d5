"""Mean bytes a ``process_vo`` call brought to the host for the mono-scaled
fit while it was traced (the ``scale_fit_bytes`` count of its ``vo_window``
event: the window's depth and confidence maps), over the measured window's
calls. A program without the counter gives nothing."""

READS = ("program:vo_window.counts",)


def value(rec):
    counts = [e["counts"] for e in rec.get("events", ())
              if e.get("event") == "vo_window" and "counts" in e]
    if not any("scale_fit_bytes" in c for c in counts):
        return None
    return sum(c.get("scale_fit_bytes", 0) for c in counts) / len(counts)
