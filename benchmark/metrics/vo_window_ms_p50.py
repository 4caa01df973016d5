"""Median wall of a VO window, as the SLAM layer logs it (``vo_window``
events, ``window_s``), over the windows of the measured window."""

READS = ("program:vo_window.window_s",)


def value(rec):
    v = sorted(e["window_s"] for e in rec.get("events", ()) if e.get("event") == "vo_window")
    if not v:
        return None
    n = len(v)
    return 1e3 * (v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2]))
