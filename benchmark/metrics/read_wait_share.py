"""Share of the measured window's ``process_vo`` wall in which the host
waited in the program's own blocking reads of the device (``vo_window``
events: ``read_wait_s`` over ``window_s``)."""

READS = ("program:vo_window.read_wait_s", "program:vo_window.window_s")


def value(rec):
    ev = [e for e in rec.get("events", ())
          if e.get("event") == "vo_window" and "read_wait_s" in e]
    wall = sum(e["window_s"] for e in ev)
    return 100.0 * sum(e["read_wait_s"] for e in ev) / wall if wall > 0 else None
