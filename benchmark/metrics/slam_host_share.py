"""Share of the measured window's ``process_vo`` wall that the SLAM VO
layer spends in its own host work: the self time (its children's spans and
its reads' waits taken out) of the program's ``vo.call``, ``vo.inputs``,
``vo.upload`` and ``vo.collect`` spans (``vo_window`` events, ``spans``)
over ``window_s``."""

READS = ("program:vo_window.spans", "program:vo_window.window_s")
SPANS = ("vo.call", "vo.inputs", "vo.upload", "vo.collect")


def value(rec):
    ev = [e for e in rec.get("events", ()) if e.get("event") == "vo_window" and "spans" in e]
    wall = sum(e["window_s"] for e in ev)
    own = sum(e["spans"][s][1] for e in ev for s in SPANS if s in e["spans"])
    return 100.0 * own / wall if wall > 0 else None
