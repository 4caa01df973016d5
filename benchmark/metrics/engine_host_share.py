"""Share of the measured window's ``process_vo`` wall that the VO engine
spends in its own host work outside the pose sweeps and depth rounds: the
self time (its children's spans and its reads' waits taken out) of the
program's ``vo.dispatch``, ``engine.init``, ``engine.solve`` and
``engine.covis`` spans (``vo_window`` events, ``spans``) over
``window_s``."""

READS = ("program:vo_window.spans", "program:vo_window.window_s")
SPANS = ("vo.dispatch", "engine.init", "engine.solve", "engine.covis")


def value(rec):
    ev = [e for e in rec.get("events", ()) if e.get("event") == "vo_window" and "spans" in e]
    wall = sum(e["window_s"] for e in ev)
    own = sum(e["spans"][s][1] for e in ev for s in SPANS if s in e["spans"])
    return 100.0 * own / wall if wall > 0 else None
