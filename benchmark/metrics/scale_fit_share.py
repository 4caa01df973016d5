"""Share of the measured window's ``process_vo`` wall that the mono-scaled
fit takes on the host: the self time (its reads' waits taken out) of the
program's ``vo.scale_fit`` span (the Huber fit of the sensor's disparity)
and of its child ``vo.scale_copy`` (the window's depth and confidence maps
brought to the host), from the ``vo_window`` events, over ``window_s``. A
program without these spans gives nothing."""

READS = ("program:vo_window.spans", "program:vo_window.window_s")
SPANS = ("vo.scale_fit", "vo.scale_copy")


def value(rec):
    ev = [e for e in rec.get("events", ()) if e.get("event") == "vo_window" and "spans" in e]
    if not any(s in e["spans"] for e in ev for s in SPANS):
        return None
    wall = sum(e["window_s"] for e in ev)
    own = sum(e["spans"][s][1] for e in ev for s in SPANS if s in e["spans"])
    return 100.0 * own / wall if wall > 0 else None
