"""Share of the mapped drive's wall in which the mapping thread ran frame
alignment: the program's ``falign.setup``, ``falign.lm`` and
``falign.finish`` spans inside its ``map.links`` passes (``map_pass``
events) over ``window_s``; the host's blur and the link gates around them
are left out."""

READS = ("program:map_pass.spans", "window_s")
SPANS = ("falign.setup", "falign.lm", "falign.finish")


def value(rec):
    ev = [e for e in rec.get("events", ())
          if e.get("event") == "map_pass" and "map.links" in e.get("spans", {})]
    if not ev:
        return None
    t = sum(e["spans"][s][0] for e in ev for s in SPANS if s in e["spans"])
    return 100.0 * t / rec["window_s"]
