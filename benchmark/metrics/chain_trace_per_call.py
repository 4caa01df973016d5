"""Mean launches of the chain trace kernel a ``process_vo`` call made while
it was traced (the ``em.chain_trace`` count of its ``vo_window`` event:
one a depth round's rigidness refresh, ``ops/chain_trace.py``), over the
measured window's calls. A program without the kernel counts none, and
gives nothing."""

READS = ("program:vo_window.counts",)


def value(rec):
    counts = [e["counts"] for e in rec.get("events", ())
              if e.get("event") == "vo_window" and "counts" in e]
    if not any("em.chain_trace" in c for c in counts):
        return None
    return sum(c.get("em.chain_trace", 0) for c in counts) / len(counts)
