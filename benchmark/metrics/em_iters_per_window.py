"""Mean EM iterations a window ran, read from the engine's iteration
counter after each window was collected."""

READS = ("counter:em_iters",)


def value(rec):
    v = rec.get("counters", {}).get("em_iters")
    return sum(v) / len(v) if v else None
