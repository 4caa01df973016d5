"""The frame-alignment kernels (``falign_linearize``, ``falign_lm``) of the
profiled stretch's photometric ``falign_pairs`` calls: the calls' least
time (``roofline/falign_counts.py``, from each call's shape and the LM
iterations its lanes ran) over the kernels' own device time inside the
calls."""

READS = ("profile:falign.kernel_s", "work:falign")


def value(rec):
    p = rec.get("profile") or {}
    busy = (p.get("falign") or {}).get("kernel_s", 0.0)
    work = p.get("work", {}).get("falign", 0.0)
    return 100.0 * work / busy if busy > 0 and work > 0 else None
