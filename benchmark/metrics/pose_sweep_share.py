"""Share of the measured window's wall spent in the pose sweeps (both sweep
cores), by synchronised spans."""

READS = ("span:pose_seq", "span:pose_jacobi")


def value(rec):
    s = rec.get("span_s", {})
    t = s.get("pose_seq", 0.0) + s.get("pose_jacobi", 0.0)
    return 100.0 * t / rec["window_s"] if t > 0 else None
