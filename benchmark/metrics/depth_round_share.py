"""Share of the measured window's wall spent in the depth round, by a
synchronised span."""

READS = ("span:depth_round",)


def value(rec):
    t = rec.get("span_s", {}).get("depth_round", 0.0)
    return 100.0 * t / rec["window_s"] if t > 0 else None
