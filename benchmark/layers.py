"""The program's layers as the benchmark sees them: which calls it wraps in
spans, and the least work it counts for each kernel layer's call.

Every wrapped name is an attribute that the program looks up at call time,
so a wrapper placed here sees every call of the layer. Work is counted
only while a profiled stretch runs (``Spans.profiling``), after the call's
span has closed.
"""

from __future__ import annotations

from roofline import counts

# span name -> the engine's attribute
VO_LAYERS = {
    "pose_seq": "_cameras_window_core",
    "pose_jacobi": "_cameras_window_jacobi_core",
    "depth_round": "_depth_round_core",
}


def install_vo(spans, torch):
    """Spans on the pose sweeps and the depth round; the cost calls and the
    pose solve counted for their rooflines."""
    from voldor_tpu_torch.vo import engine, pose_step

    for name, attr in VO_LAYERS.items():
        spans.wrap(engine, attr, name)

    def cost_after(accept):
        def after(args, kwargs, out):
            if accept:
                _, _, cands, _masks, _track, tinb, _rig, Rs, ts, active_n, p = args[:11]
                ps = args[11] if len(args) > 11 else kwargs.get("prior_samples")
                y0 = args[12] if len(args) > 12 else kwargs.get("y0", 0)
            else:
                cands, _track, tinb, _rig, Rs, ts, active_n, p = args[:8]
                ps = args[8] if len(args) > 8 else kwargs.get("prior_samples")
                y0 = args[9] if len(args) > 9 else kwargs.get("y0", 0)
            n = counts.cost_counts(torch, cands, tinb, Rs, ts, int(active_n), p.fx, p.fy, p.cx, p.cy, ps, y0)
            K, h, w = cands.shape
            spans.work["cost"] += counts.cost_bound_s(
                n, K, h, w, tinb.shape[0], 0 if ps is None else ps[0].shape[0], accept)
        return after

    spans.wrap(engine, "cost_map_score", "cost", after=cost_after(False))
    spans.wrap(engine, "cost_map_accept", "cost", after=cost_after(True))

    # the pose solve: P4P, meanshift and the refit; their iterations are
    # read from the inner calls' results after the span has closed
    inner = {}

    def keep(name, fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            if spans.profiling:
                inner[name] = out.iters
            return out
        return wrapper

    for attr in ("meanshift", "fit_robust_gaussian"):
        fn = getattr(pose_step, attr)
        setattr(pose_step, attr, keep(attr, fn))
        spans._saved.append((pose_step, attr, fn))

    def pose_after(args, kwargs, out):
        _p2s, _p3s, valid, _init, _succ, rg_refine, _gen, _p, hp = args[:9]
        B, M = valid.shape
        ms_iters = inner.pop("meanshift").tolist()
        rg = inner.pop("fit_robust_gaussian", None)
        spans.work["pose"] += counts.pose_bound_s(
            B, M, int(hp["n_poses_to_sample"]), int(hp["meanshift_max_init_trials"]), ms_iters,
            rg.tolist() if (rg_refine and rg is not None) else None, int(hp["rg_max_iters"]))

    spans.wrap(pose_step, "_solve_and_fuse", "pose", after=pose_after)

