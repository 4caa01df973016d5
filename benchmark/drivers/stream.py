"""Traffic driver ``stream``: one sequence, closed loop, through one system.

One period of a closed trajectory is rendered in set-up and the stream
cycles through its flows (and, in stereo, disparities) by reference for as
long as the run lasts. Set-up runs the stream through at least one period,
past the bootstrap window and until windows carry both depth priors; the
window then opens on the same system and calls ``process_vo`` back to back.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np

import reference
import scene
from tracing import Spans, profile_stretch

ENDLESS = 10 ** 9  # frames the system is told the sequence has


class Cycle:
    """A list-like view that repeats ``items`` up to length ``n``."""

    def __init__(self, items, n):
        self.items, self.n = items, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.items[i % len(self.items)]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.stereo = self.cfg["mode"] == "stereo"
        self.calls = []  # (t0, t1, frames published)
        self.em_iters = []
        self._handles = []
        self.spans = None

    # ------------------------------------------------------------------
    def setup(self):
        ctx, cfg = self.ctx, self.cfg
        from voldor_tpu_torch.slam.system import VOLDOR_SLAM

        self.period = scene.stream_period(ctx.seed, cfg, self.traffic, self.stereo)
        P = len(self.period["flows"])
        slam = VOLDOR_SLAM(mode=cfg["mode"], device=ctx.device)
        slam.use_image_info = False
        slam.voldor_user_config = cfg.get("voldor_user_config", "")
        slam.set_cam_params(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"],
                            basefocal=cfg["bf"] if self.stereo else "auto")
        slam.flows = Cycle(list(self.period["flows"]), ENDLESS)
        slam.N_FRAMES = ENDLESS + 1
        slam.h, slam.w = cfg["h"], cfg["w"]
        slam.flow_loader_pt = ENDLESS
        if self.stereo:
            slam.disps = Cycle(list(self.period["disparity"]), ENDLESS)
            slam.disp_loader_pt = ENDLESS
        self.slam = slam
        if ctx.trace:
            self.metrics_path = ctx.tmp / "program_events.jsonl"
            slam.metrics.open(str(self.metrics_path))
            self.spans = Spans(ctx.torch, sync=True)
            import layers

            layers.install_vo(self.spans, ctx.torch)
            dispatch = slam._vo_dispatch

            def kept(inputs):
                h = dispatch(inputs)
                self._handles.append(h)
                return h

            slam._vo_dispatch = kept
        n = 0
        while not (slam.fid_cur >= self.traffic["warm_periods"] * P and self._two_priors()):
            slam.process_vo()
            self._drain(keep=False)
            n += 1
            if n > self.traffic["max_warm_calls"]:
                raise RuntimeError("the stream did not reach windows with both depth priors")
        self.warm_calls = n

    def _two_priors(self):
        s = self.slam
        return s.fid_cur_tmpkf >= 0 and s.fid_cur_spakf >= 0 and s.fid_cur_tmpkf != s.fid_cur_spakf

    def _drain(self, keep=True):
        """EM iterations of every collected window (all but the one in flight)."""
        while len(self._handles) > 1:
            h = self._handles.pop(0)
            if keep:
                self.em_iters.append(int(h.engine._st_scalars[1]))

    # ------------------------------------------------------------------
    def window(self, seconds):
        slam = self.slam
        self.f0 = slam.fid_cur
        self.t0 = time.perf_counter()
        end = self.t0 + seconds
        while True:
            t = time.perf_counter()
            if t >= end:
                break
            f = slam.fid_cur
            slam.process_vo()
            self.calls.append((t, time.perf_counter(), slam.fid_cur - f))
            if self.spans is not None:
                self._drain()
        self.f1 = slam.fid_cur
        self.t1 = time.perf_counter()

    def end_to_end(self, wall):
        steps = [b - a for a, b, _ in self.calls]
        frames = sum(n for _, _, n in self.calls)
        return {"vo_fps": (frames / wall, "frames/s"),
                "vo_step_p95_ms": (1e3 * float(np.percentile(steps, 95)), "ms")}

    def counts(self):
        steps = [b - a for a, b, _ in self.calls]
        kf = sum(1 for f in range(self.f0, self.f1) if self.slam.frames[f].is_keyframe)
        return {"warm-up process_vo calls": self.warm_calls,
                "process_vo calls in the window": len(steps),
                "frames published in the window": self.f1 - self.f0,
                "step median ms": 1e3 * statistics.median(steps),
                "steps beyond the p95": sum(1 for s in steps if s > np.percentile(steps, 95)),
                "keyframes in the window": kf}

    # ------------------------------------------------------------------
    def trace_stretch(self):
        """The profiler over a fixed number of further calls."""

        def work():
            for _ in range(self.traffic["trace_calls"]):
                self.slam.process_vo()
                self._drain(keep=False)

        return profile_stretch(self.ctx.torch, self.ctx.device, self.spans, work)

    def record(self, wall):
        lo, hi = self.t0, self.t1
        ev_t0 = self.slam.metrics._t0
        events = []
        for line in self.metrics_path.read_text().splitlines():
            e = json.loads(line)
            if lo <= ev_t0 + e["t"] <= hi:
                events.append(e)
        span_s = {name: self.spans.total(name, lo=lo, hi=hi) for name in self.spans.intervals}
        return {"window_s": wall, "span_s": span_s, "events": events,
                "counters": {"em_iters": self.em_iters}}

    # ------------------------------------------------------------------
    def outputs(self):
        """What the window published: each frame's motion to the next, from
        the frame before the window to its last, and a seeded sample of its
        keyframes, each with its depth map and the one of the keyframe
        published before it."""
        s = self.slam

        def Tcw(f):
            return s.frames[f].Tcw if f < len(s.frames) else np.linalg.inv(s.Twc_cur)

        T = np.stack([np.asarray(Tcw(f), np.float64) for f in range(self.f0 - 1, self.f1 + 1)])
        motions = reference.relative_motions(T)  # motions[k] is frame f0 - 1 + k -> next
        kfs = [f for f in range(self.f0, self.f1) if s.frames[f].is_keyframe]
        prev = {}
        last = next((f for f in range(self.f0 - 1, -1, -1) if s.frames[f].is_keyframe), None)
        for f in kfs:
            prev[f], last = last, f
        kfs = [f for f in kfs if prev[f] is not None]
        rng = np.random.default_rng(self.ctx.seed)
        n = min(self.traffic["depth_sample"], len(kfs))
        pick = sorted(rng.choice(len(kfs), size=n, replace=False)) if n else []
        depths = {kfs[i]: (np.array(s.frames[kfs[i]].depth, np.float32),
                           np.array(s.frames[prev[kfs[i]]].depth, np.float32)) for i in pick}
        return motions, depths

    def judge(self, control=False):
        """The numbers compared: the worst pose errors of every frame the
        window published and the worst depth errors of a seeded sample of
        its keyframes (in the scale of their poses, and in their own). ``control`` puts stale answers in the program's place:
        each frame's motion is the one published for the frame before it,
        each keyframe's depth map the one of the keyframe before it."""
        motions, depths = self.outputs()
        motions = motions[:-1] if control else motions[1:]
        P = len(self.period["increments"])
        fids = np.arange(self.f0, self.f1)
        inc = self.period["increments"][fids % P]
        errs = reference.pose_errors(motions, inc, metric=self.stereo)
        out = {k: float(v.max()) for k, v in errs.items()}
        worst = shape = 0.0
        for f, (d, d_prev) in depths.items():
            m = motions[f - self.f0]
            s = 1.0 if self.stereo else np.linalg.norm(inc[f - self.f0, 3:]) / max(
                np.linalg.norm(m[:3, 3]), 1e-30)
            d, true = (d_prev if control else d), self.period["depths"][f % P]
            worst = max(worst, reference.depth_error(d, true, s))
            shape = max(shape, reference.depth_shape_error(d, true))
        out["depth_err"] = worst
        out["depth_shape_err"] = shape
        out["keyframes_judged"] = float(len(depths))
        return out

    def attempted_failed(self):
        lost = sum(1 for e in self.slam.edges
                   if e.edge_type == "none" and self.f0 <= e.fid1 < self.f1)
        return len(self.calls), lost

    def close(self):
        if self.spans is not None:
            self.spans.restore()
            self.slam.metrics.close()
        self.slam = None
