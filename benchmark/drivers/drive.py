"""Traffic driver ``drive``: a mapped drive, VO and the mapping thread
together on one system, as ``demo.py --enable_mapping`` runs them.

The drive is a period of closed laps (``laps`` of ``lap_flows`` flows):
each lap's outbound leg is drawn from the seed as the stream's is
(``scene.stream_increments``), its return inverts it, so every lap ends
where the drive began and later laps revisit the first as near views,
never identical ones. The period's flows, disparities and world-anchored
textured images are rendered in set-up and cycled by reference.

Set-up warms up a separate system over ``warm_laps`` laps with both
threads, and requires a global PGO of it. The window opens on a fresh
system: the program's ``vo_thread`` and ``mapping_thread``, each on a
thread of its own. A wrapper of ``process_vo`` times each call and, once
the seconds are up, returns False in place of the next call, as the
sequence's end does: ``vo_thread`` then sets ``end_of_vo``, the mapping
thread flushes its links, runs its final global PGO and returns, and the
window closes. Every thread is joined with a timeout: a program that
raises fails the run, and nothing waits for ever.

A traced run profiles the window itself (every thread's operations and
the device's), so its device metrics read the drive that its program
metrics read.
"""

from __future__ import annotations

import json
import statistics
import threading
import time

import numpy as np

import reference
import reference_map
import scene
from tracing import reduce_profile

ENDLESS = 10 ** 9  # frames the window's system is told the sequence has


def motion_of(pose) -> np.ndarray:
    """The 4 x 4 motion of an edge's [rvec, t, ...]."""
    T = np.eye(4)
    T[:3, :3] = scene.rodrigues(pose[:3])
    T[:3, 3] = pose[3:6]
    return T


class Cycle:
    """A list-like view that repeats ``items`` up to length ``n``."""

    def __init__(self, items, n):
        self.items, self.n = items, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.items[i % len(self.items)]


def drive_increments(seed: int, traffic: dict) -> np.ndarray:
    """(laps x lap_flows, 6) increments: each lap a closed out-and-back leg
    of the stream's kind, from a seed of its own drawn from ``seed``."""
    lap = dict(traffic, period=traffic["lap_flows"])
    seeds = np.random.default_rng(seed).integers(0, 2 ** 62, traffic["laps"])
    return np.concatenate([scene.stream_increments(int(s), lap) for s in seeds])


def texture(Xw: np.ndarray) -> np.ndarray:
    """Gray levels (uint8) of the planes' world-anchored texture at world
    points (..., 3): three hard-edged sinusoid patterns (the repository's
    full-SLAM scene) averaged with cell noise, a fixed hash of the 0.3 m
    world cell (a few hundred ORB features a frame at 613 x 185, as a
    street gives)."""
    t1 = np.sin(2.1 * Xw[..., 0]) * np.cos(1.7 * Xw[..., 1])
    t2 = np.sin(0.9 * Xw[..., 0] + 1.3 * Xw[..., 1] + 0.7 * Xw[..., 2])
    t3 = np.sin(3.7 * Xw[..., 0]) * np.sin(2.9 * Xw[..., 1])
    waves = 40.0 + 75.0 * (t1 > 0) + 60.0 * (t2 > 0.3) + 45.0 * (t3 > 0.2)
    c = np.floor(Xw / 0.3).astype(np.int64)
    h = ((c[..., 0] * 73856093) ^ (c[..., 1] * 19349663) ^ (c[..., 2] * 83492791)) * 2654435761
    noise = ((h & 0xFFFFFFFF) >> 8) % 256
    return np.clip(0.5 * waves + 0.5 * noise, 0, 255).astype(np.uint8)


def render_drive(seed: int, cfg: dict, traffic: dict) -> dict:
    """One period of the drive: flows (P, h, w, 2), disparities bf / depth
    (P, h, w), BGR uint8 and gray float images of frames 0..P-1, the
    increments and the transforms Ts (P + 1, frame 0 -> frame k)."""
    K, h, w = scene.intrinsics(cfg), cfg["h"], cfg["w"]
    inc = drive_increments(seed, traffic)
    Ts = scene.compose(inc)
    flows, depths = scene.render_flows(K, Ts, scene.planes_of(cfg), h, w)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    lap = traffic["lap_flows"]
    bgr, gray = [], []
    for k in range(len(inc)):
        j = k % lap
        if j > lap // 2:  # the return leg retraces the outbound poses
            src = k - j + lap - j
            bgr.append(bgr[src])
            gray.append(gray[src])
            continue
        R, t = Ts[k][:3, :3], Ts[k][:3, 3]
        g8 = texture(((rays * depths[k][..., None] - t) @ R).astype(np.float32))
        bgr.append(np.repeat(g8[..., None], 3, axis=-1))
        gray.append(g8.astype(np.float32) / 255.0)
    return dict(increments=inc, Ts=Ts, flows=flows, bgr=bgr, gray=gray,
                disparity=(cfg["bf"] / depths[:-1]).astype(np.float32))


class PgoRecorder:
    """Keeps what the program's PGO entry point was given and returned (host
    arrays, copied after the call: nothing waits for the card), the whole
    graph of the last global solve and the first id of every solve."""

    def __init__(self, pgo_api):
        self.api, self.fn = pgo_api, pgo_api.pgo
        self.starts, self.last_global = [], None
        pgo_api.pgo = self

    def __call__(self, **kw):
        out = self.fn(**kw)
        idx = np.asarray(kw["poses_idx"])
        self.starts.append((int(idx.min()), int(idx.max())))
        if idx.min() == 0:
            self.last_global = {k: np.array(kw[k]) for k in
                                ("poses", "poses_idx", "edges_idx", "edges_pose", "edges_covar")}
            self.last_global["out"] = np.array(out)
        return out

    def restore(self):
        self.api.pgo = self.fn


class FalignRecorder:
    """Each ``falign_pairs`` call of the traced window as a
    ``drive::falign_call.<k>`` profiler range on its own thread (no
    synchronisation), with its shape and the iterations its lanes ran. The
    range is an operator's, as the program's spans are: the profiler would
    mirror a user annotation onto the device's timeline, where the busy
    time would count it, and its name stays out of the ``bench::`` spans
    that ``reduce_profile`` reads."""

    def __init__(self, falign_api, torch):
        self.api, self.fn, self.torch = falign_api, falign_api.falign_pairs, torch
        self.calls = []
        falign_api.falign_pairs = self

    def __call__(self, **kw):
        k = len(self.calls)
        with self.torch._C._profiler._RecordFunctionFast(f"drive::falign_call.{k}"):
            out = self.fn(**kw)
        P, _, h, w = np.shape(kw["depths"])
        self.calls.append(dict(
            P=P, h=h, w=w, stride=int(kw.get("stride", 4)), coarse_stride=int(kw.get("coarse_stride", 0)),
            photo=kw.get("images") is not None, iters=[int(r["iters"]) for r in out],
            iters_coarse=[int(r["iters_coarse"]) for r in out]))
        return out

    def restore(self):
        self.api.falign_pairs = self.fn


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.calls = []  # [start, end, end of its block wait] of each process_vo call
        self.pgo = self.falign = self._prof = None
        self.metrics_path = None

    # ------------------------------------------------------------------
    def _system(self, n_frames):
        """A fresh VOLDOR_SLAM on the period, told the sequence has
        ``n_frames`` frames, with loop closure on and the configuration's
        settings."""
        from voldor_tpu_torch.slam.system import VOLDOR_SLAM

        cfg, p = self.cfg, self.period
        slam = VOLDOR_SLAM(mode=cfg["mode"], device=self.ctx.device)
        slam.voldor_winsize = cfg["window"]
        slam.voldor_user_config = cfg.get("voldor_user_config", "")
        for k, v in cfg["slam"].items():
            if not hasattr(slam, k):
                raise AttributeError(f"the program has no setting {k!r}")
            setattr(slam, k, v)
        slam.set_cam_params(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"], basefocal=cfg["bf"])
        n = n_frames - 1
        slam.flows = Cycle(list(p["flows"]), n)
        slam.disps = Cycle(list(p["disparity"]), n + 1)
        slam.images_bgri = Cycle(p["bgr"], n + 1)
        slam.images_grayf = Cycle(p["gray"], n + 1)
        slam.N_FRAMES = n_frames
        slam.h, slam.w = cfg["h"], cfg["w"]
        slam.flow_loader_pt = slam.disp_loader_pt = slam.image_loader_pt = n + 1
        slam.enable_loop_closure()
        return slam

    def _drive(self, slam, seconds=None, steps=None):
        """``vo_thread`` and ``mapping_thread`` on threads of their own,
        until the sequence ends or ``seconds`` are up. ``process_vo`` is
        wrapped: each call is appended to ``steps`` as [start, end, end of
        its block wait] (the last filled when ``vo_thread`` next asks for
        a call), and the wrapper returns False
        once the seconds are up or a thread has raised. Raises what a
        thread raised, or when one outlives ``join_timeout_s``."""
        err = []
        process_vo = slam.process_vo
        end = None if seconds is None else time.perf_counter() + seconds

        def step():
            t = time.perf_counter()
            if steps:
                steps[-1][2] = t
            if err or (end is not None and t >= end):
                return False
            more = process_vo()
            if steps is not None:
                steps.append([t, time.perf_counter(), None])
            return more

        def guarded(fn):
            def target():
                try:
                    fn()
                except BaseException as e:  # noqa: BLE001 (re-raised on the calling thread)
                    err.append(e)
            return target

        slam.process_vo = step
        vo = threading.Thread(target=guarded(slam.vo_thread), name="vo", daemon=True)
        mp = threading.Thread(target=guarded(slam.mapping_thread), name="mapping", daemon=True)
        timeout = self.traffic["join_timeout_s"]
        deadline = time.perf_counter() + (seconds or 0.0) + timeout
        try:
            vo.start()
            mp.start()
            # a mapping thread that died while it blocked VO leaves vo_thread waiting
            while vo.is_alive() and time.perf_counter() < deadline and not (err and not mp.is_alive()):
                vo.join(timeout=0.1)
        finally:
            # vo_thread sets end_of_vo on its way out; a program whose
            # vo_thread does not when process_vo raises would leave the
            # mapping thread waiting for frames
            slam.end_of_vo = True
            mp.join(timeout=timeout)
            del slam.process_vo
        if err:
            raise RuntimeError("a thread of the drive raised") from err[0]
        if vo.is_alive() or mp.is_alive():
            raise RuntimeError(f"a thread of the drive did not end within {timeout} s")

    # ------------------------------------------------------------------
    def setup(self):
        from voldor_tpu_torch.pgo import api as pgo_api

        tr = self.traffic
        self.P = tr["laps"] * tr["lap_flows"]
        self.period = render_drive(self.ctx.seed, self.cfg, tr)
        warm = self._system(tr["warm_laps"] * tr["lap_flows"] + 1)
        rec = PgoRecorder(pgo_api)
        try:
            self._drive(warm)
        finally:
            rec.restore()
        glob = sum(a == 0 for a, _ in rec.starts)
        self.warm_counts = {"frames": warm.fid_cur, "keyframes": len(warm.kf_ids),
                            "lc_links": sum(e.edge_type == "falign-lc" for e in warm.edges),
                            "global_pgo": glob}
        if glob < 1:
            raise RuntimeError(f"the warm-up drive ({self.warm_counts}) ran no global PGO")
        self.slam = self._system(ENDLESS + 1)
        if self.ctx.trace:
            self.metrics_path = self.ctx.tmp / "program_events.jsonl"
            self.slam.metrics.open(str(self.metrics_path))

    def window(self, seconds):
        """The drive for ``seconds``, up to its finished map; traced, under
        the profiler (every thread's operations, started inside it, and the
        device's), each ``falign_pairs`` call a range of its own."""
        from voldor_tpu_torch.falign import api as falign_api
        from voldor_tpu_torch.pgo import api as pgo_api

        torch = self.ctx.torch
        self.pgo = PgoRecorder(pgo_api)
        if self.ctx.trace:
            self.falign = FalignRecorder(falign_api, torch)
        try:
            if self.ctx.trace and self.ctx.device != "cpu":
                from torch._C._profiler import _ExperimentalConfig
                from torch.profiler import ProfilerActivity, profile, record_function

                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
                    with record_function("bench::window"):
                        self._timed_drive(seconds)
                        torch.cuda.synchronize()
                self._prof = prof
            else:
                self._timed_drive(seconds)
        finally:
            self.pgo.restore()
            if self.falign is not None:
                self.falign.restore()
        # frames with a published motion (a sequence's last frame has none)
        self.f1 = min(self.slam.fid_cur, int(self.slam.N_FRAMES) - 1)

    def _timed_drive(self, seconds):
        self.t0 = time.perf_counter()
        self._drive(self.slam, seconds=seconds, steps=self.calls)
        self.t1 = time.perf_counter()
        self.t_vo = self.calls[-1][1] if self.calls else self.t0

    def _steps(self):
        """Seconds of each call and the block wait after it."""
        return [(w if w is not None else b) - a for a, b, w in self.calls]

    def end_to_end(self, wall):
        return {"vo_fps": (self.f1 / wall, "frames/s"),
                "vo_step_p95_ms": (1e3 * float(np.percentile(self._steps(), 95)), "ms")}

    def counts(self):
        s = self.slam
        kinds = {}
        for e in s.edges:
            kinds[e.edge_type] = kinds.get(e.edge_type, 0) + 1
        return {"warm-up drive": self.warm_counts,
                "process_vo calls in the window": len(self.calls),
                "frames published in the window": self.f1,
                "laps": self.f1 / self.traffic["lap_flows"],
                "step median ms": 1e3 * statistics.median(self._steps()),
                "keyframes": len(s.kf_ids), "loop-closure candidates": len(s.lc_candidates),
                "edges by kind": kinds, "PGO solves (first id, last id)": self.pgo.starts,
                "s from the last step to the finished map": self.t1 - self.t_vo}

    # ------------------------------------------------------------------
    def trace_stretch(self):
        """The traced window's profile, reduced: the device's busy time
        and idle share over the window, and the frame-alignment kernels'
        own device time in each photometric ``falign_pairs`` call beside
        the calls' least time (``roofline/falign_counts.py``)."""
        from roofline import falign_counts

        out = {}
        if self._prof is not None:
            out = reduce_profile(self.ctx.torch, self._prof, "window")
            out["falign"] = self._falign_kernels(self._prof, self.falign.calls)
            self._prof = None
        calls = self.falign.calls if self.falign is not None else []
        out["work"] = {"falign": sum(
            falign_counts.call_bound_s(c["P"], c["h"], c["w"], c["stride"], c["coarse_stride"],
                                       c["iters"], c["iters_coarse"]) for c in calls if c["photo"])}
        out["falign_calls"] = len(calls)
        return out

    @staticmethod
    def _falign_kernels(prof, calls):
        """Device seconds of the falign_linearize and falign_lm kernels
        that started inside each photometric call's range, summed."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        ranges, kernels = {}, []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if name.startswith("drive::falign_call.") and e.device_type() != cuda:
                ranges[int(name.rsplit(".", 1)[1])] = (e.start_ns(), e.end_ns())
            elif e.device_type() == cuda and ("falign_linearize" in name or "falign_lm" in name):
                kernels.append((e.start_ns(), e.end_ns()))
        photo = [ranges[k] for k, c in enumerate(calls) if c["photo"] and k in ranges]
        ns = sum(t - s for s, t in kernels if any(a <= s <= b for a, b in photo))
        n = sum(1 for s, _ in kernels if any(a <= s <= b for a, b in photo))
        return {"kernel_s": ns * 1e-9, "launches": n, "photo_calls": len(photo)}

    def record(self, wall):
        """The program's events logged inside the window, and the window's
        wall up to the finished map (the profiler's own stop left out)."""
        ev_t0 = self.slam.metrics._t0
        events = []
        for line in self.metrics_path.read_text().splitlines():
            e = json.loads(line)
            if self.t0 <= ev_t0 + e["t"] <= self.t1 + 1e-3:
                events.append(e)
        return {"window_s": self.t1 - self.t0, "events": events}

    # ------------------------------------------------------------------
    def outputs(self):
        """What the drive published: each frame's motion to the next (VO's
        edges), the keyframes' map poses and, from the VO edges alone,
        their poses along the VO chain."""
        s = self.slam
        by_fid = {e.fid1: e for e in s.edges if e.edge_type in ("vo", "none") and e.fid2 == e.fid1 + 1}
        motions = np.full((self.f1, 4, 4), np.nan)
        for f in range(self.f1):
            if f in by_fid:
                motions[f] = motion_of(by_fid[f].pose)
        chain = [np.eye(4)]
        for f in range(self.f1):
            chain.append(chain[-1] @ np.linalg.inv(motions[f]))
        kfs = [k for k in s.kf_ids if k < self.f1]
        Tcw = np.stack([np.asarray(s.frames[k].Tcw, np.float64) for k in kfs])
        return motions, kfs, Tcw, np.stack([chain[k] for k in kfs])

    def judge(self, control=False):
        """The numbers compared (``reference_map.py``): the worst VO
        errors over every published motion but the first; the worst
        frame-alignment local link against the true motion between its
        keyframes; the map's keyframes (all but the
        first) against the truth; the program's last global PGO against the
        plain solver on its graph, and that solver's optimum held in
        float16, which the limit on the cost gap has to refuse; whether
        anything was dropped. ``control`` puts stale answers in the
        program's place: each frame's motion is the one published for the
        frame before it, each link's motion the one of the link before it
        (the first link's the identity),
        each keyframe's map pose the one of the keyframe before it, each
        pose the PGO returned the one of the row before it."""
        motions, kfs, Tcw, Tcw_vo = self.outputs()
        P, lap = self.P, self.traffic["lap_flows"]
        inc = self.period["increments"][np.arange(1, self.f1) % P]
        errs = reference.pose_errors(motions[:-1] if control else motions[1:], inc, metric=True)
        out = {k: float(v.max()) for k, v in errs.items()}
        Ts = self.period["Ts"]
        links = [e for e in self.slam.edges if e.edge_type == "falign-local"]
        if links:
            meas = np.stack([motion_of(e.pose) for e in links])
            if control:
                meas = np.concatenate([np.eye(4)[None], meas[:-1]])
            true = np.stack([Ts[e.fid2 % P] @ np.linalg.inv(Ts[e.fid1 % P]) for e in links])
            out["link_rot_err_deg"], out["link_t_err"] = reference_map.link_errors(meas, true)
        true = np.linalg.inv(Ts[np.asarray(kfs) % P])
        pos = np.linalg.inv(Ts[:P])[:, :3, 3]
        extent = float(np.linalg.norm(pos - pos[0], axis=1).max())
        est = Tcw[:-1] if control else Tcw[1:]
        out["map_ate"], out["map_rot_err_deg"] = reference_map.map_errors(est, true[1:], extent)
        out["map_ate_vo_chain"], _ = reference_map.map_errors(Tcw_vo[1:], true[1:], extent)
        call = self.pgo.last_global
        final = call is not None and int(call["poses_idx"].max()) == len(self.slam.frames)
        out["global_pgo_runs"] = float(sum(a == 0 for a, _ in self.pgo.starts)) if final else 0.0
        if call is not None:
            ids = {int(i) for i in call["poses_idx"]} & {int(i) for i in call["edges_idx"].ravel()}
            out["kf_in_graph"] = sum(k in ids for k in self.slam.kf_ids) / max(len(self.slam.kf_ids), 1)
            rows = {int(i): r for r, i in enumerate(call["poses_idx"])}
            pick = np.array([rows[k] for k in self.slam.kf_ids if k in rows], np.int64)
            out.update(reference_map.pgo_check(call, pick, extent, self.cfg["mode"] == "mono", control))
        lc = sum(e.edge_type == "falign-lc" for e in self.slam.edges)
        out["lc_links"] = float(lc)
        # the guarantee: a loop-closure link for each full lap after the
        # first two (a lap's keyframes reach the keyframe distance from the
        # third lap on); the links beyond that
        out["lc_links_spare"] = float(lc - max(0, self.f1 // lap - 2))
        out["keyframes_judged"] = float(len(kfs) - 1)
        return out

    def attempted_failed(self):
        lost = sum(1 for e in self.slam.edges if e.edge_type == "none" and e.fid1 < self.f1)
        return len(self.calls), lost

    def close(self):
        if self.metrics_path is not None:
            self.slam.metrics.close()
        self.slam = None
