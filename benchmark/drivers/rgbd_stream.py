"""Traffic driver ``rgbd_stream``: one handheld RGB-D sequence, closed loop,
through one ``mono-scaled`` system.

The stream driver (``stream.py``) with what an RGB-D sensor gives: each
frame comes with the sensor's depth read as a disparity, ``bf / depth`` with
the configuration's virtual ``bf``, rounded to the sensor's disparity step
and 0 (a hole) where the depth lies outside the sensor's range. The system
solves each window as monocular VO and fits its scale to those disparities
(``VOLDOR_SLAM._mono_scaled_fit``), so every pose and keyframe depth is
judged at metric scale, as the stream judges stereo.

This driver keeps, for the reference (``reference_rgbd.py``), the scale of
every fit the window makes and, for a seeded sample of them (reservoir
sampling, ``fit_sample`` of the traffic), the fit's very inputs: the
window's depth and confidence maps before the fit, the frame, and the state
of the system's pixel-draw generator. ``judge`` adds:

* ``scale_fit_gap``: the largest |s_program / s_reference - 1| over the
  sampled fits; the control puts each fit's scale before it in the
  program's place;
* ``scale_fit_gap_float16``: the same, with the reference computed in
  float16 (the precision below the maps' float32) in the program's place:
  it has to read at least ``scale_fit_gap``'s limit, so that the limit
  refuses a float16 fit;
* ``fits_judged``: how many fits were sampled;
* ``depth_err`` over a seeded sample of the window's depth maps (each
  window's frame 0 keeps its fitted map), counted in ``depth_maps_judged``,
  in place of the stream's keyframes;
* the median rotation error of each 24-frame block of the window, reported
  and not compared: the first block's, the last full block's and the
  largest (a monocular scale drift shows as growth, ROADMAP C6).
"""

from __future__ import annotations

import copy
import importlib.util
from pathlib import Path

import numpy as np
import torch

import reference
import reference_rgbd

_spec = importlib.util.spec_from_file_location("bench_driver_stream", Path(__file__).with_name("stream.py"))
stream = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(stream)

BLOCK = 24  # frames a block of the rotation-error readings
PROBE = 997  # every PROBE-th pixel reads a fit's scale


def sensor_disparity(depths, cfg) -> np.ndarray:
    """(P, h, w) float32: ``bf / depth`` rounded to the sensor's disparity
    step, 0 where the depth is outside its range."""
    s = cfg["sensor"]
    d = np.asarray(depths, np.float64)
    disp = np.round(cfg["bf"] / d / s["disparity_step_px"]) * s["disparity_step_px"]
    disp[~((d >= s["depth_min_m"]) & (d <= s["depth_max_m"]))] = 0.0
    return disp.astype(np.float32)


class Driver(stream.Driver):
    def __init__(self, ctx):
        super().__init__(ctx)
        # the stream's metric branch: the system is given the configuration's
        # bf and a disparity per frame, and is judged at metric scale
        self.stereo = True
        self.fit_scales = []  # the program's scale of every fit in the window
        self.fit_sample = []  # reservoir: (index into fit_scales, inputs)
        self._fit_rng = np.random.default_rng([ctx.seed, 1])
        self._sampling = False

    @property
    def period(self):
        return self._period

    @period.setter
    def period(self, p):
        """The stream's period, with the sensor's disparities in place of
        exact ones (``stream.Driver.setup`` hands these to the system)."""
        p["disparity"] = sensor_disparity(p["depths"], self.cfg)
        self._period = p

    def setup(self):
        super().setup()
        slam = self.slam
        fit = slam._mono_scaled_fit

        def kept(vo_ret):
            if not self._sampling:
                return fit(vo_ret)
            depth = vo_ret["depth"]
            probe = depth.reshape(-1)[::PROBE].astype(np.float64)
            k = len(self.fit_scales)
            keep = k < self.traffic["fit_sample"] or self._fit_rng.integers(k + 1) < self.traffic["fit_sample"]
            if keep:
                inputs = dict(fid=slam.fid_cur, depth=depth.copy(), conf=vo_ret["depth_conf"].copy(),
                              basefocal=slam.basefocal,
                              rng_state=copy.deepcopy(slam.depth_scaling_rng.bit_generator.state))
            fit(vo_ret)
            ok = np.isfinite(probe) & (probe > 0)
            s = float(np.median(depth.reshape(-1)[::PROBE][ok] / probe[ok])) if ok.any() else float("nan")
            self.fit_scales.append(s)
            if keep:
                if len(self.fit_sample) < self.traffic["fit_sample"]:
                    self.fit_sample.append((k, inputs))
                else:
                    self.fit_sample[int(self._fit_rng.integers(len(self.fit_sample)))] = (k, inputs)

        slam._mono_scaled_fit = kept

    def _two_priors(self):
        """Warm once a window has a depth prior. At a handheld rotation of
        ~3.4 deg a frame a window can take a new spatial keyframe every
        step, and then the temporal and the spatial keyframe are one frame
        (one prior) for as long as the stream lasts."""
        s = self.slam
        return s.fid_cur_tmpkf >= 0 and s.fid_cur_spakf >= 0

    def window(self, seconds):
        self._sampling = True
        try:
            super().window(seconds)
        finally:
            self._sampling = False

    # ------------------------------------------------------------------
    def outputs(self):
        """The stream's published motions, and a seeded sample of the
        window's depth maps: in ``mono-scaled`` each window's frame 0 keeps
        its window's fitted map on the host, whether or not it becomes a
        keyframe (a handheld stream may take none in a window, or one every
        window). Each sampled map comes with the map of the window before
        it."""
        motions, _ = super().outputs()
        s = self.slam
        starts = [f for f in range(self.f0, self.f1) if s.frames[f].depth is not None]
        last = next((f for f in range(self.f0 - 1, -1, -1) if s.frames[f].depth is not None), None)
        prev = {}
        for f in starts:
            prev[f], last = last, f
        starts = [f for f in starts if prev[f] is not None]
        rng = np.random.default_rng(self.ctx.seed)
        n = min(self.traffic["depth_sample"], len(starts))
        pick = sorted(rng.choice(len(starts), size=n, replace=False)) if n else []
        depths = {starts[i]: (np.array(s.frames[starts[i]].depth, np.float32),
                              np.array(s.frames[prev[starts[i]]].depth, np.float32)) for i in pick}
        return motions, depths

    def judge(self, control=False):
        out = super().judge(control)
        out["depth_maps_judged"] = out.pop("keyframes_judged")
        P = len(self.period["increments"])
        worst = worst16 = grad = 0.0
        for k, f in sorted(self.fit_sample, key=lambda kf: kf[0]):
            if control and k == 0:
                continue  # no fit before the window's first
            args = (f["depth"], f["conf"], self.period["disparity"][f["fid"] % P], f["basefocal"], f["rng_state"])
            s_ref, _, g = reference_rgbd.scale(*args)
            s_prog = self.fit_scales[k - 1 if control else k]
            worst = max(worst, abs(s_prog / s_ref - 1.0)) if np.isfinite(s_prog) else float("inf")
            if not control:
                worst16 = max(worst16, abs(reference_rgbd.scale(*args, dtype=torch.float16)[0] / s_ref - 1.0))
            grad = max(grad, g)
        out["scale_fit_gap"] = worst
        out["scale_fit_gap_float16"] = worst16
        out["fits_judged"] = float(len(self.fit_sample))
        out["scale_fit_ref_grad"] = grad
        out["fits_in_window"] = float(len(self.fit_scales))
        motions, _ = self.outputs()
        motions = motions[:-1] if control else motions[1:]
        fids = np.arange(self.f0, self.f1)
        rot = reference.pose_errors(motions, self.period["increments"][fids % P], metric=True)["rot_err_deg"]
        blocks = [float(np.median(rot[i:i + BLOCK])) for i in range(0, max(len(rot) - BLOCK, 0) + 1, BLOCK)]
        out["rot_err_block_first"] = blocks[0]
        out["rot_err_block_last"] = blocks[-1]
        out["rot_err_block_max"] = max(blocks)
        out["rot_err_blocks"] = float(len(blocks))
        return out
