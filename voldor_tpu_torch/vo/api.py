"""``voldor()`` and ``voldor_dispatch()`` — the pyvoldor-compatible VO entry
points (port of ``voldor_tpu/vo/api.py:15-266``): same signature, shapes and
return dict, plus a ``device`` keyword (default: the CUDA device; without
one, pass ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from voldor_tpu_torch.config import VoldorConfig
from voldor_tpu_torch.ops.covis import covis_keyframe, covis_window
from voldor_tpu_torch.utils.profiling import device_sync, host_read, span
from voldor_tpu_torch.vo.engine import VoldorEngine, _depth_confidence, _to_tensor, host_array


class VoWindow:
    """One dispatched VO window (``api.py:15``): ``collect()`` returns the
    poses, covariances and covisibility scores, ``depth_host()`` /
    ``conf_host()`` the dense maps. The device tensors stay reachable as
    ``depth_dev`` and ``conf_dev`` (a later window may take them as depth
    priors).

    ``host_copies=True`` enqueues the dense device-to-host copies at
    dispatch; the SLAM layer passes False and calls ``start_host_copies()``
    for keyframe windows only."""

    def __init__(self, engine: VoldorEngine, cfg: VoldorConfig, n_true: int, conf_dev,
                 covis_dev=None, spakf_covis_dev=None, host_copies: bool = True):
        self.engine = engine
        self.cfg = cfg
        self.n_true = n_true
        self.depth_dev = engine.depth
        self.conf_dev = conf_dev
        self._covis_dev = covis_dev
        self._spakf_covis_dev = spakf_covis_dev
        self._res = None
        self._host = None  # (depth, conf) pinned host tensors, once started
        self._copied = None  # CUDA event recorded after the copies
        if host_copies:
            self.start_host_copies()

    def start_host_copies(self):
        """Enqueue the dense depth/conf device-to-host copies into pinned
        host tensors (idempotent). On the CPU there is nothing to copy."""
        if self._host is not None or self.depth_dev.device.type != "cuda":
            return
        self._host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in (self.depth_dev, self.conf_dev)
        )
        self._copied = torch.cuda.Event()
        self._copied.record()

    def _host_map(self, i: int, dev: torch.Tensor) -> np.ndarray:
        if self._host is not None:
            host_read("api.copy_wait", torch.cuda.Event.synchronize, self._copied)
            return np.array(self._host[i].numpy(), np.float32)
        return host_read("api.host_map", host_array, dev)

    def collect(self) -> dict:
        """The solve's scalars in one read: the legacy voldor() dict minus
        the dense maps, plus 'covis' / 'spakf_covis' when covisibility was
        requested at dispatch."""
        if self._res is not None:
            return self._res
        engine, n_true = self.engine, self.n_true
        fetch = [engine.poses6[:n_true], engine.pose_covars[:n_true]]
        names = ["poses", "poses_covar"]
        for name, val in (("covis", self._covis_dev), ("spakf_covis", self._spakf_covis_dev)):
            if val is not None:
                fetch.append(val)
                names.append(name)
        if self.cfg.save_everything:
            fetch.append(engine.rigidness[:n_true])
            names.append("rigidness")
        host = engine.finalize_host(fetch)
        n = min(engine.n_flows, n_true)
        res = {"n_registered": n}
        for name, val in zip(names, host):
            if name in ("poses", "poses_covar"):
                res[name] = np.array(val[:n], np.float32)
            else:
                res[name] = np.asarray(val, np.float32)
        self._res = res
        return res

    def depth_host(self) -> np.ndarray:
        return self._host_map(0, self.depth_dev)

    def conf_host(self) -> np.ndarray:
        return self._host_map(1, self.conf_dev)


def _pad_flows(flows, pad_window_to):
    if isinstance(flows, (list, tuple)):
        flows = list(flows)
        n_true = len(flows)
        if pad_window_to is not None and n_true < pad_window_to:
            shape = tuple(flows[0].shape)
            flows += [np.zeros(shape, np.float32)] * (pad_window_to - n_true)
        return flows, n_true
    n_true = flows.shape[0]
    if pad_window_to is not None and n_true < pad_window_to:
        flows = np.asarray(flows, np.float32)
        pad = np.zeros((pad_window_to - n_true,) + flows.shape[1:], np.float32)
        flows = np.concatenate([flows, pad])
    return flows, n_true


def voldor_dispatch(
    flows, fx: float, fy: float, cx: float, cy: float, basefocal: float = 0.0,
    disparity=None, disparity_pconf=None, depth_priors=None, depth_prior_poses=None,
    depth_prior_pconfs=None, config: str = "", pad_window_to: int | None = None,
    poses_init=None, covis_spec: dict | None = None, host_copies: bool = True,
    device=None,
) -> VoWindow:
    """Run one VO window and return its VoWindow handle (``api.py:90``).

    flows may be a per-transition list mixing host numpy maps and tensors;
    depth_priors / depth_prior_pconfs may mix host maps, tensors and
    DeviceMap entries. covis_spec requests the covisibility scores of the
    window's output depth:
      {'conf_thresh': float,                       # depth-conf gate
       'spakf': (depth, conf, scale, M) | absent}  # keyframe gate inputs
    where M = Twc_cur_before_window @ Tcw_keyframe (ops/covis.py)."""
    cfg = VoldorConfig(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                       basefocal=float(basefocal))
    cfg.read_config(config)
    flows, n_true = _pad_flows(flows, pad_window_to)
    with span("engine.init"):
        engine = VoldorEngine(cfg, device=device)
        engine.init(
            flows, disparity=disparity, disparity_pconf=disparity_pconf,
            depth_priors=depth_priors, depth_prior_poses=depth_prior_poses,
            depth_prior_pconfs=depth_prior_pconfs, poses_init=poses_init,
        )
    if pad_window_to is not None:
        engine.n_flows = min(engine.n_flows, n_true)
        engine.n_flows_init = n_true
    with span("engine.solve"):
        engine.solve(defer_host=True)
    with span("engine.covis"):
        n_flows = engine._st_scalars[0]
        conf_dev = _depth_confidence(engine.rigidness, engine.dp_confs, n_flows)
        covis_dev = spakf_covis_dev = None
        if covis_spec is not None:
            dev = engine.device
            with device_sync("api.upload", dev):
                K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1]],
                                 dtype=torch.float32, device=dev)
            thresh = float(np.float32(covis_spec["conf_thresh"]))
            covis_dev = covis_window(engine.depth, conf_dev, engine.poses6, n_flows, K, thresh,
                                     n_cap=n_true)
            spa = covis_spec.get("spakf")
            if spa is not None:
                sdep, sconf, sscale, M = spa
                spakf_covis_dev = covis_keyframe(
                    _to_tensor(sdep, dev), _to_tensor(sconf, dev), float(np.float32(sscale)),
                    engine.poses6, n_flows, _to_tensor(M, dev), K, thresh, n_cap=n_true,
                )
    return VoWindow(engine, cfg, n_true, conf_dev, covis_dev, spakf_covis_dev,
                    host_copies=host_copies)


def voldor(
    flows, fx: float, fy: float, cx: float, cy: float, basefocal: float = 0.0,
    disparity=None, disparity_pconf=None, depth_priors=None, depth_prior_poses=None,
    depth_prior_pconfs=None, config: str = "", pad_window_to: int | None = None,
    poses_init=None, device=None,
) -> dict:
    """Run one VO window.

    flows: (N, h, w, 2) float32; disparity: (h, w); depth_priors: (D, h, w)
    with (D, 6) poses; config: '--flag value' string in the reference
    dialect.

    Returns {'n_registered', 'poses' (n, 6), 'poses_covar' (n, 6, 6),
    'depth' (h, w), 'depth_conf' (h, w)}.
    """
    win = voldor_dispatch(
        flows, fx, fy, cx, cy, basefocal=basefocal, disparity=disparity,
        disparity_pconf=disparity_pconf, depth_priors=depth_priors,
        depth_prior_poses=depth_prior_poses, depth_prior_pconfs=depth_prior_pconfs,
        config=config, pad_window_to=pad_window_to, poses_init=poses_init, device=device,
    )
    ret = dict(win.collect())
    ret["depth"] = win.depth_host()
    ret["depth_conf"] = win.conf_host()
    return ret
