"""On-device covisibility scores for the SLAM layer's window stepping
(port of ``voldor_tpu/ops/covis.py``).

The SLAM layer decides how many frames of a solved window to accept
(vo_step) and whether the spatial keyframe must be replaced from
covisibility scores. Computing them on the device, beside the solve, lets
the host learn vo_step from a few scalars instead of reading the dense
depth map back first.

The scores follow the JAX version: the same strided grid, a strict
in-bounds test for visibility, the closed range for the half-resolution
coverage histogram, visibility over the strided grid's size
``ceil(h / stride) * ceil(w / stride)`` and the harmonic mean over
``max(visibility + coverage, 1e-12)`` (``voldor_tpu/ops/covis.py:65-66,
87-89``). Masking is by zero weights instead of boolean indexing, and the
N chain transforms are broadcast instead of vmapped.

The host gate ``slam/slam_utils.py:eval_covisibility`` divides by
``(h // stride) * (w // stride)`` and by ``max(v + c, 1)`` instead; off the
stride grid (185 x 613, say) its scores differ from these, as the JAX
package's do.

The rigid transform and the projection run in float64, so that a
projection landing on a bin or image edge falls on the same side on the
card and on the CPU; the scores still agree with the JAX package's float32
ones to 1e-5 (``tests/test_torch_covis.py``).
"""

from __future__ import annotations

import torch

from voldor_tpu_torch.ops import lie
from voldor_tpu_torch.utils.profiling import device_sync


def _chain_T(poses6, n_flows: int):
    """Cumulative window transforms: chain_i maps frame-0 coords into frame
    (i+1) coords, chain_i = T(pose_i) @ ... @ T(pose_0). Inactive frames
    (>= n_flows) repeat the last active transform (``covis.py:30``)."""
    Rs = lie.so3_exp(poses6[:, :3])
    ts = poses6[:, 3:6]
    R = torch.eye(3, dtype=poses6.dtype, device=poses6.device)
    t = torch.zeros(3, dtype=poses6.dtype, device=poses6.device)
    Rc, tc = [], []
    for i in range(poses6.shape[0]):
        if i < n_flows:
            R, t = Rs[i] @ R, Rs[i] @ t + ts[i]
        Rc.append(R)
        tc.append(t)
    return torch.stack(Rc), torch.stack(tc)


def _rays(K, h: int, w: int, stride: int):
    """(M, 3) float32 K^-1 rays of the strided pixel grid (``covis.py:92``)."""
    ys = torch.arange(0, h, stride, dtype=torch.float32, device=K.device)
    xs = torch.arange(0, w, stride, dtype=torch.float32, device=K.device)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([X, Y, torch.ones_like(X)], -1).reshape(-1, 3)
    with device_sync("covis.inv", K.device):  # its error check reads the card
        K_inv = torch.linalg.inv(K)
    return coords @ K_inv.T


def _covis_many(pts0, w_mask, R, t, K, h: int, w: int, stride: int):
    """(N,) covisibility of the frame-0 points pts0 (M, 3) under N
    transforms (R (N, 3, 3), t (N, 3)); w_mask: (M,) {0, 1} weights
    (``covis.py:54``)."""
    pts = pts0.double() @ R.double().transpose(-1, -2) + t.double()[:, None, :]
    proj = pts @ K.double().T
    z = proj[..., 2]
    zpos = z > 0
    p = proj[..., :2] / torch.where(zpos, z, 1.0)[..., None]
    px, py = p[..., 0], p[..., 1]
    inb = (px > 0) & (px < w) & (py > 0) & (py < h)
    visibility = (w_mask * zpos * inb).sum(-1) / pts0.shape[0]

    # half-resolution coverage histogram (bins with any weighted hit); the
    # host's histogram2d keeps 0 <= p <= w, its closed right edge falling
    # into the last bin
    nbx, nby = w // (2 * stride), h // (2 * stride)
    bx = torch.clamp((px * nbx / w).to(torch.int64), 0, nbx - 1)
    by = torch.clamp((py * nby / h).to(torch.int64), 0, nby - 1)
    wcov = w_mask * zpos * ((px >= 0) & (px <= w) & (py >= 0) & (py <= h))
    n = R.shape[0]
    idx = torch.arange(n, device=pts0.device)[:, None] * (nbx * nby) + by * nbx + bx
    hist = torch.zeros(n * nbx * nby, dtype=torch.float64, device=pts0.device)
    hist.index_add_(0, idx.reshape(-1), wcov.reshape(-1).double())
    coverage = (hist.reshape(n, -1) > 0).sum(-1) / (nbx * nby)
    return 2 * (visibility * coverage) / torch.clamp_min(visibility + coverage, 1e-12)


def _grid(depth, conf, K, conf_thresh: float, stride: int):
    h, w = depth.shape
    rays = _rays(K, h, w, stride)
    pts0 = rays * depth[::stride, ::stride].reshape(-1, 1)
    mask = (conf[::stride, ::stride] > conf_thresh).reshape(-1).double()
    return pts0, mask, h, w


def covis_window(depth, conf, poses6, n_flows: int, K, conf_thresh: float,
                 stride: int = 4, n_cap: int | None = None):
    """(N,) float32 covisibility of the window's frame-0 depth under each
    cumulative transform chain_i (i = 1..N reported at index i-1)
    (``covis.py:101``). n_cap clamps the active chain length (window
    padding). K: (3, 3) float32 tensor on the depth's device."""
    if n_cap is not None:
        n_flows = min(n_flows, n_cap)
    pts0, mask, h, w = _grid(depth, conf, K, conf_thresh, stride)
    Rc, tc = _chain_T(poses6.double(), n_flows)
    return _covis_many(pts0, mask, Rc, tc, K, h, w, stride).float()


def covis_keyframe(depth_kf, conf_kf, scale_kf: float, poses6, n_flows: int, M, K,
                   conf_thresh: float, stride: int = 4, n_cap: int | None = None):
    """(N,) float32 covisibility of a keyframe's scaled depth under
    T(s) = chain_s @ M for every candidate window step s = 1..N, where
    M = Twc_cur_before_window @ Tcw_keyframe (``covis.py:124``). Entry s-1
    answers: if the window advances s frames, does the spatial keyframe
    still see the current view? M: (4, 4) tensor."""
    if n_cap is not None:
        n_flows = min(n_flows, n_cap)
    with device_sync("covis.upload", depth_kf.device):
        s = torch.tensor(scale_kf, dtype=torch.float32, device=depth_kf.device)
    depth_s = depth_kf * s
    pts0, mask, h, w = _grid(depth_s, conf_kf, K, conf_thresh, stride)
    Rc, tc = _chain_T(poses6.double(), n_flows)
    M = M.double()
    R = Rc @ M[:3, :3]
    t = (Rc @ M[:3, 3]) + tc
    return _covis_many(pts0, mask, R, t, K, h, w, stride).float()
