"""KITTI ground-plane estimation, a legacy capability (port of
``voldor_tpu/vo/kitti_ground.py``; voldor/geometry.cpp:336-433). The
reference flags it "not used anymore" (config.h:78) but keeps it; so does
the port.

Per pixel of the region of interest: a local PCA over the backprojected
(2 * holo_width + 1)^2 neighbourhood gives a plane normal (the smallest
eigenvector), flipped to point at the viewer; the plane height is |n . X|.
Heights are normalised by their median, then a 4-D meanshift over
(h, n1, n2, n3), started at the external mean (1, 0, -1, 0), finds the
dominant ground hypothesis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from voldor_tpu_torch.ops.meanshift import meanshift


class KittiGround(NamedTuple):
    height: float
    normal: np.ndarray  # (3,)
    confidence: float
    used_iters: int


def _box(a: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of a (h, w, c) map over each (2k+1)^2 window, zero outside the
    map (a cumulative-sum box filter). The cumulative sums run in float64:
    in float32 the box sums of x x^T lose the local covariance to
    cancellation, and how much depends on the order of the additions
    (which differs between devices)."""
    pad = F.pad(a.double(), (0, 0, k, k, k, k))
    c = torch.cumsum(torch.cumsum(pad, dim=0), dim=1)
    c = F.pad(c, (0, 0, 1, 0, 1, 0))
    s = 2 * k + 1
    return (c[s:, s:] - c[:-s, s:] - c[s:, :-s] + c[:-s, :-s]).to(a.dtype)


def estimate_kitti_ground(
    depth, K, roi_frac: float = 0.4, holo_width: int = 4, ms_kernel_var: float = 0.01,
) -> KittiGround:
    """depth: (h, w) tensor or array; K: (3, 3). The region of interest is
    the bottom-centre fraction roi_frac of the image (voldor.cpp:320-331)."""
    depth = torch.as_tensor(np.asarray(depth, np.float32)) if not isinstance(depth, torch.Tensor) \
        else depth.to(torch.float32)
    dev = depth.device
    K = np.asarray(K)
    h, w = depth.shape
    x0 = int(w * 0.5 * (1 - roi_frac))
    y0 = int(h * (1 - roi_frac))
    rw = int(w * roi_frac)
    rh = int(h * roi_frac)

    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    fx, fy, cx, cy = (float(np.float32(v)) for v in (K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    X = torch.stack([
        ((xs - cx) / torch.full_like(depth, fx)) * depth,
        ((ys - cy) / torch.full_like(depth, fy)) * depth,
        depth,
    ], dim=-1)  # (h, w, 3)

    # local PCA from box-filtered moments: E[x x^T] - mu mu^T
    cnt = _box(torch.ones((h, w, 1), dtype=torch.float32, device=dev), holo_width)
    mean = _box(X, holo_width) / cnt
    second = _box((X[..., :, None] * X[..., None, :]).reshape(h, w, 9), holo_width) / cnt
    cov = second.reshape(h, w, 3, 3) - mean[..., :, None] * mean[..., None, :]

    roi_cov = cov[y0:y0 + rh, x0:x0 + rw].reshape(-1, 3, 3)
    roi_X = X[y0:y0 + rh, x0:x0 + rw].reshape(-1, 3)
    _, evecs = torch.linalg.eigh(roi_cov)
    n_vec = evecs[:, :, 0]  # the smallest eigenvalue's vector
    n_vec = n_vec / torch.clamp_min(torch.linalg.norm(n_vec, dim=-1, keepdim=True), 1e-12)
    height = torch.sum(n_vec * roi_X, dim=-1)
    # normals point at the viewer, heights positive (geometry.cpp:396-399)
    flip = height > 0
    n_vec = torch.where(flip[:, None], -n_vec, n_vec)
    height = torch.abs(height)
    finite = torch.isfinite(height) & torch.isfinite(n_vec).all(dim=-1)

    h_np = height.cpu().numpy()
    f_np = finite.cpu().numpy()
    if f_np.sum() < 1:
        return KittiGround(0.0, np.zeros(3), 0.0, 0)
    med = float(np.median(h_np[f_np]))
    med = med if med != 0 else 1.0

    params = torch.cat([(height / med)[:, None], n_vec], dim=-1)  # (M, 4)
    # the reference passes an external mean (geometry.cpp:424-425), so no
    # init trial is drawn
    res = meanshift(
        params[None], finite.to(torch.float32)[None], ms_kernel_var,
        torch.tensor([[1.0, 0.0, -1.0, 0.0]], device=dev), torch.tensor([True], device=dev),
        torch.zeros((1, 1), dtype=torch.long, device=dev),
    )
    mean_out = res.mean[0].cpu().numpy()
    return KittiGround(
        height=float(mean_out[0] * med),
        normal=mean_out[1:4],
        confidence=float(res.confidence[0]),
        used_iters=int(res.iters[0]),
    )
