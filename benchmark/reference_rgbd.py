"""The plain reference of the RGB-D scale fit: torch in float64 on the CPU,
and numpy for the pixel draw.

A monocular window is brought to metric scale by a robust regression of
the sensor's disparity on the disparity its depth map predicts:

* ``fit_pixels``: the pixels that enter the fit, those whose confidence is
  above 0.3 and whose sensor disparity is above 1e-6 (a hole reads 0), in
  row-major order; where more than 10,000 remain, the first 10,000 of a
  permutation drawn from the given generator state.
* ``huber``: the Huber loss with its scale sigma fitted jointly (Owen 2007,
  "A robust hybrid of lasso and ridge regression"), as scikit-learn's
  ``HuberRegressor`` states it: epsilon 1.35, alpha 1e-4 on the
  coefficient, no intercept. It is minimised here by a damped Newton
  iteration on the mean over the pixels, with both sides divided by the
  mean predicted disparity, to a gradient under 1e-12 or
  until no step changes the point in float64 (the gradient then reads a
  few 1e-12 where sigma is small), and not by L-BFGS-B: the objective is convex in (coef, sigma) for sigma > 0,
  so both reach the same minimum. The fit runs in float64; in float16,
  the precision below the maps' float32, it serves as the yardstick that
  the comparison's limit has to refuse.
* ``scale``: clip(1 / coef, 0.1, 10), or 1 where fewer than 10 pixels
  enter the fit; it multiplies the window's depth and translations.
"""

from __future__ import annotations

import numpy as np
import torch

CONF_THRESH = 0.3
DISP_MIN = 1e-6
MAX_PIXELS = 10000
MIN_PIXELS = 10
EPSILON = 1.35
ALPHA = 1e-4
GRAD_TOL = 1e-12
MAX_STEPS = 200


def fit_pixels(depth, conf, disp, basefocal, rng_state=None, dtype=torch.float64):
    """(src, dst) tensors of ``dtype``: the predicted disparity basefocal /
    depth and the sensor's disparity at the fit's pixels."""
    depth = torch.as_tensor(np.asarray(depth)).to(dtype).reshape(-1)
    conf = torch.as_tensor(np.asarray(conf)).reshape(-1)
    disp = torch.as_tensor(np.asarray(disp)).to(dtype).reshape(-1)
    idx = torch.nonzero((conf > CONF_THRESH) & (disp > DISP_MIN)).reshape(-1)
    if idx.numel() > MAX_PIXELS:
        bits = getattr(np.random, rng_state["bit_generator"])()
        bits.state = rng_state
        pick = np.random.Generator(bits).permutation(idx.numel())[:MAX_PIXELS]
        idx = idx[torch.from_numpy(pick)]
    return basefocal / depth[idx], disp[idx]


def _objective(w, sigma, x, y):
    """The objective over the pixels' mean, its gradient and Hessian in
    (w, sigma). Every sum is a mean, so that no partial sum leaves the
    range of a narrow float."""
    n = x.numel()
    r = y - w * x
    inl = r.abs() <= EPSILON * sigma
    zero = torch.zeros((), dtype=x.dtype)
    r2 = torch.where(inl, r * r, zero).mean()
    rx = torch.where(inl, r * x, zero).mean()
    x2 = torch.where(inl, x * x, zero).mean()
    out = (~inl).to(x.dtype).mean()
    loss = (sigma + r2 / sigma + 2 * EPSILON * torch.where(inl, zero, r.abs()).mean()
            - sigma * out * EPSILON ** 2 + ALPHA * w * w / n)
    g = torch.stack([
        -2 / sigma * rx - 2 * EPSILON * torch.where(inl, zero, torch.sign(r) * x).mean() + 2 * ALPHA * w / n,
        1 - out * EPSILON ** 2 - r2 / sigma ** 2])
    H = torch.stack([torch.stack([2 / sigma * x2 + 2 * ALPHA / n, 2 / sigma ** 2 * rx]),
                     torch.stack([2 / sigma ** 2 * rx, 2 / sigma ** 3 * r2])])
    return loss, g, H


def huber(src, dst, dtype=torch.float64):
    """(coef, sigma, |gradient|) of the Huber regression dst ~ coef * src,
    computed in ``dtype``."""
    x = torch.as_tensor(src).to(dtype)
    y = torch.as_tensor(dst).to(dtype)
    c = x.abs().mean()  # both sides over the mean |src|: coef is the same, sigma / c
    x, y = x / c, y / c
    eps = torch.finfo(dtype).eps
    w = (x * y).mean() / (x * x).mean()
    sigma = torch.clamp((y - w * x).abs().median() * 1.4826, min=1e-3)
    loss, g, H = _objective(w, sigma, x, y)
    seen = {(float(w), float(sigma))}
    for _ in range(MAX_STEPS):
        if g.abs().max() < GRAD_TOL:
            break
        det = H[0, 0] * H[1, 1] - H[0, 1] * H[1, 0]  # the 2 x 2 solve, in the dtype
        step = -torch.stack([H[1, 1] * g[0] - H[0, 1] * g[1], H[0, 0] * g[1] - H[1, 0] * g[0]]) / det
        if not (torch.isfinite(step).all() and float(step @ g) < 0):
            step = -g  # not a descent direction: the gradient's
        # backtracking: a step is taken where it lowers the loss enough
        # (Armijo) or, where the loss no longer resolves the decrease in
        # its precision, lowers the gradient's largest entry without raising it
        # where sigma falls, a step goes at most half the way to 0
        t = min(1.0, float(-0.5 * sigma / step[1])) if step[1] < 0 else 1.0
        flat = 4 * eps * abs(float(loss))
        while t >= eps:  # a shorter step moves no coordinate in this precision
            w1 = w + t * step[0]
            s1 = sigma + t * step[1]
            l1, g1, H1 = _objective(w1, s1, x, y)
            if l1 <= loss + 1e-4 * t * float(step @ g) or (
                    l1 <= loss + flat and g1.abs().max() < g.abs().max()):
                break
            t *= 0.5
        else:
            break  # no step improves on this point in this precision
        if (float(w1), float(s1)) in seen:
            break  # a point met before: the precision cannot settle between them
        seen.add((float(w1), float(s1)))
        w, sigma, loss, g, H = w1, s1, l1, g1, H1
    return float(w), float(sigma * c), float(g.abs().max())


def scale(depth, conf, disp, basefocal, rng_state=None, dtype=torch.float64):
    """(scale, pixels, |gradient|) of one window's fit: clip(1 / coef, 0.1,
    10) over ``fit_pixels``; 1 where fewer than 10 pixels enter it."""
    src, dst = fit_pixels(depth, conf, disp, basefocal, rng_state, dtype)
    if src.numel() < MIN_PIXELS:
        return 1.0, int(src.numel()), 0.0
    coef, _, grad = huber(src, dst, dtype)
    return float(np.clip(1.0 / coef, 0.1, 10.0)), int(src.numel()), grad
