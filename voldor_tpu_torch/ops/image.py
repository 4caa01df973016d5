"""Image sampling and filtering with CUDA-texture semantics
(port of ``voldor_tpu/ops/image.py:20-189``).

Texel centres sit at integer coordinates and addressing clamps to the edge;
the floor indices are int32 as in the JAX package. An off-by-half here
silently costs accuracy everywhere flows are sampled.
"""

from __future__ import annotations

import math

import torch


def _index(floor: torch.Tensor, dtype) -> torch.Tensor:
    """A floored coordinate as an index. A NaN coordinate (a point on the
    camera plane) samples NaN through the lerp weights, as in the JAX
    package, whose gather clamps the index; the index itself must stay in
    range, and a NaN's cast is not (the most negative integer on the CPU,
    a device-side assert in the gather on the card), so NaN becomes 0
    first."""
    return torch.nan_to_num(floor, nan=0.0).to(dtype)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample ``img`` at continuous pixel coordinates.

    img: (h, w) or (h, w, c); x, y: any matching shape S. Returns (S,) or
    (S, c). Coordinates are clamped to the valid range.
    """
    h, w = img.shape[0], img.shape[1]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = _index(x0f, torch.int32)
    y0 = _index(y0f, torch.int32)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    if img.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    x0, x1, y0, y1 = x0.long(), x1.long(), y0.long(), y1.long()
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def _packed_taps(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, rows=None):
    """The four corner taps of a channel-packed map and the lerp weights.

    img: (*B, h, w, c) with x, y: (*B, *S) sharing the leading batch dims B;
    or, with ``rows`` (B,), img: (F, h, w, c) and x, y: (B, *S), where query
    b samples map rows[b] (no copy of the selected maps). Start indices are
    clamped to [0, dim-2], so x clamped to w-1 gives x0 = w-2 and fx = 1:
    the same value the clamped corner pair gives (``image.py:63-65``). One
    gather of the flat (F*h*w, c) view at y0*w+x0, +1, +w, +w+1. Returns
    ((4, *B, *S, c) taps in the order 00, 01, 10, 11), fx, fy (*B, *S, 1))."""
    h, w, c = img.shape[-3:]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.clamp_max(torch.floor(x), w - 2.0)
    y0 = torch.clamp_max(torch.floor(y), h - 2.0)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    idx = _index(y0, torch.int64) * w + _index(x0, torch.int64)
    if rows is None and img.dim() > 3:
        nb = img.dim() - 3
        rows = torch.arange(math.prod(img.shape[:nb]), device=img.device).reshape(img.shape[:nb])
    if rows is not None:
        idx = idx + (rows * (h * w)).reshape(rows.shape + (1,) * (idx.dim() - rows.dim()))
    corners = torch.stack([idx, idx + 1, idx + w, idx + w + 1])
    taps = img.reshape(-1, c)[corners]
    return taps, fx, fy


def bilinear_sample_packed(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                           rows=None) -> torch.Tensor:
    """Bilinear sample of a channel-packed (h, w, c) map (``image.py:52``);
    clamp-to-edge, texel centres at integers. Batched as _packed_taps says.
    Returns (*S, c)."""
    (v00, v01, v10, v11), fx, fy = _packed_taps(img, x, y, rows)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def bilinear_sample_packed_grad(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                                rows=None):
    """bilinear_sample_packed plus its screen-space derivatives
    (``image.py:93``): (value, d/dx, d/dy), each (*S, c), from the same
    taps. The clip on the query coordinates zeroes the derivative outside
    [0, dim-1] (``jnp.clip``'s gradient); the floor contributes nothing."""
    h, w = img.shape[-3], img.shape[-2]
    in_x = ((x >= 0.0) & (x <= w - 1.0)).to(img.dtype)[..., None]
    in_y = ((y >= 0.0) & (y <= h - 1.0)).to(img.dtype)[..., None]
    (v00, v01, v10, v11), fx, fy = _packed_taps(img, x, y, rows)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    val = top * (1.0 - fy) + bot * fy
    ddx = ((v01 - v00) * (1.0 - fy) + (v11 - v10) * fy) * in_x
    ddy = (bot - top) * in_y
    return val, ddx, ddy


# OpenCV special-cases tiny kernels with fixed binomial-ish taps
_SMALL_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def cv2_gaussian_kernel(ksize: int, sigma: float = 0.0, dtype=torch.float32) -> torch.Tensor:
    """1-D Gaussian kernel matching cv2.getGaussianKernel (``image.py:141``).
    For sigma <= 0, sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0 and ksize in _SMALL_TAB:
        return torch.tensor(_SMALL_TAB[ksize], dtype=dtype)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8
    i = torch.arange(ksize, dtype=torch.float32) - (ksize - 1) * 0.5
    k = torch.exp(-(i * i) / (2.0 * sigma * sigma))
    return (k / torch.sum(k)).to(dtype)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur of a (h, w) image (``image.py:165``): rows
    first, then columns, borders as cv2's default BORDER_REFLECT_101."""
    if ksize <= 1:
        return img
    k = cv2_gaussian_kernel(ksize, sigma, img.dtype).to(img.device)
    r = ksize // 2
    out = _conv1d(_reflect101(img, r, 0), k, 0)
    return _conv1d(_reflect101(out, r, 1), k, 1)


def _reflect101(a: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Pad r elements on both sides of dim, mirrored without repeating the
    edge (numpy's 'reflect')."""
    n = a.shape[dim]
    idx = torch.arange(-r, n + r, device=a.device).abs()
    idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
    return a.index_select(dim, idx)


def _conv1d(padded: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    n = padded.shape[dim] - (k.shape[0] - 1)
    out = torch.zeros_like(padded.narrow(dim, 0, n))
    for i in range(k.shape[0]):
        out = out + k[i] * padded.narrow(dim, i, n)
    return out
