"""Frame-alignment residual: point-to-plane geometry + photometric term
(port of ``voldor_tpu/falign/residual.py``).

Per (ref, tar) pair and per ref pixel on a strided grid: lift the
(depth-scaled) ref point to world, drop it into the tar camera, and measure
the point-to-plane distance to the tar surface (weighted by a depth-based
confidence) plus an exposure-adjusted photometric difference, both wrapped
in a weighted sqrt-Cauchy robustifier. Invalid pixels (projections out of
bounds or behind the camera) surface as a validity mask.

Every function here takes a BATCH of pair evaluations: params_ref and
params_tar (B, 9), ref_fid and tar_fid (B,) rows into the FrameMaps. The
per-frame parameter vector is [rvec(3), tvec(3) (cam->world), log depth
scale, log color scale, color offset].

The JAX package pads the maps to multiples of 8 x 128 (a TPU fault
workaround, residual.py:72-80); the port does not: with edge padding the
values inside the logical frame are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from voldor_tpu_torch.ops import lie
from voldor_tpu_torch.ops.image import bilinear_sample_packed, bilinear_sample_packed_grad

_EPS_ROBUST = 1.1920929e-07


class FrameMaps(NamedTuple):
    """Per-frame precomputed maps. The interpolated fields are channel-packed
    in one (F, h, w, 5) tensor, [depth, nx, ny, nz, image], so the tar-side
    sampling is one gather of four corner taps; weights (F, h, w) are only
    read on the ref side at stride."""

    packed: torch.Tensor  # (F, h, w, 5)
    weights: torch.Tensor  # (F, h, w)

    @property
    def depths(self):
        return self.packed[..., 0]

    @property
    def images(self):
        return self.packed[..., 4]

    @property
    def normals(self):
        return self.packed[..., 1:4]

    @property
    def bounds(self) -> tuple[int, int]:
        return int(self.packed.shape[1]), int(self.packed.shape[2])


def precompute_maps(depths, weights, images, fx, fy, cx, cy) -> FrameMaps:
    """Normals from central differences of back-projected neighbours
    (clamped at the borders), flipped to point at the viewer
    (``residual.py:65``). depths, weights, images: (F, h, w) tensors;
    weights default to ones and images to zeros."""
    F, h, w = depths.shape
    dev, dt = depths.device, depths.dtype
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=dt),
                            torch.arange(w, device=dev, dtype=dt), indexing="ij")

    def backproject(px, py, d):
        return torch.stack([((px - cx) / fx) * d, ((py - cy) / fy) * d, d], dim=-1)

    def clamped(a, dy, dx):
        ys_ = torch.clamp(torch.arange(h, device=dev) + dy, 0, h - 1)
        xs_ = torch.clamp(torch.arange(w, device=dev) + dx, 0, w - 1)
        return a[..., ys_[:, None], xs_[None, :]]

    p3t = backproject(xs, ys - 1, clamped(depths, -1, 0))
    p3b = backproject(xs, ys + 1, clamped(depths, 1, 0))
    p3l = backproject(xs - 1, ys, clamped(depths, 0, -1))
    p3r = backproject(xs + 1, ys, clamped(depths, 0, 1))
    n = lie.cross(p3t - p3b, p3l - p3r)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    ray = backproject(xs, ys, torch.ones_like(depths))
    flip = torch.sum(ray * n, dim=-1, keepdim=True) > 0
    normals = torch.where(flip, -n, n)
    if images is None:
        images = torch.zeros_like(depths)
    if weights is None:
        weights = torch.ones_like(depths)
    packed = torch.cat([depths[..., None], normals, images[..., None]], dim=-1)
    return FrameMaps(packed=packed.contiguous(), weights=weights.contiguous())


def _grid(maps: FrameMaps, stride: int):
    h, w = maps.bounds
    dev, dt = maps.packed.device, maps.packed.dtype
    ys = torch.arange(0, h, stride, device=dev, dtype=dt)
    xs = torch.arange(0, w, stride, device=dev, dtype=dt)
    return torch.meshgrid(ys, xs, indexing="ij")


def _col(v):
    """(B,) -> (B, 1, 1), to broadcast a per-pair scalar over the grid."""
    return v[:, None, None]


def pair_residual_map(params_ref, params_tar, ref_fid, tar_fid, maps: FrameMaps,
                      fx, fy, cx, cy, vbf, crw, use_photo: bool, stride: int,
                      apply_weights: bool = True):
    """Residual + validity over the strided ref pixel grid
    (``residual.py:117``). Returns (residual (B, hs, ws) sqrt-Cauchy
    robustified and zero where invalid, valid (B, hs, ws))."""
    h, w = maps.bounds
    ys, xs = _grid(maps, stride)

    rvec = params_ref[:, 0:3]
    tvec = params_ref[:, 3:6]
    depth_ref = maps.depths[:, ::stride, ::stride][ref_fid]
    p2r_d = depth_ref * _col(torch.exp(params_ref[:, 6]))
    p3r = torch.stack([((xs - cx) / fx) * p2r_d, ((ys - cy) / fy) * p2r_d, p2r_d], dim=-1)
    p3w = lie.rotate_rvec(p3r, rvec[:, None, None, :]) + tvec[:, None, None, :]

    rvec0 = -params_tar[:, 0:3]
    tvec0 = -lie.rotate_rvec(params_tar[:, 3:6], rvec0)

    p3t = lie.rotate_rvec(p3w, rvec0[:, None, None, :]) + tvec0[:, None, None, :]
    zt = p3t[..., 2]
    safe_zt = torch.where(torch.abs(zt) < 1e-12, 1e-12, zt)
    p2t_x = (fx * p3t[..., 0]) / safe_zt + cx
    p2t_y = (fy * p3t[..., 1]) / safe_zt + cy
    valid = (p2t_x >= 0) & (p2t_x < w) & (p2t_y >= 0) & (p2t_y < h) & (zt >= 1.0)

    tar_samp = bilinear_sample_packed(maps.packed, p2t_x, p2t_y, rows=tar_fid)
    p2t_d = tar_samp[..., 0] * _col(torch.exp(params_tar[:, 6]))
    nvec = tar_samp[..., 1:4]

    p3t_ray = p3t * (p2t_d / safe_zt)[..., None]
    diff_geo = nvec * torch.sum(nvec * (p3t_ray - p3t), dim=-1, keepdim=True)
    p3_geo = p3t + diff_geo
    z_geo = p3_geo[..., 2]
    safe_zgeo = torch.where(torch.abs(z_geo) < 1e-12, 1e-12, z_geo)
    geo_x = (fx * p3_geo[..., 0]) / safe_zgeo + cx
    geo_y = (fy * p3_geo[..., 1]) / safe_zgeo + cy
    valid = valid & (geo_x >= 0) & (geo_x < w) & (geo_y >= 0) & (geo_y < h)

    residual_depth = 0.5 * torch.sum(diff_geo * diff_geo, dim=-1)
    drw = (vbf / (torch.clamp_min(z_geo, 1.0) * torch.clamp_min(zt, 1.0))) ** 2
    residual = drw * residual_depth

    if use_photo:
        c_ref = maps.images[:, ::stride, ::stride][ref_fid] + _col(params_ref[:, 8])
        c_tar = (tar_samp[..., 4] + _col(params_tar[:, 8])) * _col(
            torch.exp(params_ref[:, 7]) / torch.exp(params_tar[:, 7]))
        residual = residual + crw * 0.5 * (c_ref - c_tar) ** 2

    if apply_weights:
        residual = maps.weights[:, ::stride, ::stride][ref_fid] * residual
    r2 = residual
    robust = torch.sqrt(torch.log(torch.clamp_min(r2, 0.0) + 1.0))
    res = torch.where(r2 > _EPS_ROBUST, robust, r2)
    return torch.where(valid, res, 0.0), valid


def pair_residual_and_grads(params_ref, params_tar, ref_fid, tar_fid, maps: FrameMaps,
                            fx, fy, cx, cy, vbf, crw, use_photo: bool, stride: int):
    """Residual + ANALYTIC per-point gradients w.r.t. both frames' 9-dim
    parameter vectors (``residual.py:207``). Returns (res (B, hs, ws),
    Jr (B, hs, ws, 9), Jt (B, hs, ws, 9)).

    Everything downstream of the tar-camera point p_t is differentiated once
    into h = d(res)/d(p_t) per point; the pose columns chain through
    per-pair constant 3x3s:

        dres/dr = ((pw - t) x y)^T (R J_r(r)),   y = R0^T h,  R0 = R(q)^T
        dres/dt = y;   dres/du = -y;   dres/dq = -(p_t x h)^T J_r(q)
        dres/ds_ref = h . (p_t - R0 (t - u))

    and the scale and colour columns are closed-form scalars."""
    h, w = maps.bounds
    ys, xs = _grid(maps, stride)

    rvec, tvec = params_ref[:, 0:3], params_ref[:, 3:6]
    s_ref, c_ref_s, c_ref_o = params_ref[:, 6], params_ref[:, 7], params_ref[:, 8]
    qvec, uvec = params_tar[:, 0:3], params_tar[:, 3:6]
    s_tar, c_tar_s, c_tar_o = params_tar[:, 6], params_tar[:, 7], params_tar[:, 8]

    R = lie.so3_exp(rvec)  # (B, 3, 3)
    A = R @ lie.so3_right_jacobian(rvec)
    R0 = lie.so3_exp(qvec).transpose(-1, -2)
    Jr_q = lie.so3_right_jacobian(qvec)
    Bm = R0 @ R
    w0t = torch.einsum("bij,bj->bi", R0, tvec - uvec)[:, None, None, :]

    kx = ((xs - cx) / fx)[None, :, :, None]
    ky = ((ys - cy) / fy)[None, :, :, None]
    depth_ref = maps.depths[:, ::stride, ::stride][ref_fid]
    D = (depth_ref * _col(torch.exp(s_ref)))[..., None]

    def col(M, j):
        return M[:, None, None, :, j]

    pw_t = (col(R, 0) * kx + col(R, 1) * ky + col(R, 2)) * D
    pt = (col(Bm, 0) * kx + col(Bm, 1) * ky + col(Bm, 2)) * D + w0t

    zt = pt[..., 2]
    safe_zt = torch.where(torch.abs(zt) < 1e-12, 1e-12, zt)
    inv_zt = 1.0 / safe_zt
    p2t_x = fx * pt[..., 0] * inv_zt + cx
    p2t_y = fy * pt[..., 1] * inv_zt + cy
    valid = (p2t_x >= 0) & (p2t_x < w) & (p2t_y >= 0) & (p2t_y < h) & (zt >= 1.0)

    samp, s_u, s_v = bilinear_sample_packed_grad(maps.packed, p2t_x, p2t_y, rows=tar_fid)
    est = _col(torch.exp(s_tar))
    p2t_d = samp[..., 0] * est
    n = samp[..., 1:4]
    gam = p2t_d * inv_zt - 1.0
    npt = torch.sum(n * pt, dim=-1)
    g = gam * npt  # n . (p3t_ray - p3t)
    nn = torch.sum(n * n, dim=-1)
    res_d = 0.5 * g * g * nn
    z_geo = zt + g * n[..., 2]
    p3_geo = pt + n * g[..., None]
    safe_zgeo = torch.where(torch.abs(z_geo) < 1e-12, 1e-12, z_geo)
    geo_x = fx * p3_geo[..., 0] / safe_zgeo + cx
    geo_y = fy * p3_geo[..., 1] / safe_zgeo + cy
    valid = valid & (geo_x >= 0) & (geo_x < w) & (geo_y >= 0) & (geo_y < h)

    Zg = torch.clamp_min(z_geo, 1.0)
    Zt = torch.clamp_min(zt, 1.0)
    drw = (vbf / (Zg * Zt)) ** 2
    residual = drw * res_d
    if use_photo:
        E = _col(torch.exp(c_ref_s) / torch.exp(c_tar_s))
        cref = maps.images[:, ::stride, ::stride][ref_fid] + _col(c_ref_o)
        star = samp[..., 4] + _col(c_tar_o)
        ph = cref - star * E
        residual = residual + crw * 0.5 * ph * ph

    weight = maps.weights[:, ::stride, ::stride][ref_fid]
    r2 = weight * residual
    robust = torch.sqrt(torch.log(torch.clamp_min(r2, 0.0) + 1.0))
    res = torch.where(r2 > _EPS_ROBUST, robust, r2)
    res = torch.where(valid, res, 0.0)

    # ---- reverse mode by hand -------------------------------------------
    dres_dr2 = torch.where(r2 > _EPS_ROBUST,
                           1.0 / (2.0 * torch.clamp_min(robust, 1e-20) * (r2 + 1.0)), 1.0)
    Wp = dres_dr2 * weight

    zeros = torch.zeros_like(zt)
    au = torch.stack([fx * inv_zt, zeros, -fx * pt[..., 0] * inv_zt * inv_zt], dim=-1)
    av = torch.stack([zeros, fy * inv_zt, -fy * pt[..., 1] * inv_zt * inv_zt], dim=-1)
    # built on the device: a tensor from a Python list, or a Python scalar
    # stored into one, is a host-to-device copy and a host sync
    ez = torch.eye(3, dtype=pt.dtype, device=pt.device)[2]

    sd_u, sd_v = s_u[..., 0], s_v[..., 0]
    n_u, n_v = s_u[..., 1:4], s_v[..., 1:4]

    dgam_pt = ((est * inv_zt)[..., None] * (sd_u[..., None] * au + sd_v[..., None] * av)
               - (p2t_d * inv_zt * inv_zt)[..., None] * ez)
    pt_nu = torch.sum(pt * n_u, dim=-1)
    pt_nv = torch.sum(pt * n_v, dim=-1)
    dnpt_pt = pt_nu[..., None] * au + pt_nv[..., None] * av + n
    dg_pt = gam[..., None] * dnpt_pt + npt[..., None] * dgam_pt
    n_nu = torch.sum(n * n_u, dim=-1)
    n_nv = torch.sum(n * n_v, dim=-1)
    dnn_pt = 2.0 * (n_nu[..., None] * au + n_nv[..., None] * av)
    dresd_pt = (g * nn)[..., None] * dg_pt + (0.5 * g * g)[..., None] * dnn_pt
    dzgeo_pt = (ez + n[..., 2:3] * dg_pt
                + g[..., None] * (n_u[..., 2:3] * au + n_v[..., 2:3] * av))
    gz = torch.where(z_geo > 1.0, 1.0 / Zg, 0.0)
    tz = torch.where(zt > 1.0, 1.0 / Zt, 0.0)
    ddrw_pt = (-2.0 * drw)[..., None] * (gz[..., None] * dzgeo_pt + tz[..., None] * ez)
    h_pt = drw[..., None] * dresd_pt + res_d[..., None] * ddrw_pt
    if use_photo:
        si_u, si_v = s_u[..., 4], s_v[..., 4]
        dph_pt = -E[..., None] * (si_u[..., None] * au + si_v[..., None] * av)
        h_pt = h_pt + (crw * ph)[..., None] * dph_pt
    h_pt = Wp[..., None] * h_pt
    h_pt = torch.where(valid[..., None], h_pt, 0.0)

    # pose/scale columns through per-pair constant 3x3s
    y3 = torch.einsum("bhwi,bij->bhwj", h_pt, R0)  # R0^T h
    Jc_r = torch.einsum("bhwi,bij->bhwj", lie.cross(pw_t, y3), A)
    Jc_sr = torch.sum(h_pt * (pt - w0t), dim=-1)
    Jq = -torch.einsum("bhwi,bij->bhwj", lie.cross(pt, h_pt), Jr_q)

    # tar depth-scale column (direct, not via p_t)
    dgam_st = p2t_d * inv_zt
    dg_st = npt * dgam_st
    Jst = Wp * (drw * (g * nn * dg_st) + res_d * (-2.0 * drw * gz * (n[..., 2] * dg_st)))
    vmask = valid.to(pt.dtype)
    Jst = Jst * vmask

    if use_photo:
        phv = Wp * crw * ph * vmask
        Jcr = phv * (-(star * E))
        Jor = phv
        Jct = phv * (star * E)
        Jot = phv * (-E)
    else:
        Jcr = Jor = Jct = Jot = zeros

    Jr_out = torch.cat([Jc_r, y3, Jc_sr[..., None], Jcr[..., None], Jor[..., None]], dim=-1)
    Jt_out = torch.cat([Jq, -y3, Jst[..., None], Jct[..., None], Jot[..., None]], dim=-1)
    return res, Jr_out, Jt_out


# --------------------------------------------------------------------------
# the plain versions of the linearise kernel (csrc/falign_linearize.cu)
# --------------------------------------------------------------------------


class PairBlocks(NamedTuple):
    """Per pair evaluation b, the reductions of its residual r and its
    masked Jacobians Jr, Jt (ref and tar parameters) over the grid: the
    blocks of the Gram matrix of the 19 columns [r, Jr, Jt]."""

    cost: torch.Tensor  # (B,) 1/2 sum r^2
    Hrr: torch.Tensor  # (B, 9, 9) Jr^T Jr
    Hrt: torch.Tensor  # (B, 9, 9) Jr^T Jt
    Htt: torch.Tensor  # (B, 9, 9) Jt^T Jt
    gr: torch.Tensor  # (B, 9) Jr^T r
    gt: torch.Tensor  # (B, 9) Jt^T r


def lane_pairs(params, lanes, pairs):
    """The pair evaluations of lanes: lane l's pair p is evaluation
    b = l * np + p, its frame j map row ``lanes[l] * N + j``. params (L, N,
    9), lanes (L,), pairs (np, 2) local frame indices. Returns (ref and tar
    parameters (B, 9) each, ref and tar map rows (B,) each)."""
    base = lanes[:, None] * params.shape[1]
    ref = (base + pairs[None, :, 0]).reshape(-1)
    tar = (base + pairs[None, :, 1]).reshape(-1)
    return (params[:, pairs[:, 0]].reshape(-1, 9), params[:, pairs[:, 1]].reshape(-1, 9),
            ref, tar)


def pair_jacobians(params, lanes, pairs, dim_mask, maps: FrameMaps, fx, fy, cx, cy, vbf, crw,
                   use_photo: bool, stride: int):
    """Residuals (L, np, m) and the Jacobians w.r.t. ref and tar parameters
    ((L, np, m, 9) each) of the lanes' pair evaluations, columns masked by
    the dim mask (N, 9) (``solver.py:67``)."""
    L, n_p = params.shape[0], pairs.shape[0]
    pr, pt, ref, tar = lane_pairs(params, lanes, pairs)
    res, Jr, Jt = pair_residual_and_grads(pr, pt, ref, tar, maps, fx, fy, cx, cy, vbf, crw,
                                          use_photo, stride)
    m = res.shape[1] * res.shape[2]
    mask_r = dim_mask[pairs[:, 0]][None, :, None, :]
    mask_t = dim_mask[pairs[:, 1]][None, :, None, :]
    return (res.reshape(L, n_p, m), Jr.reshape(L, n_p, m, 9) * mask_r,
            Jt.reshape(L, n_p, m, 9) * mask_t)


def pair_normal_blocks(params, lanes, pairs, dim_mask, maps: FrameMaps, fx, fy, cx, cy, vbf, crw,
                       use_photo: bool, stride: int) -> PairBlocks:
    """The linearise kernel's plain version: per pair evaluation of the
    lanes, the reductions of ``pair_residual_and_grads`` over the strided
    grid (PairBlocks, B = L * np)."""
    res, Jr, Jt = pair_jacobians(params, lanes, pairs, dim_mask, maps, fx, fy, cx, cy, vbf, crw,
                                 use_photo, stride)
    B = res.shape[0] * res.shape[1]
    res, Jr, Jt = res.reshape(B, -1), Jr.reshape(B, -1, 9), Jt.reshape(B, -1, 9)
    return PairBlocks(
        cost=0.5 * torch.sum(res * res, dim=1),
        Hrr=torch.einsum("bki,bkj->bij", Jr, Jr), Hrt=torch.einsum("bki,bkj->bij", Jr, Jt),
        Htt=torch.einsum("bki,bkj->bij", Jt, Jt),
        gr=torch.einsum("bki,bk->bi", Jr, res), gt=torch.einsum("bki,bk->bi", Jt, res))


def pair_score_sums(params, lanes, pairs, maps: FrameMaps, fx, fy, cx, cy, vbf, crw,
                    use_photo: bool, stride: int, bound):
    """The linearise kernel's scores mode, plain: per pair evaluation, over
    the UNWEIGHTED residual of ``pair_residual_map``, the count of visible
    pixels and the sum over them of 1 - min(r^2, bound) / bound. Returns
    two (B,) float tensors."""
    pr, pt, ref, tar = lane_pairs(params, lanes, pairs)
    r, v = pair_residual_map(pr, pt, ref, tar, maps, fx, fy, cx, cy, vbf, crw, use_photo, stride,
                             apply_weights=False)
    bounded = torch.clamp_max(r * r, bound)
    return (torch.sum(v, dim=(1, 2)).to(r.dtype),
            torch.sum(torch.where(v, 1.0 - bounded / bound, 0.0), dim=(1, 2)))
