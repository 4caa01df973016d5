// Frame alignment's linearisation, fused, for sm_90a.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel here:
// voldor_tpu/falign/residual.py:207 (pair_residual_and_grads, the residual
// and its analytic Jacobian), falign/solver.py:67 (_pair_res_and_jacs, the
// dim mask) and :237 (_joint_normal_eq, the normal equations); in scores
// mode, :510 (align_scores). The port's plain versions are
// falign/residual.py:pair_normal_blocks and pair_score_sums.
//
// Per pair evaluation b (lane l = b / np, pair p = b % np; ref frame row
// lanes[l] * N + pairs[p][0], tar row lanes[l] * N + pairs[p][1]) and per
// pixel of the strided ref grid: the sqrt-Cauchy residual r and its
// gradient w.r.t. the pair's 9 + 9 parameters (masked by the dim mask),
// never written to memory; reduced over the grid into the upper triangle of
// the 19 x 19 Gram matrix of [r, Jr, Jt]: 1/2 sum r^2, Jr^T r, Jt^T r,
// Jr^T Jr, Jr^T Jt, Jt^T Jt (190 sums). Scores mode: over the unweighted
// residual of pair_residual_map, the visible pixels and the sum over them of
// 1 - min(r^2, bound) / bound.
//
// What bounds it on the card: neither bytes nor operations at these sizes.
// A 4-pair batch at stride 4 on 185 x 613 is 8 pair evaluations x 7238
// pixels, ~58k residuals of a few hundred FP32 operations and 190 products
// each, and ~5 MB of taps, mostly in L2: microseconds of work. The design
// takes what was ~600 torch launches per LM iteration down to one launch
// per linearisation and keeps the reduction deterministic.
//
// Design: a block per (tile of TILE = 256 grid pixels, pair evaluation).
// Thread 0 computes the pair's constants (the rotations, their right
// Jacobians, the exponentials) into shared memory; each thread evaluates
// one pixel in the exact operation order of the plain per-pixel functions
// (residual.py) and writes its 19 values into a shared tile V[19][257]
// (odd row length: the 32 threads of a warp reading one pixel column of 19
// rows hit distinct banks); then thread k < 190 sums V[a][q] * V[b][q]
// over the tile's pixels q in order, for its Gram entry (a, b), and writes
// the block's partial sum to partials[b][tile][k]. A second pass (the
// reduce kernel below, or the LM accept kernel of falign_lm.cu) adds the
// tiles in order. No float atomics: two launches on the same inputs are
// bitwise equal. A lane whose `active` flag is 0 is skipped whole.
//
// Numerics: the plain versions' operation order (torch evaluates each
// expression left to right, one rounding per operation), IEEE division and
// square root, built with --fmad=false and without fast math. Sums are
// taken in another order than torch's, so the blocks agree with the plain
// version's to rounding, not bitwise. torch.clamp and clamp_min propagate
// NaN; so do the helpers here. A NaN or infinite tar coordinate samples
// from in-range taps (NaN becomes index 0, as ops/image.py:_index does) and
// the pixel is invalid.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kTile = 256;  // threads per block; one grid pixel each
constexpr int kCols = 19;   // [r, Jr (9), Jt (9)]
constexpr int kGram = 190;  // upper triangle of the 19 x 19 Gram matrix
constexpr int kScores = 2;
constexpr float kEpsRobust = 1.1920929e-07f;

__device__ __forceinline__ float clamp_min_nan(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max_nan(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float safe_z(float z) { return fabsf(z) < 1e-12f ? 1e-12f : z; }

struct Args {
  const float* packed;   // (F, h, w, 5): depth, normal (3), image
  const float* weights;  // (F, h, w)
  int h, w;
  const float* params;      // (L, N, 9)
  const long long* lanes;   // (L,)
  const long long* pairs;   // (np, 2)
  const float* dim_mask;    // (N, 9)
  const int* active;        // (L,) or null
  int N, np, stride, use_photo;
  float fx, fy, cx, cy, vbf, crw, bound;
  float* partials;  // (L * np, tiles, width)
  int tiles;
};

// Per pair evaluation, computed once per block by thread 0.
struct PairConsts {
  float R[3][3];   // so3_exp(rvec): ref camera -> world rotation
  float A[3][3];   // R J_r(rvec)
  float R0[3][3];  // so3_exp(q)^T: world -> tar camera
  float Jq[3][3];  // J_r(q)
  float Bm[3][3];  // R0 R
  float w0t[3];    // R0 (t - u)
  float exp_sref, est, E, c_ref_o, c_tar_o;
  float mask_r[9], mask_t[9];
  // scores mode (pair_residual_map's formulation)
  float rvec[3], tvec[3], rvec0[3], tvec0[3];
  long long ref_row, tar_row;
};

__device__ void hat(const float r[3], float K[3][3]) {
  K[0][0] = 0.f;   K[0][1] = -r[2]; K[0][2] = r[1];
  K[1][0] = r[2];  K[1][1] = 0.f;   K[1][2] = -r[0];
  K[2][0] = -r[1]; K[2][1] = r[0];  K[2][2] = 0.f;
}

__device__ void matmul3(const float A[3][3], const float B[3][3], float C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C[i][j] = (A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j];
}

__device__ float norm2(const float r[3]) { return (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]; }

// ops/lie.py:so3_exp
__device__ void so3_exp(const float r[3], float R[3][3]) {
  const float theta2 = norm2(r);
  const float theta = sqrtf(clamp_min_nan(theta2, 1e-12f));
  const bool small = theta2 < 1e-8f;
  const float a = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / theta2;
  float K[3][3], KK[3][3];
  hat(r, K);
  matmul3(K, K, KK);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[i][j] = ((i == j ? 1.0f : 0.0f) + a * K[i][j]) + b * KK[i][j];
}

// ops/lie.py:so3_right_jacobian
__device__ void so3_right_jacobian(const float r[3], float J[3][3]) {
  const float theta2 = norm2(r);
  const float theta = sqrtf(clamp_min_nan(theta2, 1e-12f));
  const bool small = theta2 < 1e-8f;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / theta2;
  const float c = small ? (1.0f / 6.0f) - theta2 / 120.0f : (theta - sinf(theta)) / (theta2 * theta);
  float K[3][3], KK[3][3];
  hat(r, K);
  matmul3(K, K, KK);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) J[i][j] = ((i == j ? 1.0f : 0.0f) - b * K[i][j]) + c * KK[i][j];
}

__device__ void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// ops/lie.py:rotate_rvec
__device__ void rotate_rvec(const float p[3], const float r[3], float out[3]) {
  const float theta2 = norm2(r);
  const float theta = sqrtf(clamp_min_nan(theta2, 1e-12f));
  const bool small = theta2 < 1e-12f;
  const float safe_theta = small ? 1.0f : theta;
  float w[3];
  for (int i = 0; i < 3; ++i) w[i] = r[i] / safe_theta;
  const float cos_t = small ? 1.0f : cosf(theta);
  const float sin_t = small ? 0.0f : sinf(theta);
  float wxp[3], rxp[3];
  cross3(w, p, wxp);
  cross3(r, p, rxp);
  const float wdp = (w[0] * p[0] + w[1] * p[1]) + w[2] * p[2];
  for (int i = 0; i < 3; ++i) {
    const float rotated = (p[i] * cos_t + wxp[i] * sin_t) + (w[i] * wdp) * (1.0f - cos_t);
    out[i] = small ? p[i] + rxp[i] : rotated;
  }
}

__device__ void make_consts(const Args& a, int b, PairConsts& c) {
  const int l = b / a.np, p = b % a.np;
  const int fr = (int)a.pairs[2 * p], ft = (int)a.pairs[2 * p + 1];
  c.ref_row = a.lanes[l] * a.N + fr;
  c.tar_row = a.lanes[l] * a.N + ft;
  const float* pr = a.params + ((long long)l * a.N + fr) * 9;
  const float* pt = a.params + ((long long)l * a.N + ft) * 9;
  for (int i = 0; i < 9; ++i) {
    c.mask_r[i] = a.dim_mask[fr * 9 + i];
    c.mask_t[i] = a.dim_mask[ft * 9 + i];
  }
  const float rvec[3] = {pr[0], pr[1], pr[2]}, tvec[3] = {pr[3], pr[4], pr[5]};
  const float qvec[3] = {pt[0], pt[1], pt[2]}, uvec[3] = {pt[3], pt[4], pt[5]};
  c.exp_sref = expf(pr[6]);
  c.est = expf(pt[6]);
  c.E = expf(pr[7]) / expf(pt[7]);
  c.c_ref_o = pr[8];
  c.c_tar_o = pt[8];
  // residual.py:pair_residual_and_grads
  float Jr[3][3], Rq[3][3];
  so3_exp(rvec, c.R);
  so3_right_jacobian(rvec, Jr);
  matmul3(c.R, Jr, c.A);
  so3_exp(qvec, Rq);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) c.R0[i][j] = Rq[j][i];
  so3_right_jacobian(qvec, c.Jq);
  matmul3(c.R0, c.R, c.Bm);
  float tu[3];
  for (int j = 0; j < 3; ++j) tu[j] = tvec[j] - uvec[j];
  for (int i = 0; i < 3; ++i) c.w0t[i] = (c.R0[i][0] * tu[0] + c.R0[i][1] * tu[1]) + c.R0[i][2] * tu[2];
  // residual.py:pair_residual_map
  float tv0[3];
  for (int i = 0; i < 3; ++i) {
    c.rvec[i] = rvec[i];
    c.tvec[i] = tvec[i];
    c.rvec0[i] = -qvec[i];
  }
  rotate_rvec(uvec, c.rvec0, tv0);
  for (int i = 0; i < 3; ++i) c.tvec0[i] = -tv0[i];
}

// ops/image.py:bilinear_sample_packed_grad on map `row`: values, and (grad)
// their derivatives along x and y, 5 channels each.
template <bool kGrad>
__device__ void sample(const Args& a, long long row, float x, float y, float val[5], float ddx[5],
                       float ddy[5]) {
  const float wm1 = (float)(a.w - 1), hm1 = (float)(a.h - 1);
  const float in_x = (x >= 0.0f && x <= wm1) ? 1.0f : 0.0f;
  const float in_y = (y >= 0.0f && y <= hm1) ? 1.0f : 0.0f;
  const float xc = clamp_max_nan(clamp_min_nan(x, 0.0f), wm1);
  const float yc = clamp_max_nan(clamp_min_nan(y, 0.0f), hm1);
  const float x0 = clamp_max_nan(floorf(xc), (float)(a.w - 2));
  const float y0 = clamp_max_nan(floorf(yc), (float)(a.h - 2));
  const float fx = xc - x0, fy = yc - y0;
  const long long xi = isnan(x0) ? 0 : (long long)x0;
  const long long yi = isnan(y0) ? 0 : (long long)y0;
  const float* p00 = a.packed + ((row * a.h + yi) * a.w + xi) * 5;
  const float* p01 = p00 + 5;
  const float* p10 = p00 + (long long)a.w * 5;
  const float* p11 = p10 + 5;
  for (int ch = 0; ch < 5; ++ch) {
    const float v00 = __ldg(p00 + ch), v01 = __ldg(p01 + ch), v10 = __ldg(p10 + ch),
                v11 = __ldg(p11 + ch);
    const float top = v00 * (1.0f - fx) + v01 * fx;
    const float bot = v10 * (1.0f - fx) + v11 * fx;
    val[ch] = top * (1.0f - fy) + bot * fy;
    if constexpr (kGrad) {
      ddx[ch] = ((v01 - v00) * (1.0f - fy) + (v11 - v10) * fy) * in_x;
      ddy[ch] = (bot - top) * in_y;
    }
  }
}

// residual.py:pair_residual_and_grads at one grid pixel: v = [res, Jr, Jt],
// the Jacobian columns masked.
__device__ void eval_grads(const Args& a, const PairConsts& c, int yi, int xi, float v[kCols]) {
  const int py = yi * a.stride, px = xi * a.stride;
  const float xs = (float)px, ys = (float)py;
  const float kx = (xs - a.cx) / a.fx, ky = (ys - a.cy) / a.fy;
  const long long ref_px = (c.ref_row * a.h + py) * a.w + px;
  const float* ref_pk = a.packed + ref_px * 5;
  const float Dd = __ldg(ref_pk) * c.exp_sref;
  float pw[3], pt[3];
  for (int i = 0; i < 3; ++i) {
    pw[i] = ((c.R[i][0] * kx + c.R[i][1] * ky) + c.R[i][2]) * Dd;
    pt[i] = ((c.Bm[i][0] * kx + c.Bm[i][1] * ky) + c.Bm[i][2]) * Dd + c.w0t[i];
  }
  const float fw = (float)a.w, fh = (float)a.h;
  const float zt = pt[2];
  const float inv_zt = 1.0f / safe_z(zt);
  const float p2t_x = (a.fx * pt[0]) * inv_zt + a.cx;
  const float p2t_y = (a.fy * pt[1]) * inv_zt + a.cy;
  bool valid = (p2t_x >= 0.0f) && (p2t_x < fw) && (p2t_y >= 0.0f) && (p2t_y < fh) && (zt >= 1.0f);

  float samp[5], su[5], sv[5];
  sample<true>(a, c.tar_row, p2t_x, p2t_y, samp, su, sv);
  const float est = c.est;
  const float p2t_d = samp[0] * est;
  const float n[3] = {samp[1], samp[2], samp[3]};
  const float gam = p2t_d * inv_zt - 1.0f;
  const float npt = (n[0] * pt[0] + n[1] * pt[1]) + n[2] * pt[2];
  const float g = gam * npt;
  const float nn = (n[0] * n[0] + n[1] * n[1]) + n[2] * n[2];
  const float res_d = ((0.5f * g) * g) * nn;
  const float z_geo = zt + g * n[2];
  const float pg0 = pt[0] + n[0] * g, pg1 = pt[1] + n[1] * g;
  const float szg = safe_z(z_geo);
  const float geo_x = (a.fx * pg0) / szg + a.cx;
  const float geo_y = (a.fy * pg1) / szg + a.cy;
  valid = valid && (geo_x >= 0.0f) && (geo_x < fw) && (geo_y >= 0.0f) && (geo_y < fh);

  const float Zg = clamp_min_nan(z_geo, 1.0f), Zt = clamp_min_nan(zt, 1.0f);
  const float q = a.vbf / (Zg * Zt);
  const float drw = q * q;
  float residual = drw * res_d;
  const float E = c.E;
  float star = 0.0f, ph = 0.0f;
  if (a.use_photo) {
    const float cref = __ldg(ref_pk + 4) + c.c_ref_o;
    star = samp[4] + c.c_tar_o;
    ph = cref - star * E;
    residual = residual + ((a.crw * 0.5f) * ph) * ph;
  }
  const float weight = __ldg(a.weights + ref_px);
  const float r2 = weight * residual;
  const float robust = sqrtf(logf(clamp_min_nan(r2, 0.0f) + 1.0f));
  float res = r2 > kEpsRobust ? robust : r2;
  res = valid ? res : 0.0f;

  // ---- reverse mode by hand
  const float dres_dr2 =
      r2 > kEpsRobust ? 1.0f / ((2.0f * clamp_min_nan(robust, 1e-20f)) * (r2 + 1.0f)) : 1.0f;
  const float Wp = dres_dr2 * weight;
  const float au[3] = {a.fx * inv_zt, 0.0f, ((-a.fx * pt[0]) * inv_zt) * inv_zt};
  const float av[3] = {0.0f, a.fy * inv_zt, ((-a.fy * pt[1]) * inv_zt) * inv_zt};
  const float ez[3] = {0.0f, 0.0f, 1.0f};
  const float sd_u = su[0], sd_v = sv[0];
  const float nu[3] = {su[1], su[2], su[3]}, nv[3] = {sv[1], sv[2], sv[3]};
  const float ei = est * inv_zt;
  const float pdz = (p2t_d * inv_zt) * inv_zt;
  const float pt_nu = (pt[0] * nu[0] + pt[1] * nu[1]) + pt[2] * nu[2];
  const float pt_nv = (pt[0] * nv[0] + pt[1] * nv[1]) + pt[2] * nv[2];
  const float n_nu = (n[0] * nu[0] + n[1] * nu[1]) + n[2] * nu[2];
  const float n_nv = (n[0] * nv[0] + n[1] * nv[1]) + n[2] * nv[2];
  const float gz = z_geo > 1.0f ? 1.0f / Zg : 0.0f;
  const float tz = zt > 1.0f ? 1.0f / Zt : 0.0f;
  const float gnn = g * nn, hgg = (0.5f * g) * g, m2drw = -2.0f * drw;
  float hpt[3];
  for (int i = 0; i < 3; ++i) {
    const float dgam = ei * (sd_u * au[i] + sd_v * av[i]) - pdz * ez[i];
    const float dnpt = (pt_nu * au[i] + pt_nv * av[i]) + n[i];
    const float dg = gam * dnpt + npt * dgam;
    const float dnn = 2.0f * (n_nu * au[i] + n_nv * av[i]);
    const float dresd = gnn * dg + hgg * dnn;
    const float dzgeo = (ez[i] + n[2] * dg) + g * (nu[2] * au[i] + nv[2] * av[i]);
    const float ddrw = m2drw * (gz * dzgeo + tz * ez[i]);
    float h = drw * dresd + res_d * ddrw;
    if (a.use_photo) {
      const float dph = (-E) * (su[4] * au[i] + sv[4] * av[i]);
      h = h + (a.crw * ph) * dph;
    }
    h = Wp * h;
    hpt[i] = valid ? h : 0.0f;
  }
  // pose / scale columns through the pair's constant 3 x 3s
  float y3[3], Jc_r[3], Jq[3], cr[3], cq[3];
  for (int j = 0; j < 3; ++j)
    y3[j] = (hpt[0] * c.R0[0][j] + hpt[1] * c.R0[1][j]) + hpt[2] * c.R0[2][j];
  cross3(pw, y3, cr);
  cross3(pt, hpt, cq);
  for (int j = 0; j < 3; ++j) {
    Jc_r[j] = (cr[0] * c.A[0][j] + cr[1] * c.A[1][j]) + cr[2] * c.A[2][j];
    Jq[j] = -((cq[0] * c.Jq[0][j] + cq[1] * c.Jq[1][j]) + cq[2] * c.Jq[2][j]);
  }
  const float Jc_sr = (hpt[0] * (pt[0] - c.w0t[0]) + hpt[1] * (pt[1] - c.w0t[1]))
                      + hpt[2] * (pt[2] - c.w0t[2]);
  const float dg_st = npt * (p2t_d * inv_zt);
  const float vmask = valid ? 1.0f : 0.0f;
  const float Jst =
      (Wp * (drw * (gnn * dg_st) + res_d * ((m2drw * gz) * (n[2] * dg_st)))) * vmask;
  float Jcr = 0.0f, Jor = 0.0f, Jct = 0.0f, Jot = 0.0f;
  if (a.use_photo) {
    const float phv = ((Wp * a.crw) * ph) * vmask;
    const float se = star * E;
    Jcr = phv * (-se);
    Jor = phv;
    Jct = phv * se;
    Jot = phv * (-E);
  }
  v[0] = res;
  for (int j = 0; j < 3; ++j) {
    v[1 + j] = Jc_r[j] * c.mask_r[j];
    v[4 + j] = y3[j] * c.mask_r[3 + j];
    v[10 + j] = Jq[j] * c.mask_t[j];
    v[13 + j] = (-y3[j]) * c.mask_t[3 + j];
  }
  v[7] = Jc_sr * c.mask_r[6];
  v[8] = Jcr * c.mask_r[7];
  v[9] = Jor * c.mask_r[8];
  v[16] = Jst * c.mask_t[6];
  v[17] = Jct * c.mask_t[7];
  v[18] = Jot * c.mask_t[8];
}

// residual.py:pair_residual_map (apply_weights=False) at one grid pixel:
// v = [visible, visible ? 1 - min(r^2, bound) / bound : 0].
__device__ void eval_scores(const Args& a, const PairConsts& c, int yi, int xi, float v[kScores]) {
  const int py = yi * a.stride, px = xi * a.stride;
  const float xs = (float)px, ys = (float)py;
  const long long ref_px = (c.ref_row * a.h + py) * a.w + px;
  const float* ref_pk = a.packed + ref_px * 5;
  const float p2r_d = __ldg(ref_pk) * c.exp_sref;
  const float p3r[3] = {((xs - a.cx) / a.fx) * p2r_d, ((ys - a.cy) / a.fy) * p2r_d, p2r_d};
  float p3w[3], p3t[3];
  rotate_rvec(p3r, c.rvec, p3w);
  for (int i = 0; i < 3; ++i) p3w[i] = p3w[i] + c.tvec[i];
  rotate_rvec(p3w, c.rvec0, p3t);
  for (int i = 0; i < 3; ++i) p3t[i] = p3t[i] + c.tvec0[i];
  const float fw = (float)a.w, fh = (float)a.h;
  const float zt = p3t[2];
  const float szt = safe_z(zt);
  const float p2t_x = (a.fx * p3t[0]) / szt + a.cx;
  const float p2t_y = (a.fy * p3t[1]) / szt + a.cy;
  bool valid = (p2t_x >= 0.0f) && (p2t_x < fw) && (p2t_y >= 0.0f) && (p2t_y < fh) && (zt >= 1.0f);

  float samp[5];
  sample<false>(a, c.tar_row, p2t_x, p2t_y, samp, nullptr, nullptr);
  const float p2t_d = samp[0] * c.est;
  const float n[3] = {samp[1], samp[2], samp[3]};
  const float ray = p2t_d / szt;
  float dv[3];
  for (int i = 0; i < 3; ++i) dv[i] = n[i] * (p3t[i] * ray - p3t[i]);
  const float s = (dv[0] + dv[1]) + dv[2];
  float diff[3], p3g[3];
  for (int i = 0; i < 3; ++i) {
    diff[i] = n[i] * s;
    p3g[i] = p3t[i] + diff[i];
  }
  const float z_geo = p3g[2];
  const float szg = safe_z(z_geo);
  const float geo_x = (a.fx * p3g[0]) / szg + a.cx;
  const float geo_y = (a.fy * p3g[1]) / szg + a.cy;
  valid = valid && (geo_x >= 0.0f) && (geo_x < fw) && (geo_y >= 0.0f) && (geo_y < fh);
  const float res_depth = 0.5f * ((diff[0] * diff[0] + diff[1] * diff[1]) + diff[2] * diff[2]);
  const float q = a.vbf / (clamp_min_nan(z_geo, 1.0f) * clamp_min_nan(zt, 1.0f));
  float residual = (q * q) * res_depth;
  if (a.use_photo) {
    const float c_ref = __ldg(ref_pk + 4) + c.c_ref_o;
    const float c_tar = (samp[4] + c.c_tar_o) * c.E;
    const float d = c_ref - c_tar;
    residual = residual + (a.crw * 0.5f) * (d * d);
  }
  const float r2 = residual;
  const float robust = sqrtf(logf(clamp_min_nan(r2, 0.0f) + 1.0f));
  float r = r2 > kEpsRobust ? robust : r2;
  r = valid ? r : 0.0f;
  const float bounded = clamp_max_nan(r * r, a.bound);
  v[0] = valid ? 1.0f : 0.0f;
  v[1] = valid ? 1.0f - bounded / a.bound : 0.0f;
}

template <bool kScoreMode>
__global__ void __launch_bounds__(kTile) falign_linearize_kernel(Args a) {
  constexpr int kW = kScoreMode ? kScores : kCols;
  __shared__ PairConsts pc;
  __shared__ float V[kW][kTile + 1];
  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  if (a.active != nullptr && a.active[b / a.np] == 0) return;  // the whole block
  if (tid == 0) make_consts(a, b, pc);
  __syncthreads();
  const int hs = (a.h + a.stride - 1) / a.stride, ws = (a.w + a.stride - 1) / a.stride;
  const int pix = tile * kTile + tid;
  float v[kW];
  for (int k = 0; k < kW; ++k) v[k] = 0.0f;
  if (pix < hs * ws) {
    if constexpr (kScoreMode)
      eval_scores(a, pc, pix / ws, pix % ws, v);
    else
      eval_grads(a, pc, pix / ws, pix % ws, v);
  }
  for (int k = 0; k < kW; ++k) V[k][tid] = v[k];
  __syncthreads();
  float* out = a.partials + ((long long)b * a.tiles + tile) * (kScoreMode ? kScores : kGram);
  if constexpr (kScoreMode) {
    if (tid < kScores) {
      float s = 0.0f;
      for (int q = 0; q < kTile; ++q) s += V[tid][q];
      out[tid] = s;
    }
  } else if (tid < kGram) {
    // Gram entry (r, c), r <= c, packed row-major
    int r = 0, k = tid;
    while (k >= kCols - r) {
      k -= kCols - r;
      ++r;
    }
    const int col = r + k;
    float s = 0.0f;
    for (int q = 0; q < kTile; ++q) s += V[r][q] * V[col][q];
    out[tid] = s;
  }
}

// (B, tiles, width) -> (B, width): the tiles added in order.
__global__ void falign_reduce_kernel(const float* part, float* out, int tiles, int width) {
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) s += part[((long long)b * tiles + t) * width + k];
    out[(long long)b * width + k] = s;
  }
}

}  // namespace

extern "C" int falign_linearize_launch(const float* packed, const float* weights, int F, int h,
                                       int w, const float* params, const long long* lanes,
                                       const long long* pairs, const float* dim_mask,
                                       const int* active, int L, int N, int np, int stride,
                                       int use_photo, int scores, float fx, float fy, float cx,
                                       float cy, float vbf, float crw, float bound,
                                       float* partials, int tiles, void* stream) {
  if (F < 1 || h < 2 || w < 2 || L < 1 || N < 1 || np < 1 || stride < 1 || tiles < 1)
    return (int)cudaErrorInvalidValue;
  const int hs = (h + stride - 1) / stride, ws = (w + stride - 1) / stride;
  if (tiles != (hs * ws + kTile - 1) / kTile || (long long)L * np > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{packed, weights, h, w, params, lanes, pairs, dim_mask, active, N, np, stride,
         use_photo, fx, fy, cx, cy, vbf, crw, bound, partials, tiles};
  const dim3 grid(tiles, L * np);
  cudaStream_t s = (cudaStream_t)stream;
  if (scores)
    falign_linearize_kernel<true><<<grid, kTile, 0, s>>>(a);
  else
    falign_linearize_kernel<false><<<grid, kTile, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int falign_reduce_launch(const float* partials, float* out, int B, int tiles, int width,
                                    void* stream) {
  if (B < 1 || tiles < 1 || width < 1 || B > 2147483647) return (int)cudaErrorInvalidValue;
  falign_reduce_kernel<<<B, 256, 0, (cudaStream_t)stream>>>(partials, out, tiles, width);
  return (int)cudaGetLastError();
}
