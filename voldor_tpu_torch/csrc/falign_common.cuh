// Frame alignment's per-pixel linearisation and its reduction across a
// thread-block cluster, for sm_90a: shared by falign_linearize.cu (the
// one-shot launches: phase start, covariances, scores) and falign_lm.cu
// (the LM chunk).
//
// The per-pixel functions (make_consts, sample, eval_grads, eval_scores)
// follow the port's plain versions (falign/residual.py) operation for
// operation: IEEE division and square root, built with --fmad=false and
// without fast math, NaN-propagating clamps. A NaN or infinite tar
// coordinate samples from in-range taps (NaN becomes index 0, as
// ops/image.py:_index does) and the pixel is invalid.
//
// A cluster of C blocks of kThreads threads linearises a set of pairs: in
// the LM chunk a lane's (an independent problem of N frames and np pairs),
// in groups of pairs; in a one-shot launch one pair evaluation. Block 0
// computes the pairs' constants (PairConsts) into its shared memory; the
// other blocks copy them through distributed shared memory after a cluster
// barrier. Block `rank` takes the tiles rank, rank + C, ... of kThreads
// pixels of each pair's strided ref grid, in that order; each thread
// evaluates one pixel of a tile and stages its 19 values [r, Jr (9), Jt (9)]
// as a row of V (20 floats, 16-byte aligned). The upper triangle of the 19 x
// 19 Gram matrix is padded to 20 x 20 and cut into the 15 4 x 4 blocks (I,
// J), I <= J: warp b < 15 owns block b, and its lane s sums the block's 16
// products over the tile's pixels s, s + 32, ..., s + 480 (two 16-byte loads
// and 16 multiply-adds a pixel), carrying the sums in registers from tile to
// tile. After a pair's last tile the 32 lanes' sums of each entry are added
// by a fixed tree (the second level), into the block's `part`. Block 0 then
// adds the C blocks' parts in rank order (reduce_ranks). No float atomics:
// two launches on the same inputs are bitwise equal. Scores mode keeps its
// two sums per thread across the tiles and adds them by a fixed tree.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>

namespace falign {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;      // threads per block; one grid pixel each per tile
constexpr int kCols = 19;          // [r, Jr (9), Jt (9)]
constexpr int kGram = 190;         // upper triangle of the 19 x 19 Gram matrix
constexpr int kScores = 2;         // [visible, sum of 1 - min(r^2, bound) / bound]
constexpr int kVRow = 20;          // a staged pixel: 19 values and a zero
constexpr int kGramBlocks = 15;    // 4 x 4 blocks (I, J), I <= J < 5, of the padded 20 x 20
constexpr int kPxPerLane = kThreads / 32;
constexpr int kL2Stride = 17;      // second-level buffer: 16 sums a lane, odd stride
constexpr int kMaxCluster = 16;
constexpr float kEpsRobust = 1.1920929e-07f;

// threadIdx.x, read where it is used: what is derived from it cannot be
// hoisted out of the chunk kernel's launch-long loop and kept live there
// (where it spilled, ~180 bytes, and slowed every phase of an iteration).
__device__ __forceinline__ int tid_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__device__ __forceinline__ float clamp_min_nan(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max_nan(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float safe_z(float z) { return fabsf(z) < 1e-12f ? 1e-12f : z; }

// What the per-pixel functions read of the maps and the camera.
struct Maps {
  const float* packed;   // (F, h, w, 5): depth, normal (3), image
  const float* weights;  // (F, h, w)
  int h, w, stride, use_photo;
  float fx, fy, cx, cy, vbf, crw, bound;
};

// Per pair evaluation: what every pixel of the pair reads.
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
static_assert(sizeof(PairConsts) % 16 == 0, "PairConsts packs into 16-byte units");
constexpr int kConstWords = (int)(sizeof(PairConsts) / 4);

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of the shared memory the cluster linearise takes per block: the
// staged tile V, the block's part (np x width) and the pairs' constants.
__host__ __device__ constexpr int lin_smem_floats(int np, int width) {
  return kThreads * kVRow + round4(np * width) + np * kConstWords;
}

static __device__ void hat(const float r[3], float K[3][3]) {
  K[0][0] = 0.f;   K[0][1] = -r[2]; K[0][2] = r[1];
  K[1][0] = r[2];  K[1][1] = 0.f;   K[1][2] = -r[0];
  K[2][0] = -r[1]; K[2][1] = r[0];  K[2][2] = 0.f;
}

static __device__ void matmul3(const float A[3][3], const float B[3][3], float C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C[i][j] = (A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j];
}

static __device__ float norm2(const float r[3]) { return (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]; }

// ops/lie.py:so3_exp
static __device__ void so3_exp(const float r[3], float R[3][3]) {
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
static __device__ void so3_right_jacobian(const float r[3], float J[3][3]) {
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

static __device__ void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// ops/lie.py:rotate_rvec
static __device__ void rotate_rvec(const float p[3], const float r[3], float out[3]) {
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

// The constants of the pair (ref frame parameters pr, tar frame parameters
// pt, 9 each; their dim-mask rows; their map rows).
static __device__ void make_consts(const float* pr, const float* pt, const float* mask_r,
                            const float* mask_t, long long ref_row, long long tar_row,
                            PairConsts& c) {
  c.ref_row = ref_row;
  c.tar_row = tar_row;
  for (int i = 0; i < 9; ++i) {
    c.mask_r[i] = mask_r[i];
    c.mask_t[i] = mask_t[i];
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
static __device__ void sample(const Maps& a, long long row, float x, float y, float val[5], float ddx[5],
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
static __device__ void eval_grads(const Maps& a, const PairConsts& c, int yi, int xi, float v[kCols]) {
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
static __device__ void eval_scores(const Maps& a, const PairConsts& c, int yi, int xi, float v[kScores]) {
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

// (I, J) of Gram block b, I <= J < 5, blocks numbered row by row.
__device__ __forceinline__ void gram_block(int b, int& I, int& J) {
  I = 0;
  while (b >= 5 - I) {
    b -= 5 - I;
    ++I;
  }
  J = I + b;
}

// Gram entry k of the packed upper triangle -> its row a <= column b.
__device__ __forceinline__ void gram_entry(int k, int& a, int& b) {
  a = 0;
  while (k >= kCols - a) {
    k -= kCols - a;
    ++a;
  }
  b = a + k;
}

// Warp `warp` < kGramBlocks, lane `lane`: the 16 products of its Gram block
// over the staged tile's pixels lane, lane + 32, ..., added to acc.
__device__ __forceinline__ void gram_tile(const float* Vt, int I, int J, int lane, float acc[16]) {
#pragma unroll 4
  for (int i = 0; i < kPxPerLane; ++i) {
    const float4* row = reinterpret_cast<const float4*>(Vt + (lane + 32 * i) * kVRow);
    const float4 x = row[I], y = row[J];
    const float xa[4] = {x.x, x.y, x.z, x.w}, ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r * 4 + c] = acc[r * 4 + c] + xa[r] * ya[c];
  }
}

// This block's share of the lane's linearisation: for each pair p of cst,
// the sums over the block's tiles into part[p * width, (p + 1) * width)
// (width kGram, or kScores in scores mode). Vt: kThreads * kVRow floats of
// scratch. Every thread of the block calls it.
template <bool kScoreMode>
static __device__ void cta_linearize(const Maps& m, const PairConsts* cst, int np, int rank, int C,
                              float* Vt, float* part) {
  const int tid = tid_x(), warp = tid >> 5, lane = tid & 31;
  const int hs = (m.h + m.stride - 1) / m.stride, ws = (m.w + m.stride - 1) / m.stride;
  const int npx = hs * ws;
  const int tiles = (npx + kThreads - 1) / kThreads;
  for (int p = 0; p < np; ++p) {
    const PairConsts& c = cst[p];
    if constexpr (kScoreMode) {
      float s0 = 0.0f, s1 = 0.0f;
      for (int t = rank; t < tiles; t += C) {
        const int pix = t * kThreads + tid;
        if (pix < npx) {
          float v[kScores];
          eval_scores(m, c, pix / ws, pix % ws, v);
          s0 = s0 + v[0];
          s1 = s1 + v[1];
        }
      }
      Vt[tid] = s0;
      Vt[kThreads + tid] = s1;
      __syncthreads();
      for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (tid < s) {
          Vt[tid] = Vt[tid] + Vt[tid + s];
          Vt[kThreads + tid] = Vt[kThreads + tid] + Vt[kThreads + tid + s];
        }
        __syncthreads();
      }
      if (tid == 0) {
        part[p * kScores] = Vt[0];
        part[p * kScores + 1] = Vt[kThreads];
      }
      __syncthreads();
    } else {
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
      int I = 0, J = 0;
      if (warp < kGramBlocks) gram_block(warp, I, J);
      for (int t = rank; t < tiles; t += C) {
        const int pix = t * kThreads + tid;
        float v[kCols];
#pragma unroll
        for (int k = 0; k < kCols; ++k) v[k] = 0.0f;
        if (pix < npx) eval_grads(m, c, pix / ws, pix % ws, v);
        float4* row = reinterpret_cast<float4*>(Vt + tid * kVRow);
        row[0] = make_float4(v[0], v[1], v[2], v[3]);
        row[1] = make_float4(v[4], v[5], v[6], v[7]);
        row[2] = make_float4(v[8], v[9], v[10], v[11]);
        row[3] = make_float4(v[12], v[13], v[14], v[15]);
        row[4] = make_float4(v[16], v[17], v[18], 0.0f);
        __syncthreads();
        if (warp < kGramBlocks) gram_tile(Vt, I, J, lane, acc);
        __syncthreads();
      }
      // second level: each entry's 32 lane sums, in lane order
      if (warp < kGramBlocks) {
#pragma unroll
        for (int e = 0; e < 16; ++e) Vt[(warp * 32 + lane) * kL2Stride + e] = acc[e];
      }
      __syncthreads();
      if (tid < kGram) {
        int a, b, Ib, Jb;
        gram_entry(tid, a, b);
        Ib = a >> 2;
        Jb = b >> 2;
        const int blk = Ib * 5 - (Ib * (Ib - 1)) / 2 + (Jb - Ib);
        const int e = (a & 3) * 4 + (b & 3);
        float v[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) v[r] = Vt[(blk * 32 + r) * kL2Stride + e];
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
#pragma unroll
          for (int r = 0; r < w; ++r) v[r] = v[r] + v[r + w];
        part[p * kGram + tid] = v[0];
      }
      __syncthreads();
    }
  }
}

// Blocks other than 0: the pairs' constants copied from block 0's shared
// memory (after a cluster barrier that follows block 0's writes).
static __device__ void fetch_consts(PairConsts* cst, int np) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned* src = cluster.map_shared_rank(reinterpret_cast<unsigned*>(cst), 0);
  unsigned* dst = reinterpret_cast<unsigned*>(cst);
  for (int i = tid_x(); i < np * kConstWords; i += kThreads) dst[i] = src[i];
  __syncthreads();
}

// Block 0: entry e < n of the C blocks' parts added in rank order into
// dst[e] (dst may be part itself: each entry is read and written by one
// thread).
static __device__ void reduce_ranks(float* part, int n, int C, float* dst) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int e = tid_x(); e < n; e += kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) v[r] = cluster.map_shared_rank(part, r)[e];
    float s = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < C) s = s + v[r];
    dst[e] = s;
  }
}

// A kernel's attributes for cluster launches, set once a device (by
// max_clusters, which the wrapper calls once per device and shape before
// its first launch): non-portable cluster sizes allowed, and dynamic shared
// memory up to what the device allows a block beside the kernel's static
// shared memory, so that no launch sets an attribute.
template <class Arg>
inline cudaError_t prepare_cluster(void (*kernel)(Arg)) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

inline cudaLaunchConfig_t cluster_config(int clusters, int C, size_t bytes, cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * C), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launching a kernel of one argument as `clusters` clusters of C blocks,
// with `bytes` of dynamic shared memory a block (prepare_cluster done).
template <class Arg>
inline int launch_cluster(void (*kernel)(Arg), const Arg& arg, int clusters, int C, size_t bytes,
                          cudaStream_t s) {
  if (C < 1 || C > kMaxCluster || clusters < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(clusters, C, bytes, s, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, arg);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of C blocks with `bytes` of shared memory each the
// current device can hold at once (0: such a cluster cannot be launched);
// prepares the kernel's attributes first.
template <class Arg>
inline int max_clusters(void (*kernel)(Arg), int C, size_t bytes, int* out) {
  *out = 0;
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare_cluster(kernel);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, C, bytes, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

}  // namespace falign
