// LambdaTwist P3P / P4P, a thread per pose hypothesis, for sm_90a.
//
// Replaces the jitted vmap of voldor_tpu/ops/p3p.py:_p4p_single (:175),
// solve_batch_p4p (:300), which has no Pallas kernel: XLA compiles the
// whole batch into one device program. The port's plain version
// (ops/p3p.py:_p4p_batch) is some 1,500 elementwise torch launches over
// (B, S) per call (24 Newton steps of the cubic, 5 Gauss-Newton steps for
// each of 4 depth triples, a dozen operations each).
//
// Input: the correspondences p2s (B, M, 2) and p3s (B, M, 3) float32; the
// stable compaction `order` (B, M) int64 (the valid rows first, in order:
// argsort of ~valid, ops/p3p.py:select_subsets); the draws idx (B, S, 4)
// int64, indices into the valid rows (ops/p3p.py:draw_p4p_indices; an
// index outside [0, M) is clamped into it); n_valid (B,) int32. Output
// either rvec, t (B, S, 3) and ok (B, S) bool, or the meanshift pool row
// [rvec * rvec_scale, t] (B, S, 6) and its 0 / 1 validity (B, S) float32
// (ops/p3p.py:solve_batch_p4p_pool). ok is the plain version's: some
// depth triple was real and positive, the chosen one reprojects the 4th
// point finitely, rvec and t are finite, and n_valid >= 4.
//
// What bounds it on the card: the chain of dependent IEEE operations of
// one hypothesis (~3,000 FP32 instructions with ~100 divisions and ~20
// square roots, most of it in sequence: the Newton steps, then each
// triple's refinement). Its bytes (the 4 gathered rows and 28 bytes out,
// ~2 MB at B = 5, S = 8192) take under a microsecond at 3.35 TB/s, and
// its least operations ~4 us at the FP32 peak; the 40,960 threads of a
// B = 5 launch fill 10 warps of each of the 132 SMs, so the latency of
// each thread's chain is what a launch takes.
//
// Design: one thread runs the whole of _p4p_batch for its hypothesis in
// registers: the bearings, the cubic, the eigenvectors with the known zero
// eigenvalue, both lambda_candidates, then each of the 4 depth triples in
// turn (its refinement, R = Y X^-1, t, the 4th point's reprojection),
// keeping the first smallest error as torch.argmin does, so one triple's
// R and t live at a time; then lie.so3_log through the quaternion. No
// shared memory, no synchronisation.
//
// Numerics: the plain version's expression order, operation for
// operation, built with --fmad=false and without fast math, so every
// product, sum, division and sqrtf is rounded on its own as PyTorch's
// elementwise kernels round it; each torch.where is a select of two
// evaluated values (NaN does not leak through the branch not taken).
// lie.so3_log's norms, which PyTorch reduces in its own order, are added
// here in turn: they may differ in the last bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 128;
constexpr int kCubicIters = 24;  // ops/p3p.py:_CUBIC_ITERS
constexpr int kRefineIters = 5;  // ops/p3p.py:_REFINE_ITERS

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float nz(float x) { return fabsf(x) < 1e-30f ? 1e-30f : x; }

// torch.clamp_min(x, lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

// ops/p3p.py:_sqrt, the correctly rounded root
__device__ __forceinline__ float sqrt0(float x) { return sqrtf(clamp_min(x, 0.0f)); }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

// ops/p3p.py:_root2real: stable real roots of x^2 + b x + c
__device__ __forceinline__ void root2real(float b, float c, float& r1, float& r2, bool& has_real) {
  const float v = b * b - 4.0f * c;
  has_real = v >= 0.0f;
  const float y = sqrt0(v);
  const float r1_neg = 0.5f * (-b + y);
  const float r2_neg = 0.5f * (-b - y);
  const float r1_pos = 2.0f * c / nz(-b + y);
  const float r2_pos = 2.0f * c / nz(-b - y);
  r1 = b < 0.0f ? r1_neg : r1_pos;
  r2 = b < 0.0f ? r2_neg : r2_pos;
  r1 = has_real ? r1 : 0.5f * b;
  r2 = has_real ? r2 : 0.5f * b;
}

__device__ __forceinline__ float cubic_h(float r, float b, float c, float d) {
  return ((r + b) * r + c) * r + d;
}

__device__ __forceinline__ float cubic_hp(float r, float b, float c) {
  return (3.0f * r + 2.0f * b) * r + c;
}

// ops/p3p.py:_cubick: the most stable real root of x^3 + b x^2 + c x + d
__device__ float cubick(float b, float c, float d) {
  const float disc = b * b - 3.0f * c;
  const float v = sqrt0(disc);
  const float t1 = (-b - v) / 3.0f;
  const float t2 = (-b + v) / 3.0f;
  const float k1 = cubic_h(t1, b, c, d);
  const float k2 = cubic_h(t2, b, c, d);
  const float r0_a = t1 - sqrt0(-k1 / (3.0f * t1 + b));
  const float r0_b = t2 + sqrt0(-k2 / (3.0f * t2 + b));
  const float r0_stat = k1 > 0.0f ? r0_a : r0_b;
  float r0_mono = -b / 3.0f;
  r0_mono = fabsf(cubic_hp(r0_mono, b, c)) < 1e-4f ? r0_mono + 1.0f : r0_mono;
  float r = disc >= 0.0f ? r0_stat : r0_mono;
#pragma unroll 1
  for (int i = 0; i < kCubicIters; ++i) r = r - cubic_h(r, b, c, d) / nz(cubic_hp(r, b, c));
  return r;
}

struct Consts {  // a hypothesis's squared distances and bearing products
  float a12, a13, a23, b12, b13, b23;
};

__device__ __forceinline__ void gn_residuals(float l1, float l2, float l3, const Consts& k,
                                             float& r1, float& r2, float& r3) {
  r1 = l1 * l1 + l2 * l2 + k.b12 * l1 * l2 - k.a12;
  r2 = l1 * l1 + l3 * l3 + k.b13 * l1 * l3 - k.a13;
  r3 = l2 * l2 + l3 * l3 + k.b23 * l2 * l3 - k.a23;
}

// ops/p3p.py:_gn_refine_lambdas, in place; unchanged where !valid
__device__ void gn_refine(float& L1, float& L2, float& L3, bool valid, const Consts& k) {
  float l1 = L1, l2 = L2, l3 = L3;
  bool frozen = false;
#pragma unroll 1
  for (int i = 0; i < kRefineIters; ++i) {
    float r1, r2, r3;
    gn_residuals(l1, l2, l3, k, r1, r2, r3);
    const float rsum = fabsf(r1) + fabsf(r2) + fabsf(r3);
    const bool converged = rsum < 1e-10f;
    const float v0 = 2.0f * l1 + k.b12 * l2;
    const float v1 = 2.0f * l2 + k.b12 * l1;
    const float v3 = 2.0f * l1 + k.b13 * l3;
    const float v5 = 2.0f * l3 + k.b13 * l1;
    const float v7 = 2.0f * l2 + k.b23 * l3;
    const float v8 = 2.0f * l3 + k.b23 * l2;
    const float det = -v0 * v5 * v7 - v1 * v3 * v8;
    const float det_inv = 1.0f / nz(det);
    const float j1 = -v5 * v7 * r1 + -v1 * v8 * r2 + v1 * v5 * r3;
    const float j2 = -v3 * v8 * r1 + v0 * v8 * r2 + -v0 * v5 * r3;
    const float j3 = v3 * v7 * r1 + -v0 * v7 * r2 + -v1 * v3 * r3;
    const float n1 = l1 - det_inv * j1;
    const float n2 = l2 - det_inv * j2;
    const float n3 = l3 - det_inv * j3;
    float q1, q2, q3;
    gn_residuals(n1, n2, n3, k, q1, q2, q3);
    const bool worse = (fabsf(q1) + fabsf(q2) + fabsf(q3)) > rsum;
    const bool accept = !frozen && !converged && !worse;
    l1 = accept ? n1 : l1;
    l2 = accept ? n2 : l2;
    l3 = accept ? n3 : l3;
    frozen = frozen || converged || worse;
  }
  if (valid) {
    L1 = l1;
    L2 = l2;
    L3 = l3;
  }
}

__device__ __forceinline__ float norm4(float a, float b, float c, float d) {
  return sqrtf(((a * a + b * b) + c * c) + d * d);
}

// ops/lie.py:so3_log (quat_from_matrix, quat_normalize, quat_to_rvec)
__device__ V3 so3_log(const float (&m)[3][3]) {
  const float tr = m[0][0] + m[1][1] + m[2][2];
  float q[4][4], s[4];
  const float t[4] = {tr + 1.0f, 1.0f + m[0][0] - m[1][1] - m[2][2],
                      1.0f + m[1][1] - m[0][0] - m[2][2], 1.0f + m[2][2] - m[0][0] - m[1][1]};
  const float num[4][4] = {
      {t[0], m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]},
      {m[2][1] - m[1][2], t[1], m[0][1] + m[1][0], m[0][2] + m[2][0]},
      {m[0][2] - m[2][0], m[0][1] + m[1][0], t[2], m[1][2] + m[2][1]},
      {m[1][0] - m[0][1], m[0][2] + m[2][0], m[1][2] + m[2][1], t[3]},
  };
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = sqrtf(clamp_min(t[k], 1e-12f)) * 2.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) q[k][j] = num[k][j] / s[k];
  }
  int best = 0;  // torch.argmax: the first largest, a NaN first of all
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (isnan(s[best])) break;
    if (isnan(s[k]) || s[k] > s[best]) best = k;
  }
  float w = q[best][0], x = q[best][1], y = q[best][2], z = q[best][3];
  const float sgn = w < 0.0f ? -1.0f : 1.0f;
  w = w * sgn;
  x = x * sgn;
  y = y * sgn;
  z = z * sgn;
  const float n = clamp_min(norm4(w, x, y, z), 1e-12f);
  w = w / n;
  x = x / n;
  y = y / n;
  z = z / n;
  const float sin_half = sqrtf((x * x + y * y) + z * z);
  const float theta = 2.0f * atan2f(sin_half, w);
  const bool small = sin_half < 1e-8f;
  const float sign_w = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  const float w_div = w == 0.0f ? 1.0f : sign_w;
  const float sc = small ? (1.0f / w_div) * 2.0f : theta / clamp_min(sin_half, 1e-12f);
  return {x * sc, y * sc, z * sc};
}

struct Cam {
  float fx, fy, cx, cy;
};

__device__ __forceinline__ V3 bearing(float u, float v, const Cam& cam) {
  const float bx = (u - cam.cx) / cam.fx;
  const float by = (v - cam.cy) / cam.fy;
  const float n = sqrtf(bx * bx + by * by + 1.0f);
  return {bx / n, by / n, 1.0f / n};
}

// ops/p3p.py:_p4p_batch for one hypothesis: (rvec, t, valid)
__device__ bool p4p_one(const float (&u)[4], const float (&v)[4], const V3 (&X)[4], const Cam& cam,
                        V3& rvec, V3& t_out) {
  const V3 y1 = bearing(u[0], v[0], cam), y2 = bearing(u[1], v[1], cam),
           y3 = bearing(u[2], v[2], cam);
  Consts k;
  k.b12 = -2.0f * dot(y1, y2);
  k.b13 = -2.0f * dot(y1, y3);
  k.b23 = -2.0f * dot(y2, y3);
  const V3 d12 = sub(X[0], X[1]), d13 = sub(X[0], X[2]), d23 = sub(X[1], X[2]);
  const V3 d12xd13 = cross(d12, d13);
  k.a12 = dot(d12, d12);
  k.a13 = dot(d13, d13);
  k.a23 = dot(d23, d23);
  const float a12 = k.a12, a13 = k.a13, a23 = k.a23, b12 = k.b12, b13 = k.b13, b23 = k.b23;

  const float c31 = -0.5f * b13, c23 = -0.5f * b23, c12 = -0.5f * b12;
  const float blob = c12 * c23 * c31 - 1.0f;
  const float s31s = 1.0f - c31 * c31, s23s = 1.0f - c23 * c23, s12s = 1.0f - c12 * c12;
  const float p3 = a13 * (a23 * s31s - a13 * s23s);
  const float p2 = 2.0f * blob * a23 * a13 + a13 * (2.0f * a12 + a13) * s23s + a23 * (a23 - a12) * s31s;
  const float p1 = a23 * (a13 - a23) * s12s - a12 * a12 * s23s - 2.0f * a12 * (blob * a23 + a13 * s23s);
  const float p0 = a12 * (a12 * s23s - a23 * s12s);
  const float p3_inv = 1.0f / nz(p3);
  const float g = cubick(p2 * p3_inv, p1 * p3_inv, p0 * p3_inv);

  const float A00 = a23 * (1.0f - g);
  const float A01 = (a23 * b12) * 0.5f;
  const float A02 = (a23 * b13 * g) * (-0.5f);
  const float A11 = a23 - a12 + a13 * g;
  const float A12 = b23 * (a13 * g - a12) * 0.5f;
  const float A22 = g * (a13 - a23) - a12;
  const float eb = -A00 - A11 - A22;
  const float ec = -A01 * A01 - A02 * A02 - A12 * A12 + A00 * (A11 + A22) + A11 * A22;
  float e1, e2;
  bool unused;
  root2real(eb, ec, e1, e2, unused);
  const bool swap = fabsf(e1) < fabsf(e2);
  const float e1s = swap ? e2 : e1, e2s = swap ? e1 : e2;
  const float mx0011 = -A00 * A11;
  const float prec_0 = A01 * A12 - A02 * A11;
  const float prec_1 = A01 * A02 - A00 * A12;
  float V[2][3];  // the first two eigenvectors (columns 0 and 1)
  const float es[2] = {e1s, e2s};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float e = es[c];
    const float tmp = 1.0f / (e * (A00 + A11) + mx0011 - e * e + A01 * A01);
    const float w0 = -(e * A02 + prec_0) * tmp;
    const float w1 = -(e * A12 + prec_1) * tmp;
    const float rnorm = 1.0f / sqrtf(w0 * w0 + w1 * w1 + 1.0f);
    V[c][0] = w0 * rnorm;
    V[c][1] = w1 * rnorm;
    V[c][2] = rnorm;
  }
  const float vv = sqrt0(-e2s / nz(e1s));

  // the four depth triples: lambda_candidates(v), lambda_candidates(-v)
  float L[4][3];
  bool oks[4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float s = half == 0 ? vv : -vv;
    const float w2 = 1.0f / nz(s * V[1][0] - V[0][0]);
    const float w0 = (V[0][1] - s * V[1][1]) * w2;
    const float w1 = (V[0][2] - s * V[1][2]) * w2;
    const float a = 1.0f / nz((a13 - a12) * w1 * w1 - a12 * b13 * w1 - a12);
    const float b = (a13 * b12 * w1 - a12 * b13 * w0 - 2.0f * w0 * w1 * (a12 - a13)) * a;
    const float c = ((a13 - a12) * w0 * w0 + a13 * b12 * w0 + a13) * a;
    float taus[2];
    bool has_real;
    root2real(b, c, taus[0], taus[1], has_real);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float tau = taus[j];
      const float d = a23 / (tau * (b23 + tau) + 1.0f);
      const bool ok = has_real && (tau > 0.0f) && (d > 0.0f);
      const float l2 = sqrt0(d);
      const float l3 = tau * l2;
      const float l1 = w0 * l2 + w1 * l3;
      L[2 * half + j][0] = l1;
      L[2 * half + j][1] = l2;
      L[2 * half + j][2] = l3;
      oks[2 * half + j] = ok && (l1 >= 0.0f);
    }
  }

  // X's inverse: the rows c0, c1, c2 over its determinant
  const V3 c0 = cross(d13, d12xd13), c1 = cross(d12xd13, d12), c2 = cross(d12, d13);
  const float detX = nz(dot(d12, c0));
  const V3 Xi[3] = {{c0.x / detX, c0.y / detX, c0.z / detX},
                    {c1.x / detX, c1.y / detX, c1.z / detX},
                    {c2.x / detX, c2.y / detX, c2.z / detX}};

  float Rb[3][3] = {};
  V3 tb = {0.0f, 0.0f, 0.0f};
  float best = 0.0f;
  bool any_ok = false;
#pragma unroll
  for (int cnd = 0; cnd < 4; ++cnd) {
    float l1 = L[cnd][0], l2 = L[cnd][1], l3 = L[cnd][2];
    gn_refine(l1, l2, l3, oks[cnd], k);
    any_ok = any_ok || oks[cnd];
    const V3 ry1 = scale(y1, l1), ry2 = scale(y2, l2), ry3 = scale(y3, l3);
    const V3 yd1 = sub(ry1, ry2), yd2 = sub(ry1, ry3), yx = cross(yd1, yd2);
    const float Yc[3][3] = {{yd1.x, yd1.y, yd1.z}, {yd2.x, yd2.y, yd2.z}, {yx.x, yx.y, yx.z}};
    const float Xr[3][3] = {{Xi[0].x, Xi[0].y, Xi[0].z}, {Xi[1].x, Xi[1].y, Xi[1].z},
                            {Xi[2].x, Xi[2].y, Xi[2].z}};
    float R[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R[i][j] = dot({Yc[0][i], Yc[1][i], Yc[2][i]}, {Xr[0][j], Xr[1][j], Xr[2][j]});
    const V3 r0 = {R[0][0], R[0][1], R[0][2]}, r1 = {R[1][0], R[1][1], R[1][2]},
             r2 = {R[2][0], R[2][1], R[2][2]};
    const V3 t = sub(ry1, {dot(r0, X[0]), dot(r1, X[0]), dot(r2, X[0])});
    const V3 p4 = {dot(r0, X[3]) + t.x, dot(r1, X[3]) + t.y, dot(r2, X[3]) + t.z};
    const float z4 = nz(p4.z);
    const float du = cam.cx + cam.fx * p4.x / z4 - u[3];
    const float dv = cam.cy + cam.fy * p4.y / z4 - v[3];
    float reproj = du * du + dv * dv;
    reproj = (oks[cnd] && isfinite(reproj)) ? reproj : INFINITY;
    if (cnd == 0 || reproj < best) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Rb[i][j] = R[i][j];
      tb = t;
      best = reproj;
    }
  }
  bool valid = any_ok && isfinite(best);
  rvec = so3_log(Rb);
  t_out = tb;
  valid = valid && isfinite(rvec.x) && isfinite(rvec.y) && isfinite(rvec.z) && isfinite(tb.x) &&
          isfinite(tb.y) && isfinite(tb.z);
  return valid;
}

__global__ void __launch_bounds__(kBlock) p4p_kernel(
    const float* __restrict__ p2s, const float* __restrict__ p3s,
    const int64_t* __restrict__ order, const int64_t* __restrict__ idx,
    const int* __restrict__ n_valid, int B, int M, int S, Cam cam, float rvec_scale,
    float* __restrict__ rvec_out, float* __restrict__ t_out, bool* __restrict__ ok_out,
    float* __restrict__ pool, float* __restrict__ pool_valid) {
  const long long g = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (g >= (long long)B * S) return;
  const int b = (int)(g / S);
  float u[4], v[4];
  V3 X[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long long k = idx[g * 4 + i];
    k = k < 0 ? 0 : (k >= M ? M - 1 : k);
    const long long row = (long long)b * M + order[(long long)b * M + k];
    u[i] = p2s[row * 2];
    v[i] = p2s[row * 2 + 1];
    X[i] = {p3s[row * 3], p3s[row * 3 + 1], p3s[row * 3 + 2]};
  }
  V3 rv, t;
  const bool ok = p4p_one(u, v, X, cam, rv, t) && n_valid[b] >= 4;
  if (rvec_out != nullptr) {
    rvec_out[g * 3] = rv.x;
    rvec_out[g * 3 + 1] = rv.y;
    rvec_out[g * 3 + 2] = rv.z;
    t_out[g * 3] = t.x;
    t_out[g * 3 + 1] = t.y;
    t_out[g * 3 + 2] = t.z;
    ok_out[g] = ok;
  }
  if (pool != nullptr) {
    float* row = pool + g * 6;
    row[0] = rv.x * rvec_scale;
    row[1] = rv.y * rvec_scale;
    row[2] = rv.z * rvec_scale;
    row[3] = t.x;
    row[4] = t.y;
    row[5] = t.z;
    pool_valid[g] = ok ? 1.0f : 0.0f;
  }
}

}  // namespace

// Solve the B x S hypotheses; see the header for the arguments. Either the
// three (rvec, t, ok) outputs or the two pool outputs may be null, not
// both. All pointers are device pointers, contiguous. Returns a
// cudaError_t as int; does not synchronise.
extern "C" int p4p_launch(const float* p2s, const float* p3s, const int64_t* order,
                          const int64_t* idx, const int* n_valid, int B, int M, int S, float fx,
                          float fy, float cx, float cy, float rvec_scale, float* rvec, float* t,
                          bool* ok, float* pool, float* pool_valid, void* stream) {
  const bool triple = rvec != nullptr && t != nullptr && ok != nullptr;
  const bool pooled = pool != nullptr && pool_valid != nullptr;
  if (B < 0 || M < 1 || S < 0 || !(triple || pooled)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * S;
  if (n == 0) return (int)cudaSuccess;
  const Cam cam = {fx, fy, cx, cy};
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  p4p_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      p2s, p3s, order, idx, n_valid, B, M, S, cam, rvec_scale, triple ? rvec : nullptr,
      triple ? t : nullptr, triple ? ok : nullptr, pooled ? pool : nullptr,
      pooled ? pool_valid : nullptr);
  return (int)cudaGetLastError();
}
