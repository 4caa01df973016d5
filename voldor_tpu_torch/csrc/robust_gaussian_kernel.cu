// Truncated-Gaussian EM refit of the pose pool, a block per search, for
// sm_90a.
//
// Replaces voldor_tpu/ops/robust_gaussian.py:fit_robust_gaussian (:102),
// which has no Pallas kernel: XLA runs its lax.while_loop as one device
// program. The port's plain version
// (ops/robust_gaussian.py:fit_robust_gaussian_reference) takes ~150 small
// launches per iteration and reads the host every 8 to stop.
//
// Input: the scaled pool (B, P, 6) float32 and its weights valid (B, P)
// (a row with valid <= 0 counts as zeros and never as an inlier); the
// start mean0 (B, 6) and covar0 (B, 6, 6). Output: mean (B, 6), covar
// (B, 6, 6), density (B,), iterations (B,) int32, reliable (B,) bool.
// Per search, in the plain version's order, while not done and it <
// max_iters:
// 1. covar_r: Ledoit-Wolf shrinkage lam tr(C) / 6 I + (1 - lam) C from
//    the second iteration on (lam > 0); its blockwise Schur inverse with
//    the det > 0 gates (_chol_inverse, the identity where it fails);
// 2. the E-step: z^2 = (x - mean)^T inv (x - mean) per row, the inliers
//    z^2 < trunc^2 of the valid rows, wsum their count;
// 3. fail (the inverse failed or wsum is not finite) and converged
//    (|wsum - prev| / n_valid < epsilon) are tested before the M-step is
//    committed, as the JAX package and the plain version do; fail ends
//    unreliable with the last outputs, converged ends with the current
//    mean and covar_r;
// 4. else the M-step: the inliers' mean, then in a second pass over the
//    rows their covariance about it; both become the state and the output.
// The exit test reads the block's own sums: no host read.
//
// What bounds it on the card: the chain of an iteration's two block
// reductions and one thread's 6x6 inverse. An iteration's work is ~180
// FP32 operations per row (~1.5 M instructions at P = 8192, microseconds
// on one SM); the pool (196 KB a search) stays in L2. chip_smoke.py
// times a block sum on the card: the chain floor.
//
// Design: one block of pose::kThreads threads per search, the rows strided
// over the threads and the sums added by pose::block_sum's fixed tree
// (pose_reduce.cuh; ops/reduce.py:block_sum repeats the order), so two
// launches give the same bits. Thread 0 shrinks and inverts covar_r (a
// few hundred operations) into shared memory, which every thread then
// holds in registers for its rows; the E-step writes each row's inlier
// flag to the scratch `inliers` (B, P) bytes, which the M-step's second
// pass reads back from the same thread. The state lives in shared memory.
//
// Numerics: the plain version's operation order (its 3x3 products' terms,
// the Mahalanobis sums and the trace added in turn) with --fmad=false and
// IEEE division, as PyTorch's elementwise kernels round.

#include <cuda_runtime.h>

#include <cstdint>

#include "pose_reduce.cuh"

namespace {

constexpr int kD = 6;

struct Params {
  int P, max_iters;
  float trunc2;  // trunc_sigma^2 as float32
  float lam, oml;  // lam and 1 - lam, each rounded to float32
  float epsilon;
};

// ops/robust_gaussian.py:_det3 / _adj3 / _inv3 on a row-major 3x3
__device__ float det3(const float* M) {
  return M[0] * (M[4] * M[8] - M[5] * M[7]) - M[1] * (M[3] * M[8] - M[5] * M[6]) +
         M[2] * (M[3] * M[7] - M[4] * M[6]);
}

__device__ float inv3(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5], g = M[6], h = M[7],
              i = M[8];
  const float det = det3(M);
  const float safe = fabsf(det) < 1e-30f ? 1e-30f : det;
  const float adj[9] = {e * i - f * h, c * h - b * i, b * f - c * e,
                        f * g - d * i, a * i - c * g, c * d - a * f,
                        d * h - e * g, b * g - a * h, a * e - b * d};
  for (int k = 0; k < 9; ++k) out[k] = adj[k] / safe;
  return det;
}

// ops/robust_gaussian.py:_mm3: (i, j) = (X_i0 Y_0j + X_i1 Y_1j) + X_i2 Y_2j
__device__ void mm3(const float* X, const float* Y, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[i * 3 + j] = X[i * 3] * Y[j] + X[i * 3 + 1] * Y[3 + j] + X[i * 3 + 2] * Y[6 + j];
}

// ops/robust_gaussian.py:_chol_inverse of the row-major 6x6 C into inv;
// returns ok
__device__ bool chol_inverse(const float* C, float* inv) {
  float A[9], Bm[9], Cm[9], Dm[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[i * 3 + j] = C[i * 6 + j];
      Bm[i * 3 + j] = C[i * 6 + 3 + j];
      Cm[i * 3 + j] = C[(3 + i) * 6 + j];
      Dm[i * 3 + j] = C[(3 + i) * 6 + 3 + j];
    }
  float Ainv[9], CA[9], CAB[9], S[9], Sinv[9], AB[9], ABS[9], TL[9], nAB[9], nS[9], TR[9], BL[9];
  const float detA = inv3(A, Ainv);
  mm3(Cm, Ainv, CA);
  mm3(CA, Bm, CAB);
  for (int k = 0; k < 9; ++k) S[k] = Dm[k] - CAB[k];
  const float detS = inv3(S, Sinv);
  mm3(Ainv, Bm, AB);
  mm3(AB, Sinv, ABS);
  mm3(ABS, CA, TL);
  for (int k = 0; k < 9; ++k) {
    nAB[k] = -AB[k];
    nS[k] = -Sinv[k];
  }
  mm3(nAB, Sinv, TR);
  mm3(nS, CA, BL);
  bool finite = true;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      inv[i * 6 + j] = Ainv[i * 3 + j] + TL[i * 3 + j];
      inv[i * 6 + 3 + j] = TR[i * 3 + j];
      inv[(3 + i) * 6 + j] = BL[i * 3 + j];
      inv[(3 + i) * 6 + 3 + j] = Sinv[i * 3 + j];
    }
  for (int k = 0; k < 36; ++k) finite = finite && isfinite(inv[k]);
  const bool ok = detA > 0.0f && detS > 0.0f && finite;
  if (!ok)
    for (int k = 0; k < 36; ++k) inv[k] = (k % 7 == 0) ? 1.0f : 0.0f;
  return ok;
}

struct Shared {
  float tree_buf[sizeof(pose::TreeScratch<kD * kD>) / sizeof(float)];
  float mean[kD], covar[kD * kD], covar_r[kD * kD], inv[kD * kD];
  float out_mean[kD], out_covar[kD * kD], new_mean[kD];
  float n_valid, out_density, prev_wsum, wsum, wsum_safe;
  int it;
  bool ok, done, reliable, mstep;
};

template <int Q>
__device__ __forceinline__ pose::TreeScratch<Q>& tree(float* buf) {
  return *reinterpret_cast<pose::TreeScratch<Q>*>(buf);
}

__device__ __forceinline__ void load_row(const float* __restrict__ sp, const float* __restrict__ va,
                                         int p, float (&x)[kD], float& v) {
  v = va[p];
#pragma unroll
  for (int d = 0; d < kD; ++d) x[d] = v > 0.0f ? sp[(long long)p * kD + d] : 0.0f;
}

__global__ void __launch_bounds__(pose::kThreads) robust_gaussian_kernel(
    const float* __restrict__ space, const float* __restrict__ valid,
    const float* __restrict__ mean0, const float* __restrict__ covar0,
    float* __restrict__ mean_out, float* __restrict__ covar_out, float* __restrict__ density_out,
    int* __restrict__ iters_out, bool* __restrict__ reliable_out,
    uint8_t* __restrict__ inliers, Params prm) {
  __shared__ Shared sh;
  const int b = blockIdx.x, t = threadIdx.x;
  const float* sp = space + (long long)b * prm.P * kD;
  const float* va = valid + (long long)b * prm.P;
  uint8_t* inl = inliers + (long long)b * prm.P;

  {
    float acc[1] = {0.0f};
#pragma unroll 4
    for (int p = t; p < prm.P; p += pose::kThreads) acc[0] = p < pose::kThreads ? va[p] : acc[0] + va[p];
    pose::block_sum<1>(acc, tree<1>(sh.tree_buf));
  }
  if (t == 0) {
    const float s = tree<1>(sh.tree_buf).out[0];
    sh.n_valid = isnan(s) ? s : fmaxf(s, 1.0f);
    for (int k = 0; k < kD; ++k) sh.mean[k] = sh.out_mean[k] = mean0[(long long)b * kD + k];
    for (int k = 0; k < kD * kD; ++k)
      sh.covar[k] = sh.out_covar[k] = covar0[(long long)b * kD * kD + k];
    sh.out_density = 0.0f;
    sh.prev_wsum = 0.0f;
    sh.it = 0;
    sh.done = false;
    sh.reliable = true;
    sh.mstep = false;
  }
  __syncthreads();

  while (!sh.done && sh.it < prm.max_iters) {
    // 1. the shrunk covariance and its inverse
    if (t == 0) {
      if (sh.it > 0 && prm.lam > 0.0f) {
        float tr = sh.covar[0];
        for (int i = 1; i < kD; ++i) tr = tr + sh.covar[i * kD + i];
        const float lm = prm.lam * (tr / (float)kD);
        for (int i = 0; i < kD; ++i)
          for (int j = 0; j < kD; ++j)
            sh.covar_r[i * kD + j] = lm * (i == j ? 1.0f : 0.0f) + prm.oml * sh.covar[i * kD + j];
      } else {
        for (int k = 0; k < kD * kD; ++k) sh.covar_r[k] = sh.covar[k];
      }
      sh.ok = chol_inverse(sh.covar_r, sh.inv);
    }
    __syncthreads();

    // 2. the E-step, and the inliers' sums for the new mean
    float inv[kD * kD], m[kD];
#pragma unroll
    for (int k = 0; k < kD * kD; ++k) inv[k] = sh.inv[k];
#pragma unroll
    for (int d = 0; d < kD; ++d) m[d] = sh.mean[d];
    float acc[kD + 1];
#pragma unroll
    for (int q = 0; q <= kD; ++q) acc[q] = 0.0f;
#pragma unroll 4
    for (int p = t; p < prm.P; p += pose::kThreads) {
      float x[kD], v, diff[kD];
      load_row(sp, va, p, x, v);
#pragma unroll
      for (int d = 0; d < kD; ++d) diff[d] = x[d] - m[d];
      float z2 = 0.0f;
#pragma unroll
      for (int i = 0; i < kD; ++i) {
        float ti = inv[i * kD] * diff[0];
#pragma unroll
        for (int j = 1; j < kD; ++j) ti = ti + inv[i * kD + j] * diff[j];
        z2 = i == 0 ? ti * diff[0] : z2 + ti * diff[i];
      }
      const bool in = z2 < prm.trunc2 && v > 0.0f;
      inl[p] = in ? 1 : 0;
      const float w = in ? 1.0f : 0.0f;
      const bool first = p < pose::kThreads;
      acc[0] = first ? w : acc[0] + w;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[1 + d] = first ? x[d] * w : acc[1 + d] + x[d] * w;
    }
    pose::TreeScratch<kD + 1>& s1 = tree<kD + 1>(sh.tree_buf);
    pose::block_sum<kD + 1>(acc, s1);

    // 3. the exit tests, before the M-step is committed
    if (t == 0) {
      const float wsum = s1.out[0];
      const bool fail = !sh.ok || !isfinite(wsum);
      const bool converged = (fabsf(wsum - sh.prev_wsum) / sh.n_valid < prm.epsilon) && !fail;
      sh.wsum = wsum;
      if (fail) {
        sh.reliable = false;
        sh.done = true;
      } else if (converged) {
        for (int k = 0; k < kD; ++k) sh.out_mean[k] = sh.mean[k];
        for (int k = 0; k < kD * kD; ++k) sh.out_covar[k] = sh.covar_r[k];
        sh.out_density = wsum / sh.n_valid;
        sh.reliable = true;
        sh.done = true;
      } else {
        const float safe = fmaxf(wsum, 1.0f);
        sh.wsum_safe = safe;
        for (int d = 0; d < kD; ++d) sh.new_mean[d] = s1.out[1 + d] / safe;
        sh.mstep = true;
      }
      sh.it = sh.it + 1;
    }
    __syncthreads();

    // 4. the M-step: the inliers' covariance about the new mean
    if (sh.mstep) {
      float nm[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) nm[d] = sh.new_mean[d];
      float cacc[kD * kD];
#pragma unroll
      for (int q = 0; q < kD * kD; ++q) cacc[q] = 0.0f;
#pragma unroll 4
      for (int p = t; p < prm.P; p += pose::kThreads) {
        float x[kD], v;
        load_row(sp, va, p, x, v);
        const float w = inl[p] ? 1.0f : 0.0f;
        float dn[kD], a[kD];
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          dn[d] = x[d] - nm[d];
          a[d] = dn[d] * w;
        }
        const bool first = p < pose::kThreads;
#pragma unroll
        for (int i = 0; i < kD; ++i)
#pragma unroll
          for (int j = 0; j < kD; ++j)
            cacc[i * kD + j] = first ? a[i] * dn[j] : cacc[i * kD + j] + a[i] * dn[j];
      }
      pose::TreeScratch<kD * kD>& s2 = tree<kD * kD>(sh.tree_buf);
      pose::block_sum<kD * kD>(cacc, s2);
      if (t == 0) {
        for (int k = 0; k < kD * kD; ++k) {
          const float c = s2.out[k] / sh.wsum_safe;
          sh.covar[k] = c;
          sh.out_covar[k] = c;
        }
        for (int d = 0; d < kD; ++d) sh.mean[d] = sh.out_mean[d] = sh.new_mean[d];
        sh.out_density = sh.wsum / sh.n_valid;
        sh.prev_wsum = sh.wsum;
        sh.reliable = true;
        sh.mstep = false;
      }
      __syncthreads();
    }
  }
  if (t == 0) {
    for (int k = 0; k < kD; ++k) mean_out[(long long)b * kD + k] = sh.out_mean[k];
    for (int k = 0; k < kD * kD; ++k) covar_out[(long long)b * kD * kD + k] = sh.out_covar[k];
    density_out[b] = sh.out_density;
    iters_out[b] = sh.it;
    reliable_out[b] = sh.reliable;
  }
}

}  // namespace

// Fit B searches; see the header for the arguments. threads must be
// pose::kThreads (ops/reduce.py:THREADS); inliers is (B, P) bytes of
// scratch. All pointers are device pointers, contiguous. Returns a
// cudaError_t as int; does not synchronise.
extern "C" int robust_gaussian_launch(const float* space, const float* valid, const float* mean0,
                                      const float* covar0, float* mean, float* covar,
                                      float* density, int* iters, bool* reliable,
                                      uint8_t* inliers, int B, int P, int max_iters, float trunc2,
                                      float lam, float oml, float epsilon, int threads,
                                      void* stream) {
  if (B < 0 || P < 1 || max_iters < 0 || threads != pose::kThreads)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Params prm = {P, max_iters, trunc2, lam, oml, epsilon};
  robust_gaussian_kernel<<<B, pose::kThreads, 0, (cudaStream_t)stream>>>(
      space, valid, mean0, covar0, mean, covar, density, iters, reliable, inliers, prm);
  return (int)cudaGetLastError();
}
