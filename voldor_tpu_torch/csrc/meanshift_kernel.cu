// Gaussian-kernel meanshift mode seeking, a block per search, for sm_90a.
//
// Replaces voldor_tpu/ops/meanshift.py:meanshift (:38), which has no
// Pallas kernel: XLA runs its two lax.while_loops (the init trials, then
// the mean-shift steps) as one device program. The port's plain version
// (ops/meanshift.py:meanshift_reference) takes ~50 small launches per step
// and reads the host every 8 steps to stop.
//
// Input: the pool (B, P, D) float32, D <= 8, and its weights valid (B, P)
// (0 / 1; a row with valid <= 0 counts as zeros, as the plain version
// scrubs it); the external start init (B, D) and its switch use_init (B,)
// bool; the T <= 32 init-trial rows trials (B, T) int64. Output: mean
// (B, D), confidence (B,), iterations (B,) int32, the valid count (B,)
// int32. Per search, in the plain version's order:
// 1. n_valid = max(sum of valid, 1);
// 2. the T trial confidences, sum_p exp(-|x_p - c_t|^2 / (2 var)) v_p;
// 3. the replay of the early stop: trial t ran iff no earlier trial's
//    running best exceeded good * n_valid; the first best of those that
//    ran is the start, unless use_init;
// 4. while it < max_iters and disp >= epsilon: the weights at the mean,
//    wsum = max(sum w, 1e-30), the new mean sum_p w_p x_p / wsum, disp its
//    distance from the old one, confidence wsum / n_valid.
// The loop's test reads the block's own sums: no host read.
//
// What bounds it on the card: the chain of block reductions, one per
// step. A step's work is ~35 FP32 operations and an exp per row (~1.4 M
// instructions at P = 8192: ~0.04 us at the FP32 peak over the card, ~3 us
// on one SM); its bytes (the pool, 196 KB a search at D = 6) stay in L2
// after the first step. A search's steps are sequential and each ends in a
// barrier-separated tree over the block, so a step costs the latency of
// its block sum and one thread's update (chip_smoke.py times one block
// sum on the card: the chain floor).
//
// Design: one block of pose::kThreads threads per search; thread t takes
// rows t, t + kThreads, ... and keeps its partial sums in registers (8
// trials' sums a pass over the pool in step 2, the weight and the D
// weighted coordinates in step 4); pose::block_sum adds them in a fixed tree (pose_reduce.cuh),
// so two launches give the same bits and ops/reduce.py:block_sum repeats
// the order in plain torch. Thread 0 does the replay and each step's
// update; the state (mean, disp, it) lives in shared memory. The pool is
// read from global memory on every step (the L2 holds it); staging it in
// shared memory would cut a step's loads but not its reduction chain.
//
// Numerics: the plain version's operation order with --fmad=false and
// IEEE division, expf and sqrtf, as PyTorch's elementwise kernels round.

#include <cuda_runtime.h>

#include <cstdint>

#include "pose_reduce.cuh"

namespace {

constexpr int kMaxTrials = 32;  // ops/meanshift.py:MAX_TRIALS
constexpr int kTrialGroup = 8;  // trials scored per pass over the pool
constexpr int kMaxQ = 9;  // the most sums of one block_sum: D + 1 at D = 8

struct Params {
  int P, T, max_iters;
  float kv2;  // 2 kernel_var, as float32
  float epsilon;
  float good;  // good_init_confidence
};

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ sp, const float* __restrict__ va,
                                         int p, float (&x)[D], float& v) {
  v = va[p];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = v > 0.0f ? sp[(long long)p * D + d] : 0.0f;
}

// exp(-|x - m|^2 / kv2) v, the squares added in turn over D
template <int D>
__device__ __forceinline__ float weight(const float (&x)[D], const float* m, float v, float kv2) {
  float d2 = (x[0] - m[0]) * (x[0] - m[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) d2 = d2 + (x[d] - m[d]) * (x[d] - m[d]);
  return expf(-d2 / kv2) * v;
}

// block_sum's scratch for Q values, in a buffer sized for the largest Q
template <int Q>
__device__ __forceinline__ pose::TreeScratch<Q>& tree(float* buf) {
  return *reinterpret_cast<pose::TreeScratch<Q>*>(buf);
}

template <int D>
struct Shared {
  float tree_buf[sizeof(pose::TreeScratch<kMaxQ>) / sizeof(float)];
  float cand[kMaxTrials][D];
  float confs[kMaxTrials];
  float mean[D];
  float n_valid;
  float disp;
  int it;
};

template <int D>
__global__ void __launch_bounds__(pose::kThreads) meanshift_kernel(
    const float* __restrict__ space, const float* __restrict__ valid,
    const float* __restrict__ init, const bool* __restrict__ use_init,
    const int64_t* __restrict__ trials, float* __restrict__ mean_out,
    float* __restrict__ conf_out, int* __restrict__ iters_out, int* __restrict__ n_valid_out,
    Params prm) {
  __shared__ Shared<D> sh;
  const int b = blockIdx.x, t = threadIdx.x;
  const float* sp = space + (long long)b * prm.P * D;
  const float* va = valid + (long long)b * prm.P;
  const int T = prm.T;

  // 1. the valid count (exact: a sum of 0 / 1 below 2^24)
  {
    float acc[1] = {0.0f};
#pragma unroll 4
    for (int p = t; p < prm.P; p += pose::kThreads) acc[0] = p < pose::kThreads ? va[p] : acc[0] + va[p];
    pose::block_sum<1>(acc, tree<1>(sh.tree_buf));
    if (t == 0) {
      const float s = tree<1>(sh.tree_buf).out[0];
      sh.n_valid = s < 1.0f ? 1.0f : s;
      n_valid_out[b] = (int)s;
    }
  }
  // the trial candidates, scrubbed rows of the pool
  for (int i = t; i < T * D; i += pose::kThreads) {
    const int k = i / D, d = i % D;
    long long row = trials[(long long)b * T + k];
    row = row < 0 ? 0 : (row >= prm.P ? prm.P - 1 : row);
    sh.cand[k][d] = va[row] > 0.0f ? sp[row * D + d] : 0.0f;
  }
  __syncthreads();

  // 2. the trial confidences, kTrialGroup trials a pass over the pool
  for (int k0 = 0; k0 < T; k0 += kTrialGroup) {
    float acc[kTrialGroup];
#pragma unroll
    for (int k = 0; k < kTrialGroup; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int p = t; p < prm.P; p += pose::kThreads) {
      float x[D], v;
      load_row<D>(sp, va, p, x, v);
#pragma unroll
      for (int k = 0; k < kTrialGroup; ++k) {
        if (k0 + k < T) {
          const float w = weight<D>(x, sh.cand[k0 + k], v, prm.kv2);
          acc[k] = p < pose::kThreads ? w : acc[k] + w;
        }
      }
    }
    pose::TreeScratch<kTrialGroup>& sums = tree<kTrialGroup>(sh.tree_buf);
    pose::block_sum<kTrialGroup>(acc, sums);
    if (t == 0)
      for (int k = 0; k < kTrialGroup && k0 + k < T; ++k) sh.confs[k0 + k] = sums.out[k];
  }
  __syncthreads();
  // 3. the replay of the early stop, and the start
  if (t == 0) {
    const float* confs = sh.confs;
    const float bar = prm.good * sh.n_valid;
    float best_so_far = confs[0], best = confs[0];
    int pick = 0;
    bool ran = true;
    for (int k = 1; k < T; ++k) {
      ran = ran && !(best_so_far > bar);  // trial k runs iff trial k - 1's running best was not over
      const float c = confs[k];
      best_so_far = c > best_so_far ? c : best_so_far;
      if (ran && c > best) {
        best = c;
        pick = k;
      }
    }
    const bool ext = use_init[b];
#pragma unroll
    for (int d = 0; d < D; ++d) sh.mean[d] = ext ? init[(long long)b * D + d] : sh.cand[pick][d];
    sh.disp = INFINITY;
    sh.it = 0;
  }
  __syncthreads();

  // 4. the mean-shift steps
  float conf = 0.0f;
  while (sh.it < prm.max_iters && sh.disp >= prm.epsilon) {
    float m[D];
#pragma unroll
    for (int d = 0; d < D; ++d) m[d] = sh.mean[d];
    float acc[D + 1];
#pragma unroll
    for (int q = 0; q <= D; ++q) acc[q] = 0.0f;
#pragma unroll 4
    for (int p = t; p < prm.P; p += pose::kThreads) {
      float x[D], v;
      load_row<D>(sp, va, p, x, v);
      const float w = weight<D>(x, m, v, prm.kv2);
      const bool first = p < pose::kThreads;
      acc[0] = first ? w : acc[0] + w;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[1 + d] = first ? x[d] * w : acc[1 + d] + x[d] * w;
    }
    pose::TreeScratch<D + 1>& sums = tree<D + 1>(sh.tree_buf);
    pose::block_sum<D + 1>(acc, sums);
    if (t == 0) {
      const float s0 = sums.out[0];
      const float wsum = isnan(s0) ? s0 : fmaxf(s0, 1e-30f);
      float nm[D];
#pragma unroll
      for (int d = 0; d < D; ++d) nm[d] = sums.out[1 + d] / wsum;
      float d2 = (m[0] - nm[0]) * (m[0] - nm[0]);
#pragma unroll
      for (int d = 1; d < D; ++d) d2 = d2 + (m[d] - nm[d]) * (m[d] - nm[d]);
#pragma unroll
      for (int d = 0; d < D; ++d) sh.mean[d] = nm[d];
      sh.disp = sqrtf(d2);
      conf = wsum / sh.n_valid;
      sh.it = sh.it + 1;
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) mean_out[(long long)b * D + d] = sh.mean[d];
    conf_out[b] = conf;
    iters_out[b] = sh.it;
  }
}

// One block doing n dependent block sums of Q values (Q = 7: a
// meanshift step's at D = 6 and the robust-Gaussian E-step's; Q = 8: a
// pass of meanshift trials; Q = 36: the robust-Gaussian covariance's):
// the latency of a step's reduction, timed by chip_smoke.py.
template <int Q>
__global__ void __launch_bounds__(pose::kThreads) pose_reduce_probe_kernel(float* out, int n) {
  __shared__ pose::TreeScratch<Q> tree;
  float seed = (float)threadIdx.x * 1e-3f;
  for (int i = 0; i < n; ++i) {
    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = seed + (float)q;
    pose::block_sum<Q>(acc, tree);
    seed = tree.out[i % Q] * 1e-9f;
  }
  if (threadIdx.x == 0) out[0] = seed;
}

template <int D>
cudaError_t launch(const float* space, const float* valid, const float* init, const bool* use_init,
                   const int64_t* trials, float* mean, float* conf, int* iters, int* n_valid, int B,
                   const Params& prm, cudaStream_t s) {
  meanshift_kernel<D><<<B, pose::kThreads, 0, s>>>(space, valid, init, use_init, trials, mean,
                                                   conf, iters, n_valid, prm);
  return cudaGetLastError();
}

}  // namespace

// Run B searches; see the header for the arguments. threads must be
// pose::kThreads (the plain version's lane count, ops/reduce.py:THREADS).
// All pointers are device pointers, contiguous. Returns a cudaError_t as
// int; does not synchronise.
extern "C" int meanshift_launch(const float* space, const float* valid, const float* init,
                                const bool* use_init, const int64_t* trials, float* mean,
                                float* conf, int* iters, int* n_valid, int B, int P, int D, int T,
                                int max_iters, float kv2, float epsilon, float good, int threads,
                                void* stream) {
  if (B < 0 || P < 1 || T < 1 || T > kMaxTrials || max_iters < 0 || threads != pose::kThreads)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Params prm = {P, T, max_iters, kv2, epsilon, good};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 1: return (int)launch<1>(space, valid, init, use_init, trials, mean, conf, iters, n_valid, B, prm, s);
    case 2: return (int)launch<2>(space, valid, init, use_init, trials, mean, conf, iters, n_valid, B, prm, s);
    case 3: return (int)launch<3>(space, valid, init, use_init, trials, mean, conf, iters, n_valid, B, prm, s);
    case 4: return (int)launch<4>(space, valid, init, use_init, trials, mean, conf, iters, n_valid, B, prm, s);
    case 5: return (int)launch<5>(space, valid, init, use_init, trials, mean, conf, iters, n_valid, B, prm, s);
    case 6: return (int)launch<6>(space, valid, init, use_init, trials, mean, conf, iters, n_valid, B, prm, s);
    case 7: return (int)launch<7>(space, valid, init, use_init, trials, mean, conf, iters, n_valid, B, prm, s);
    case 8: return (int)launch<8>(space, valid, init, use_init, trials, mean, conf, iters, n_valid, B, prm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// pose_reduce_probe_kernel<q> (q = 7, 8 or 36) on one block, n block
// sums; out: 1 float on the device.
extern "C" int pose_reduce_probe_launch(float* out, int n, int q, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q == 7)
    pose_reduce_probe_kernel<7><<<1, pose::kThreads, 0, s>>>(out, n);
  else if (q == 8)
    pose_reduce_probe_kernel<8><<<1, pose::kThreads, 0, s>>>(out, n);
  else if (q == 36)
    pose_reduce_probe_kernel<36><<<1, pose::kThreads, 0, s>>>(out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
