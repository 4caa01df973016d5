// Frame alignment's linearisation, one launch a call, for sm_90a: the
// phase start, the covariances' Hrr blocks and (scores mode) the scores.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel here:
// voldor_tpu/falign/residual.py:207 (pair_residual_and_grads, the residual
// and its analytic Jacobian), falign/solver.py:67 (_pair_res_and_jacs, the
// dim mask) and :237 (_joint_normal_eq, the normal equations); in scores
// mode, :510 (align_scores). The port's plain versions are
// falign/residual.py:pair_normal_blocks and pair_score_sums. The LM
// iterations linearise inside the chunk kernel of falign_lm.cu, with the
// same device functions (falign_common.cuh).
//
// Per pair evaluation b (lane l = b / np, pair p = b % np; ref frame row
// lanes[l] * N + pairs[p][0], tar row lanes[l] * N + pairs[p][1]) and per
// pixel of the strided ref grid: the sqrt-Cauchy residual r and its
// gradient w.r.t. the pair's 9 + 9 parameters (masked by the dim mask),
// never written to memory; reduced over the grid into the upper triangle of
// the 19 x 19 Gram matrix of [r, Jr, Jt]: 1/2 sum r^2, Jr^T r, Jt^T r,
// Jr^T Jr, Jr^T Jt, Jt^T Jt (190 sums), written to out[b]. Scores mode:
// over the unweighted residual of pair_residual_map, the visible pixels and
// the sum over them of 1 - min(r^2, bound) / bound (2 sums).
//
// What bounds it on the card: latency, not bytes or operations. A 4-pair
// batch at stride 4 on 185 x 613 is 8 pair evaluations x 7238 pixels,
// ~58k residuals of ~500 FP32 operations and 190 products each, and ~5 MB
// of taps, mostly in L2: microseconds of work at the card's rates. What
// costs time is the chain: a pixel's evaluation (two dependent gathers and
// ~600 dependent instructions), the Gram sums and the reduction across
// blocks.
//
// Design: one thread-block cluster per pair evaluation (C blocks of 512
// threads), the design of falign_common.cuh: L * np clusters. C = 16 where
// the card holds all of a launch's clusters at once, else 8 (the wrapper
// decides from cudaOccupancyMaxActiveClusters: an H100 holds 7 clusters of
// 16 of the gradient mode, so a 4-pair batch's 8 pair evaluations take
// clusters of 8 and one wave, 64 SMs; scores mode holds 14 and takes 16).
// Block 0's thread 0 computes the pair's constants once a launch (not once
// a block); the blocks share them through distributed shared memory,
// evaluate their tiles, sum the Gram blocks with all warps (two levels,
// fixed order) and block 0 adds the blocks' sums in rank order and writes
// the pair's 190 (or 2) sums. No separate reduce pass, no float atomics:
// two launches on the same inputs are bitwise equal.
//
// Not used, and why: the tensor cores (the Gram sums must stay float32
// within 1e-4 of the plain version's; TF32 keeps about three digits); TMA
// (the tar-side taps are data-dependent gathers, which TMA does not do).
//
// Numerics: the plain versions' operation order per pixel (torch evaluates
// each expression left to right, one rounding per operation), IEEE
// division and square root, built with --fmad=false and without fast math.
// Sums are taken in another order than torch's, so the blocks agree with
// the plain version's to rounding, not bitwise.

#include "falign_common.cuh"

namespace falign {

struct OneShot {
  Maps m;
  const float* params;     // (L, N, 9)
  const long long* lanes;  // (L,)
  const long long* pairs;  // (np, 2)
  const float* dim_mask;   // (N, 9)
  int N, np;
  float* out;  // (L * np, width)
};

template <bool kScoreMode>
__global__ void __launch_bounds__(kThreads, 1) falign_linearize_kernel(OneShot a) {
  constexpr int kW = kScoreMode ? kScores : kGram;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = (int)blockIdx.x / C, l = b / a.np, p = b - l * a.np;
  extern __shared__ float4 smem4[];
  float* Vt = reinterpret_cast<float*>(smem4);
  float* part = Vt + kThreads * kVRow;
  PairConsts* cst = reinterpret_cast<PairConsts*>(part + round4(kW));
  if (rank == 0 && tid_x() == 0) {
    const int fr = (int)a.pairs[2 * p], ft = (int)a.pairs[2 * p + 1];
    const long long base = a.lanes[l] * a.N;
    make_consts(a.params + ((long long)l * a.N + fr) * 9, a.params + ((long long)l * a.N + ft) * 9,
                a.dim_mask + fr * 9, a.dim_mask + ft * 9, base + fr, base + ft, cst[0]);
  }
  cluster.sync();
  if (rank != 0) fetch_consts(cst, 1);
  cta_linearize<kScoreMode>(a.m, cst, 1, rank, C, Vt, part);
  cluster.sync();
  if (rank == 0) reduce_ranks(part, kW, C, a.out + (long long)b * kW);
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

}  // namespace falign

using namespace falign;

extern "C" int falign_linearize_max_clusters(int scores, int cluster, int* out) {
  const size_t bytes = 4 * (size_t)lin_smem_floats(1, scores ? kScores : kGram);
  if (scores) return max_clusters(falign_linearize_kernel<true>, cluster, bytes, out);
  return max_clusters(falign_linearize_kernel<false>, cluster, bytes, out);
}

extern "C" int falign_linearize_launch(const float* packed, const float* weights, int F, int h,
                                       int w, const float* params, const long long* lanes,
                                       const long long* pairs, const float* dim_mask, int L, int N,
                                       int np, int stride, int use_photo, int scores, float fx,
                                       float fy, float cx, float cy, float vbf, float crw,
                                       float bound, float* out, int cluster, void* stream) {
  if (F < 1 || h < 2 || w < 2 || L < 1 || N < 1 || np < 1 || stride < 1)
    return (int)cudaErrorInvalidValue;
  OneShot a{Maps{packed, weights, h, w, stride, use_photo, fx, fy, cx, cy, vbf, crw, bound},
            params, lanes, pairs, dim_mask, N, np, out};
  const size_t bytes = 4 * (size_t)lin_smem_floats(1, scores ? kScores : kGram);
  cudaStream_t s = (cudaStream_t)stream;
  if (scores) return launch_cluster(falign_linearize_kernel<true>, a, L * np, cluster, bytes, s);
  return launch_cluster(falign_linearize_kernel<false>, a, L * np, cluster, bytes, s);
}
