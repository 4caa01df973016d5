// Fused multi-frame Fisk cost of K candidate depth maps, with the
// normalisation and the per-pixel accept of a proposal batch, for sm_90a.
//
// Replaces the Pallas TPU kernel voldor_tpu/ops/pallas_cost.py:_cost_kernel
// (both arms: the flow arm over the N window frames and the fused
// depth-prior arm over D prior cameras), its normalize_cost (:225), and the
// accept of voldor_tpu/vo/em.py:optimize_depth_batched (:596-610).
//
// Two modes, one thread per pixel:
// * score: writes the normalised (K, h, w) cost of every candidate;
// * accept: masks the candidates (uint8 (K, h, w), or none = all kept),
//   takes the first argmin over K as jnp.min / jnp.argmin do (ties go to
//   the lowest k, a NaN among the kept costs wins), and where that cost is
//   below the pixel's current cost writes the candidate's depth and cost
//   over the current ones, in place. Nothing else is written.
// The planes may be a band of the image's rows, y0 the image row of their
// first row (the multi-card solve launches one per band,
// parallel/mesh.py); the whole image is the band at y0 = 0.
//
// What bounds it on the card: the arithmetic. Per pixel the accept reads
// K candidates, depth and cost, 6 planes per active window frame (track
// x/y, observed flow x/y, rigidness, in-bounds byte), 2 per prior and the
// masks, and writes 8 bytes (~180 B at K=10, N=5, D=2: ~6 us at 3.35 TB/s).
// Each of the K * (N + D) Fisk terms needs two powf, a logf, a sqrtf and
// seven divisions: even counted at one special-function op each, the
// operations, not the bytes, set the floor (~26 us at K=10 on an H100;
// chip_smoke.py counts them from the plain formula). The IEEE versions
// are longer sequences.
//
// Design: consecutive threads on consecutive pixels (coalesced). The
// thread keeps its K candidates, their K chained 3-D points and K
// accumulator pairs in registers, so each input plane is read once per
// pixel for all K (the TPU kernel re-streamed every plane per candidate),
// and the candidate-independent half of every Fisk term is computed once
// per pixel and frame. The flow arm runs first; the prior arm then rebuilds
// each candidate's frame-0 point from its depth, so the chained points are
// dead by then and fewer registers are live at once. The (N + D) x 12 pose
// rows live on the device and each block reads them into shared memory
// once: the caller never copies a pose to the host.
//
// Numerics: IEEE logf/expf/powf/sqrtf and divisions, built with
// --fmad=false and without fast math, in the JAX package's operation order
// (voldor_tpu/ops/fisk.py), so the kernel agrees with the plain PyTorch
// version to float rounding of the math library.

#include <cuda_runtime.h>
#include <stdint.h>

#define COST_MAX_N 8
#define COST_MAX_D 4
#define COST_MAX_K 16

struct CostParams {
  float fx, fy, cx, cy;
  float lam, arf, bf, omega;
  int n_frames;  // N planes per input stack
  int active_n;  // frames f < active_n contribute
  int n_priors;  // D
  int k;         // candidates
  int h, w;
  int y0;        // image row of the planes' first row (a row band's offset)
};

namespace {

constexpr int kThreads = 128;
constexpr float kEstRf = 0.5f;
constexpr float kFiskA1 = 0.01f;
constexpr float kFiskA2 = 0.09f;
constexpr float kFiskB1 = 1.0f;
constexpr float kFiskB2 = -0.0022f;
constexpr float kMinObsFmag = 2.0f;
constexpr float kMaxObsFmag = 100.0f;
constexpr float kZde = 1.1920929e-07f;

__device__ __forceinline__ float clamp_fmag(float fmag) {
  return fminf(fmaxf(fmag * kEstRf, kMinObsFmag), kMaxObsFmag);
}

// fisk.fisk_pdf: u = max(x*EST_RF, eps)^2 / scale,
// pdf = c * u^-c * (1/u) * (1 + u^-c)^-2 / scale
__device__ __forceinline__ float fisk_pdf(float x, float c, float scale) {
  x = fmaxf(x * kEstRf, kZde);
  const float u = (x * x) / scale;
  const float u_negc = powf(u, -c);
  return (c * u_negc * (1.0f / u) * powf(1.0f + u_negc, -2.0f)) / scale;
}

struct FiskModel {  // the candidate-independent half of one Fisk term
  float c, s, p_out;
};

__device__ __forceinline__ FiskModel fisk_model(float fmag, float outlier_x) {
  FiskModel m;
  const float cf = clamp_fmag(fmag);
  m.c = kFiskB1 + kFiskB2 * cf;
  m.s = kFiskA1 * expf(kFiskA2 * cf);
  m.p_out = fisk_pdf(outlier_x, m.c, m.s);
  return m;
}

struct CostInputs {
  const float* poses;  // (N + D, 12) rows [R row-major (9), t (3)]: window, then priors
  const float* cands;  // (K, h, w)
  const float* tx;     // (N, h, w) track x/y, observed flow x/y, rigidness
  const float* ty;
  const float* obx;
  const float* oby;
  const float* rig;
  const uint8_t* inb;  // (N, h, w)
  const float* ptgt;   // (D, h, w) prior target and weight
  const float* pwgt;
  const uint8_t* masks;  // accept: (K, h, w) or null (every candidate kept)
  float* depth;          // accept: (h, w), read and written
  float* cost;           // accept: (h, w), read and written
  float* out;            // score: (K, h, w) normalised costs
};

// Registers (ptxas -v, sm_90a, --fmad=false): without bounds 39 / 71 / 121
// / 168 for KT = 1 / 4 / 10 / 16; with the bounds below 48 / 84 / 121 /
// 157, no spills, 576 B of shared memory. At KT = 10 that is 4 blocks of
// 128 threads per SM (16 warps); the bounds hold that residency (3 blocks
// at KT = 16) so that later growth spills instead of silently halving it.
// Forcing 7 blocks, one wave for the 886 blocks of a 185 x 613 launch,
// would cap KT = 10 at 72 registers, below its ~6 * KT live candidate
// state.
template <int KT, bool ACCEPT>
__global__ void __launch_bounds__(kThreads, KT > 10 ? 3 : 4)
cost_kernel(const CostInputs in, const CostParams prm) {
  __shared__ float sposes[(COST_MAX_N + COST_MAX_D) * 12];
  for (int i = threadIdx.x; i < (prm.n_frames + prm.n_priors) * 12; i += blockDim.x)
    sposes[i] = in.poses[i];
  __syncthreads();

  const int hw = prm.h * prm.w;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const int y = pix / prm.w;
  const int x = pix - y * prm.w;
  const int K = prm.k;

  // backprojection of every candidate (em._backproject)
  const float bx = ((float)x - prm.cx) / prm.fx;
  const float by = ((float)(y + prm.y0) - prm.cy) / prm.fy;
  float d[KT], ox[KT], oy[KT], oz[KT], cost[KT], wsum[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    d[k] = (k < K) ? in.cands[k * hw + pix] : 1.0f;
    ox[k] = bx * d[k];
    oy[k] = by * d[k];
    oz[k] = d[k];
    cost[k] = 0.0f;
    wsum[k] = 0.0f;
  }

  // flow arm (em.compute_cost_map_tracked): chain through the window
  const int n_use = min(prm.n_frames, prm.active_n);
  for (int f = 0; f < n_use; ++f) {
    const int off = f * hw + pix;
    const float* P = sposes + f * 12;
    const bool in_b = in.inb[off] != 0;
    const float tfx = in.tx[off], tfy = in.ty[off];
    const float ofx = in.obx[off], ofy = in.oby[off];
    const float rg = in.rig[off];
    // fisk.rigidness_xy, candidate-independent part
    const float obs_fmag = sqrtf(ofx * ofx + ofy * ofy) / prm.arf;
    const FiskModel m = fisk_model(obs_fmag, prm.lam * obs_fmag);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (k >= K) break;
      const float nx = P[0] * ox[k] + P[1] * oy[k] + P[2] * oz[k] + P[9];
      const float ny = P[3] * ox[k] + P[4] * oy[k] + P[5] * oz[k] + P[10];
      const float nz = P[6] * ox[k] + P[7] * oy[k] + P[8] * oz[k] + P[11];
      if (in_b && nz > 0.0f) {
        const float snz = (fabsf(nz) < 1e-12f) ? 1e-12f : nz;
        const float px2 = (prm.fx * nx + prm.cx * snz) / snz;
        const float py2 = (prm.fy * ny + prm.cy * snz) / snz;
        const float ddx = (px2 - tfx) - ofx;
        const float ddy = (py2 - tfy) - ofy;
        const float diff_fmag = sqrtf(ddx * ddx + ddy * ddy) / prm.arf;
        const float p_in = fisk_pdf(diff_fmag, m.c, m.s);
        const float r = p_in / (p_in + m.p_out);
        cost[k] = cost[k] + (-rg) * logf(fmaxf(r, 1e-30f));
        wsum[k] = wsum[k] + rg;
      }
      ox[k] = nx;
      oy[k] = ny;
      oz[k] = nz;
    }
  }

  // fused depth-prior arm (em.prior_cost_sums): the frame-0 point's depth
  // in each prior camera against the pre-sampled target, summed apart from
  // the flow arm and added to it at the end, as the plain version does
  if (prm.n_priors > 0) {
    float pcost[KT], pwsum[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      pcost[k] = 0.0f;
      pwsum[k] = 0.0f;
    }
    for (int dd = 0; dd < prm.n_priors; ++dd) {
      const float tgt = in.ptgt[dd * hw + pix];
      const float wgt = in.pwgt[dd * hw + pix];
      if (!(tgt > 0.0f && wgt > 0.0f)) continue;
      const float* P = sposes + (prm.n_frames + dd) * 12;
      // fisk.depth_rigidness(d1=max(nz,1e-12), d2=max(tgt,1e-12), bf, omega, arf)
      const float disp2 = (prm.bf / fmaxf(tgt, 1e-12f)) / prm.arf;
      const FiskModel m = fisk_model(disp2, prm.omega * disp2);
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k >= K) break;
        const float nz = P[6] * (bx * d[k]) + P[7] * (by * d[k]) + P[8] * d[k] + P[11];
        if (!(nz > 0.0f)) continue;
        const float disp1 = (prm.bf / fmaxf(nz, 1e-12f)) / prm.arf;
        const float p_in = fisk_pdf(fabsf(disp1 - disp2), m.c, m.s);
        const float r = p_in / (p_in + m.p_out);
        pcost[k] = pcost[k] + (-wgt) * logf(fmaxf(r, 1e-30f));
        pwsum[k] = pwsum[k] + wgt;
      }
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      cost[k] = cost[k] + pcost[k];
      wsum[k] = wsum[k] + pwsum[k];
    }
  }

  // normalize_cost: cost / max(weight, FLT_EPSILON), +inf where weight == 0
  float best = __int_as_float(0x7f800000);
  float best_d = d[0];
  bool best_nan = false;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k >= K) break;
    const float wk = wsum[k];
    float c = cost[k] / (wk < kZde ? kZde : wk);
    if (wk == 0.0f) c = __int_as_float(0x7f800000);
    if (!ACCEPT) {
      in.out[k * hw + pix] = c;
      continue;
    }
    if (in.masks != nullptr && in.masks[k * hw + pix] == 0) c = __int_as_float(0x7f800000);
    if (best_nan) continue;
    if (c != c) {  // the first NaN wins, as in jnp.min / jnp.argmin
      best = c;
      best_d = d[k];
      best_nan = true;
    } else if (c < best) {  // strict: ties keep the lowest k
      best = c;
      best_d = d[k];
    }
  }
  if (ACCEPT && best < in.cost[pix]) {  // false for a NaN on either side
    in.depth[pix] = best_d;
    in.cost[pix] = best;
  }
}

template <int KT>
cudaError_t launch(bool accept, const CostInputs& in, const CostParams& prm,
                   cudaStream_t stream) {
  const int hw = prm.h * prm.w;
  const int blocks = (hw + kThreads - 1) / kThreads;
  if (accept) {
    cost_kernel<KT, true><<<blocks, kThreads, 0, stream>>>(in, prm);
  } else {
    cost_kernel<KT, false><<<blocks, kThreads, 0, stream>>>(in, prm);
  }
  return cudaGetLastError();
}

}  // namespace

// mode 0 = score (writes out), 1 = accept (updates depth and cost in place;
// masks may be null). `poses` is a device pointer to the (N + D, 12) pose
// rows. Returns a cudaError_t as int (0 = launched). Launches on `stream`
// and does not synchronise; allocates nothing.
extern "C" int cost_kernel_launch(int mode, const float* poses, const float* cands,
                                  const float* tx, const float* ty, const float* obx,
                                  const float* oby, const float* rig, const uint8_t* inb,
                                  const float* ptgt, const float* pwgt,
                                  const uint8_t* masks, float* depth, float* cost,
                                  float* out, const CostParams* prm, void* stream) {
  if (mode < 0 || mode > 1 || prm->k < 1 || prm->k > COST_MAX_K ||
      prm->n_frames < 1 || prm->n_frames > COST_MAX_N || prm->n_priors < 0 ||
      prm->n_priors > COST_MAX_D || prm->h < 1 || prm->w < 1 || prm->y0 < 0 ||
      (long long)prm->h * prm->w * COST_MAX_K > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const CostInputs in{poses, cands, tx, ty, obx, oby, rig, inb, ptgt, pwgt,
                      masks, depth, cost, out};
  const bool accept = mode == 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (prm->k <= 1) return (int)launch<1>(accept, in, *prm, s);
  if (prm->k <= 4) return (int)launch<4>(accept, in, *prm, s);
  if (prm->k <= 10) return (int)launch<10>(accept, in, *prm, s);
  return (int)launch<16>(accept, in, *prm, s);
}
