// Fused multi-frame Fisk cost of K candidate depth maps, with the
// normalisation and the per-pixel accept of a proposal batch, for sm_90a.
//
// Replaces the Pallas TPU kernel voldor_tpu/ops/pallas_cost.py:_cost_kernel
// (both arms: the flow arm over the N window frames and the fused
// depth-prior arm over D prior cameras), its normalize_cost (:225), and the
// accept of voldor_tpu/vo/em.py:optimize_depth_batched (:596-610).
//
// Two modes:
// * score: writes the normalised (K, h, w) cost of every candidate;
// * accept: masks the candidates (uint8 (K, h, w), or none = all kept),
//   takes the first argmin over K as jnp.min / jnp.argmin do (ties go to
//   the lowest k, a NaN among the kept costs wins), and where that cost is
//   below the pixel's current cost writes the candidate's depth and cost
//   over the current ones, in place. Nothing else is written.
//
// What bounds it on the card: the arithmetic. Per pixel the accept reads
// K candidates, depth and cost, 6 planes per active window frame (track
// x/y, observed flow x/y, rigidness, in-bounds byte), 2 per prior and the
// masks, and writes 8 bytes (~180 B at K=10, N=5, D=2: ~6 us at 3.35 TB/s).
// Each of the K * (N + D) Fisk terms needs a powf, a logf, a sqrtf and
// seven divisions: even counted at one special-function op each, the
// operations set the floor (~26 us at K=10 on an H100; chip_smoke.py counts
// them from the plain formula). The IEEE sequences the parity rule needs
// are far longer than that count, so the instruction stream and how well
// the SMs issue it decide the time.
//
// Design: a block takes a tile of `tile` consecutive pixels of the image
// (a multiple of 32) and all K candidates: k * tile + j is the thread of
// candidate k at pixel j, so warp w takes one candidate over 32
// consecutive pixels and candidate loads and score stores stay coalesced.
// 1. The block stages, once per pixel and window frame, the track, the
//    observed flow, the rigidness and in-bounds byte together with the
//    frame's Fisk model (c, scale, outlier density), and once per pixel and
//    prior its weight, disparity and Fisk model, into shared memory: the
//    candidate-independent half of every term, computed by the block's
//    threads spread over (frame or prior, pixel) pairs. Every input byte is
//    read from device memory once; the candidate warps read the pairs as
//    float2 from shared memory, consecutive pixels on consecutive words (no
//    bank conflicts). The planes' tile segments are only 4-byte aligned
//    (h * w is odd at 613 x 185), so neither 16-byte cp.async nor a TMA
//    bulk copy applies, and the staging loads feed the model at once.
// 2. Each thread chains its one candidate through the active frames and
//    then the priors: 40 registers, where a thread that chains all K
//    candidates of its pixel needs 121 at K = 10 and leaves an SM 16
//    warps. An SM holds 40-48 warps at K = 4, 10 and 16, and a launch at
//    K >= 4 is 2-9 waves of small blocks: no long last wave.
// 3. accept: each thread writes its normalised, masked cost and its depth
//    to shared memory; after one barrier one thread per pixel scans k = 0
//    .. K-1 in order with the rule above and writes depth and cost. No
//    atomics: the result does not depend on the schedule.
// The (N + D) x 12 pose rows live on the device and each block reads them
// into shared memory once: the caller never copies a pose to the host. The
// wrapper chooses the tile (ops/cost.py:geometry); the threads (K * tile),
// the shared bytes (within the default 48 KB a block) and the grid follow
// from it here.
//
// Numerics: IEEE logf/expf/powf/sqrtf and divisions, built with
// --fmad=false and without fast math, in the JAX package's operation order
// (voldor_tpu/ops/fisk.py), so the kernel agrees with the plain PyTorch
// version to float rounding of the math library. (1 + u^-c)^-2 is
// 1 / (v * v): what torch.pow(v, -2.0) computes on the card and the CPU
// (chip_smoke.py phase 6 checks it bitwise), one powf a term fewer.

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
  int tile;      // pixels per block, a multiple of 32 (ops/cost.py:geometry)
};

namespace {

constexpr int kMaxThreads = 768;
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared bytes a block without opting in
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
  const float v = 1.0f + u_negc;
  return (c * u_negc * (1.0f / u) * (1.0f / (v * v))) / scale;
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

// One flow term (em.compute_cost_map_tracked): the point (ox, oy, oz) moved
// into frame f by its pose row P, its projection's residual against the
// track and observed flow, -rig * log(r) and rig summed where the pixel's
// track is in bounds and the point in front. Returns the moved point.
__device__ __forceinline__ void flow_term(const float* P, float& ox, float& oy, float& oz,
                                          float2 track, float2 obs, float2 model,
                                          float2 pout_rig, bool in_b, const CostParams& prm,
                                          float& cost, float& wsum) {
  const float nx = P[0] * ox + P[1] * oy + P[2] * oz + P[9];
  const float ny = P[3] * ox + P[4] * oy + P[5] * oz + P[10];
  const float nz = P[6] * ox + P[7] * oy + P[8] * oz + P[11];
  if (in_b && nz > 0.0f) {
    const float snz = (fabsf(nz) < 1e-12f) ? 1e-12f : nz;
    const float px2 = (prm.fx * nx + prm.cx * snz) / snz;
    const float py2 = (prm.fy * ny + prm.cy * snz) / snz;
    const float ddx = (px2 - track.x) - obs.x;
    const float ddy = (py2 - track.y) - obs.y;
    const float diff_fmag = sqrtf(ddx * ddx + ddy * ddy) / prm.arf;
    const float p_in = fisk_pdf(diff_fmag, model.x, model.y);
    const float r = p_in / (p_in + pout_rig.x);
    cost = cost + (-pout_rig.y) * logf(fmaxf(r, 1e-30f));
    wsum = wsum + pout_rig.y;
  }
  ox = nx;
  oy = ny;
  oz = nz;
}

// One prior term (em.prior_cost_sums, fisk.depth_rigidness): the frame-0
// point (p0x, p0y, p0z) in prior camera P against the prior's disparity; wd =
// (weight, disparity), 0 weight where the prior has no target.
__device__ __forceinline__ void prior_term(const float* P, float p0x, float p0y, float p0z,
                                           float2 wd, float2 model, float p_out,
                                           const CostParams& prm, float& pcost, float& pwsum) {
  if (!(wd.x > 0.0f)) return;
  const float nz = P[6] * p0x + P[7] * p0y + P[8] * p0z + P[11];
  if (!(nz > 0.0f)) return;
  const float disp1 = (prm.bf / fmaxf(nz, 1e-12f)) / prm.arf;
  const float p_in = fisk_pdf(fabsf(disp1 - wd.y), model.x, model.y);
  const float r = p_in / (p_in + p_out);
  pcost = pcost + (-wd.x) * logf(fmaxf(r, 1e-30f));
  pwsum = pwsum + wd.x;
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

// A block's shared memory, plane-major, each plane `tile` entries:
// per window frame track (x, y), observed flow (x, y), model (c, scale),
// (outlier density, rigidness); per prior (weight, disparity), model
// (c, scale), outlier density; per candidate the accept's cost and depth;
// per window frame the in-bounds bytes last.
struct Tile {
  float2 *track, *obs, *model, *pout_rig, *prior_wd, *prior_model;
  float *prior_pout, *acc_cost, *acc_depth;
  uint8_t* inb;
};

__host__ __device__ inline int cost_smem_bytes(int tile, int n, int d, int k) {
  return tile * (33 * n + 20 * d + 8 * k);
}

__device__ inline Tile carve(unsigned char* base, int tile, int n, int d, int k) {
  Tile s;
  float2* f2 = reinterpret_cast<float2*>(base);
  s.track = f2;
  s.obs = f2 + n * tile;
  s.model = f2 + 2 * n * tile;
  s.pout_rig = f2 + 3 * n * tile;
  s.prior_wd = f2 + 4 * n * tile;
  s.prior_model = f2 + (4 * n + d) * tile;
  float* f1 = reinterpret_cast<float*>(f2 + (4 * n + 2 * d) * tile);
  s.prior_pout = f1;
  s.acc_cost = f1 + d * tile;
  s.acc_depth = f1 + (d + k) * tile;
  s.inb = reinterpret_cast<uint8_t*>(f1 + (d + 2 * k) * tile);
  return s;
}

// Registers (ptxas -v, sm_90a, --fmad=false): 38 (score) and 42 (accept)
// under a cap of 64; the bounds below (two blocks of 768 threads an SM)
// cap them at 40, no spills, so an SM holds 12 blocks of 128 threads (48
// warps) at K = 4 in either mode: 1.4% off a depth round's launches and
// 7.5% off an accept at K = 16 on an H100 (a cap of 32 spilled and was
// slower; PERF.md).
template <bool ACCEPT>
__global__ void __launch_bounds__(kMaxThreads, 2) cost_kernel(const CostInputs in,
                                                              const CostParams prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sposes[(COST_MAX_N + COST_MAX_D) * 12];
  const int P = prm.tile, N = prm.n_frames, D = prm.n_priors, K = prm.k;
  const int t = threadIdx.x, nt = blockDim.x;
  const int hw = prm.h * prm.w;
  const int pix0 = blockIdx.x * P;
  const int n_use = max(0, min(N, prm.active_n));
  const Tile s = carve(smem, P, N, D, K);

  for (int i = t; i < (N + D) * 12; i += nt) sposes[i] = in.poses[i];

  // 1. the candidate-independent half, once per (frame or prior, pixel);
  // P is a multiple of 32, so each warp takes one frame or prior
  for (int i = t; i < (n_use + D) * P; i += nt) {
    const int q = i / P, j = i - q * P, pix = pix0 + j;
    if (pix >= hw) continue;
    if (q < n_use) {
      const int off = q * hw + pix, o = q * P + j;
      const float ofx = in.obx[off], ofy = in.oby[off];
      // fisk.rigidness_xy, candidate-independent part
      const float obs_fmag = sqrtf(ofx * ofx + ofy * ofy) / prm.arf;
      const FiskModel m = fisk_model(obs_fmag, prm.lam * obs_fmag);
      s.track[o] = make_float2(in.tx[off], in.ty[off]);
      s.obs[o] = make_float2(ofx, ofy);
      s.model[o] = make_float2(m.c, m.s);
      s.pout_rig[o] = make_float2(m.p_out, in.rig[off]);
      s.inb[o] = in.inb[off];
    } else {
      const int dd = q - n_use, off = dd * hw + pix, o = dd * P + j;
      const float tgt = in.ptgt[off], wgt = in.pwgt[off];
      if (tgt > 0.0f && wgt > 0.0f) {
        // fisk.depth_rigidness(d1=max(nz,1e-12), d2=max(tgt,1e-12), bf, omega, arf)
        const float disp2 = (prm.bf / fmaxf(tgt, 1e-12f)) / prm.arf;
        const FiskModel m = fisk_model(disp2, prm.omega * disp2);
        s.prior_wd[o] = make_float2(wgt, disp2);
        s.prior_model[o] = make_float2(m.c, m.s);
        s.prior_pout[o] = m.p_out;
      } else {
        s.prior_wd[o] = make_float2(0.0f, 0.0f);
      }
    }
  }
  __syncthreads();

  // 2. this thread's candidate k at pixel j, chained through the window,
  // then the fused depth-prior arm, summed apart from the flow arm and
  // added to it at the end, as the plain version does
  const int k = t / P, j = t - k * P, pix = pix0 + j;
  const bool live = pix < hw;
  float d = 1.0f, cost = 0.0f, wsum = 0.0f;
  if (live) {
    d = in.cands[k * hw + pix];
    const int y = pix / prm.w;
    const int x = pix - y * prm.w;
    // backprojection (em._backproject)
    const float bx = ((float)x - prm.cx) / prm.fx;
    const float by = ((float)y - prm.cy) / prm.fy;
    const float p0x = bx * d, p0y = by * d;
    float ox = p0x, oy = p0y, oz = d;
    for (int f = 0; f < n_use; ++f) {
      const int o = f * P + j;
      flow_term(sposes + f * 12, ox, oy, oz, s.track[o], s.obs[o], s.model[o], s.pout_rig[o],
                s.inb[o] != 0, prm, cost, wsum);
    }
    if (D > 0) {
      float pcost = 0.0f, pwsum = 0.0f;
      for (int dd = 0; dd < D; ++dd) {
        const int o = dd * P + j;
        prior_term(sposes + (N + dd) * 12, p0x, p0y, d, s.prior_wd[o], s.prior_model[o],
                   s.prior_pout[o], prm, pcost, pwsum);
      }
      cost = cost + pcost;
      wsum = wsum + pwsum;
    }
  }

  // normalize_cost: cost / max(weight, FLT_EPSILON), +inf where weight == 0
  float c = cost / (wsum < kZde ? kZde : wsum);
  if (wsum == 0.0f) c = __int_as_float(0x7f800000);
  if (!ACCEPT) {
    if (live) in.out[k * hw + pix] = c;
    return;
  }

  // 3. the accept: one thread per pixel scans the candidates in order
  if (live && in.masks != nullptr && in.masks[k * hw + pix] == 0) c = __int_as_float(0x7f800000);
  s.acc_cost[t] = c;
  s.acc_depth[t] = d;
  __syncthreads();
  if (t >= P || pix0 + t >= hw) return;
  float best = __int_as_float(0x7f800000);
  float best_d = s.acc_depth[t];
  for (int kk = 0; kk < K; ++kk) {
    const float ck = s.acc_cost[kk * P + t];
    if (ck != ck) {  // the first NaN wins, as in jnp.min / jnp.argmin
      best = ck;
      best_d = s.acc_depth[kk * P + t];
      break;
    }
    if (ck < best) {  // strict: ties keep the lowest k
      best = ck;
      best_d = s.acc_depth[kk * P + t];
    }
  }
  const int p = pix0 + t;
  if (best < in.cost[p]) {  // false for a NaN on either side
    in.depth[p] = best_d;
    in.cost[p] = best;
  }
}

// The instruction count behind chip_smoke.py's issue-rate floor: RF flow
// terms and RP prior terms a loop iteration, through the kernel's own
// device functions and shared-memory operands. ptxas builds each variant;
// the SASS difference between two of them is one term. Launched only to
// check that it runs.
template <int RF, int RP>
__global__ void cost_term_probe_kernel(const float* data, float* out, int n,
                                       const CostParams prm) {
  __shared__ float2 sv[6 * 32];
  __shared__ float sf[32];
  __shared__ uint8_t sb[32];
  __shared__ float sp[24];
  const int t = threadIdx.x & 31;
  for (int i = 0; i < 6; ++i) sv[i * 32 + t] = make_float2(data[2 * i], data[2 * i + 1] + t);
  sf[t] = data[12];
  sb[t] = (uint8_t)(t & 1);
  if (t < 24) sp[t] = data[16 + t];
  __syncthreads();
  float ox = data[13], oy = data[14], oz = data[15];
  float cost = 0.0f, wsum = 0.0f, pcost = 0.0f, pwsum = 0.0f;
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      const int o = (i + r + t) & 31;
      flow_term(sp, ox, oy, oz, sv[o], sv[32 + o], sv[64 + o], sv[96 + o], sb[o] != 0, prm,
                cost, wsum);
    }
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int o = (i + r + t) & 31;
      prior_term(sp + 12, ox, oy, oz, sv[128 + o], sv[160 + o], sf[o], prm, pcost, pwsum);
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = cost + wsum + pcost + pwsum + oz;
}

template <bool ACCEPT>
const void* kernel_of() {
  return (const void*)cost_kernel<ACCEPT>;
}

struct Launch {
  int threads, smem, grid;
};

// The launch that follows from the tile; false where it does not fit.
bool geometry(const CostParams& p, Launch* g) {
  const long long hw = (long long)p.h * p.w;
  g->threads = p.k * p.tile;
  g->smem = p.tile > 0 ? cost_smem_bytes(p.tile, p.n_frames, p.n_priors, p.k) : 0;
  g->grid = p.tile > 0 ? (int)((hw + p.tile - 1) / p.tile) : 0;
  return p.tile >= 32 && p.tile % 32 == 0 && g->threads <= kMaxThreads && g->smem <= kMaxSmem;
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
  Launch g;
  if (mode < 0 || mode > 1 || prm->k < 1 || prm->k > COST_MAX_K ||
      prm->n_frames < 1 || prm->n_frames > COST_MAX_N || prm->n_priors < 0 ||
      prm->n_priors > COST_MAX_D || prm->h < 1 || prm->w < 1 ||
      (long long)prm->h * prm->w * COST_MAX_K > 0x7fffffffLL || !geometry(*prm, &g)) {
    return (int)cudaErrorInvalidValue;
  }
  const CostInputs in{poses, cands, tx, ty, obx, oby, rig, inb, ptgt, pwgt,
                      masks, depth, cost, out};
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 1) {
    cost_kernel<true><<<g.grid, g.threads, g.smem, s>>>(in, *prm);
  } else {
    cost_kernel<false><<<g.grid, g.threads, g.smem, s>>>(in, *prm);
  }
  return (int)cudaGetLastError();
}

// The launch of `mode` for `prm`: out[0] registers a thread, out[1] local
// (spilled) bytes a thread, out[2] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] static shared
// bytes, out[4..6] the threads, dynamic shared bytes and grid it launches.
// Returns a cudaError_t as int.
extern "C" int cost_kernel_info(int mode, const CostParams* prm, int* out) {
  Launch g;
  if (mode < 0 || mode > 1 || !geometry(*prm, &g)) return (int)cudaErrorInvalidValue;
  const void* kern = mode == 1 ? kernel_of<true>() : kernel_of<false>();
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[3] = (int)fa.sharedSizeBytes;
  out[4] = g.threads;
  out[5] = g.smem;
  out[6] = g.grid;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kern, g.threads,
                                                            (size_t)g.smem);
}

// One launch of each term probe (RF, RP) = (1, 1), (2, 1), (1, 2) over
// `data` (40 floats: operands, point, two pose rows) into out (32 floats
// each, 96 in all), n iterations; a check that the probes run.
extern "C" int cost_term_probe_launch(const float* data, float* out, int n,
                                      const CostParams* prm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cost_term_probe_kernel<1, 1><<<1, 32, 0, s>>>(data, out, n, *prm);
  cost_term_probe_kernel<2, 1><<<1, 32, 0, s>>>(data, out + 32, n, *prm);
  cost_term_probe_kernel<1, 2><<<1, 32, 0, s>>>(data, out + 64, n, *prm);
  return (int)cudaGetLastError();
}
