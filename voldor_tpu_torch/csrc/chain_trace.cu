// The chain trace of a depth round, for sm_90a: each frame-0 pixel walked
// through the window's frames, its per-frame rigidness and in-bounds flag,
// and optionally the anchored track planes, in one launch.
//
// Replaces the plain composition of voldor_tpu_torch/ops/chain_trace.py
// (chain_flow_terms -> fisk.rigidness_xy -> where), which ports
// voldor_tpu/vo/em.py:update_rigidness (:325) and
// update_rigidness_and_tracks (:332) over chain_flow_terms (:95): a Python
// loop over the N frames of ~110 elementwise ops each, then stacks, the
// Fisk rigidness and a select, ~600 launches a call on a 613 x 185 map.
//
// Per pixel, frame by frame in the plain version's order: the point is
// moved into the next frame by the frame's pose row, projected with the
// 1e-12 guard, tested in bounds at the frame's traced position (and
// f < active_n), the observed flow of frame f sampled bilinearly there
// (ops/image.py:bilinear_sample: clamped to the map, floored, a NaN
// coordinate's index 0, the four taps read as float2), the Fisk rigidness
// of the rigid against the observed flow taken where the pixel is in
// bounds (0 elsewhere), and the traced position carried to the projection
// where it is. Frames at or past active_n write rigidness 0, in-bounds 0,
// observed flow 0 and the carried position.
//
// Outputs, each (N, h, w): rigidness (f32) and in-bounds (u8), and when
// the track pointers are given the track planes: the traced position
// (x, y) at which frame f was sampled and the observed flow sampled there.
//
// What bounds it on the card: the arithmetic of the rigidness terms
// (two square roots, two powf, an expf and eleven IEEE divisions each),
// beside 8 bytes read and 21 written a pixel and frame with the tracks (5
// without). chip_smoke.py counts both from the plain formula.
//
// Design: a thread per pixel (blocks of 128: 15.1 us against 16.2 at 256
// on an H100 at N = 5, 613 x 185), the walk in registers; the (N, 12) pose rows
// [R row-major (9), t (3)], built on the device by the wrapper, are staged
// once a block in shared memory, so the caller never reads a pose back.
// Every plane is written coalesced, frame after frame; the taps of
// neighbouring pixels share cache lines and go through the read-only path.
//
// Numerics: IEEE divisions, sqrtf, expf and powf, built with --fmad=false
// and without fast math, in the plain version's operation order
// (voldor_tpu_torch/ops/fisk.py). Clamps keep a NaN as torch.clamp and
// torch.clamp_min do. (1 + u^-c)^-2 is 1 / (v * v), what torch.pow(v, -2.0)
// computes (chip_smoke.py phase 6 checks it bitwise).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

#define CHAIN_MAX_N 8

struct ChainParams {
  float fx, fy, cx, cy;
  float lam, arf;
  int n_frames;  // N planes per output stack
  int active_n;  // frames f < active_n are traced
  int h, w;
};

namespace {

constexpr int kMaxThreads = 256;
constexpr float kEstRf = 0.5f;
constexpr float kFiskA1 = 0.01f;
constexpr float kFiskA2 = 0.09f;
constexpr float kFiskB1 = 1.0f;
constexpr float kFiskB2 = -0.0022f;
constexpr float kMinObsFmag = 2.0f;
constexpr float kMaxObsFmag = 100.0f;
constexpr float kZde = 1.1920929e-07f;

using img::bilinear;
using img::clamp_keep_nan;
using img::clamp_min_keep_nan;

// fisk.fisk_pdf: u = max(x*EST_RF, eps)^2 / scale,
// pdf = c * u^-c * (1/u) * (1 + u^-c)^-2 / scale
__device__ __forceinline__ float fisk_pdf(float x, float c, float scale) {
  x = clamp_min_keep_nan(x * kEstRf, kZde);
  const float u = (x * x) / scale;
  const float u_negc = powf(u, -c);
  const float v = u_negc + 1.0f;
  return (c * u_negc * (1.0f / u) * (1.0f / (v * v))) / scale;
}

// fisk.rigidness_xy of the rigid flow (dx1, dy1) against the observed
// flow (dx2, dy2)
__device__ __forceinline__ float rigidness_xy(float dx1, float dy1, float dx2, float dy2,
                                              float lam, float arf) {
  const float obs_fmag = sqrtf(dx2 * dx2 + dy2 * dy2) / arf;
  const float ddx = dx1 - dx2;
  const float ddy = dy1 - dy2;
  const float diff_fmag = sqrtf(ddx * ddx + ddy * ddy) / arf;
  const float cf = clamp_keep_nan(obs_fmag * kEstRf, kMinObsFmag, kMaxObsFmag);
  const float c = kFiskB2 * cf + kFiskB1;
  const float s = kFiskA1 * expf(kFiskA2 * cf);
  const float p_in = fisk_pdf(diff_fmag, c, s);
  const float p_out = fisk_pdf(lam * obs_fmag, c, s);
  return p_in / (p_in + p_out);
}

struct ChainInputs {
  const float* poses;   // (N, 12) rows [R row-major (9), t (3)]
  const float* depth;   // (h, w)
  const float2* flows;  // (N, h, w) flow vectors
  float* rig;           // (N, h, w)
  uint8_t* inb;         // (N, h, w)
  float* tx;            // (N, h, w) track planes, all four or none
  float* ty;
  float* obx;
  float* oby;
};

template <bool TRACKS>
__global__ void __launch_bounds__(kMaxThreads) chain_trace_kernel(const ChainInputs in,
                                                                  const ChainParams prm) {
  __shared__ float sposes[CHAIN_MAX_N * 12];
  const int N = prm.n_frames;
  for (int i = threadIdx.x; i < N * 12; i += blockDim.x) sposes[i] = in.poses[i];
  __syncthreads();

  const int hw = prm.h * prm.w;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const int y = pix / prm.w;
  const int x = pix - y * prm.w;
  const float wf = (float)prm.w, hf = (float)prm.h;
  const int n_use = max(0, min(N, prm.active_n));

  // _backproject
  const float d = in.depth[pix];
  float ox = (((float)x - prm.cx) / prm.fx) * d;
  float oy = (((float)y - prm.cy) / prm.fy) * d;
  float oz = d;
  float px1 = (float)x, py1 = (float)y;
  for (int f = 0; f < N; ++f) {
    const int off = f * hw + pix;
    float r = 0.0f, obx = 0.0f, oby = 0.0f;
    bool in_b = false;
    if (TRACKS) {
      in.tx[off] = px1;
      in.ty[off] = py1;
    }
    if (f < n_use) {
      const float* P = sposes + f * 12;
      const float nx = P[0] * ox + P[1] * oy + P[2] * oz + P[9];
      const float ny = P[3] * ox + P[4] * oy + P[5] * oz + P[10];
      const float nz = P[6] * ox + P[7] * oy + P[8] * oz + P[11];
      const float snz = (fabsf(nz) < 1e-12f) ? 1e-12f : nz;
      const float px2 = (prm.fx * nx + prm.cx * snz) / snz;
      const float py2 = (prm.fy * ny + prm.cy * snz) / snz;
      in_b = nz > 0.0f && px1 >= 0.0f && px1 < wf && py1 >= 0.0f && py1 < hf;
      const float2 obs = bilinear(in.flows + (size_t)f * hw, px1, py1, prm.w, prm.h);
      obx = obs.x;
      oby = obs.y;
      if (in_b) {
        r = rigidness_xy(px2 - px1, py2 - py1, obx, oby, prm.lam, prm.arf);
        px1 = px2;
        py1 = py2;
      }
      ox = nx;
      oy = ny;
      oz = nz;
    }
    in.rig[off] = r;
    in.inb[off] = in_b ? 1 : 0;
    if (TRACKS) {
      in.obx[off] = obx;
      in.oby[off] = oby;
    }
  }
}

template <bool TRACKS>
const void* kernel_of() {
  return (const void*)chain_trace_kernel<TRACKS>;
}

bool valid(const ChainParams& p, int threads) {
  return p.n_frames >= 1 && p.n_frames <= CHAIN_MAX_N && p.h >= 1 && p.w >= 1 &&
         (long long)p.h * p.w * CHAIN_MAX_N <= 0x7fffffffLL && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace

// One launch of `threads` threads a block (a multiple of 32, at most 256)
// over the h * w pixels. `poses` is a device pointer to the (N, 12) pose
// rows; the four track pointers are all given or all null (rigidness and
// in-bounds only). Returns a cudaError_t as int (0 = launched). Launches on
// `stream` and does not synchronise; allocates nothing.
extern "C" int chain_trace_launch(const float* poses, const float* depth, const float* flows,
                                  float* rig, uint8_t* inb, float* tx, float* ty, float* obx,
                                  float* oby, const ChainParams* prm, int threads, void* stream) {
  const bool tracks = tx != nullptr;
  if (!valid(*prm, threads) || tracks != (ty != nullptr) || tracks != (obx != nullptr) ||
      tracks != (oby != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const ChainInputs in{poses, depth, reinterpret_cast<const float2*>(flows), rig, inb,
                       tx, ty, obx, oby};
  const long long hw = (long long)prm->h * prm->w;
  const int grid = (int)((hw + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (tracks) {
    chain_trace_kernel<true><<<grid, threads, 0, s>>>(in, *prm);
  } else {
    chain_trace_kernel<false><<<grid, threads, 0, s>>>(in, *prm);
  }
  return (int)cudaGetLastError();
}

// The kernel with (tracks = 1) or without the track planes: out[0]
// registers a thread, out[1] local (spilled) bytes a thread, out[2]
// resident blocks an SM at `threads` threads a block. Returns a cudaError_t
// as int.
extern "C" int chain_trace_info(int tracks, int threads, int* out) {
  const void* kern = tracks ? kernel_of<true>() : kernel_of<false>();
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kern, threads, 0);
}
