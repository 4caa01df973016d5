// The pose sweep's P3P correspondence collect, for sm_90a: each sampled
// pixel's (p2, p3, valid) for one target frame (traced mode) or for every
// frame of the window (obs mode), in one launch.
//
// Replaces the plain versions in voldor_tpu_torch/vo/pose_step.py, which
// port voldor_tpu/vo/pose_step.py's collects:
// * collect_p3p_instances (:37), the sequential sweep's traced collect: a
//   Python loop over the window of ~25 elementwise ops a frame, twice, with
//   a bilinear flow gather a traced frame: 134-498 launches a target on a
//   613 x 185 map;
// * collect_p3p_instances_obs (:290), the Jacobi sweep's collect from the
//   observed tracks: ~460 launches a sweep.
//
// Per pixel (the grid's pixel (x, y) = stride * (i, j)), in the plain
// versions' order:
// * both modes: the depth tests, the rigidness-sum test where it is on
//   (rigidness_sum_threshold > N + 1: the host decides), the point
//   back-projected (fisk.div_scalar: one IEEE division) and carried
//   through the chain by the pose rows Rs[f], ts[f];
// * traced: the rigidness product from the target back to the first
//   frame the trace may start at (lo, from max_trace_on_flow), stopping
//   at the first frame whose product is not above the threshold; the 2-D
//   trace started at trace_start = target - count + 1 at the chain point's
//   projection (the 1e-12 guard of _project_safe) and carried along the
//   observed flows, sampled bilinearly (bilinear.cuh) where the trace is
//   strictly inside the map, flagged out of bounds where it is not; then
//   the out-of-bounds flag, the target frame's depth tests and finiteness;
// * obs: frame by frame, p2 = track + observed flow, the running AND of
//   the frames' rigidness tests (frames at or past active_n pass) and of
//   the in-bounds flags, the chain point's depth tests and finiteness.
//   The plain version's leading-alive count over the M rolling products
//   enters only as count > 0, i.e. the age-0 product (the frame's own
//   rigidness) above the threshold, which the running AND already
//   requires of every frame below active_n: the kernel reads no product.
//
// Outputs: p2 (T, hs, ws, 2) and p3 (T, hs, ws, 3) float32, valid (T, hs,
// ws) bytes, T = 1 (traced) or N (obs): the layouts _solve_and_fuse takes.
//
// What bounds it on the card: bytes. Obs mode at N = 5 reads 109 B a pixel
// (depth, 5 rigidness planes, 4 x 5 track planes, 5 flags) and writes 105
// (N x (8 + 12 + 1)): ~24 MB at 613 x 185, ~7 us at 3.35 TB/s. Traced mode
// reads the depth, at most M rigidness planes and four float2 taps a
// traced frame, and writes 21 B. Either is far below the host's cost of
// the ~460-500 torch ops it replaces: one launch a collect, no host read.
//
// Design (as chain_trace.cu): a thread per sampled pixel, blocks of 128,
// the window walked in registers; the (N, 12) pose rows [R row-major (9),
// t (3)], built on the device by the wrapper, staged once a block in
// shared memory, so the caller never reads a pose back. Numerics: IEEE
// divisions, built with --fmad=false, each product and sum in the plain
// version's order; thresholds compared in float32, as torch compares a
// float32 tensor with a Python scalar.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

#define COLLECT_MAX_N 8

struct CollectParams {
  float fx, fy, cx, cy;
  float rig_thresh;      // rigidness_threshold
  float rig_sum_thresh;  // rigidness_sum_threshold
  float min_depth;       // sample_min_depth
  float max_depth;       // sample_max_depth
  int use_rig_sum;       // rigidness_sum_threshold > N + 1
  int use_max_depth;     // sample_max_depth > 0
  int n_frames;          // N
  int active;            // traced: the target frame; obs: active_n
  int lo;                // traced: the first frame a trace may start at
  int stride;            // pose_sample_stride
  int h, w;              // the maps
  int hs, ws;            // the sampled grid, ceil(h / stride) x ceil(w / stride)
};

namespace {

constexpr int kMaxThreads = 256;

struct CollectInputs {
  const float* poses;   // (N, 12)
  const float* depth;   // (h, w)
  const float* rig;     // (N, h, w)
  const float2* flows;  // traced: (N, h, w) flow vectors
  const float* tx;      // obs: (N, h, w) track planes and in-bounds flags
  const float* ty;
  const float* obx;
  const float* oby;
  const uint8_t* tinb;
  float* p2;            // (T, hs, ws, 2)
  float* p3;            // (T, hs, ws, 3)
  uint8_t* valid;       // (T, hs, ws)
};

// the sampled pixel's depth: sample_min_depth <= d <= sample_max_depth
__device__ __forceinline__ bool depth_in_range(float d, const CollectParams& prm) {
  return d >= prm.min_depth && (!prm.use_max_depth || d <= prm.max_depth);
}

// the chain point's depth in its frame: sample_min_depth < z < sample_max_depth
__device__ __forceinline__ bool point_in_range(float z, const CollectParams& prm) {
  return z > prm.min_depth && (!prm.use_max_depth || z < prm.max_depth);
}

// the depth tests of the sampled pixel and, where on, its rigidness sum
__device__ __forceinline__ bool pixel_ok(float d, const float* __restrict__ rig, int src, int hw,
                                         const CollectParams& prm) {
  bool ok = depth_in_range(d, prm);
  if (prm.use_rig_sum) {
    float s = 0.0f;
    for (int f = 0; f < prm.n_frames; ++f) s += __ldg(rig + f * hw + src);
    ok = ok && !(s < prm.rig_sum_thresh);
  }
  return ok;
}

// _transform: the point moved into the next frame by pose row P
__device__ __forceinline__ void transform(const float* P, float& ox, float& oy, float& oz) {
  const float nx = P[0] * ox + P[1] * oy + P[2] * oz + P[9];
  const float ny = P[3] * ox + P[4] * oy + P[5] * oz + P[10];
  const float nz = P[6] * ox + P[7] * oy + P[8] * oz + P[11];
  ox = nx;
  oy = ny;
  oz = nz;
}

__device__ __forceinline__ void store(const CollectInputs& in, int q, float px, float py,
                                      float ox, float oy, float oz, bool v) {
  reinterpret_cast<float2*>(in.p2)[q] = make_float2(px, py);
  in.p3[3 * q] = ox;
  in.p3[3 * q + 1] = oy;
  in.p3[3 * q + 2] = oz;
  in.valid[q] = v ? 1 : 0;
}

template <bool OBS>
__global__ void __launch_bounds__(kMaxThreads) pose_collect_kernel(const CollectInputs in,
                                                                   const CollectParams prm) {
  __shared__ float sposes[COLLECT_MAX_N * 12];
  const int N = prm.n_frames;
  for (int k = threadIdx.x; k < N * 12; k += blockDim.x) sposes[k] = in.poses[k];
  __syncthreads();

  const int n_pix = prm.hs * prm.ws;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const int j = pix / prm.ws;
  const int i = pix - j * prm.ws;
  const int x = i * prm.stride;
  const int y = j * prm.stride;
  const int hw = prm.h * prm.w;
  const int src = y * prm.w + x;

  const float d = in.depth[src];
  const bool ok0 = pixel_ok(d, in.rig, src, hw, prm);
  // _backproject (fisk.div_scalar: one rounding a division)
  float ox = (((float)x - prm.cx) / prm.fx) * d;
  float oy = (((float)y - prm.cy) / prm.fy) * d;
  float oz = d;

  if (OBS) {
    bool cum_rig_ok = true, cum_inb = true;
    for (int f = 0; f < N; ++f) {
      const int o = f * hw + src;
      const bool active = f < prm.active;
      cum_rig_ok = cum_rig_ok && (!active || __ldg(in.rig + o) > prm.rig_thresh);
      cum_inb = cum_inb && in.tinb[o] != 0;
      const float p2x = __ldg(in.tx + o) + __ldg(in.obx + o);
      const float p2y = __ldg(in.ty + o) + __ldg(in.oby + o);
      const bool v = ok0 && active && cum_rig_ok && point_in_range(oz, prm) && isfinite(ox) &&
                     isfinite(oy) && isfinite(oz) && cum_inb && isfinite(p2x) && isfinite(p2y);
      store(in, f * n_pix + pix, p2x, p2y, ox, oy, oz, v);
      transform(sposes + f * 12, ox, oy, oz);
    }
    return;
  }

  // traced: the rigidness product from the target back to lo
  const int a = prm.active;
  float prod = 1.0f;
  int n_trace = 0;
  for (int f = a; f >= prm.lo; --f) {
    const float pn = prod * __ldg(in.rig + f * hw + src);
    if (!(pn > prm.rig_thresh)) break;
    prod = pn;
    ++n_trace;
  }
  const int trace_start = a - n_trace + 1;  // a + 1: no trace
  const float wf = (float)prm.w, hf = (float)prm.h;
  float px = 0.0f, py = 0.0f;
  bool oob = false;
  for (int f = 0; f <= a; ++f) {
    if (f == trace_start) {  // _project_safe
      const float soz = (fabsf(oz) < 1e-12f) ? 1e-12f : oz;
      px = (prm.fx * ox + prm.cx * soz) / soz;
      py = (prm.fy * oy + prm.cy * soz) / soz;
    }
    if (f >= trace_start) {
      if (px > 0.0f && px < wf && py > 0.0f && py < hf) {
        const float2 d2 = img::bilinear(in.flows + (size_t)f * hw, px, py, prm.w, prm.h);
        px = px + d2.x;
        py = py + d2.y;
      } else {
        oob = true;
      }
    }
    if (f < a) transform(sposes + f * 12, ox, oy, oz);
  }
  const bool v = ok0 && n_trace > 0 && !oob && point_in_range(oz, prm) && isfinite(px) &&
                 isfinite(py) && isfinite(ox) && isfinite(oy) && isfinite(oz);
  store(in, pix, px, py, ox, oy, oz, v);
}

template <bool OBS>
const void* kernel_of() {
  return (const void*)pose_collect_kernel<OBS>;
}

bool valid_params(const CollectParams& p, int threads, bool obs) {
  const bool active_ok = obs ? p.active >= 0 : (p.active >= 0 && p.active < p.n_frames);
  return p.n_frames >= 1 && p.n_frames <= COLLECT_MAX_N && p.h >= 1 && p.w >= 1 &&
         p.stride >= 1 && p.hs == (p.h + p.stride - 1) / p.stride &&
         p.ws == (p.w + p.stride - 1) / p.stride &&
         (long long)p.h * p.w * COLLECT_MAX_N <= 0x7fffffffLL && active_ok && p.lo >= 0 &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace

// One launch of `threads` threads a block (a multiple of 32, at most 256)
// over the hs * ws sampled pixels. Obs mode when the five track pointers
// (tx, ty, obx, oby, tinb) are given, traced mode when `flows` is; the
// other group null. `poses` is a device pointer to the (N, 12) pose rows.
// Returns a cudaError_t as int (0 = launched). Launches on `stream` and
// does not synchronise; allocates nothing.
extern "C" int pose_collect_launch(const float* poses, const float* depth, const float* rig,
                                   const float* flows, const float* tx, const float* ty,
                                   const float* obx, const float* oby, const uint8_t* tinb,
                                   float* p2, float* p3, uint8_t* valid,
                                   const CollectParams* prm, int threads, void* stream) {
  const bool obs = tx != nullptr;
  const bool tracks_whole = obs == (ty != nullptr) && obs == (obx != nullptr) &&
                            obs == (oby != nullptr) && obs == (tinb != nullptr);
  if (!tracks_whole || obs == (flows != nullptr) || !valid_params(*prm, threads, obs)) {
    return (int)cudaErrorInvalidValue;
  }
  const CollectInputs in{poses, depth, rig, reinterpret_cast<const float2*>(flows),
                         tx, ty, obx, oby, tinb, p2, p3, valid};
  const long long n_pix = (long long)prm->hs * prm->ws;
  const int grid = (int)((n_pix + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (obs) {
    pose_collect_kernel<true><<<grid, threads, 0, s>>>(in, *prm);
  } else {
    pose_collect_kernel<false><<<grid, threads, 0, s>>>(in, *prm);
  }
  return (int)cudaGetLastError();
}

// The obs (obs = 1) or traced kernel: out[0] registers a thread, out[1]
// local (spilled) bytes a thread, out[2] resident blocks an SM at
// `threads` threads a block. Returns a cudaError_t as int.
extern "C" int pose_collect_info(int obs, int threads, int* out) {
  const void* kern = obs ? kernel_of<true>() : kernel_of<false>();
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kern, threads, 0);
}
