// HMM forward-backward smoothing of a stack of probability maps, for sm_90a.
//
// Replaces the lax.scan of voldor_tpu/ops/fb_smooth.py:fb_smooth (:134-168),
// which has no Pallas kernel: XLA runs that scan on the device. The port's
// plain version (ops/fb_smooth.py:fb_smooth_reference) walks the same
// recurrences from Python, ~12 small launches per line position.
//
// Input (M, h, w) float32, contiguous. Along every row: a forward message
// pass, a backward message pass, then the pointwise posterior
// s1 / max(s0 + s1, 1e-30); then the same along every column of the result.
//
// What bounds it on the card: the recurrence is sequential along a line,
// 2 * w dependent steps per row and 2 * h per column, each ending in an IEEE
// division. The bytes (the stack read once, the result written once) take
// ~1.4 us at M = 5, 185 x 613; the dependence chain takes far longer (~54 us
// on an H100, timed by fb_chain_probe_kernel), so it is the chain, not
// memory, that sets the floor. Every line runs on its own thread, so all
// lines walk their chains at once.
//
// Design: two launches.
// * Rows: a block loads a tile of R rows coalesced into shared memory; one
//   thread per row walks the forward pass (messages kept in a second shared
//   tile), then the backward pass, writing the posterior over the tile in
//   place; the tile is stored back coalesced. The row stride in shared
//   memory is odd, so the 32 walkers of a warp hit 32 distinct banks.
// * Columns: one thread per column, consecutive threads on consecutive
//   columns, so every step's load and store is coalesced. The forward
//   messages are kept in the output itself and overwritten by the posterior
//   on the way back.
//
// Numerics: the JAX operation order of fwd_step / bwd_step (:145-155), IEEE
// division, built with --fmad=false and without fast math, so the kernel
// rounds every step as the plain version does.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kRowWalkers = 32;   // rows per block of the row kernel, at most
constexpr int kRowThreads = 128;  // threads that load and store the tile
constexpr int kColThreads = 64;
constexpr int kMaxDevices = 64;

struct Hmm {
  float e0, ncp, omn;  // emission of state 0, no-change prob, 1 - ncp
};

__device__ __forceinline__ float fwd_step(float prev, float e1, const Hmm& m) {
  const float s0 = (prev * m.omn + (1.0f - prev) * m.ncp) * m.e0;
  const float s1 = (prev * m.ncp + (1.0f - prev) * m.omn) * e1;
  return s1 / (s0 + s1);
}

__device__ __forceinline__ float bwd_step(float prev, float e1, const Hmm& m) {
  const float s0 = prev * e1 * m.omn + (1.0f - prev) * m.ncp * m.e0;
  const float s1 = prev * e1 * m.ncp + (1.0f - prev) * m.omn * m.e0;
  return s1 / (s0 + s1);
}

__device__ __forceinline__ float posterior(float f, float b) {
  const float s1 = f * b;
  const float s0 = (1.0f - f) * (1.0f - b);
  const float z = s0 + s1;
  return s1 / (z < 1e-30f ? 1e-30f : z);  // max() that keeps a NaN
}

__global__ void __launch_bounds__(kRowThreads)
fb_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
               int lines, int n, int ld, int rows, Hmm m) {
  extern __shared__ float smem[];
  float* tile = smem;               // [rows][ld]
  float* fwd = smem + rows * ld;    // [rows][ld]
  const int line0 = blockIdx.x * rows;
  const int nl = min(rows, lines - line0);
  const size_t base = (size_t)line0 * n;
  for (int i = threadIdx.x; i < nl * n; i += blockDim.x) {
    const int r = i / n;
    tile[r * ld + (i - r * n)] = in[base + i];
  }
  __syncthreads();
  if (threadIdx.x < nl) {
    float* t = tile + threadIdx.x * ld;
    float* f = fwd + threadIdx.x * ld;
    float prev = t[0];
    for (int i = 0; i < n; ++i) {
      prev = fwd_step(prev, t[i], m);
      f[i] = prev;
    }
    prev = t[n - 1];
    for (int i = n - 1; i >= 0; --i) {
      prev = bwd_step(prev, t[i], m);
      t[i] = posterior(f[i], prev);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nl * n; i += blockDim.x) {
    const int r = i / n;
    out[base + i] = tile[r * ld + (i - r * n)];
  }
}

__global__ void __launch_bounds__(kColThreads)
fb_cols_kernel(const float* __restrict__ in, float* __restrict__ out,
               int h, int w, Hmm m) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const size_t off = (size_t)blockIdx.y * h * w + x;
  const float* p = in + off;
  float* o = out + off;
  float prev = p[0];
#pragma unroll 4
  for (int y = 0; y < h; ++y) {
    prev = fwd_step(prev, p[(size_t)y * w], m);
    o[(size_t)y * w] = prev;
  }
  prev = p[(size_t)(h - 1) * w];
#pragma unroll 4
  for (int y = h - 1; y >= 0; --y) {
    prev = bwd_step(prev, p[(size_t)y * w], m);
    o[(size_t)y * w] = posterior(o[(size_t)y * w], prev);
  }
}

// The chain's latency without memory: one thread walks n forward steps,
// then n backward steps, from registers. n steps of each is the chain of one
// line of n positions, so (h + w) times the time of one step of each is the
// serial floor of a call (chip_smoke.py measures it).
__global__ void fb_chain_probe_kernel(const float* e, float* out, int n, Hmm m) {
  float prev = e[0];
  const float e1 = e[1];
  for (int i = 0; i < n; ++i) prev = fwd_step(prev, e1, m);
  for (int i = 0; i < n; ++i) prev = bwd_step(prev, e1, m);
  out[0] = prev;
}

// The opt-in shared memory per block of the current device, with the row
// kernel's limit raised to it: queried and set once per device.
cudaError_t row_smem_limit(int* limit) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*limit = cache[dev].load()) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fb_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *limit);
  if (err == cudaSuccess && dev < kMaxDevices) cache[dev].store(*limit);
  return err;
}

}  // namespace

// Smooths the (m, h, w) stack `in` into `out`, through the scratch stack
// `mid` (the row pass's result); all three device pointers, contiguous.
// Returns a cudaError_t as int (0 = launched). Launches on `stream` and does
// not synchronise; allocates nothing.
extern "C" int fb_smooth_launch(const float* in, float* mid, float* out, int m,
                                int h, int w, float e0, float ncp, float omn,
                                void* stream) {
  if (m < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Hmm hmm{e0, ncp, omn};
  const int ld = w | 1;  // odd stride: conflict-free walkers
  int max_smem = 0;
  cudaError_t err = row_smem_limit(&max_smem);
  if (err != cudaSuccess) return (int)err;
  // as many rows per block as shared memory holds (32 at w = 613)
  const int rows = std::min(kRowWalkers, max_smem / (int)(2 * ld * sizeof(float)));
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2ull * rows * ld * sizeof(float);
  const int lines = m * h;
  fb_rows_kernel<<<(lines + rows - 1) / rows, kRowThreads, smem, s>>>(
      in, mid, lines, w, ld, rows, hmm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + kColThreads - 1) / kColThreads, m);
  fb_cols_kernel<<<grid, kColThreads, 0, s>>>(mid, out, h, w, hmm);
  return (int)cudaGetLastError();
}

// fb_chain_probe_kernel on one thread: e (2 floats) in, out (1 float); both
// device pointers. Returns a cudaError_t as int; does not synchronise.
extern "C" int fb_chain_probe_launch(const float* e, float* out, int n, float e0, float ncp,
                                     float omn, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  fb_chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(e, out, n, Hmm{e0, ncp, omn});
  return (int)cudaGetLastError();
}
