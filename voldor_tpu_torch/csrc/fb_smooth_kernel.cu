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
// What bounds it on the card: each message pass is a recurrence along its
// line. Walked on one thread, a call is (h + w) dependent step pairs, each
// ending in an IEEE division (~54 us on an H100, timed by
// fb_chain_probe_kernel), 40x the time the bytes take (~1.4 us at M = 5,
// 185 x 613). So the design cuts the chain, not the traffic.
//
// Design: a chunked log-depth scan, one warp per line, two launches (rows,
// then columns, through the scratch stack `mid`).
// * A line of n positions is cut into 32 chunks of L = ceil(n / 32); lane t
//   owns positions [t L, (t + 1) L). Each line step is a
//   Moebius map prev' = (a prev + b) / (c prev + d)
//   (voldor_tpu/ops/fb_smooth.py:52, :68), so a lane composes its chunk's
//   forward and backward maps in registers (renormalised by the largest
//   entry and flushed below 1e-12 at every product, as _mobius_combine :29
//   does; positions past the line's end are identity maps).
// * A shuffle scan of the chunk maps over the warp (5 steps each way)
//   gives every lane the message at the end of its neighbouring chunk: the
//   forward prefix applied to the first position's probability, the
//   backward suffix applied to the last's.
// * From that carry-in each lane walks its chunk with the exact serial
//   steps (fwd_step / bwd_step, both directions interleaved), so within a
//   chunk the numerics are the serial recurrence's; only the carry-in is
//   rounded differently. The recurrence contracts, so that rounding fades
//   within a few steps (ops/fb_smooth.py:fb_smooth_chunked_reference is
//   this arithmetic in plain torch, op for op).
// * The lines sit in shared memory in the chunked layout, chunk t of a
//   line at t * S with S = L | 1 (odd), one float of padding after each
//   line, so the 32 lanes of a warp hit 32 distinct banks; the forward and backward
//   messages get two more such buffers. Rows: each warp loads its row
//   coalesced. Columns: a block loads a tile of columns row by row
//   (consecutive threads on consecutive columns) and each warp smooths
//   one column of the tile.
// The dependent chain per line pass is L compositions, 5 scan steps and L
// walk steps (20 + 5 + 20 per row at w = 613), against
// w (or h) step pairs on one thread.
//
// Numerics: the JAX operation order of fwd_step / bwd_step (:145-155) and of
// the Moebius helpers, IEEE division, built with --fmad=false and without
// fast math, so every product and sum is rounded on its own, as the plain
// torch versions round them.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kLanes = 32;  // chunks per line: one warp's lanes
constexpr int kRowWarps = 4;     // warps per block of the row kernel, at most
constexpr int kColWarps = 8;     // warps per block of the column kernel, at most
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// The HMM's constants, each rounded to float32 on the host in the JAX
// package's operation order (ops/fb_smooth.py:_constants).
struct Hmm {
  float e0;     // emission of state 0
  float ncp;    // no-change probability
  float omn;    // 1 - ncp
  float k1;     // 2 ncp - 1
  float k2;     // 1 - 2 ncp
  float e0ncp;  // e0 ncp
  float omne0;  // (1 - ncp) e0
};

struct Mob {  // the Moebius map x -> (a x + b) / (c x + d)
  float a, b, c, d;
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

__device__ __forceinline__ Mob identity() { return Mob{1.0f, 0.0f, 0.0f, 1.0f}; }

// _forward_coeffs (fb_smooth.py:52) at emission e1
__device__ __forceinline__ Mob fwd_map(float e1, const Hmm& m) {
  return Mob{e1 * m.k1, e1 * m.omn, (m.e0 - e1) * m.k2, m.e0ncp + e1 * m.omn};
}

// _backward_coeffs (fb_smooth.py:68) at emission e1
__device__ __forceinline__ Mob bwd_map(float e1, const Hmm& m) {
  return Mob{e1 * m.ncp - m.omne0, m.omne0, e1 - m.e0, m.e0};
}

__device__ __forceinline__ float flush(float v) { return fabsf(v) < 1e-12f ? 0.0f : v; }

// _mobius_combine (fb_smooth.py:29): `earlier` applied first, then `later`;
// the product later @ earlier, scaled by the reciprocal of its largest
// |entry| (at least 1e-30), entries below 1e-12 flushed to zero.
__device__ __forceinline__ Mob combine(const Mob& e, const Mob& l) {
  const float a = l.a * e.a + l.b * e.c;
  const float b = l.a * e.b + l.b * e.d;
  const float c = l.c * e.a + l.d * e.c;
  const float d = l.c * e.b + l.d * e.d;
  const float s = fmaxf(fmaxf(fmaxf(fabsf(a), fabsf(b)), fabsf(c)), fabsf(d));
  const float r = 1.0f / fmaxf(s, 1e-30f);
  return Mob{flush(a * r), flush(b * r), flush(c * r), flush(d * r)};
}

// _apply_mobius (fb_smooth.py:46)
__device__ __forceinline__ float apply(const Mob& m, float x) {
  const float num = m.a * x + m.b;
  const float den = m.c * x + m.d;
  return num / (fabsf(den) < 1e-30f ? 1e-30f : den);
}

__device__ __forceinline__ Mob shfl_up(const Mob& v, int k) {
  return Mob{__shfl_up_sync(kFull, v.a, k), __shfl_up_sync(kFull, v.b, k),
             __shfl_up_sync(kFull, v.c, k), __shfl_up_sync(kFull, v.d, k)};
}

__device__ __forceinline__ Mob shfl_down(const Mob& v, int k) {
  return Mob{__shfl_down_sync(kFull, v.a, k), __shfl_down_sync(kFull, v.b, k),
             __shfl_down_sync(kFull, v.c, k), __shfl_down_sync(kFull, v.d, k)};
}

// Position i of a line in the chunked layout.
__device__ __forceinline__ int slot(int i, int L, int S) { return (i / L) * S + i % L; }

// Offset of local line j's region in each of the p, f, b buffers: 32 * S
// floats a line, one float of padding after each. A warp's lanes then sit
// S apart (S odd), and a column tile's first row, stored by consecutive
// threads, lands on distinct banks.
__host__ __device__ __forceinline__ int line_base(int j, int S) { return j * (kLanes * S + 1); }

// Length of each of the p, f, b buffers for `lines` local lines.
int buffer_len(int lines, int S) { return line_base(lines, S) + 1; }

// Smooths one line of n >= 1 positions, called by all 32 lanes of a warp.
// p holds the line in the chunked layout (chunk t at t * S, L positions
// each); the posterior is written over it. f and b are scratch of the same
// layout.
__device__ void smooth_line(float* p, float* f, float* b, int n, int L, int S, const Hmm& m) {
  const int lane = threadIdx.x % kLanes;
  const int cnt = max(0, min(L, n - lane * L));  // real positions of this chunk
  float* pc = p + lane * S;
  float* fc = f + lane * S;
  float* bc = b + lane * S;

  // the chunk's maps: forward from its first position, backward from its last
  Mob F = cnt > 0 ? fwd_map(pc[0], m) : identity();
  Mob B = L - 1 < cnt ? bwd_map(pc[L - 1], m) : identity();
  for (int k = 1; k < L; ++k) {
    F = combine(F, k < cnt ? fwd_map(pc[k], m) : identity());
    const int kb = L - 1 - k;
    B = combine(B, kb < cnt ? bwd_map(pc[kb], m) : identity());
  }
  // inclusive scans: F over this and the earlier chunks, B over this and
  // the later ones
#pragma unroll
  for (int k = 1; k < kLanes; k *= 2) {
    const Mob fo = shfl_up(F, k);
    const Mob bo = shfl_down(B, k);
    if (lane >= k) F = combine(fo, F);
    if (lane + k < kLanes) B = combine(bo, B);
  }
  // carry-in messages: the neighbouring chunk's end message
  const float init_f = p[0];
  const float init_b = p[slot(n - 1, L, S)];
  const float mf = __shfl_up_sync(kFull, apply(F, init_f), 1);
  const float mb = __shfl_down_sync(kFull, apply(B, init_b), 1);
  float pf = lane == 0 ? init_f : mf;
  float pb = lane == kLanes - 1 ? init_b : mb;
  // the exact serial steps over the chunk, both directions at once
  for (int k = 0; k < cnt; ++k) {
    pf = fwd_step(pf, pc[k], m);
    fc[k] = pf;
    const int kb = cnt - 1 - k;
    pb = bwd_step(pb, pc[kb], m);
    bc[kb] = pb;
  }
  for (int k = 0; k < cnt; ++k) pc[k] = posterior(fc[k], bc[k]);
}

// Each warp smooths one row: loads it coalesced, smooths it, stores it.
__global__ void __launch_bounds__(kRowWarps * kLanes)
fb_rows_kernel(const float* __restrict__ in, float* __restrict__ out, int lines, int n,
               int L, int S, int len, Hmm m) {
  constexpr int C = kLanes;
  extern __shared__ float smem[];
  const int j = threadIdx.x / C;  // local line
  const int lane = threadIdx.x % C;
  const int line = blockIdx.x * (blockDim.x / C) + j;
  if (line >= lines) return;  // the whole warp: no block-wide barrier follows
  float* p = smem + line_base(j, S);
  float* f = p + len;
  float* b = f + len;
  const float* src = in + (size_t)line * n;
  int i = lane;
  for (; i + 3 * C < n; i += 4 * C) {  // four loads in flight
    const float v0 = src[i], v1 = src[i + C], v2 = src[i + 2 * C], v3 = src[i + 3 * C];
    p[slot(i, L, S)] = v0;
    p[slot(i + C, L, S)] = v1;
    p[slot(i + 2 * C, L, S)] = v2;
    p[slot(i + 3 * C, L, S)] = v3;
  }
  for (; i < n; i += C) p[slot(i, L, S)] = src[i];
  __syncwarp();
  smooth_line(p, f, b, n, L, S, m);
  __syncwarp();
  float* dst = out + (size_t)line * n;
  for (i = lane; i < n; i += C) dst[i] = p[slot(i, L, S)];
}

// blockIdx.y: the map; blockIdx.x: a tile of `tile` columns, one warp
// each. The tile is loaded and stored row by row (consecutive threads on
// consecutive columns).
__global__ void __launch_bounds__(kColWarps * kLanes)
fb_cols_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w, int L,
               int S, int tile, int len, Hmm m) {
  extern __shared__ float smem[];
  const int x0 = blockIdx.x * tile;
  const int nc = min(tile, w - x0);
  const size_t base = (size_t)blockIdx.y * h * w + x0;
  for (int i = threadIdx.x; i < h * nc; i += blockDim.x) {
    const int y = i / nc, c = i - y * nc;
    smem[line_base(c, S) + slot(y, L, S)] = in[base + (size_t)y * w + c];
  }
  __syncthreads();
  const int c = threadIdx.x / kLanes;
  if (c < nc) {
    float* p = smem + line_base(c, S);
    smooth_line(p, p + len, p + 2 * len, h, L, S, m);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h * nc; i += blockDim.x) {
    const int y = i / nc, c2 = i - y * nc;
    out[base + (size_t)y * w + c2] = smem[line_base(c2, S) + slot(y, L, S)];
  }
}

// The chain's latency without memory: one thread walks n forward steps,
// then n backward steps, from registers. n steps of each is the chain of one
// line of n positions walked on one thread, so (h + w) times the time of one
// step of each is the serial floor of a call (chip_smoke.py measures it).
__global__ void fb_chain_probe_kernel(const float* e, float* out, int n, Hmm m) {
  float prev = e[0];
  const float e1 = e[1];
  for (int i = 0; i < n; ++i) prev = fwd_step(prev, e1, m);
  for (int i = 0; i < n; ++i) prev = bwd_step(prev, e1, m);
  out[0] = prev;
}

// The composition's latency: one thread composes n forward and n backward
// maps, the two chains interleaved as smooth_line composes them. With
// fb_chain_probe_kernel it gives the chunked design's chain floor.
__global__ void fb_combine_probe_kernel(const float* e, float* out, int n, Hmm m) {
  Mob F = fwd_map(e[0], m), B = bwd_map(e[0], m);
  const Mob fm = fwd_map(e[1], m), bm = bwd_map(e[1], m);
  for (int i = 0; i < n; ++i) {
    F = combine(F, fm);
    B = combine(B, bm);
  }
  out[0] = apply(F, e[0]) + apply(B, e[0]);
}

// The opt-in shared memory per block of the current device, with kernel's
// limit raised to it: set once per kernel and device.
cudaError_t allow_smem(const void* kernel, std::atomic<int>* cache, int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*limit = cache[dev].load()) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  if (err == cudaSuccess && dev < kMaxDevices) cache[dev].store(*limit);
  return err;
}

// Warps per block, at most `most`, whose three buffers fit in `limit` bytes;
// 0 if not even one warp's do.
int warps_that_fit(int most, int S, int limit) {
  for (int wp = most; wp >= 1; --wp)
    if (3ull * buffer_len(wp, S) * sizeof(float) <= (size_t)limit) return wp;
  return 0;
}

cudaError_t launch_rows(const float* in, float* out, int lines, int n, const Hmm& hmm,
                        cudaStream_t s) {
  static std::atomic<int> cache[kMaxDevices];
  int limit = 0;
  cudaError_t err = allow_smem((const void*)fb_rows_kernel, cache, &limit);
  if (err != cudaSuccess) return err;
  const int L = (n + kLanes - 1) / kLanes, S = L | 1;
  const int warps = warps_that_fit(kRowWarps, S, limit);
  if (warps < 1) return cudaErrorInvalidValue;
  const int len = buffer_len(warps, S);
  fb_rows_kernel<<<(lines + warps - 1) / warps, warps * kLanes, 3ull * len * sizeof(float), s>>>(
      in, out, lines, n, L, S, len, hmm);
  return cudaGetLastError();
}

cudaError_t launch_cols(const float* in, float* out, int m, int h, int w, const Hmm& hmm,
                        cudaStream_t s) {
  static std::atomic<int> cache[kMaxDevices];
  int limit = 0;
  cudaError_t err = allow_smem((const void*)fb_cols_kernel, cache, &limit);
  if (err != cudaSuccess) return err;
  const int L = (h + kLanes - 1) / kLanes, S = L | 1;
  const int tile = warps_that_fit(kColWarps, S, limit);
  if (tile < 1) return cudaErrorInvalidValue;
  const int len = buffer_len(tile, S);
  dim3 grid((w + tile - 1) / tile, m);
  fb_cols_kernel<<<grid, tile * kLanes, 3ull * len * sizeof(float), s>>>(
      in, out, h, w, L, S, tile, len, hmm);
  return cudaGetLastError();
}

Hmm make_hmm(const float* c) { return Hmm{c[0], c[1], c[2], c[3], c[4], c[5], c[6]}; }

}  // namespace

// Smooths the (m, h, w) stack `in` into `out`, through the scratch stack
// `mid` (the row pass's result); all three device pointers, contiguous.
// consts: the 7 HMM constants of struct Hmm, host memory. Returns a
// cudaError_t as int (0 = launched). Launches on `stream` and does not
// synchronise; allocates nothing.
extern "C" int fb_smooth_launch(const float* in, float* mid, float* out, int m, int h, int w,
                                const float* consts, void* stream) {
  if (m < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Hmm hmm = make_hmm(consts);
  const cudaError_t err = launch_rows(in, mid, m * h, w, hmm, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cols(mid, out, m, h, w, hmm, s);
}

// fb_chain_probe_kernel (which = 0) or fb_combine_probe_kernel (which = 1)
// on one thread: e (2 floats) in, out (1 float); both device pointers;
// consts as for fb_smooth_launch. Returns a cudaError_t as int; does not
// synchronise.
extern "C" int fb_chain_probe_launch(const float* e, float* out, int n, const float* consts,
                                     int which, void* stream) {
  if (n < 1 || which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  const Hmm hmm = make_hmm(consts);
  if (which == 0)
    fb_chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(e, out, n, hmm);
  else
    fb_combine_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(e, out, n, hmm);
  return (int)cudaGetLastError();
}
