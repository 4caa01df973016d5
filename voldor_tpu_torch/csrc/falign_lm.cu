// Frame alignment's LM chunk, one launch, for sm_90a.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel here:
// the vmapped lax.while_loop of voldor_tpu/falign/solver.py:396-445
// (lm_chunk_pairs) over _make_lm_step's body, :184-235 (the gauge weight,
// the damped system, its Cholesky solve, the linearisation at the trial,
// the accept decision, the gain-ratio damping and the stopping rules), and
// the loop's freeze, :424-441 (a lane runs while it < it_end and it is not
// done). The port's plain version is ops/falign_kernels.py:
// lm_chunk_reference (lm_propose_reference, pair_normal_blocks,
// lm_accept_reference per iteration).
//
// One launch advances every lane by up to n iterations (and, where it_end
// is given, not past it_end[l]). The lane state is PairLmState's: params,
// lam, cost, H, g (the raw normal equations at params), it, done, w2. It
// lives in block 0 for the whole launch and is written to new tensors at
// its end; a lane that does not run is copied through.
//
// What bounds it on the card: latency. A lane is small (D = 9N = 18 for
// falign_pairs; two pair evaluations of <= 12.7k pixels each) and every
// iteration is a dependent chain: the factor's D column steps and 2D solve
// steps, the pair constants, the pixels' evaluation and Gram sums, the sums
// across blocks, the accept. Bytes and operations take well under a
// microsecond of the card's rates (chip_smoke.py phase 6 prints the bounds
// beside the chain floor, each piece timed by falign_chain_probe_kernel).
// The design shortens that chain and takes the launches out of it:
// * One launch a chunk, one thread-block cluster a lane (C blocks of 512
//   threads, C = 16; falign_common.cuh). Lanes are independent: no
//   grid-wide barrier. An iteration linearises the lane's pairs in groups
//   of up to kPairGroup (one group for falign_pairs' two pairs) and
//   synchronises the cluster twice a group: after block 0 publishes
//   whether the lane runs and the group's pair constants, and after the
//   linearisation (block 0 then adds the blocks' sums in rank order
//   through distributed shared memory and into the trial's H, g and cost).
//   Every block reads block 0's run flag after the same barrier, so all
//   leave the loop together; a last barrier keeps each block's shared
//   memory alive while another may read it.
// * Propose in block 0. For D <= 32 one warp: lane i holds row i of the
//   damped system in registers (D = 9, 18 or 27, a template constant); the
//   factor is Cholesky's without square roots (L diag(d) L^T),
//   right-looking, column by column, the pivot broadcast by shuffle and the
//   trailing update spread over the rows; both triangular solves the same
//   way (no block barrier in the factor or the solves). For D > 32
//   (falign() over many frames) a right-looking block-wide factor and
//   solves in shared memory, one row a thread. ok = every pivot > 0 and
//   every factor entry finite; the identity where not ok. U's column sums
//   are computed once a launch, U^T U's entries from U (K, a row per
//   connected component of the pair graph, is small).
// * The pair constants, once an iteration, one warp's lane 0 a pair in
//   block 0; the other blocks copy them through distributed shared memory.
// * Accept in block 0: the lane's H, g and cost from its pairs' sums (pair
//   by pair, in order), the trial's gauge term over a warp, the decision,
//   lam, done and the next state.
// * Shared memory grows with D^2, not with the pairs: the damped system
//   (D (D + 1) floats) and a group's linearise (its staged tile, sums and
//   constants) take one region in turn; for D <= 32 block 0 also keeps H
//   and the trial's H, above they live in global memory (the lane's output
//   and a work buffer). A fully connected lane of 26 frames (650 pairs)
//   fits an H100's 227 KB a block.
// No float atomics: two launches on the same inputs are bitwise equal, and
// a chunk of n iterations is bitwise equal to n chunks of one.
//
// Not used, and why: the tensor cores (the Gram sums must stay float32
// within 1e-4 of the plain version's; TF32 keeps about three digits); TMA
// (the tar-side taps are data-dependent gathers, which TMA does not do).
//
// Numerics: lm_body's operation order where it is a formula (torch
// evaluates left to right, one rounding per operation), IEEE division and
// square root, --fmad=false, comparisons against float32 constants as
// torch makes them. The factorisation, the solves and the sums run in
// another order than LAPACK's and torch's, so steps agree with the plain
// version's to rounding.

#include "falign_common.cuh"

namespace falign {

constexpr unsigned kFull = 0xffffffffu;

struct State {
  const float* params;        // (L, N, 9)
  const float* lam;           // (L,)
  const float* cost;          // (L,)
  const float* H;             // (L, D, D)
  const float* g;             // (L, D)
  const int* it;              // (L,)
  const unsigned char* done;  // (L,) bool
  const float* w2;            // (L,)
};

struct StateOut {
  float* params;
  float* lam;
  float* cost;
  float* H;
  float* g;
  int* it;
  unsigned char* done;
  float* w2;
};

struct ChunkArgs {
  Maps m;
  const long long* lanes;  // (L,) map row of frame j of lane l: lanes[l] * N + j
  const long long* pairs;  // (np, 2) local frame indices
  const float* dim_mask;   // (N, 9)
  const float* U;          // (K, D) gauge rows
  const int* it_end;       // (L,) or null
  int N, np, K, n;
  State s;
  StateOut o;
  float* work;               // (L, D, D) the trial's H for D > 32, or null
  float* step_out;           // (L, D) each lane's last masked step, or null
  unsigned long long* prof;  // (L, kPhases + 1) block 0's phase times, or null
};

// Block 0's phases of an iteration, timed when ChunkArgs::prof is given
// (chip_smoke.py phase 6): thread 0 adds the nanoseconds since the last
// mark, each taken after a block barrier.
enum Phase { kSetup, kFactor, kStep, kConsts, kBarrierA, kLinearize, kBarrierB, kReduce,
             kAccept, kPhases };

struct PhaseTimer {
  unsigned long long last, acc[kPhases];
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mark(PhaseTimer* tm, int phase) {
  if (tm != nullptr && tid_x() == 0) {
    const unsigned long long now = global_ns();
    if (phase >= 0) tm->acc[phase] += now - tm->last;
    tm->last = now;
  }
}

// Block 0's scalars of the lane.
struct Scalars {
  int run, fail, ok, accept, it, it_end, done;
  float lam, cost, w2, nscale, pred, cur, step_inf, tcost;
};

constexpr int kPairGroup = 16;  // pairs linearised between two cluster barriers

__host__ __device__ constexpr int pair_group(int np) { return np < kPairGroup ? np : kPairGroup; }

// Floats of the region that the proposal's damped system M (D rows of
// stride D + 1) and, after the proposal, the cluster linearise of a group
// of pairs (its tile, sums and constants) take in turn.
__host__ __device__ constexpr int region_floats(int N, int np) {
  return round4((9 * N) * (9 * N + 1) > lin_smem_floats(pair_group(np), kGram)
                    ? (9 * N) * (9 * N + 1)
                    : lin_smem_floats(pair_group(np), kGram));
}

// Floats of a block's dynamic shared memory: the region, the lane's ten
// vectors, its gauge rows U and their sums at params, and for D <= 32 its
// H, the trial's and U^T U (above, H and the trial's live in global memory
// and U^T U's entries are formed from U where they are used).
__host__ __device__ constexpr int chunk_smem_floats(int N, int K, int np) {
  return region_floats(N, np) + 10 * (9 * N) + K * (9 * N) + K
         + (9 * N <= 32 ? 3 * (9 * N) * (9 * N) : 0);
}

// The lane's vectors and matrices (D = 9N; M's rows have stride D + 1):
// two base pointers into block 0's shared memory and offsets from them, so
// that the derived pointers need not stay live in registers.
struct Lane {
  int D, K, np, G;  // G: pairs a group
  float* r;         // the region: M, or the linearise's tile, sums and constants
  float* v;         // P, T, g, gt, gg, dg, y, uany, mask, xs (D each), U (K x D),
                    // its sums at params (K), and for D <= 32 H, Ht, U^T U (D x D each)
  // D > 32: H and the trial's in global memory (the lane's output H and its
  // work rows). Apart from H() and Ht(), so that the compiler knows each
  // pointer's address space (with_h).
  float *Hg, *Htg;
  int* pairs;  // the group's pairs (2 G ints, shared)
  float* sout;  // the lane's row of ChunkArgs::step_out, or null
  __device__ __forceinline__ int S() const { return D + 1; }
  __device__ __forceinline__ float* M() const { return r; }
  __device__ __forceinline__ float* Vt() const { return r; }
  __device__ __forceinline__ float* part() const { return r + kThreads * kVRow; }
  __device__ __forceinline__ PairConsts* cst() const {
    return reinterpret_cast<PairConsts*>(r + kThreads * kVRow + round4(G * kGram));
  }
  __device__ __forceinline__ float* P() const { return v; }
  __device__ __forceinline__ float* T() const { return v + D; }
  __device__ __forceinline__ float* g() const { return v + 2 * D; }
  __device__ __forceinline__ float* gt() const { return v + 3 * D; }
  __device__ __forceinline__ float* gg() const { return v + 4 * D; }
  __device__ __forceinline__ float* dg() const { return v + 5 * D; }
  __device__ __forceinline__ float* y() const { return v + 6 * D; }
  __device__ __forceinline__ float* uany() const { return v + 7 * D; }
  __device__ __forceinline__ float* mask() const { return v + 8 * D; }
  __device__ __forceinline__ float* xs() const { return v + 9 * D; }
  __device__ __forceinline__ float* U() const { return v + 10 * D; }
  __device__ __forceinline__ float* ssum() const { return v + (10 + K) * D; }
  __device__ __forceinline__ float* H() const { return v + (10 + K) * D + K; }
  __device__ __forceinline__ float* Ht() const { return H() + D * D; }
  __device__ __forceinline__ float* UtU() const { return H() + 2 * D * D; }
};

__device__ Lane carve(float* f, int* pairs, int N, int K, int np, float* H_glob, float* Ht_glob) {
  Lane z;
  z.D = 9 * N;
  z.K = K;
  z.np = np;
  z.G = pair_group(np);
  z.r = f;
  z.v = f + region_floats(N, np);
  z.Hg = H_glob;
  z.Htg = Ht_glob;
  z.pairs = pairs;
  z.sout = nullptr;
  return z;
}

// f(H, Ht) on the lane's H and trial H, shared or global (Lane).
template <class F>
__device__ __forceinline__ void with_h(const Lane& z, F f) {
  if (z.D <= 32)
    f(z.H(), z.Ht());
  else
    f(z.Hg, z.Htg);
}

// (U^T U)[i][j], summed over the gauge rows in order
__device__ __forceinline__ float utu(const float* U, int K, int D, int i, int j) {
  float u = 0.0f;
  for (int k = 0; k < K; ++k) u = u + U[k * D + i] * U[k * D + j];
  return u;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float warp_nan_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One warp: the sum over d < D of f(d), lane-strided, then a fixed butterfly
// (every lane gets the same bits).
template <class F>
__device__ __forceinline__ float lane_sum(int D, F f) {
  float v = 0.0f;
  for (int d = (tid_x() & 31); d < D; d += 32) v = v + f(d);
  return warp_sum(v);
}

// packed index of Gram entry (a, b) of the 19 x 19 matrix, a <= b row-major
__device__ __forceinline__ int gidx(int a, int b) {
  if (a > b) {
    const int t = a;
    a = b;
    b = t;
  }
  return a * kCols - (a * (a - 1)) / 2 + (b - a);
}

// Block 0, every thread: the lane's state, U, and the gauge sums that stay
// fixed for the launch (U's column sums, max(sum U, 1)).
__device__ void load_lane(const ChunkArgs& a, int l, Lane& z, Scalars& sc) {
  const int tid = tid_x(), D = z.D, K = z.K;
  const float* P = a.s.params + (long long)l * D;
  const float* H = a.s.H + (long long)l * D * D;
  const float* g = a.s.g + (long long)l * D;
  for (int d = tid; d < D; d += kThreads) {
    z.P()[d] = P[d];
    z.g()[d] = g[d];
    z.mask()[d] = a.dim_mask[d];
    float u = 0.0f;
    for (int k = 0; k < K; ++k) u = u + a.U[k * D + d];
    z.uany()[d] = u;
  }
  for (int e = tid; e < K * D; e += kThreads) z.U()[e] = a.U[e];
  for (int e = tid; e < 2 * z.G; e += kThreads) z.pairs[e] = (int)a.pairs[e];
  with_h(z, [&](float* Hz, float*) {
    for (int e = tid; e < D * D; e += kThreads) Hz[e] = H[e];
  });
  if (D <= 32)
    for (int e = tid; e < D * D; e += kThreads) z.UtU()[e] = utu(a.U, K, D, e / D, e % D);
  if (tid == 0) {
    sc.lam = a.s.lam[l];
    sc.cost = a.s.cost[l];
    sc.w2 = a.s.w2[l];
    sc.it = a.s.it[l];
    sc.done = a.s.done[l] != 0 ? 1 : 0;
    int end = sc.it + a.n;
    if (a.it_end != nullptr && a.it_end[l] < end) end = a.it_end[l];
    sc.it_end = end;
    float tot = 0.0f;
    for (int e = 0; e < K * D; ++e) tot = tot + a.U[e];
    sc.nscale = clamp_min_nan(tot, 1.0f);
  }
  __syncthreads();
}

// Block 0, every thread: the state written out.
__device__ void store_lane(const ChunkArgs& a, int l, const Lane& z, const Scalars& sc) {
  const int tid = tid_x(), D = z.D;
  float* P = a.o.params + (long long)l * D;
  float* H = a.o.H + (long long)l * D * D;
  float* g = a.o.g + (long long)l * D;
  for (int d = tid; d < D; d += kThreads) {
    P[d] = z.P()[d];
    g[d] = z.g()[d];
  }
  if (D <= 32)  // above, H is the output already
    for (int e = tid; e < D * D; e += kThreads) H[e] = z.H()[e];
  if (tid == 0) {
    a.o.lam[l] = sc.lam;
    a.o.cost[l] = sc.cost;
    a.o.w2[l] = sc.w2;
    a.o.it[l] = sc.it;
    a.o.done[l] = sc.done ? 1 : 0;
  }
}

// Warp 0, D = DN <= 32 (9, 18 or 27), after propose_gauge: lane i builds
// row i of the damped system in registers (every index a constant) and
// factors it without square roots, M = L diag(d) L^T with L unit lower,
// right-looking: column j's entries below the pivot d_j are shuffled
// unscaled for the trailing update while each row divides out its own
// multiplier, so a column's chain is one shuffle, one division and one
// update. L y = gg is solved along, then L^T step = y / d; the step into
// z.y(); the identity factor where not ok (a pivot not > 0 or an entry not
// finite). Straight-line code: no branch around the shuffles, the failed
// case computed and dropped. The factor's rows go through M for the second
// solve's columns.
template <int DN>
__device__ void factor_solve_rows(Lane& z, Scalars& sc, float w2) {
  const int i = (tid_x() & 31), S = z.S(), K = z.K;
  const float* U = z.U();
  const bool own = i < DN;
  const int ri = own ? i : 0;
  const float lam = sc.lam;
  float r[DN];
#pragma unroll
  for (int k = 0; k < DN; ++k) r[k] = z.H()[ri * DN + k] + w2 * z.UtU()[ri * DN + k];
  float gu = 0.0f;
  for (int k = 0; k < K; ++k) gu = gu + z.ssum()[k] * U[k * DN + ri];
  const float gg = z.g()[ri] + w2 * gu;
  float hg = 0.0f;
#pragma unroll
  for (int k = 0; k < DN; ++k) hg = k == ri ? r[k] : hg;
  const float dg = clamp_min_nan(hg, 1e-8f);
  const float damped = hg + (lam * dg + (1.0f - z.mask()[ri]));
#pragma unroll
  for (int k = 0; k < DN; ++k) r[k] = k == ri ? damped : r[k];
  if (own) {
    z.gg()[i] = gg;
    z.dg()[i] = dg;
  }
  bool fail = false;
  float dii = 1.0f;
  float x = own ? gg : 0.0f;
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    const float dj = __shfl_sync(kFull, r[j], j);
    fail = fail || !(dj > 0.0f);  // the same on every lane
    const bool below = own && i > j;
    const float v = below ? r[j] : 0.0f;  // below the pivot, unscaled
    const float t = v / dj;               // L[i][j]
    dii = i == j ? dj : dii;
    r[j] = below ? t : r[j];
#pragma unroll
    for (int k = j + 1; k < DN; ++k) {
      const float vk = __shfl_sync(kFull, v, k);
      r[k] = (own && i >= k) ? r[k] - t * vk : r[k];
    }
    const float yj = __shfl_sync(kFull, x, j);
    x = below ? x - t * yj : x;
  }
  bool bad = fail;
#pragma unroll
  for (int k = 0; k < DN; ++k) bad = bad || (own && k <= i && !isfinite(r[k]));
  const bool ok = !__any_sync(kFull, bad);
  float* row = z.M() + ri * S;
  if (own) {
#pragma unroll
    for (int k = 0; k < DN; ++k) row[k] = r[k];
  }
  __syncwarp();  // the rows' writes, before each lane reads its column
  float c[DN];   // column i of L: c[j] = L[j][i]
#pragma unroll
  for (int j = 0; j < DN; ++j) c[j] = z.M()[j * S + ri];
  x = x / dii;
#pragma unroll
  for (int j = DN - 1; j >= 0; --j) {  // L^T step = y / d
    const float sj = __shfl_sync(kFull, x, j);
    x = (own && i < j) ? x - c[j] * sj : x;
  }
  if (own) z.y()[i] = ok ? x : gg;  // the identity factor where not ok
  if (i == 0) sc.ok = ok ? 1 : 0;
}

__device__ void factor_solve_warp(Lane& z, Scalars& sc, float w2) {
  if (z.D == 9)
    factor_solve_rows<9>(z, sc, w2);
  else if (z.D == 18)
    factor_solve_rows<18>(z, sc, w2);
  else
    factor_solve_rows<27>(z, sc, w2);
}

// Block 0, every thread (D > 32): the same, block-wide in shared memory,
// one row a thread; the pivot's square root on thread 0.
__device__ void factor_solve_block(Lane& z, Scalars& sc) {
  const int tid = tid_x(), D = z.D, S = z.S();
  for (int j = 0; j < D; ++j) {
    if (tid == 0) {
      const float d = z.M()[j * S + j];
      if (!(d > 0.0f))
        sc.fail = 1;
      else
        z.M()[j * S + j] = sqrtf(d);
    }
    __syncthreads();
    if (sc.fail) break;
    const float ljj = z.M()[j * S + j];
    for (int i = j + 1 + tid; i < D; i += kThreads) z.M()[i * S + j] = z.M()[i * S + j] / ljj;
    __syncthreads();
    const int n = D - j - 1;
    for (int e = tid; e < n * n; e += kThreads) {
      const int i = j + 1 + e / n, k = j + 1 + e % n;
      if (k <= i) z.M()[i * S + k] = z.M()[i * S + k] - z.M()[i * S + j] * z.M()[k * S + j];
    }
    __syncthreads();
  }
  if (!sc.fail) {
    for (int e = tid; e < D * D; e += kThreads) {
      const int i = e / D, k = e - i * D;
      if (k <= i && !isfinite(z.M()[i * S + k])) sc.fail = 1;
    }
  }
  __syncthreads();
  const bool ok = sc.fail == 0;
  if (ok) {
    for (int d = tid; d < D; d += kThreads) z.xs()[d] = z.gg()[d];
    __syncthreads();
    for (int j = 0; j < D; ++j) {  // L y = gg
      const float yj = z.xs()[j] / z.M()[j * S + j];
      if (tid == 0) z.y()[j] = yj;
      for (int i = j + 1 + tid; i < D; i += kThreads) z.xs()[i] = z.xs()[i] - z.M()[i * S + j] * yj;
      __syncthreads();
    }
    for (int d = tid; d < D; d += kThreads) z.xs()[d] = z.y()[d];
    __syncthreads();
    for (int j = D - 1; j >= 0; --j) {  // L^T step = y
      const float sj = z.xs()[j] / z.M()[j * S + j];
      if (tid == 0) z.y()[j] = sj;
      for (int i = tid; i < j; i += kThreads) z.xs()[i] = z.xs()[i] - z.M()[j * S + i] * sj;
      __syncthreads();
    }
  } else {
    for (int d = tid; d < D; d += kThreads) z.y()[d] = z.gg()[d];
  }
  if (tid == 0) sc.ok = ok ? 1 : 0;
  __syncthreads();
}

// Warp 0: w2 (derived from the carried H when it is 0) and the gauge sums
// at params; returns w2, the next state's whether or not the step is taken.
__device__ float propose_gauge(Lane& z, Scalars& sc) {
  const int lane = tid_x() & 31, D = z.D, K = z.K;
  float w2 = sc.w2;
  if (!(w2 > 0.0f))  // derive from the carried Hessian's scale dims
    with_h(z, [&](float* Hz, float*) {
      w2 = lane_sum(D, [&](int d) { return Hz[d * D + d] * z.uany()[d]; }) / sc.nscale;
    });
  for (int k = 0; k < K; ++k) {
    const float s = lane_sum(D, [&](int d) { return z.P()[d] * z.U()[k * D + d]; });
    if (lane == 0) z.ssum()[k] = s;
  }
  __syncwarp();
  if (lane == 0) {
    sc.w2 = w2;
    sc.fail = 0;
  }
  return w2;
}

// Warp 0, after the solve: the masked step, the trial (z.T()), the model's
// predicted drop, the gauge-adjusted current cost, the step's largest entry.
__device__ void propose_step(Lane& z, Scalars& sc, float w2) {
  const int lane = tid_x() & 31, D = z.D, K = z.K;
  const float lam = sc.lam;
  float s1 = 0.0f, s2 = 0.0f, inf = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float sm = z.y()[d] * z.mask()[d];
    if (z.sout != nullptr) z.sout[d] = sm;
    z.T()[d] = z.P()[d] - sm;
    s1 = s1 + sm * ((lam * z.dg()[d]) * sm);
    s2 = s2 + sm * z.gg()[d];
    inf = nan_max(inf, fabsf(sm));
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  inf = warp_nan_max(inf);
  if (lane == 0) {
    float gsq = 0.0f;
    for (int k = 0; k < K; ++k) gsq = gsq + z.ssum()[k] * z.ssum()[k];
    sc.pred = 0.5f * (s1 + s2);
    sc.cur = sc.cost + (0.5f * w2) * gsq;
    sc.step_inf = inf;
  }
}

// Block 0, every thread: the proposal (lm_propose_reference): w2, the
// gauge-regularised damped system, its solve, the step and the trial. For
// D <= 32 all on warp 0 (the others wait at the closing barrier); above, the
// system and its factor in shared memory, block-wide.
__device__ void propose(Lane& z, Scalars& sc, PhaseTimer* tm) {
  const int tid = tid_x(), warp = tid >> 5;
  const int D = z.D, S = z.S(), K = z.K;
  if (D <= 32) {
    if (warp == 0) {
      const float w2 = propose_gauge(z, sc);
      __syncwarp();
      mark(tm, kSetup);
      factor_solve_warp(z, sc, w2);
      __syncwarp();
      mark(tm, kFactor);
      propose_step(z, sc, w2);
    }
    __syncthreads();
    mark(tm, kStep);
    return;
  }
  if (warp == 0) propose_gauge(z, sc);
  __syncthreads();
  const float w2 = sc.w2, lam = sc.lam;
  for (int e = tid; e < D * D; e += kThreads) {
    const int i = e / D, j = e - i * D;
    z.M()[i * S + j] = z.Hg[e] + w2 * utu(z.U(), K, D, i, j);
  }
  for (int d = tid; d < D; d += kThreads) {
    float gu = 0.0f;
    for (int k = 0; k < K; ++k) gu = gu + z.ssum()[k] * z.U()[k * D + d];
    z.gg()[d] = z.g()[d] + w2 * gu;
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    const float hg = z.M()[d * S + d];
    const float dg = clamp_min_nan(hg, 1e-8f);
    z.dg()[d] = dg;
    z.M()[d * S + d] = hg + (lam * dg + (1.0f - z.mask()[d]));
  }
  __syncthreads();
  mark(tm, kSetup);
  factor_solve_block(z, sc);
  mark(tm, kFactor);
  if (warp == 0) propose_step(z, sc, w2);
  __syncthreads();
  mark(tm, kStep);
}

// Block 0, every thread, before a lane's first group: the trial's H, g
// and cost start from zero.
__device__ void accept_begin(Lane& z, Scalars& sc) {
  const int tid = tid_x(), D = z.D;
  with_h(z, [&](float*, float* Ht) {
    for (int e = tid; e < D * D; e += kThreads) Ht[e] = 0.0f;
  });
  for (int d = tid; d < D; d += kThreads) z.gt()[d] = 0.0f;
  if (tid == 0) sc.tcost = 0.0f;
}

// Block 0, every thread: G holds the sums of the group's gn pairs
// (z.pairs; gn x 190), added into the trial's H, g and cost pair by pair, in pair
// order (a pair adds to each entry at most once: its four 9 x 9 blocks and
// two 9-vectors are distinct).
__device__ void accept_group(Lane& z, Scalars& sc, const float* G, int gn) {
  const int tid = tid_x(), D = z.D;
  for (int q = 0; q < gn; ++q) {
    const float* Gp = G + q * kGram;
    const int fr = z.pairs[2 * q], ft = z.pairs[2 * q + 1];
    if (tid < 4 * 81) {
      const int blk = tid / 81, i = (tid - blk * 81) / 9, j = tid % 9;
      const int fa = blk < 2 ? fr : ft, fb = (blk & 1) ? ft : fr;
      const int k = blk == 0   ? gidx(1 + i, 1 + j)    // Jr^T Jr
                    : blk == 1 ? gidx(1 + i, 10 + j)   // Jr^T Jt
                    : blk == 2 ? gidx(1 + j, 10 + i)   // (Jr^T Jt)^T
                               : gidx(10 + i, 10 + j); // Jt^T Jt
      with_h(z, [&](float*, float* Ht) {
        float* h = Ht + (fa * 9 + i) * D + fb * 9 + j;
        *h = *h + Gp[k];
      });
    } else if (tid < 4 * 81 + 18) {
      const int i = tid - 4 * 81, f = i < 9 ? fr : ft;
      float* gt = z.gt() + f * 9 + (i < 9 ? i : i - 9);
      *gt = *gt + Gp[gidx(0, 1 + i)];
    } else if (tid == 4 * 81 + 18) {
      sc.tcost = sc.tcost + 0.5f * Gp[0];
    }
    __syncthreads();
  }
}

// Block 0, every thread, after the last group: the trial's cost with the
// gauge term, the decision, lam, it, done and the next state
// (lm_accept_reference).
__device__ void accept_decide(Lane& z, Scalars& sc) {
  const int tid = tid_x(), warp = tid >> 5, lane = tid & 31;
  const int D = z.D, K = z.K;
  if (warp == 0) {
    float gsq = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float s = lane_sum(D, [&](int d) { return z.T()[d] * z.U()[k * D + d]; });
      gsq = gsq + s * s;
    }
    if (lane == 0) {
      const float trial_cost = sc.tcost;
      const float w2 = sc.w2, pred = sc.pred, cur_cost = sc.cur, step_inf = sc.step_inf;
      const float new_cost = trial_cost + (0.5f * w2) * gsq;
      const bool acc = sc.ok != 0 && isfinite(new_cost) && (new_cost < cur_cost);
      const float rho = (cur_cost - new_cost) / clamp_min_nan(pred, 1e-30f);
      const float t = 2.0f * rho - 1.0f;
      const float dec = clamp_max_nan(clamp_min_nan(1.0f - (t * t) * t, 1.0f / 3.0f), 1.0f);
      const float lam0 = sc.lam;
      const float lam = acc ? clamp_min_nan(lam0 * dec, 1e-7f) : lam0 * 4.0f;
      const float rel_drop = (cur_cost - new_cost) / clamp_min_nan(cur_cost, 1e-30f);
      const bool done = (acc && rel_drop < 1e-5f) || (acc && step_inf < 1e-4f)
                        || (!acc && step_inf < 3e-5f) || (lam > 1e6f);
      sc.lam = lam;
      if (acc) sc.cost = trial_cost;
      sc.it = sc.it + 1;
      sc.done = done ? 1 : 0;
      sc.accept = acc ? 1 : 0;
    }
  }
  __syncthreads();
  if (sc.accept) {
    for (int d = tid; d < D; d += kThreads) {
      z.P()[d] = z.T()[d];
      z.g()[d] = z.gt()[d];
    }
    with_h(z, [&](float* Hz, float* Ht) {
      for (int e = tid; e < D * D; e += kThreads) Hz[e] = Ht[e];
    });
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) falign_lm_chunk_kernel(ChunkArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int l = (int)blockIdx.x / C;
  const int tid = tid_x(), D = 9 * a.N, G = pair_group(a.np);
  extern __shared__ float4 smem4[];
  __shared__ Scalars sc;
  __shared__ PhaseTimer timer;
  PhaseTimer* tm = (a.prof != nullptr && rank == 0) ? &timer : nullptr;
  if (tm != nullptr && tid == 0)
    for (int k = 0; k < kPhases; ++k) timer.acc[k] = 0;
  __shared__ int gpairs[2 * kPairGroup];
  Lane z = carve(reinterpret_cast<float*>(smem4), gpairs, a.N, a.K, a.np,
                 a.o.H + (long long)l * D * D,
                 a.work == nullptr ? nullptr : a.work + (long long)l * D * D);
  if (a.step_out != nullptr) z.sout = a.step_out + (long long)l * D;
  if (rank == 0) load_lane(a, l, z, sc);
  const int it0 = rank == 0 ? sc.it : 0;
  int run = 1;
  while (run) {
    if (rank == 0) {
      if (tid == 0) sc.run = (sc.it < sc.it_end && !sc.done) ? 1 : 0;
      __syncthreads();
      mark(tm, -1);
      if (sc.run) {
        propose(z, sc, tm);
        accept_begin(z, sc);
      }
    }
    for (int g0 = 0; g0 < a.np; g0 += G) {
      const int gn = a.np - g0 < G ? a.np - g0 : G;
      if (rank == 0 && sc.run) {
        if (a.np > G) {  // the group's pairs (one group: loaded once, by load_lane)
          if (tid < 2 * gn) z.pairs[tid] = (int)a.pairs[2 * g0 + tid];
          __syncthreads();
        }
        const long long base = __ldg(a.lanes + l) * a.N;
        for (int q = tid >> 5; q < gn; q += kThreads / 32) {  // a warp's lane 0 a pair
          const int fr = z.pairs[2 * q], ft = z.pairs[2 * q + 1];
          if ((tid & 31) == 0)
            make_consts(z.T() + fr * 9, z.T() + ft * 9, z.mask() + fr * 9, z.mask() + ft * 9,
                        base + fr, base + ft, z.cst()[q]);
        }
        if (tm != nullptr) __syncthreads();
        mark(tm, kConsts);
      }
      cluster.sync();  // A: the run flag and the group's pair constants are published
      run = rank == 0 ? sc.run : *cluster.map_shared_rank(&sc.run, 0);
      if (!run) break;
      mark(tm, kBarrierA);
      if (rank != 0) fetch_consts(z.cst(), gn);
      cta_linearize<false>(a.m, z.cst(), gn, rank, C, z.Vt(), z.part());
      mark(tm, kLinearize);
      cluster.sync();  // B: every block's part is complete
      mark(tm, kBarrierB);
      if (rank == 0) {
        reduce_ranks(z.part(), gn * kGram, C, z.part());
        __syncthreads();
        mark(tm, kReduce);
        accept_group(z, sc, z.part(), gn);
        mark(tm, kAccept);
      }
    }
    if (run && rank == 0) {
      accept_decide(z, sc);
      mark(tm, kAccept);
    }
  }
  cluster.sync();  // no block leaves while another may read its shared memory
  if (rank == 0) store_lane(a, l, z, sc);
  if (tm != nullptr && tid == 0) {
    unsigned long long* out = a.prof + (long long)l * (kPhases + 1);
    for (int k = 0; k < kPhases; ++k) out[k] = timer.acc[k];
    out[kPhases] = (unsigned long long)(sc.it - it0);
  }
}

// ---------------------------------------------------------------------------
// The chain floor's pieces, each repeated n times (chip_smoke.py phase 6):
// 0: one warp's factor and two solves of a D = 9N SPD system (the system
//    rebuilt from its formula each time); 1: one pair's constants on one
//    thread; 2: one pixel's evaluation on one thread (each pixel's index
//    depends on the last result); 3: one staged tile's Gram sums by a block
//    (and its barrier); 4: block 0 adding a group's sums (190 a pair) of C
//    blocks in rank order; 5: a barrier of a cluster of C blocks.

struct ProbeArgs {
  Maps m;
  const float* params;     // lane 0's (N, 9)
  const long long* pairs;  // pair 0 is probed
  const float* dim_mask;
  int N, np, which, n, zero;
  float* out;
};

__global__ void __launch_bounds__(kThreads, 1) falign_chain_probe_kernel(ProbeArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = tid_x(), warp = tid >> 5, lane = tid & 31;
  extern __shared__ float4 smem4[];
  __shared__ Scalars sc;
  __shared__ int gpairs[2 * kPairGroup];
  Lane z = carve(reinterpret_cast<float*>(smem4), gpairs, a.N, 0, a.np, nullptr, nullptr);
  PairConsts* cst = z.cst();
  float *Vt = z.Vt(), *part = z.part();
  const int fr = (int)a.pairs[0], ft = (int)a.pairs[1];
  if (a.which == 0) {
    const int D = z.D;
    for (int e = tid; e < D * D; e += kThreads) z.UtU()[e] = 0.0f;
    for (int d = tid; d < D; d += kThreads) {
      z.g()[d] = 1.0f;
      z.mask()[d] = 1.0f;
    }
    if (tid == 0) sc.lam = 0.0f;
    __syncthreads();
    float acc = 0.0f;
    for (int rep = 0; rep < a.n; ++rep) {
      if (warp == 0) {
        const float dep = acc * (float)a.zero;
        if (lane < D) {
          for (int j = 0; j < D; ++j)
            z.H()[lane * D + j] = (lane == j ? (float)(D + 1) : 0.015625f * (float)((lane * j) % 7)) + dep;
        }
        __syncwarp();
        factor_solve_warp(z, sc, 0.0f);
        __syncwarp();
        acc = acc + z.y()[0];
      }
    }
    if (tid == 0) a.out[0] = acc;
  } else if (a.which == 1) {
    if (tid == 0) {
      PairConsts& c = cst[0];
      float q[9];
      for (int i = 0; i < 9; ++i) q[i] = a.params[fr * 9 + i];
      for (int rep = 0; rep < a.n; ++rep) {
        make_consts(q, a.params + ft * 9, a.dim_mask + fr * 9, a.dim_mask + ft * 9, fr, ft, c);
        q[0] = q[0] + c.A[0][0] * (float)a.zero;
      }
      a.out[0] = c.A[0][0];
    }
  } else if (a.which == 2) {
    if (tid == 0) {
      PairConsts& c = cst[0];
      make_consts(a.params + fr * 9, a.params + ft * 9, a.dim_mask + fr * 9,
                  a.dim_mask + ft * 9, fr, ft, c);
      const int hs = (a.m.h + a.m.stride - 1) / a.m.stride;
      const int ws = (a.m.w + a.m.stride - 1) / a.m.stride;
      int pix = (hs / 2) * ws + ws / 2;
      float acc = 0.0f;
      for (int rep = 0; rep < a.n; ++rep) {
        float v[kCols];
        eval_grads(a.m, c, pix / ws, pix % ws, v);
        acc = acc + v[0];
        pix = (pix + 7919 + (__float_as_int(v[0]) & a.zero)) % (hs * ws);
      }
      a.out[0] = acc;
    }
  } else if (a.which == 3) {
    for (int k = 0; k < kVRow; ++k) Vt[tid * kVRow + k] = 1.0f / (float)(1 + tid + k);
    __syncthreads();
    float acc[16];
    for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
    int I = 0, J = 0;
    if (warp < kGramBlocks) gram_block(warp, I, J);
    for (int rep = 0; rep < a.n; ++rep) {
      if (warp < kGramBlocks) gram_tile(Vt, I, J, lane, acc);
      __syncthreads();
    }
    float s = 0.0f;
    for (int e = 0; e < 16; ++e) s = s + acc[e];
    if (tid == 0) a.out[0] = s;
  } else if (a.which == 4) {
    const int n = pair_group(a.np) * kGram;
    for (int e = tid; e < n; e += kThreads) part[e] = (float)(rank + e);
    cluster.sync();
    if (rank == 0) {
      for (int rep = 0; rep < a.n; ++rep) {
        reduce_ranks(part, n, C, Vt);
        __syncthreads();
      }
      if (tid == 0) a.out[0] = Vt[0];
    }
    cluster.sync();
  } else {
    for (int rep = 0; rep < a.n; ++rep) cluster.sync();
    if (tid == 0 && rank == 0) a.out[0] = (float)C;
  }
}

}  // namespace falign

using namespace falign;

// What a block of the chunk kernel may take of dynamic shared memory on the
// current device (device: its index): the opt-in limit less the kernel's
// static shared memory.
extern "C" int falign_lm_smem_limit(int device, int* out) {
  int optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, (const void*)falign_lm_chunk_kernel);
  *out = optin - (int)fa.sharedSizeBytes;
  return (int)e;
}

extern "C" int falign_lm_max_clusters(int N, int K, int np, int cluster, int* out) {
  const size_t bytes = 4 * (size_t)chunk_smem_floats(N, K, np);
  return max_clusters(falign_lm_chunk_kernel, cluster, bytes, out);
}

extern "C" int falign_lm_chunk_launch(
    const float* packed, const float* weights, int F, int h, int w, const long long* lanes,
    const long long* pairs, const float* dim_mask, const float* U, int K, const int* it_end,
    int L, int N, int np, int n, int stride, int use_photo, float fx, float fy, float cx, float cy,
    float vbf, float crw, const float* params, const float* lam, const float* cost,
    const float* H, const float* g, const int* it, const unsigned char* done, const float* w2,
    float* params_o, float* lam_o, float* cost_o, float* H_o, float* g_o, int* it_o,
    unsigned char* done_o, float* w2_o, float* work, float* step_out, unsigned long long* prof,
    int cluster, void* stream) {
  if (F < 1 || h < 2 || w < 2 || L < 1 || N < 1 || np < 1 || K < 0 || n < 0 || stride < 1
      || (9 * N > 32 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  ChunkArgs a{Maps{packed, weights, h, w, stride, use_photo, fx, fy, cx, cy, vbf, crw, 1.0f},
              lanes, pairs, dim_mask, U, it_end, N, np, K, n,
              State{params, lam, cost, H, g, it, done, w2},
              StateOut{params_o, lam_o, cost_o, H_o, g_o, it_o, done_o, w2_o}, work, step_out,
              prof};
  return launch_cluster(falign_lm_chunk_kernel, a, L, cluster,
                        4 * (size_t)chunk_smem_floats(N, K, np), (cudaStream_t)stream);
}

extern "C" int falign_chain_probe_launch(const float* packed, const float* weights, int h, int w,
                                         int stride, int use_photo, float fx, float fy, float cx,
                                         float cy, float vbf, float crw, const float* params,
                                         const long long* pairs, const float* dim_mask, int N,
                                         int np, int which, int n, int cluster, float* out,
                                         void* stream) {
  if (which < 0 || which > 5 || n < 0 || N < 1 || np < 1 || (which == 0 && 9 * N > 32))
    return (int)cudaErrorInvalidValue;
  ProbeArgs a{Maps{packed, weights, h, w, stride, use_photo, fx, fy, cx, cy, vbf, crw, 1.0f},
              params, pairs, dim_mask, N, np, which, n, 0, out};
  const cudaError_t e = prepare_cluster(falign_chain_probe_kernel);
  if (e != cudaSuccess) return (int)e;
  return launch_cluster(falign_chain_probe_kernel, a, 1, cluster,
                        4 * (size_t)chunk_smem_floats(N, 0, np), (cudaStream_t)stream);
}
