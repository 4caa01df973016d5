// Frame alignment's damped LM step, per lane, for sm_90a.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel here:
// the body of voldor_tpu/falign/solver.py:184-235 (_make_lm_step: the
// gauge weight, the damped system, its Cholesky solve, the accept decision,
// the gain-ratio damping and the stopping rules) and the freeze of the
// vmapped while_loop of :424-441 (a lane runs while it < it_end and it is
// not done). The port's plain versions are ops/falign_kernels.py:
// lm_propose_reference and lm_accept_reference.
//
// One LM iteration of a batch of lanes is three launches: propose (here),
// the linearise kernel at the trial (falign_linearize.cu), accept (here).
// * propose: per lane, w2 (derived from the carried H when it is 0), the
//   gauge-regularised, damped system in shared memory, its Cholesky factor
//   (one column at a time: the pivot on one thread, the column below it
//   across the block), ok = every pivot > 0 and every entry finite, the
//   identity where not ok, the two triangular solves, the masked step, the
//   trial parameters, the model's predicted drop, the gauge-adjusted
//   current cost and the step's largest entry. An inactive lane writes its
//   current parameters as the trial and active = 0.
// * accept: per lane, the linearise kernel's tile partials of the lane's
//   pairs added in tile order, the pair's Gram blocks placed into the
//   lane's (9N) x (9N) H and 9N g (pair by pair, in order), the trial's
//   cost, then the accept decision, lam and done, and the next state into
//   new tensors: accepted lanes take the trial's parameters, cost, H and g;
//   inactive lanes are copied through unchanged.
//
// What bounds it on the card: latency. D = 18 for falign_pairs (a lane is
// two frames), 9N for falign(); the factorisation is ~D^3 / 6 multiply-adds
// and the state a few KB per lane. One block per lane; H lives in shared
// memory, D at run time. The wrapper (ops/falign_kernels.py) raises before
// launching when a lane's D does not fit the device's shared memory.
//
// Numerics: lm_body's operation order where it is a formula (torch
// evaluates left to right, one rounding per operation), IEEE division and
// square root, --fmad=false, comparisons against float32 constants as
// torch makes them. The factorisation and solves sum in another order than
// LAPACK's, so steps agree with the plain version's to rounding.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGram = 190;
constexpr int kCols = 19;
constexpr int kInfo = 8;  // w2, pred, cur_cost, step_inf, ok, active, 0, 0

__device__ __forceinline__ float clamp_min_nan(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max_nan(float x, float hi) { return x > hi ? hi : x; }

struct State {
  const float* params;  // (L, N, 9)
  const float* lam;     // (L,)
  const float* cost;    // (L,)
  const float* H;       // (L, D, D)
  const float* g;       // (L, D)
  const int* it;        // (L,)
  const unsigned char* done;  // (L,) bool
  const float* w2;      // (L,)
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

// packed index of Gram entry (a, b) of the 19 x 19 matrix, a <= b row-major
__device__ __forceinline__ int gidx(int a, int b) {
  if (a > b) {
    const int t = a;
    a = b;
    b = t;
  }
  return a * kCols - (a * (a - 1)) / 2 + (b - a);
}

__global__ void __launch_bounds__(kThreads) falign_lm_propose_kernel(
    State s, const int* it_end, const float* U, int K, const float* dim_mask, int N, float* trial,
    float* info, int* active) {
  const int l = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int D = 9 * N;
  extern __shared__ float sm[];
  float* M = sm;          // D * D: the damped system, then its factor
  float* gg = M + D * D;  // D
  float* diag = gg + D;   // D
  float* x = diag + D;    // D: the solve
  float* ssum = x + D;    // K: the gauge sums at params
  __shared__ float sh_w2;
  __shared__ int sh_fail;
  const float* P = s.params + (long long)l * D;
  float* tr = trial + (long long)l * D;
  float* pinfo = info + (long long)l * kInfo;
  const bool act = s.it[l] < it_end[l] && !s.done[l];
  if (!act) {
    for (int d = tid; d < D; d += nt) tr[d] = P[d];
    if (tid == 0) {
      for (int k = 0; k < kInfo; ++k) pinfo[k] = 0.0f;
      pinfo[0] = s.w2[l];
      active[l] = 0;
    }
    return;
  }
  const float* Hl = s.H + (long long)l * D * D;
  const float* gl = s.g + (long long)l * D;
  const float lam = s.lam[l];
  if (tid == 0) {
    float tot = 0.0f;  // torch.sum(U)
    for (int e = 0; e < K * D; ++e) tot += U[e];
    const float n_scale = clamp_min_nan(tot, 1.0f);
    float w2 = s.w2[l];
    if (!(w2 > 0.0f)) {  // derive from the carried Hessian's scale dims
      float acc = 0.0f;
      for (int d = 0; d < D; ++d) {
        float ua = 0.0f;
        for (int k = 0; k < K; ++k) ua += U[k * D + d];
        acc += Hl[d * D + d] * ua;
      }
      w2 = acc / n_scale;
    }
    sh_w2 = w2;
    sh_fail = 0;
  }
  for (int k = tid; k < K; k += nt) {
    float acc = 0.0f;
    for (int d = 0; d < D; ++d) acc += P[d] * U[k * D + d];
    ssum[k] = acc;
  }
  __syncthreads();
  const float w2 = sh_w2;
  for (int e = tid; e < D * D; e += nt) {
    const int i = e / D, j = e % D;
    float utu = 0.0f;
    for (int k = 0; k < K; ++k) utu += U[k * D + i] * U[k * D + j];
    M[e] = Hl[e] + w2 * utu;
  }
  for (int d = tid; d < D; d += nt) {
    float gu = 0.0f;
    for (int k = 0; k < K; ++k) gu += ssum[k] * U[k * D + d];
    gg[d] = gl[d] + w2 * gu;
  }
  __syncthreads();
  for (int d = tid; d < D; d += nt) {
    const float hg = M[d * D + d];
    const float dg = clamp_min_nan(hg, 1e-8f);
    diag[d] = dg;
    M[d * D + d] = hg + (lam * dg + (1.0f - dim_mask[d]));
  }
  __syncthreads();
  // Cholesky, lower, in place
  for (int j = 0; j < D; ++j) {
    if (tid == 0) {
      float acc = 0.0f;
      for (int k = 0; k < j; ++k) acc += M[j * D + k] * M[j * D + k];
      const float dj = M[j * D + j] - acc;
      if (!(dj > 0.0f))
        sh_fail = 1;
      else
        M[j * D + j] = sqrtf(dj);
    }
    __syncthreads();
    if (sh_fail) break;
    const float ljj = M[j * D + j];
    for (int i = j + 1 + tid; i < D; i += nt) {
      float acc = 0.0f;
      for (int k = 0; k < j; ++k) acc += M[i * D + k] * M[j * D + k];
      M[i * D + j] = (M[i * D + j] - acc) / ljj;
    }
    __syncthreads();
  }
  if (!sh_fail) {
    for (int e = tid; e < D * D; e += nt) {
      const int i = e / D, j = e % D;
      if (j <= i && !isfinite(M[e])) sh_fail = 1;
    }
  }
  __syncthreads();
  if (tid != 0) return;
  const bool ok = !sh_fail;
  if (ok) {
    for (int i = 0; i < D; ++i) {  // L y = gg
      float acc = 0.0f;
      for (int k = 0; k < i; ++k) acc += M[i * D + k] * x[k];
      x[i] = (gg[i] - acc) / M[i * D + i];
    }
    for (int i = D - 1; i >= 0; --i) {  // L^T step = y
      float acc = 0.0f;
      for (int k = i + 1; k < D; ++k) acc += M[k * D + i] * x[k];
      x[i] = (x[i] - acc) / M[i * D + i];
    }
  } else {
    for (int i = 0; i < D; ++i) x[i] = gg[i];  // the identity factor
  }
  float s1 = 0.0f, s2 = 0.0f, step_inf = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float sm_d = x[d] * dim_mask[d];
    tr[d] = P[d] - sm_d;
    s1 += sm_d * ((lam * diag[d]) * sm_d);
    s2 += sm_d * gg[d];
    const float a = fabsf(sm_d);
    if (a > step_inf || isnan(a)) step_inf = isnan(step_inf) ? step_inf : a;
  }
  float gsq = 0.0f;
  for (int k = 0; k < K; ++k) gsq += ssum[k] * ssum[k];
  pinfo[0] = w2;
  pinfo[1] = 0.5f * (s1 + s2);
  pinfo[2] = s.cost[l] + (0.5f * w2) * gsq;
  pinfo[3] = step_inf;
  pinfo[4] = ok ? 1.0f : 0.0f;
  pinfo[5] = 1.0f;
  pinfo[6] = 0.0f;
  pinfo[7] = 0.0f;
  active[l] = 1;
}

__global__ void __launch_bounds__(kThreads) falign_lm_accept_kernel(
    State s, const float* trial, const float* info, const int* active, const float* partials,
    int tiles, const long long* pairs, int np, const float* U, int K, int N, StateOut o) {
  const int l = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int D = 9 * N;
  const long long DD = (long long)D * D;
  const float* Pold = s.params + (long long)l * D;
  const float* Hold = s.H + l * DD;
  const float* gold = s.g + (long long)l * D;
  float* Po = o.params + (long long)l * D;
  float* Ho = o.H + l * DD;
  float* go = o.g + (long long)l * D;
  if (!active[l]) {  // frozen: copied through
    for (int d = tid; d < D; d += nt) {
      Po[d] = Pold[d];
      go[d] = gold[d];
    }
    for (long long e = tid; e < DD; e += nt) Ho[e] = Hold[e];
    if (tid == 0) {
      o.lam[l] = s.lam[l];
      o.cost[l] = s.cost[l];
      o.it[l] = s.it[l];
      o.done[l] = s.done[l];
      o.w2[l] = s.w2[l];
    }
    return;
  }
  extern __shared__ float sm[];
  float* Ht = sm;      // D * D
  float* gt = Ht + DD;  // D
  float* G = gt + D;   // 190: one pair's Gram sums
  __shared__ float sh_cost;
  __shared__ int sh_accept;
  for (long long e = tid; e < DD; e += nt) Ht[e] = 0.0f;
  for (int d = tid; d < D; d += nt) gt[d] = 0.0f;
  if (tid == 0) sh_cost = 0.0f;
  __syncthreads();
  for (int p = 0; p < np; ++p) {
    const long long b = (long long)l * np + p;
    for (int k = tid; k < kGram; k += nt) {
      float acc = 0.0f;
      for (int t = 0; t < tiles; ++t) acc += partials[(b * tiles + t) * kGram + k];
      G[k] = acc;
    }
    __syncthreads();
    const int fr = (int)pairs[2 * p], ft = (int)pairs[2 * p + 1];
    for (long long e = tid; e < DD; e += nt) {
      const int row = (int)(e / D), col = (int)(e % D);
      const int fa = row / 9, i = row % 9, fb = col / 9, j = col % 9;
      float acc = Ht[e];
      if (fa == fr && fb == fr) acc += G[gidx(1 + i, 1 + j)];    // Jr^T Jr
      if (fa == fr && fb == ft) acc += G[gidx(1 + i, 10 + j)];   // Jr^T Jt
      if (fa == ft && fb == fr) acc += G[gidx(1 + j, 10 + i)];   // (Jr^T Jt)^T
      if (fa == ft && fb == ft) acc += G[gidx(10 + i, 10 + j)];  // Jt^T Jt
      Ht[e] = acc;
    }
    for (int d = tid; d < D; d += nt) {
      const int fa = d / 9, i = d % 9;
      float acc = gt[d];
      if (fa == fr) acc += G[gidx(0, 1 + i)];
      if (fa == ft) acc += G[gidx(0, 10 + i)];
      gt[d] = acc;
    }
    if (tid == 0) sh_cost += 0.5f * G[0];
    __syncthreads();
  }
  const float* tr = trial + (long long)l * D;
  if (tid == 0) {
    const float* pinfo = info + (long long)l * kInfo;
    const float w2 = pinfo[0], pred = pinfo[1], cur_cost = pinfo[2], step_inf = pinfo[3];
    const bool ok = pinfo[4] > 0.0f;
    const float trial_cost = sh_cost;
    float gsq = 0.0f;
    for (int k = 0; k < K; ++k) {
      float acc = 0.0f;
      for (int d = 0; d < D; ++d) acc += tr[d] * U[k * D + d];
      gsq += acc * acc;
    }
    const float new_cost = trial_cost + (0.5f * w2) * gsq;
    const bool accept = ok && isfinite(new_cost) && (new_cost < cur_cost);
    const float rho = (cur_cost - new_cost) / clamp_min_nan(pred, 1e-30f);
    const float t = 2.0f * rho - 1.0f;
    const float dec = clamp_max_nan(clamp_min_nan(1.0f - (t * t) * t, 1.0f / 3.0f), 1.0f);
    const float lam0 = s.lam[l];
    const float lam = accept ? clamp_min_nan(lam0 * dec, 1e-7f) : lam0 * 4.0f;
    const float rel_drop = (cur_cost - new_cost) / clamp_min_nan(cur_cost, 1e-30f);
    const bool done = (accept && rel_drop < 1e-5f) || (accept && step_inf < 1e-4f)
                      || (!accept && step_inf < 3e-5f) || (lam > 1e6f);
    o.lam[l] = lam;
    o.cost[l] = accept ? trial_cost : s.cost[l];
    o.it[l] = s.it[l] + 1;
    o.done[l] = done ? 1 : 0;
    o.w2[l] = w2;
    sh_accept = accept ? 1 : 0;
  }
  __syncthreads();
  const bool accept = sh_accept != 0;
  for (int d = tid; d < D; d += nt) {
    Po[d] = accept ? tr[d] : Pold[d];
    go[d] = accept ? gt[d] : gold[d];
  }
  for (long long e = tid; e < DD; e += nt) Ho[e] = accept ? Ht[e] : Hold[e];
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int falign_lm_smem_limit(int device, int* out) {
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

extern "C" int falign_lm_propose_launch(const float* params, const float* lam, const float* cost,
                                        const float* H, const float* g, const int* it,
                                        const unsigned char* done, const float* w2,
                                        const int* it_end, const float* U, int K,
                                        const float* dim_mask, int L, int N, float* trial,
                                        float* info, int* active, void* stream) {
  if (L < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const int D = 9 * N;
  const size_t bytes = sizeof(float) * ((size_t)D * D + 3 * D + K);
  int err = set_smem((const void*)falign_lm_propose_kernel, bytes);
  if (err) return err;
  State s{params, lam, cost, H, g, it, done, w2};
  falign_lm_propose_kernel<<<L, kThreads, bytes, (cudaStream_t)stream>>>(s, it_end, U, K, dim_mask,
                                                                         N, trial, info, active);
  return (int)cudaGetLastError();
}

extern "C" int falign_lm_accept_launch(const float* params, const float* lam, const float* cost,
                                       const float* H, const float* g, const int* it,
                                       const unsigned char* done, const float* w2,
                                       const float* trial, const float* info, const int* active,
                                       const float* partials, int tiles, const long long* pairs,
                                       int np, const float* U, int K, int L, int N,
                                       float* params_o, float* lam_o, float* cost_o, float* H_o,
                                       float* g_o, int* it_o, unsigned char* done_o, float* w2_o,
                                       void* stream) {
  if (L < 1 || N < 1 || np < 1 || tiles < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const int D = 9 * N;
  const size_t bytes = sizeof(float) * ((size_t)D * D + D + kGram);
  int err = set_smem((const void*)falign_lm_accept_kernel, bytes);
  if (err) return err;
  State s{params, lam, cost, H, g, it, done, w2};
  StateOut o{params_o, lam_o, cost_o, H_o, g_o, it_o, done_o, w2_o};
  falign_lm_accept_kernel<<<L, kThreads, bytes, (cudaStream_t)stream>>>(
      s, trial, info, active, partials, tiles, pairs, np, U, K, N, o);
  return (int)cudaGetLastError();
}
