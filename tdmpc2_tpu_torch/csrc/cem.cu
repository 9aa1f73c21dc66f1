// The MPPI/CEM planning loop, as a sequence of kernels per plan.
//
// Replaces the TPU kernel _cem_kernel (tdmpc2_tpu/ops/pallas_cem.py,
// launched by _cem_flat / cem_prepared), which runs one environment's whole
// loop in one program because the TPU's VMEM holds every weight and
// activation of it. A Hopper SM holds 227 KB of shared memory, so the loop
// is split at the one step that needs all S samples at once, the elite
// threshold. Kernel boundaries are the only synchronisation across blocks:
// no cooperative launch, no grid barrier, no spin-wait. Each kernel plans N
// environments at once (the TPU kernel's grid=(N,), one program per env):
// a block belongs to one env, and every per-env operand is addressed
// through an env stride. The envs may be tasks of a multi-task model, each
// with its task id and action mask (value.cu, task axis): the pi rollout
// reads its first-layer biases through the id and masks the policy's mean
// and eps, the elite kernel masks the new mean and std. Per plan:
//   pi_rollout_kernel  once: the n_pi policy-prior trajectories of each env,
//                      ceil(n_pi / RT) row tiles per env (one at n_pi = 24)
//   then per iteration:
//     value_kernel     (value.cu, sampled mode) samples clip(mean + std *
//                      noise) with the policy rows overriding, where it
//                      stages each step's actions, and values every sample
//     elite_kernel     one warp per env: NaN guard, E-th largest value by the
//                      TPU kernel's 32-step bisection in one warp (no block
//                      barrier), boundary-shell tie weights, softmax-weighted
//                      mean/std update over the weighted rows only
//
// At widths above the row tiles (model_size 317) the pi rollout takes the
// layer-per-launch engine of mlp_wide.cuh (tdm_pi_rollout_wide); the elite
// kernel does not depend on the widths.
//
// Bounds, default 5M model at S=512: the value step carries the plan
// (~36 GFLOP over 6 iterations, ~36 us at 989 TFLOP/s). The pi rollout is
// 24 rows on the tensor-core row-tile engine (mlp_rows.cuh): H steps of the
// pi head and the dynamics, whose ~7.9 MB of packed weights its one block
// per env streams from L2 (~0.07 ms at ~64 bytes a cycle); only the m-tiles
// that hold rows are multiplied. The elite kernel moves a few tens of KB
// and sits far below any throughput bound: what it takes is launch and
// latency (its design is at elite_kernel). The sampling has no kernel of
// its own: a microsecond of work would sit inside a launch's fixed cost.
#include "mlp_wide.cuh"

namespace tdm {

template <int RT, int NP>
__global__ void __launch_bounds__(kBlock, 1)
pi_rollout_kernel(Weights w, Dims d, Plan pl, float lsmin, float lsdif, int n_pi,
                  int blocks_per_env, const float* z0, long zn, const float* pi_eps, long pn,
                  const int* task, int ntask, const float* amask, long amn, float* pi_acts) {
  extern __shared__ uint4 smem_u4[];
  const Tile tl(smem_u4, pl, d);
  const int env = blockIdx.x / blocks_per_env;
  const Heads hd(w, d, pl, task == nullptr ? 0 : min(max(task[env], 0), ntask - 1));
  const int row0 = (blockIdx.x % blocks_per_env) * RT;
  const int nrows = min(RT, n_pi - row0);
  const int HA = d.H * d.A;
  z0 += env * zn;
  pi_eps += env * pn;
  if (amask != nullptr) amask += env * amn;
  pi_acts += static_cast<long>(env) * n_pi * HA;

  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < d.H; ++t) {
      for (int i = 0; i < 3; ++i) tl.mats[n++] = hd.pi(i);
      for (int i = 0; i < 3; ++i) tl.mats[n++] = hd.dyn(i);
    }
  }
  load_z(tl, d, z0, 0, row0, nrows);
  ring_init(tl, pl);
  __syncthreads();
  if (threadIdx.x >= kThreads) {
    produce(tl, pl, 6 * d.H);
    return;
  }
  Stream st(tl, pl);
  for (int t = 0; t < d.H; ++t) {
    pi_head<RT, NP>(st, tl, d, w, hd);
    for (int i = threadIdx.x; i < RT * d.A; i += kThreads) {
      const int r = i / d.A, c = i % d.A;
      const float e = r < nrows ? pi_eps[(row0 + r) * HA + t * d.A + c] : 0.f;
      const float m = amask != nullptr ? amask[c] : 1.f;
      const float a = pi_action(tl, d, r, c, e, m, lsmin, lsdif);
      if (r < nrows) pi_acts[(row0 + r) * HA + t * d.A + c] = a;
      tl.z[r * tl.ldz + tl.Lp + c] = bf16_bits(a);
    }
    sync_consumers();
    dynamics<RT, NP>(st, tl, d, w, hd);
  }
}

// ---------------------------------------------------------------------------
// Elite selection and moment update
// ---------------------------------------------------------------------------
//
// One warp per env. What it computes is the TPU kernel's (pallas_cem.py:
// 194-231), in the same order of f32 operations: the NaN/huge guard, vmax
// and min, 32 bisection steps for the E-th largest value, the
// boundary-shell tie weights, the softmax score and the two-pass weighted
// moments. The bytes are a few KB and the operations a few thousand, so
// what bounds it on this card is the latency of one dependent chain, and
// the design keeps that chain in one warp, with no block barrier at all:
// - The values sit in the warp's registers (kEliteRegs a lane, S <= 512)
//   or, past that, in shared memory; the shared-memory copy alone runs
//   every S, but is measured slower at S=512 (PERF.md §6). Extrema and
//   counts use the warp's reduction instructions (redux.sync); sums,
//   shuffles.
// - count(v >= mid) >= E holds exactly when mid <= t, the E-th largest value
//   counted with multiplicity. So the bisection counts only until at most
//   kEliteCand values are left in [lo, hi); then it ranks those, one a
//   lane, takes t, and runs the remaining steps on scalars. lo and hi come
//   out bit for bit as the counting steps would give them
//   (tests/test_torch_elite.py).
// - Rows below lo weigh exactly 0 and add +0 to every sum, so the moments
//   read only the weighted rows, which the selection lists. The actions
//   are copied into shared memory at kernel entry (one bulk copy, TMA,
//   where they are 16-byte aligned; cp.async otherwise) and arrive under
//   the selection, where S*HA floats fit beside the rest; otherwise the
//   weighted rows are read from L2. Lanes take (row slot, column) pairs,
//   whatever HA is; a slot's partial sums are added in a fixed tree.

constexpr int kEliteRegs = 16;   // values a lane holds in registers: S <= 512
constexpr int kEliteCand = 32;   // count until this few values are left in [lo, hi)

// Cycle counters of block 0's lane 0 when built with -DTDM_CYCLES
// (`chip_smoke.py --cycles`; otherwise they compile to nothing): [0] the
// whole kernel, [1] the guard and the extrema, [2] the selection and
// bisection, [3] the boundary counts, the score and the list of weighted
// rows, [4] the moments (the wait for the staged actions included). They
// are kept in registers and stored once at the end, so that reading them
// adds no wait to the kernel.
#ifdef TDM_CYCLES
__device__ unsigned long long g_elite_cycles[5];
#define TDM_ELITE_COUNTERS unsigned long long elite_cycles[5] = {}
#define TDM_ELITE_COUNT(i, t0) elite_cycles[i] = clock64() - (t0)
#define TDM_ELITE_STORE()                                             \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                          \
    for (int j = 0; j < 5; ++j) g_elite_cycles[j] = elite_cycles[j];  \
  }
#else
#define TDM_ELITE_COUNTERS
#define TDM_ELITE_COUNT(i, t0)
#define TDM_ELITE_STORE()
#endif

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed cp.async groups are pending.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ float guard(float x) {  // nan_to_num semantics
  return (x == x && fabsf(x) <= 3.0e38f) ? x : 0.f;
}

// An int that orders as the (non-NaN) float does, for redux.sync max/min.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The TPU kernel's midpoint: lo + 0.5 (hi - lo), not 0.5 (lo + hi), which
// would overflow for values at the +-3e38 guard.
__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fadd_rn(lo, __fmul_rn(0.5f, __fsub_rn(hi, lo)));
}

// The warp's guarded values: value k*32 + lane is r[k] (R > 0) or
// v[k*32 + lane] in shared memory (R == 0), for k < chunks(). Past S a
// value reads as -inf, which no threshold counts and no weight takes. The
// loops over k unroll with constant k when R > 0, so r stays in registers.
template <int R>
struct Vals {
  float r[R > 0 ? R : 1];
  const float* v;
  int S;
  __device__ __forceinline__ int chunks() const { return R > 0 ? R : (S + 31) / 32; }
  __device__ __forceinline__ float at(int k) const {
    if constexpr (R > 0) {
      return r[k];
    } else {
      const int i = k * 32 + (threadIdx.x & 31);
      const float y = v[i < S ? i : S - 1];
      return i < S ? y : __int_as_float(0xff800000);
    }
  }
};

// exp(T (v - vmax)) times the tie weight: 1 at or above hi, wb in [lo, hi)
__device__ __forceinline__ float elite_score(float v, float vmax, float hi, float wb, float T) {
  return __fmul_rn(expf(__fmul_rn(T, __fsub_rn(v, vmax))), v >= hi ? 1.f : wb);
}

// The sum of n over the lanes below this one; `total` gets the warp's sum.
__device__ __forceinline__ int lanes_before(int n, int& total) {
  const int lane = threadIdx.x & 31;
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  total = __shfl_sync(0xffffffffu, incl, 31);
  return incl - n;
}

// The need-th largest, with multiplicity, of the values in [lo, hi), of
// which there are between need and 32: gathered one a lane through `cand`
// (64 floats of shared memory: 32 slots, then one a lane that takes the
// stores of values outside, so that no store needs a branch), then ranked
// against each other.
template <int R>
__device__ __forceinline__ float select_in(const Vals<R>& x, float lo, float hi, int need,
                                           float* cand) {
  const int lane = threadIdx.x & 31;
  int mine = 0, n;
#pragma unroll
  for (int k = 0; k < x.chunks(); ++k) mine += x.at(k) >= lo && x.at(k) < hi;
  int p = lanes_before(mine, n);
#pragma unroll
  for (int k = 0; k < x.chunks(); ++k) {
    const float v = x.at(k);
    const bool in = v >= lo && v < hi;
    cand[in ? p : 32 + lane] = v;
    p += in;
  }
  __syncwarp();
  const float c_lane = cand[lane];   // no branch around the load
  const float c = lane < n ? c_lane : 0.f;
  int gt = 0, ge = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float y = __shfl_sync(0xffffffffu, c, j);
    gt += j < n && y > c;
    ge += j < n && y >= c;
  }
  const unsigned ok = __ballot_sync(0xffffffffu, lane < n && gt < need && need <= ge);
  return __shfl_sync(0xffffffffu, c, __ffs(ok) - 1);
}

// The sum of x over the `slots` lanes slot*cw + col (slot < slots) of this
// lane's column col, in a fixed tree; lane col (slot 0) gets it.
__device__ __forceinline__ float slot_sum(float x, int slot, int slots, int cw) {
  for (int o = 1; o < slots; o <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, x, o * cw);
    if ((slot & (2 * o - 1)) == 0 && slot + o < slots) x += y;
  }
  return x;
}

// The two moment passes over the actions a (shared memory or global) of the
// weighted rows idx[0..nw), scores sn[i]: lane (slot, col) takes rows
// slot, slot + slots, ... of column c0 + col (cw columns at a time, c0 = 0,
// cw, ...); slots add in a fixed tree.
// mean = sum(sn a) / denom and std = sqrt(sum(sn (a - mean)^2) / denom),
// clamped, both times the action mask; division as a product with
// inv_d = 1 / denom. mk0: the mask of the lane's first column.
__device__ __forceinline__ void elite_moments(const float* a, const float* sn, const int* idx,
                                              int nw, int HA, int A, int cw, int slots,
                                              int slot, int col, const float* amask,
                                              float mk0, float inv_d, float min_std,
                                              float max_std, float* mean_out, float* std_out) {
  // rows in groups of 8, each group's loads issued together (a row past nw
  // reads the last row with weight 0, which adds +0)
  constexpr int G = 8;
  for (int c0 = 0; c0 < HA; c0 += cw) {
    const int c = c0 + col;
    const bool on = slot < slots && c < HA;
    float m = 0.f;
    if (on) {
      for (int k0 = slot; k0 < nw; k0 += G * slots) {
        int i[G];
        float w[G], y[G];
#pragma unroll
        for (int u = 0; u < G; ++u) i[u] = idx[min(k0 + u * slots, nw - 1)];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const float wu = sn[i[u]];
          w[u] = k0 + u * slots < nw ? wu : 0.f;
          y[u] = a[i[u] * HA + c];
        }
#pragma unroll
        for (int u = 0; u < G; ++u) m += w[u] * y[u];
      }
    }
    m = __fmul_rn(__shfl_sync(0xffffffffu, slot_sum(m, slot, slots, cw), col), inv_d);
    float q = 0.f;
    if (on) {
      for (int k0 = slot; k0 < nw; k0 += G * slots) {
        int i[G];
        float w[G], y[G];
#pragma unroll
        for (int u = 0; u < G; ++u) i[u] = idx[min(k0 + u * slots, nw - 1)];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const float wu = sn[i[u]];
          w[u] = k0 + u * slots < nw ? wu : 0.f;
          y[u] = a[i[u] * HA + c] - m;
        }
#pragma unroll
        for (int u = 0; u < G; ++u) q += w[u] * (y[u] * y[u]);
      }
    }
    q = slot_sum(q, slot, slots, cw);
    if (slot == 0 && c < HA) {
      const float sd = fminf(fmaxf(sqrtf(__fmul_rn(q, inv_d)), min_std), max_std);
      const float mc = c0 == 0 ? mk0 : amask[c % A];
      mean_out[c] = m * mc;
      std_out[c] = sd * mc;
    }
  }
}

// v_in, v_out [N, S] (v_out NaN/huge-guarded); acts [N, S, HA]; the env's
// action mask amask + env*amn [A]; new mean/std [N, HA]. Shared memory: an
// mbarrier (16 bytes), the values [S] (then the weighted rows' normalised
// scores at their index), the staged actions [S*HA] (stage only), the
// weighted rows' indices [S], the candidates and the spare words [64].
template <int R>
__global__ void __launch_bounds__(32)
elite_kernel(const float* __restrict__ v_in, const float* __restrict__ acts,
             const float* __restrict__ amask, long amn, int S, int HA, int A, int E,
             float temperature, float min_std, float max_std, bool stage,
             float* __restrict__ v_out, float* __restrict__ mean_out,
             float* __restrict__ std_out) {
  const int env = blockIdx.x, lane = threadIdx.x;
  amask += env * amn;
  v_in += static_cast<long>(env) * S;
  v_out += static_cast<long>(env) * S;
  acts += static_cast<long>(env) * S * HA;
  mean_out += static_cast<long>(env) * HA;
  std_out += static_cast<long>(env) * HA;
  extern __shared__ float4 smem_f4[];
  const uint32_t bar = smem_u32(smem_f4);
  float* vs = reinterpret_cast<float*>(smem_f4 + 1);
  float* staged = vs + S;
  int* idx = reinterpret_cast<int*>(staged + (stage ? static_cast<long>(S) * HA : 0));
  float* cand = reinterpret_cast<float*>(idx + S);
  TDM_ELITE_COUNTERS;
  TDM_CLOCK(t_start);

  // The values and the actions move into shared memory by asynchronous
  // copies, every one issued before the first value is waited for: one
  // round trip to memory, where loads into registers would each wait for
  // the one before. The actions go first, by one bulk copy (TMA) where they
  // are 16-byte aligned, so that its barrier's fence waits for no other
  // copy; they finish under the selection. The values go by 16-byte copies
  // where aligned; cp.async groups: the values', then the unaligned
  // actions'.
  const bool aligned = (S & 3) == 0;
  const bool bulk = stage && aligned && (reinterpret_cast<uintptr_t>(acts) & 15) == 0 &&
                    ((S * HA) & 3) == 0;
  if (bulk && lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_copy(smem_u32(staged), acts, static_cast<uint32_t>(sizeof(float) * S * HA), bar);
  }
  if (aligned && (reinterpret_cast<uintptr_t>(v_in) & 15) == 0) {
    for (int i = 4 * lane; i < S; i += 128) cp_async16(vs + i, v_in + i);
  } else {
    for (int i = lane; i < S; i += 32) cp_async4(vs + i, v_in + i);
  }
  cp_async_commit();
  if (stage && !bulk) {
    for (int i = lane; i < S * HA; i += 32) cp_async4(staged + i, acts + i);
  }
  cp_async_commit();
  // elite_moments' layout, lane (slot, col) of `slots` rows of cw columns,
  // and the mask of the lane's first column, worked out under the copies
  const int cw = HA < 32 ? HA : 32, slots = HA < 32 ? 32 / HA : 1;
  const int slot = lane / cw, col = lane % cw;
  const float mk0 = amask[col % A];
  cp_async_wait<1>();                 // the values' group
  __syncwarp();                       // every lane's copies and the mbarrier's init

  // NaN/huge guard, v_out, extrema
  Vals<R> x;
  x.v = vs;
  x.S = S;
  int kmax = order_key(__int_as_float(0xff800000)), kmin = order_key(__int_as_float(0x7f800000));
  if constexpr (R > 0) {
    // every load issued before any is used: volatile, so that none is sunk
    // into a branch that waits for it
    const volatile float* vv = vs;
    float raw[R];
#pragma unroll
    for (int k = 0; k < R; ++k) raw[k] = vv[min(k * 32 + lane, S - 1)];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = k * 32 + lane;
      x.r[k] = i < S ? guard(raw[k]) : __int_as_float(0xff800000);
      if (i < S) {
        v_out[i] = x.r[k];
        kmax = max(kmax, order_key(x.r[k]));
        kmin = min(kmin, order_key(x.r[k]));
      }
    }
  } else {
    for (int i = lane; i < S; i += 32) {
      const float v = guard(vs[i]);
      vs[i] = v;
      v_out[i] = v;
      kmax = max(kmax, order_key(v));
      kmin = min(kmin, order_key(v));
    }
    __syncwarp();
  }
  const float vmax = from_key(__reduce_max_sync(0xffffffffu, kmax));
  float lo = from_key(__reduce_min_sync(0xffffffffu, kmin));
  TDM_ELITE_COUNT(1, t_start);
  TDM_CLOCK(t_sel);

  // The TPU kernel's 32 steps. c_lo = count(v >= lo) >= E and c_hi =
  // count(v >= hi) < E throughout (hi starts above vmax, lo at the
  // minimum), so lo <= t < hi.
  float hi = __fadd_rn(__fadd_rn(vmax, __fmul_rn(0.001f, fabsf(vmax))), 1.f);
  int c_lo = S, c_hi = 0, it = 0;
  for (; it < 32 && c_lo - c_hi > kEliteCand; ++it) {
    const float m = midpoint(lo, hi);
    int c = 0;
#pragma unroll
    for (int k = 0; k < x.chunks(); ++k) c += x.at(k) >= m;
    c = __reduce_add_sync(0xffffffffu, c);
    if (c >= E) {
      lo = m;
      c_lo = c;
    } else {
      hi = m;
      c_hi = c;
    }
  }
  if (it < 32) {
    const float t = select_in(x, lo, hi, E - c_hi, cand);
    // midpoint's arithmetic, with both possible next widths hi - m and
    // m - lo taken beside the compare: one select, not a subtraction, on the
    // chain from one step to the next
    float d = __fsub_rn(hi, lo);
    for (; it < 32; ++it) {
      const float m = __fadd_rn(lo, __fmul_rn(0.5f, d));
      const bool up = m <= t;
      const float d_up = __fsub_rn(hi, m), d_down = __fsub_rn(m, lo);
      lo = up ? m : lo;
      hi = up ? hi : m;
      d = up ? d_up : d_down;
    }
  }
  TDM_ELITE_COUNT(2, t_sel);
  TDM_CLOCK(t_score);

  int n1 = 0, nlo = 0;
#pragma unroll
  for (int k = 0; k < x.chunks(); ++k) {
    n1 += x.at(k) >= hi;
    nlo += x.at(k) >= lo;
  }
  n1 = __reduce_add_sync(0xffffffffu, n1);
  nlo = __reduce_add_sync(0xffffffffu, nlo);
  const float wb = __fdiv_rn(static_cast<float>(E - n1), fmaxf(static_cast<float>(nlo - n1), 1.f));
  // the scores (kept in registers when the values are), their sum
  float s[R > 0 ? R : 1];
  float ls = 0.f;
  int mine = 0;
#pragma unroll
  for (int k = 0; k < x.chunks(); ++k) {
    const float v = x.at(k);
    const float sc = elite_score(v, vmax, hi, wb, temperature);
    if constexpr (R > 0) s[k] = sc;
    ls += v >= lo ? sc : 0.f;
    mine += v >= lo;
  }
  const float total = warp_sum(ls), inv = __frcp_rn(total);
  // the sum of the normalised scores, taken as total * inv
  const float denom = __fadd_rn(__fmul_rn(total, inv), 1e-9f);
  // the weighted rows, this lane's after the lower lanes'
  int nw;
  int p = lanes_before(mine, nw);
  // (every lane stores each score at its value's index and each index to
  // the list; a value past S or unweighted stores to the lane's spare word
  // instead: no branch)
  int* spare = reinterpret_cast<int*>(cand) + 32 + lane;
#pragma unroll
  for (int k = 0; k < x.chunks(); ++k) {
    const float v = x.at(k);
    float sc;
    if constexpr (R > 0) {
      sc = s[k];
    } else {
      sc = elite_score(v, vmax, hi, wb, temperature);
    }
    const bool in = v >= lo;
    const int i = k * 32 + lane;
    *(i < S ? vs + i : reinterpret_cast<float*>(spare)) = __fmul_rn(sc, inv);
    *(in ? idx + p : spare) = i;
    p += in;
  }
  TDM_ELITE_COUNT(3, t_score);
  TDM_CLOCK(t_mom);

  if (bulk) {
    mbar_wait(bar, 0);
  } else {
    cp_async_wait<0>();
  }
  __syncwarp();
  const float inv_d = __frcp_rn(denom);
  if (stage) {
    elite_moments(staged, vs, idx, nw, HA, A, cw, slots, slot, col, amask, mk0, inv_d, min_std,
                  max_std, mean_out, std_out);
  } else {
    elite_moments(acts, vs, idx, nw, HA, A, cw, slots, slot, col, amask, mk0, inv_d, min_std,
                  max_std, mean_out, std_out);
  }
  TDM_ELITE_COUNT(4, t_mom);
  TDM_ELITE_COUNT(0, t_start);
  TDM_ELITE_STORE();
}

template <int RT, int NP>
int launch_pi(const Weights& w, const Dims& d, const Plan& pl, float lsmin, float lsdif, int N,
              int n_pi, const float* z0, long zn, const float* pi_eps, long pn, const int* task,
              int ntask, const float* amask, long amn, float* pi_acts, cudaStream_t stream) {
  const cudaError_t err = opt_in_smem(pi_rollout_kernel<RT, NP>, pl.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_per_env = (n_pi + RT - 1) / RT;
  pi_rollout_kernel<RT, NP><<<N * blocks_per_env, kBlock, pl.bytes, stream>>>(
      w, d, pl, lsmin, lsdif, n_pi, blocks_per_env, z0, zn, pi_eps, pn, task, ntask, amask, amn,
      pi_acts);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_elite(int N, int smem, cudaStream_t stream, const float* v_in, const float* acts,
                 const float* amask, long amn, int S, int HA, int A, int E, float temperature,
                 float min_std, float max_std, bool stage, float* v_out, float* mean_out,
                 float* std_out) {
  // above 48 KB of shared memory only after an opt-in, made once per device
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_smem(elite_kernel<R>, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  elite_kernel<R><<<N, 32, smem, stream>>>(v_in, acts, amask, amn, S, HA, A, E, temperature,
                                           min_std, max_std, stage, v_out, mean_out, std_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdm

// Each launch function runs on `stream` and returns cudaGetLastError()
// (the pi rollout: kNoPlan when no row tile fits the widths).
// pi rollout of env e: z0 + e*zn ([L]), pi_eps + e*pn ([n_pi, HA]), task[e]
// (clamped to [0, ntask); null: 0), amask + e*amn ([A]; null: ones);
// pi_acts [N, n_pi, HA].
extern "C" int tdm_pi_rollout(const void* const* wptrs, const int* dims, float lsmin,
                              float lsdif, int N, int n_pi, const float* z0, long zn,
                              const float* pi_eps, long pn, const int* task, int ntask,
                              const float* amask, long amn, float* pi_acts, void* stream) {
  using namespace tdm;
  Weights w;
  for (int i = 0; i < kNumOps; ++i) w.p[i] = wptrs[i];
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const Plan pl = pick_plan(d);
  if (pl.shape < 0) return kNoPlan;
  return with_shape(pl.shape, [&](auto t) {
    return launch_pi<decltype(t)::rt, decltype(t)::np>(w, d, pl, lsmin, lsdif, N, n_pi, z0, zn,
                                                        pi_eps, pn, task, ntask, amask, amn,
                                                        pi_acts,
                                                        static_cast<cudaStream_t>(stream));
  });
}

// out = {rows per block, shared bytes, ring stages, blocks per SM} of the
// pi-rollout kernel at these dims; returns an error code.
// The pi rollout on the wide engine (mlp_wide.cuh), one layer a launch:
// the latent staged once, then per step the policy (its actions to pi_acts
// and into the action columns) and, but after the last, the dynamics.
// Operands as tdm_pi_rollout's, then the scratch buffers and their row
// strides (ops/wide.py); `launched` [6] receives the number of launches and
// of products, row kernels, stagings, u products and fused layers among
// them. When `latents` is not null it receives each step's latent z_1 ..
// z_{H-1} in f32, [H-1, N * n_pi, L], as the dynamics writes it.
extern "C" int tdm_pi_rollout_wide(const void* const* wptrs, const int* dims, float lsmin,
                                   float lsdif, int N, int n_pi, const float* z0, long zn,
                                   const float* pi_eps, long pn, const int* task, int ntask,
                                   const float* amask, long amn, float* pi_acts,
                                   const void* const* scratch, const long* lds, float* latents,
                                   int* launched, void* stream) {
  using namespace tdm;
  Wide wd(wptrs, dims, N, n_pi, task, ntask, scratch_from(scratch, lds),
          static_cast<cudaStream_t>(stream));
  if (!wide_fits(wd.d)) return kNoPlan;
  const int A = wd.d.A, HA = wd.d.H * A;
  StageArgs s{};
  s.load_z = 1;
  s.z0 = z0;
  s.zn = zn;
  wd.stage(s);
  for (int t = 0; t < wd.d.H; ++t) {
    wd.policy(pi_eps + t * A, pn, HA, amask, amn, lsmin, lsdif, pi_acts + t * A, HA);
    if (t + 1 < wd.d.H)
      wd.dynamics(latents == nullptr ? nullptr : latents + t * wd.R * wd.d.L);
  }
  wd.report(launched);
  return wd.err;
}

extern "C" int tdm_pi_rollout_plan(const int* dims, int* out) {
  using namespace tdm;
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const Plan pl = pick_plan(d);
  return with_shape(pl.shape, [&](auto t) {
    return plan_report(pi_rollout_kernel<decltype(t)::rt, decltype(t)::np>, pl, out);
  });
}

// v_in, v_out [N, S]; acts [N, S, HA]; env e's mask amask + e*amn [A];
// mean_out, std_out [N, HA]. Returns kNoPlan when the values and the row
// list do not fit in shared memory (8*S bytes and 272 more: S up to
// 29,022).
extern "C" int tdm_elite(const float* v_in, const float* acts, const float* amask, long amn,
                         int N, int S, int HA, int A, int num_elites, float temperature,
                         float min_std, float max_std, float* v_out, float* mean_out,
                         float* std_out, void* stream) {
  using namespace tdm;
  const long base = 16 + static_cast<long>(sizeof(float)) * (2L * S + 2 * kEliteCand);
  const long staged = static_cast<long>(sizeof(float)) * S * HA;
  const bool stage = base + staged <= kSmemMax;
  const long smem = base + (stage ? staged : 0);
  if (smem > kSmemMax) return kNoPlan;
  const auto launch = S <= 32 * kEliteRegs ? launch_elite<kEliteRegs> : launch_elite<0>;
  return launch(N, static_cast<int>(smem), static_cast<cudaStream_t>(stream), v_in, acts,
                amask, amn, S, HA, A, num_elites, temperature, min_std, max_std, stage, v_out,
                mean_out, std_out);
}

#ifdef TDM_CYCLES
// Copy the elite kernel's cycle counters (its last launch's) to out[5].
extern "C" int tdm_elite_cycles(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, tdm::g_elite_cycles, sizeof(tdm::g_elite_cycles)));
}
#endif
