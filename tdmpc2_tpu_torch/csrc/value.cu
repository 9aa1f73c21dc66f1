// Planner value estimate: H-step reward + dynamics rollout, terminal policy
// prior, 2-of-num_q Q bootstrap, and on episodic tasks the sticky
// termination gate; single- and multi-task.
//
// Replaces the TPU kernel _value_kernel (tdmpc2_tpu/ops/pallas_rollout.py,
// launched by _value_flat / value_prepared). For N environments, each with
// S sampled action sequences:
//   G = sum_t discs[t] * (1 - term_t) * symexp(two_hot(reward(z_t, a_t))),
//   z_{t+1} = dyn(z_t, a_t)
//   a_H = tanh(mean(z_H) + eps * exp(log_std(z_H)))
//   v = G + discs[H] * (1 - term_H) * (Q_i(z_H, a_H) + Q_j(z_H, a_H)) / 2, (i, j) = qidx
// with the env's own discs [H+1] and qidx [2]. term_0 = 0; when `episodic`,
// term_{t+1} = min(term_t + (logit(z_{t+1}) > 0), 1) with the termination
// head's logit on the new latent, else term stays 0 (the multiply by 1 is
// exact, so the non-episodic result is unchanged). When term_at is not
// null, term_at[row] receives the step 1..H at which the row's flag was
// set, or 0: how a check tells the kernel's gates from another version's.
//
// Env axis: as the TPU kernel's `blocks_per_env`, the grid holds N runs of
// ceil(S / RT) blocks, env = block / blocks_per_env, and a block never
// straddles two envs (its last rows are masked when S % RT != 0). Every
// per-env operand is addressed through an env stride, so the planner's
// broadcast latent and its strided per-iteration noise need no copies. A
// row's result does not depend on the other rows of its tile, so an N-env
// launch equals N one-env launches bit for bit.
//
// Task axis (multi-task models): each env carries a task id, task[env]. A
// task changes only the first-layer biases, where the prep folds in its
// embedding (tables with a row per task, read through the id: Heads), and
// the action mask amask [A] of the env (its own row, env stride amn; 0
// where the task has fewer action columns). The mask multiplies the
// sampled actions where they are staged and the terminal policy's mean
// and eps (pi_action). So N tasks plan in one launch, as N envs do; a
// single-task model is task 0 of a one-row table, with a mask of ones.
//
// Bound: at the default 5M model and S=512 one env's call does ~5.9 GFLOP of
// bf16-input products over ~6 MB of weights: ~6.0 us at 989 TFLOP/s
// against ~1.8 us at 3.35 TB/s, so the work is compute-bound on the card.
// Each block, though, streams every weight of the step once (~11.5 MB of
// packed bf16 at the default model) from L2, and one SM draws on the order
// of 64 bytes a cycle from it: no block finishes under ~0.1 ms. The design
// (mlp_rows.cuh): RT rows a block (32 at the default model: 16 blocks at
// one env, 128 at N=8, one wave on 132 SMs), every product on the tensor
// cores (mma.sync), weights streamed into a ring of shared-memory stages by
// a producer warp's bulk copies while the consumer warps multiply the
// stages before, every activation of the rollout in shared memory.
// The termination head (episodic) adds L*M + M*M + M multiply-adds per row
// and step, ~27% at the default model, and reuses the hidden buffer.
// The grouped SimNorm softmax is computed directly, where the TPU kernel
// used a block-diagonal mask product.
//
// Widths above the row tiles (model_size 317: mlp_dim 4096) take the
// layer-per-launch engine of mlp_wide.cuh instead (tdm_value_wide,
// tdm_value_sampled_wide): the same arithmetic, one launch a layer and a
// row kernel after each product, the env's two Q heads only. The wrapper
// picks the engine from the widths (ops/wide.py engine), never by trying.
//
// Sampled mode (the planner's step, ops/value.py value_sampled): the kernel
// also does the CEM sampling of the TPU kernel _cem_kernel
// (tdmpc2_tpu/ops/pallas_cem.py:136-147), which there runs in the same
// program as the rollout that uses the samples. Row s of env e takes, at
// step t and action column c, k = t*A + c,
//   a = s < n_pi ? pi_acts[s, k] : clip(mean[k] + std[k] * noise[s, k], -1, 1)
//   a = a * amask[c]
// where the actions are staged, so that the sampling costs no launch of its
// own (its microsecond of work would sit inside a launch's fixed cost).
// Each action is written once, in f32, to acts [N, S, H*A] for the elite
// step. The noise rows take the place of the action rows the given-actions
// mode reads, at the same size.
#include "mlp_wide.cuh"

namespace tdm {

// Step t's actions of the block's rows, sampled as the module comment says
// (the _rn intrinsics: no contraction into an fma, the roundings of the
// plain version's multiply, then add), written in f32 to acts and staged as
// bf16 into the action columns of z||a. The operands point at the env's
// own, and amask is the env's action mask [A]. Rows at or past nrows stage
// zeros and write nothing. Synchronises the consumers after.
__device__ __forceinline__ void put_sampled(const Tile& tl, const Dims& d, const Sampling& sp,
                                            const float* amask, int t, int row0, int nrows) {
  const int HA = d.H * d.A;
  for (int i = threadIdx.x; i < tl.rt * d.A; i += kThreads) {
    const int r = i / d.A, c = i % d.A, k = t * d.A + c;
    uint16_t bits = 0;
    if (r < nrows) {
      const long at = static_cast<long>(row0 + r) * HA + k;
      float a;
      if (row0 + r < sp.n_pi) {
        a = sp.pi_acts[at];
      } else {
        a = fminf(fmaxf(__fadd_rn(sp.mean[k], __fmul_rn(sp.stdv[k], sp.noise[at])), -1.f), 1.f);
      }
      a *= amask[c];
      sp.acts[at] = a;
      bits = bf16_bits(a);
    }
    tl.z[r * tl.ldz + tl.Lp + c] = bits;
  }
  sync_consumers();
}

// kSampled: the sampled mode (sp), else the given actions. Two
// instantiations, so that neither mode keeps the other's operands live
// across the rollout.
template <int RT, int NP, bool kSampled>
__global__ void __launch_bounds__(kBlock, 1)
value_kernel(Weights w, Dims d, Plan pl, float lsmin, float lsdif, int episodic, int S,
             int blocks_per_env, const float* z0, long zn, long zs, const float* actions,
             long an, long ats, long ass, Sampling sp, const int* task, int ntask,
             const float* amask, long amn, const float* eps, long en, const int* qidx, long qn,
             const float* discs, long dn, float* out, int* term_at) {
  extern __shared__ uint4 smem_u4[];
  TDM_CLOCK(t_kernel);
  const Tile tl(smem_u4, pl, d);
  const int env = blockIdx.x / blocks_per_env;
  const Heads hd(w, d, pl, task == nullptr ? 0 : min(max(task[env], 0), ntask - 1));
  const int row0 = (blockIdx.x % blocks_per_env) * RT;
  const int nrows = min(RT, S - row0);
  const int tid = threadIdx.x;
  z0 += env * zn;
  if constexpr (kSampled) {
    sp.mean += env * sp.mn;
    sp.stdv += env * sp.sn;
    sp.noise += env * sp.nn;
    sp.pi_acts += env * sp.pn;
    sp.acts += static_cast<long>(env) * S * d.H * d.A;
  } else {
    actions += env * an;
  }
  if (amask != nullptr) amask += env * amn;
  eps += env * en;
  qidx += env * qn;
  discs += env * dn;
  out += static_cast<long>(env) * S;
  if (term_at != nullptr) term_at += static_cast<long>(env) * S;
  float* G = tl.s0;     // discounted reward sum
  float* r = tl.s1;     // decoded reward / Q of the current head
  float* q = tl.s2;     // Q sum over the two heads
  float* term = tl.s3;  // sticky termination flag, 0 or 1
  int qh[2];
  for (int j = 0; j < 2; ++j) qh[j] = min(max(qidx[j], 0), d.NQ - 1);

  // the weight stream: every matrix in the order it is multiplied
  int nmat = 0;
  if (tid == 0) {
    for (int t = 0; t < d.H; ++t) {
      for (int i = 0; i < 3; ++i) tl.mats[nmat++] = hd.rew(i);
      for (int i = 0; i < 3; ++i) tl.mats[nmat++] = hd.dyn(i);
      if (episodic)
        for (int i = 0; i < 3; ++i) tl.mats[nmat++] = hd.term(i);
    }
    for (int i = 0; i < 3; ++i) tl.mats[nmat++] = hd.pi(i);
    for (int j = 0; j < 2; ++j)
      for (int i = 0; i < 3; ++i) tl.mats[nmat++] = hd.q(i, qh[j]);
  }
  nmat = (episodic ? 9 : 6) * d.H + 9;
  load_z(tl, d, z0, zs, row0, nrows);
  if (tid < RT) {
    G[tid] = 0.f;
    q[tid] = 0.f;
    term[tid] = 0.f;
    if (term_at != nullptr && tid < nrows) term_at[row0 + tid] = 0;
  }
  ring_init(tl, pl);
  __syncthreads();
  if (threadIdx.x >= kThreads) {
    produce(tl, pl, nmat);
    return;
  }
  Stream st(tl, pl);

  for (int t = 0; t < d.H; ++t) {
    if constexpr (kSampled) {
      put_sampled(tl, d, sp, amask, t, row0, nrows);
    } else {
      put_actions(tl, d, actions + t * ats, ass, row0, nrows);
    }
    // reward head on (z_t, a_t)
    reward<RT, NP>(st, tl, d, w, hd, r);
    if (tid < RT) G[tid] += discs[t] * ((1.f - term[tid]) * r[tid]);
    // z_{t+1}
    dynamics<RT, NP>(st, tl, d, w, hd);
    if (episodic) {
      hidden2<RT, NP>(st, tl, d, hd.term(0), hd.term(1), w.f(tb0) + hd.boff, w.f(tg0),
                      w.f(te0), w.f(tb1), w.f(tg1), w.f(te1));
      st = narrow_layer<RT>(st, hd.term(2), tl.h, tl.ldh, tl.part, tl.head, tl.hp, 1,
                            w.f(tb2), nullptr, 1);
      if (tid < RT) {
        const float hit = tl.head[tid * tl.hp] > 0.f ? 1.f : 0.f;
        if (term_at != nullptr && tid < nrows && term[tid] == 0.f && hit != 0.f) {
          term_at[row0 + tid] = t + 1;
        }
        term[tid] = fminf(term[tid] + hit, 1.f);
      }
    }
  }

  // terminal policy prior action, into the action columns
  pi_head<RT, NP>(st, tl, d, w, hd);
  for (int i = tid; i < RT * d.A; i += kThreads) {
    const int rr = i / d.A, c = i % d.A;
    const float e = rr < nrows ? eps[(row0 + rr) * d.A + c] : 0.f;
    const float m = amask != nullptr ? amask[c] : 1.f;
    tl.z[rr * tl.ldz + tl.Lp + c] = bf16_bits(pi_action(tl, d, rr, c, e, m, lsmin, lsdif));
  }
  sync_consumers();

  // the two Q heads named by qidx
  for (int j = 0; j < 2; ++j) {
    const int h = qh[j];
    const long M = d.M;
    hidden2<RT, NP>(st, tl, d, hd.q(0, h), hd.q(1, h), w.f(qb0) + hd.qoff + h * M,
                    w.f(qg0) + h * M, w.f(qe0) + h * M, w.f(qb1) + h * M, w.f(qg1) + h * M,
                    w.f(qe1) + h * M);
    Epi e{kTwoHot, d.B, w.f(qb2) + static_cast<long>(h) * d.B, nullptr, nullptr, w.f(bins),
          0, nullptr, 0, nullptr, 0, 0, r};
    st = wide<RT, NP>(st, hd.q(2, h), tl.h, tl.ldh, tl.red, e);
    if (tid < RT) q[tid] += r[tid];
  }
  if (tid < nrows) {
    out[row0 + tid] = G[tid] + discs[d.H] * ((1.f - term[tid]) * (q[tid] / 2.f));
  }
  TDM_COUNT(0, t_kernel);
}

template <int RT, int NP, bool kSampled>
int launch_value(const Weights& w, const Dims& d, const Plan& pl, float lsmin, float lsdif,
                 int episodic, int N, int S, const float* z0, long zn, long zs,
                 const float* actions, long an, long ats, long ass, const Sampling& sp,
                 const int* task, int ntask, const float* amask, long amn, const float* eps,
                 long en, const int* qidx, long qn, const float* discs, long dn, float* out,
                 int* term_at, cudaStream_t stream) {
  const cudaError_t err = opt_in_smem(value_kernel<RT, NP, kSampled>, pl.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_per_env = (S + RT - 1) / RT;
  value_kernel<RT, NP, kSampled><<<N * blocks_per_env, kBlock, pl.bytes, stream>>>(
      w, d, pl, lsmin, lsdif, episodic, S, blocks_per_env, z0, zn, zs, actions, an, ats, ass,
      sp, task, ntask, amask, amn, eps, en, qidx, qn, discs, dn, out, term_at);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdm

namespace {

int value_launch(const void* const* wptrs, const int* dims, float lsmin, float lsdif,
                 int episodic, int N, int S, const float* z0, long zn, long zs,
                 const float* actions, long an, long ats, long ass, const tdm::Sampling& sp,
                 const int* task, int ntask, const float* amask, long amn, const float* eps,
                 long en, const int* qidx, long qn, const float* discs, long dn, float* out,
                 int* term_at, void* stream) {
  using namespace tdm;
  Weights w;
  for (int i = 0; i < kNumOps; ++i) w.p[i] = wptrs[i];
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const Plan pl = pick_plan(d);
  if (pl.shape < 0) return kNoPlan;
  return with_shape(pl.shape, [&](auto t) {
    const auto launch = sp.mean != nullptr ? launch_value<decltype(t)::rt, decltype(t)::np, true>
                                           : launch_value<decltype(t)::rt, decltype(t)::np, false>;
    return launch(w, d, pl, lsmin, lsdif, episodic, N, S, z0, zn, zs, actions, an, ats, ass, sp,
                  task, ntask, amask, amn, eps, en, qidx, qn, discs, dn, out, term_at,
                  static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// kNoPlan when no row tile fits the widths. Operands of env e: z0 + e*zn
// (rows zs apart, 0 broadcasts one row), actions + e*an ([H, S, A] with
// strides ats, ass, 1), task[e] (the row of the first-layer bias tables,
// clamped to [0, ntask); task null: 0), amask + e*amn ([A]; null: ones),
// eps + e*en ([S, A]), qidx + e*qn ([2]), discs + e*dn ([H+1]); out
// [N, S]; term_at [N, S] or null. `episodic` (0/1) needs the termination
// head's operands among wptrs.
extern "C" int tdm_value(const void* const* wptrs, const int* dims, float lsmin, float lsdif,
                         int episodic, int N, int S, const float* z0, long zn, long zs,
                         const float* actions, long an, long ats, long ass, const int* task,
                         int ntask, const float* amask, long amn, const float* eps, long en,
                         const int* qidx, long qn, const float* discs, long dn, float* out,
                         int* term_at, void* stream) {
  const tdm::Sampling given{};
  return value_launch(wptrs, dims, lsmin, lsdif, episodic, N, S, z0, zn, zs, actions, an, ats,
                      ass, given, task, ntask, amask, amn, eps, en, qidx, qn, discs, dn, out,
                      term_at, stream);
}

// The sampled mode: as tdm_value, with the actions sampled in the kernel
// from env e's mean + e*mn and std + e*sn ([H*A]), noise + e*nn and
// pi_acts + e*pn ([S, H*A] and [n_pi, H*A], rows H*A apart) and the
// env's mask amask + e*amn ([A], not null); the actions are written to acts
// [N, S, H*A].
extern "C" int tdm_value_sampled(const void* const* wptrs, const int* dims, float lsmin,
                                 float lsdif, int episodic, int N, int S, const float* z0,
                                 long zn, long zs, const float* mean, long mn,
                                 const float* stdv, long sn, const float* noise, long nn,
                                 const float* pi_acts, long pn, int n_pi, float* acts,
                                 const int* task, int ntask, const float* amask, long amn,
                                 const float* eps, long en, const int* qidx, long qn,
                                 const float* discs, long dn, float* out, int* term_at,
                                 void* stream) {
  if (amask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const tdm::Sampling sp{mean, mn, stdv, sn, noise, nn, pi_acts, pn, n_pi, acts};
  return value_launch(wptrs, dims, lsmin, lsdif, episodic, N, S, z0, zn, zs, nullptr, 0, 0, 0,
                      sp, task, ntask, amask, amn, eps, en, qidx, qn, discs, dn, out, term_at,
                      stream);
}

namespace {

// The value step on the wide engine (mlp_wide.cuh), one layer a launch:
// per step, the actions staged (given or sampled, with the latent at t = 0),
// the reward head, the dynamics and, on episodic tasks, the termination
// gate; then the policy at z_H and the env's two Q heads. Where the latent
// broadcasts over an env's rows (zs = 0: the planner's), step 0's staging
// writes each env's latent once, into zb, and the reward's and the
// dynamics' first layers take the latent's share from it (Wide::hidden2,
// folded: a u product and a fused layer in place of a product and a row
// kernel each), 114 MB less staged at N = 80 envs of 512 rows, where the
// fused layer's staged action block fits (fold_fits). An episodic step does
// not fold: its termination flags follow the sign of a logit, which the
// last bits of a first layer can turn where it is near 0, and its first
// layers keep the one product over z||a that the gate has always run
// through. Operands as for value_launch, and the call's scratch buffers.
int value_wide(const void* const* wptrs, const int* dims, float lsmin, float lsdif,
               int episodic, int N, int S, const float* z0, long zn, long zs,
               const float* actions, long an, long ats, long ass, const tdm::Sampling& sp,
               const int* task, int ntask, const float* amask, long amn, const float* eps,
               long en, const int* qidx, long qn, const float* discs, long dn, float* out,
               int* term_at, const void* const* scratch, const long* lds, int* launched,
               void* stream) {
  using namespace tdm;
  Wide wd(wptrs, dims, N, S, task, ntask, scratch_from(scratch, lds),
          static_cast<cudaStream_t>(stream));
  if (!wide_fits(wd.d)) return kNoPlan;
  const bool fold = zs == 0 && !episodic && fold_fits(wd.d);
  if (fold && (wd.sc.zb == nullptr || wd.sc.u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < wd.d.H; ++t) {
    const bool folded = fold && t == 0;
    StageArgs s{};
    s.t = t;
    s.load_z = t == 0;
    s.z0 = z0;
    s.zn = zn;
    s.zs = zs;
    s.actions = sp.mean == nullptr ? actions : nullptr;
    s.an = an;
    s.ats = ats;
    s.ass = ass;
    s.sp = sp;
    s.amask = amask;
    s.amn = amn;
    s.G = wd.sc.G;
    s.q = wd.sc.q;
    s.term = wd.sc.term;
    s.term_at = term_at;
    if (folded) s.zb = wd.sc.zb;
    wd.stage(s);
    wd.reward(discs, dn, t, folded);
    wd.dynamics(nullptr, folded);
    if (episodic) wd.termination(t, term_at);
  }
  wd.policy(eps, en, wd.d.A, amask, amn, lsmin, lsdif);
  wd.q_head(0, qidx, qn, discs, dn, out);
  wd.q_head(1, qidx, qn, discs, dn, out);
  wd.report(launched);
  return wd.err;
}

}  // namespace

// tdm_value on the wide engine: the same operands, then the scratch
// buffers (x, h, y, G, q, term, zb, u; ops/wide.py) and their row
// strides (x, h, y); `launched` [6] receives the number of launches and of
// products, row kernels, stagings, u products and fused folded layers
// among them. Returns kNoPlan when the
// wide engine does not take the widths.
extern "C" int tdm_value_wide(const void* const* wptrs, const int* dims, float lsmin,
                              float lsdif, int episodic, int N, int S, const float* z0, long zn,
                              long zs, const float* actions, long an, long ats, long ass,
                              const int* task, int ntask, const float* amask, long amn,
                              const float* eps, long en, const int* qidx, long qn,
                              const float* discs, long dn, float* out, int* term_at,
                              const void* const* scratch, const long* lds, int* launched,
                              void* stream) {
  const tdm::Sampling given{};
  return value_wide(wptrs, dims, lsmin, lsdif, episodic, N, S, z0, zn, zs, actions, an, ats, ass,
                    given, task, ntask, amask, amn, eps, en, qidx, qn, discs, dn, out, term_at,
                    scratch, lds, launched, stream);
}

// tdm_value_sampled on the wide engine, with the scratch as tdm_value_wide.
extern "C" int tdm_value_sampled_wide(const void* const* wptrs, const int* dims, float lsmin,
                                      float lsdif, int episodic, int N, int S, const float* z0,
                                      long zn, long zs, const float* mean, long mn,
                                      const float* stdv, long sn, const float* noise, long nn,
                                      const float* pi_acts, long pn, int n_pi, float* acts,
                                      const int* task, int ntask, const float* amask, long amn,
                                      const float* eps, long en, const int* qidx, long qn,
                                      const float* discs, long dn, float* out, int* term_at,
                                      const void* const* scratch, const long* lds,
                                      int* launched, void* stream) {
  if (amask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const tdm::Sampling sp{mean, mn, stdv, sn, noise, nn, pi_acts, pn, n_pi, acts};
  return value_wide(wptrs, dims, lsmin, lsdif, episodic, N, S, z0, zn, zs, nullptr, 0, 0, 0, sp,
                    task, ntask, amask, amn, eps, en, qidx, qn, discs, dn, out, term_at,
                    scratch, lds, launched, stream);
}

// The wide engine's staging alone (stage_kernel, as the sampled step on
// the wide engine launches it at step t), for the checks and timings of
// chip_smoke.py and tests/test_torch_cuda.py (no path calls it; ops/wide.py
// stage): step t's actions of N envs of S rows sampled as
// tdm_value_sampled_wide samples them (operands as there), written in f32
// to acts and as bf16 into the action columns of x [N*S, ldx] (the z||a
// rows, zeros up to up16(A)); with load_z also G, q, term and term_at
// (each [N*S], each may be null) zeroed and the latent z0: into its
// columns of x (zeros up to up16(L)), or, folded (zb not null; zs = 0),
// each env's into its row of zb [N, up16(L)] bf16, x's latent columns
// untouched. launched [6] as above.
extern "C" int tdm_wide_stage(const int* dims, int N, int S, int t, int load_z,
                              const float* z0, long zn, long zs, const float* mean, long mn,
                              const float* stdv, long sn, const float* noise, long nn,
                              const float* pi_acts, long pn, int n_pi, float* acts,
                              const float* amask, long amn, void* x, long ldx, float* G,
                              float* q, float* term, int* term_at, void* zb,
                              int* launched, void* stream) {
  using namespace tdm;
  const void* none[kNumOps] = {};
  Scratch sc{};
  sc.x = static_cast<uint16_t*>(x);
  sc.ldx = ldx;
  Wide wd(none, dims, N, S, nullptr, 1, sc, static_cast<cudaStream_t>(stream));
  if (!wide_fits(wd.d)) return kNoPlan;
  if (amask == nullptr || t < 0 || t >= wd.d.H || ldx < up16(wd.d.L) + up16(wd.d.A) ||
      (zb != nullptr && zs != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  StageArgs s{};
  s.t = t;
  s.load_z = load_z;
  s.z0 = z0;
  s.zn = zn;
  s.zs = zs;
  s.sp = Sampling{mean, mn, stdv, sn, noise, nn, pi_acts, pn, n_pi, acts};
  s.amask = amask;
  s.amn = amn;
  s.G = G;
  s.q = q;
  s.term = term;
  s.term_at = term_at;
  s.zb = static_cast<uint16_t*>(zb);
  wd.stage(s);
  wd.report(launched);
  return wd.err;
}

// out = {rows per block, shared bytes of one block, ring stages, blocks
// per SM} of the value kernel at these dims; returns an error code.
extern "C" int tdm_value_plan(const int* dims, int* out) {
  using namespace tdm;
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const Plan pl = pick_plan(d);
  return with_shape(pl.shape, [&](auto t) {
    return plan_report(value_kernel<decltype(t)::rt, decltype(t)::np, true>, pl, out);
  });
}

#ifdef TDM_CYCLES
// Copy the cycle counters (mlp_rows.cuh) to out[5] and reset them.
extern "C" int tdm_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tdm::g_cycles, sizeof(tdm::g_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(tdm::g_cycles, zero, sizeof(zero)));
}
#endif
