// Planner value estimate: H-step reward + dynamics rollout, terminal policy
// prior, 2-of-num_q Q bootstrap, and on episodic tasks the sticky
// termination gate (single-task).
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
// ceil(S / kRows) blocks, env = block / blocks_per_env, and a block never
// straddles two envs (its last rows are masked when S % kRows != 0). Every
// per-env operand is addressed through an env stride, so the planner's
// broadcast latent and its strided per-iteration noise need no copies.
//
// Bound: at the default 5M model and S=512 one env's call does ~5.9 GFLOP of
// bf16-input products over ~6 MB of weights: ~6.0 us at 989 TFLOP/s
// against ~1.8 us at 3.35 TB/s, so the work is compute-bound. This first
// version runs its products on the FMA pipes, not the tensor cores, and is
// far from that bound. Its design: one block per kRows=8 rows keeps every
// activation of the whole rollout in shared memory (nothing but the result
// goes back to device memory); all blocks read the same bf16 weights, which
// the 50 MB L2 holds, so device memory sees them about once per call. N
// envs multiply the work by N and leave the weight bytes as they are.
// The termination head (episodic) adds L*M + M*M + M multiply-adds per row
// and step, ~27% at the default model, and reuses the hidden buffers: the
// shared memory per block does not grow.
// The grouped SimNorm softmax is computed directly, where the TPU kernel
// used a block-diagonal mask product.
#include "mlp_rows.cuh"

namespace tdm {

__global__ void __launch_bounds__(kThreads)
value_kernel(Weights w, Dims d, float lsmin, float lsdif, int episodic, int S,
             int blocks_per_env,
             const float* z0, long zn, long zs, const float* actions, long an, long ats,
             long ass, const float* eps, long en, const int* qidx, long qn,
             const float* discs, long dn, float* out, int* term_at) {
  extern __shared__ float4 smem_f4[];
  const RowSmem sm(reinterpret_cast<float*>(smem_f4), d);
  const int env = blockIdx.x / blocks_per_env;
  const int row0 = (blockIdx.x % blocks_per_env) * kRows;
  const int nrows = min(kRows, S - row0);
  z0 += env * zn;
  actions += env * an;
  eps += env * en;
  qidx += env * qn;
  discs += env * dn;
  out += static_cast<long>(env) * S;
  if (term_at != nullptr) term_at += static_cast<long>(env) * S;
  float* G = sm.s0;   // discounted reward sum
  float* r = sm.s1;   // decoded reward / Q of the current head
  float* q = sm.s2;   // Q sum over the two heads
  float* term = sm.s3;  // sticky termination flag, 0 or 1

  load_z(sm, d, z0, zs, row0, nrows);
  if (threadIdx.x < kRows) {
    G[threadIdx.x] = 0.f;
    q[threadIdx.x] = 0.f;
    term[threadIdx.x] = 0.f;
    if (term_at != nullptr && threadIdx.x < nrows) term_at[row0 + threadIdx.x] = 0;
  }
  for (int t = 0; t < d.H; ++t) {
    for (int i = threadIdx.x; i < kRows * d.A; i += kThreads) {
      const int rr = i / d.A, c = i % d.A;
      sm.a[rr * sm.ldA + c] =
          rr < nrows ? bf16r(actions[t * ats + (row0 + rr) * ass + c]) : 0.f;
    }
    __syncthreads();
    // reward head on (z_t, a_t)
    hidden2(sm, d, sm.z, sm.ldL, d.L, w.bf(rWz), sm.a, sm.ldA, d.A, w.bf(rWa), w.f(rb0),
            w.f(rg0), w.f(re0), w.bf(rW1), w.f(rb1), w.f(rg1), w.f(re1));
    mm_rows(sm.h2, sm.ldM, d.M, w.bf(rW2), nullptr, 0, 0, nullptr, w.f(rb2), d.B, sm.lg,
            sm.ldB);
    __syncthreads();
    two_hot_rows(sm.lg, sm.ldB, d.B, w.f(bins), r);
    __syncthreads();
    if (threadIdx.x < kRows) {
      G[threadIdx.x] += discs[t] * ((1.f - term[threadIdx.x]) * r[threadIdx.x]);
    }
    // z_{t+1}
    dynamics_rows(sm, d, w);
    if (episodic) {
      // the reward in r was consumed above: the logits go there
      termination_rows(sm, d, w, r);
      if (threadIdx.x < kRows) {
        const float hit = r[threadIdx.x] > 0.f ? 1.f : 0.f;
        if (term_at != nullptr && threadIdx.x < nrows && term[threadIdx.x] == 0.f &&
            hit != 0.f) {
          term_at[row0 + threadIdx.x] = t + 1;
        }
        term[threadIdx.x] = fminf(term[threadIdx.x] + hit, 1.f);
      }
    }
  }

  // terminal policy prior action
  pi_head_rows(sm, d, w);
  for (int i = threadIdx.x; i < kRows * d.A; i += kThreads) {
    const int rr = i / d.A, c = i % d.A;
    const float e = rr < nrows ? eps[(row0 + rr) * d.A + c] : 0.f;
    sm.a[rr * sm.ldA + c] = bf16r(pi_action(sm, d, rr, c, e, lsmin, lsdif));
  }
  __syncthreads();

  // the two Q heads named by qidx
  for (int j = 0; j < 2; ++j) {
    const int h = min(max(qidx[j], 0), d.NQ - 1);
    const long M = d.M;
    hidden2(sm, d, sm.z, sm.ldL, d.L, w.bf(qWz) + h * d.L * M, sm.a, sm.ldA, d.A,
            w.bf(qWa) + h * d.A * M, w.f(qb0) + h * M, w.f(qg0) + h * M,
            w.f(qe0) + h * M, w.bf(qW1) + h * M * M, w.f(qb1) + h * M, w.f(qg1) + h * M,
            w.f(qe1) + h * M);
    mm_rows(sm.h2, sm.ldM, d.M, w.bf(qW2) + h * M * d.B, nullptr, 0, 0, nullptr,
            w.f(qb2) + static_cast<long>(h) * d.B, d.B, sm.lg, sm.ldB);
    __syncthreads();
    two_hot_rows(sm.lg, sm.ldB, d.B, w.f(bins), r);
    __syncthreads();
    if (threadIdx.x < kRows) q[threadIdx.x] += r[threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x < nrows) {
    out[row0 + threadIdx.x] =
        G[threadIdx.x] + discs[d.H] * ((1.f - term[threadIdx.x]) * (q[threadIdx.x] / 2.f));
  }
}

}  // namespace tdm

// Launch on `stream`; returns cudaGetLastError() after the launch.
// Operands of env e: z0 + e*zn (rows zs apart, 0 broadcasts one row),
// actions + e*an ([H, S, A] with strides ats, ass, 1), eps + e*en ([S, A]),
// qidx + e*qn ([2]), discs + e*dn ([H+1]); out [N, S]; term_at [N, S] or
// null. `episodic` (0/1) needs the termination head's weights among wptrs.
extern "C" int tdm_value(const void* const* wptrs, const int* dims, float lsmin, float lsdif,
                         int episodic, int N, int S, const float* z0, long zn, long zs,
                         const float* actions, long an, long ats, long ass, const float* eps,
                         long en, const int* qidx, long qn, const float* discs, long dn,
                         float* out, int* term_at, void* stream) {
  using namespace tdm;
  Weights w;
  for (int i = 0; i < kNumWeights; ++i) w.p[i] = wptrs[i];
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const size_t smem = RowSmem::bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_per_env = (S + kRows - 1) / kRows;
  value_kernel<<<N * blocks_per_env, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, d, lsmin, lsdif, episodic, S, blocks_per_env, z0, zn, zs, actions, an, ats, ass,
      eps, en, qidx, qn, discs, dn, out, term_at);
  return static_cast<int>(cudaGetLastError());
}

// out[0] = shared-memory bytes of one block, out[1] = blocks of the value
// kernel that fit one SM at that size; returns the CUDA error code.
extern "C" int tdm_value_occupancy(const int* dims, int* out) {
  using namespace tdm;
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const size_t smem = RowSmem::bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(smem);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], value_kernel, kThreads, smem));
}
