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
// through an env stride. Per plan:
//   pi_rollout_kernel  once: the n_pi policy-prior trajectories of each env,
//                      ceil(n_pi / RT) row tiles per env (one at n_pi = 24)
//   then per iteration:
//     sample_kernel    clip(mean + std * noise), policy rows overriding
//     value_kernel     (value.cu) the value of every sample
//     elite_kernel     one block per env: NaN guard, E-th largest value by 32-step
//                      bisection with the TPU kernel's boundary-shell tie
//                      weights, softmax-weighted mean/std update
//
// Bounds, default 5M model at S=512: the value step carries the plan
// (~36 GFLOP over 6 iterations, ~36 us at 989 TFLOP/s). The pi rollout is
// 24 rows on the tensor-core row-tile engine (mlp_rows.cuh): H steps of the
// pi head and the dynamics, whose ~7.9 MB of packed weights its one block
// per env streams from L2 (~0.07 ms at ~64 bytes a cycle); only the m-tiles
// that hold rows are multiplied. The sample and elite kernels move a few
// tens of KB, a few microseconds of launch and latency each, and sit far
// below any throughput bound.
#include "mlp_rows.cuh"

namespace tdm {

template <int RT, int NP>
__global__ void __launch_bounds__(kBlock, 1)
pi_rollout_kernel(Weights w, Dims d, Plan pl, float lsmin, float lsdif, int n_pi,
                  int blocks_per_env, const float* z0, long zn, const float* pi_eps, long pn,
                  float* pi_acts) {
  extern __shared__ uint4 smem_u4[];
  const Tile tl(smem_u4, pl, d);
  const Heads hd(w, d, pl);
  const int env = blockIdx.x / blocks_per_env;
  const int row0 = (blockIdx.x % blocks_per_env) * RT;
  const int nrows = min(RT, n_pi - row0);
  const int HA = d.H * d.A;
  z0 += env * zn;
  pi_eps += env * pn;
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
      const float a = pi_action(tl, d, r, c, e, lsmin, lsdif);
      if (r < nrows) pi_acts[(row0 + r) * HA + t * d.A + c] = a;
      tl.z[r * tl.ldz + tl.Lp + c] = bf16_bits(a);
    }
    sync_consumers();
    dynamics<RT, NP>(st, tl, d, w, hd);
  }
}

// Element i of the [N, S, HA] output: env i / (S*HA), sample s, column c.
__global__ void sample_kernel(const float* mean, const float* stdv, const float* noise,
                              long nn, const float* pi_acts, const float* amask, int N,
                              int S, int HA, int A, int n_pi, float* acts) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long>(N) * S * HA) return;
  const int env = static_cast<int>(i / (static_cast<long>(S) * HA));
  const int k = static_cast<int>(i % (static_cast<long>(S) * HA));
  const int s = k / HA, c = k % HA;
  const int m = env * HA + c;
  // _rn intrinsics: no contraction into an fma, the plain version's rounding
  const float x = __fadd_rn(mean[m], __fmul_rn(stdv[m], noise[env * nn + k]));
  const float a = s < n_pi ? pi_acts[(static_cast<long>(env) * n_pi + s) * HA + c]
                           : fminf(fmaxf(x, -1.f), 1.f);
  acts[i] = a * amask[c % A];
}

// Block-wide reductions over kThreads threads; `red` holds kWarps+1 floats.
template <typename Op>
__device__ float block_reduce(float x, float* red, Op op) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    // xor offsets below kWarps (a power of two) keep lanes 0..kWarps-1 among
    // themselves, so lane 0 ends with the reduction of red[0..kWarps-1]
    float y = red[lane & (kWarps - 1)];
    for (int o = kWarps / 2; o > 0; o >>= 1) y = op(y, __shfl_xor_sync(0xffffffffu, y, o));
    if (lane == 0) red[kWarps] = y;
  }
  __syncthreads();
  const float out = red[kWarps];
  __syncthreads();
  return out;
}

struct SumOp { __device__ float operator()(float a, float b) const { return a + b; } };
struct MaxOp { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct MinOp { __device__ float operator()(float a, float b) const { return fminf(a, b); } };

__device__ float count_ge(const float* v, int S, float thr, float* red) {
  float c = 0.f;
  for (int i = threadIdx.x; i < S; i += kThreads) c += v[i] >= thr ? 1.f : 0.f;
  return block_reduce(c, red, SumOp());
}

// One block per env. v_in [N, S] -> v_out [N, S] NaN/huge-guarded; acts
// [N, S, HA]; new mean/std [N, HA]. The order of f32 operations follows
// the TPU kernel (pallas_cem.py:186-231).
__global__ void __launch_bounds__(kThreads)
elite_kernel(const float* v_in, const float* acts, const float* amask, int S, int HA,
             int A, float E, float temperature, float min_std, float max_std,
             float* v_out, float* mean_out, float* std_out) {
  const int env = blockIdx.x;
  v_in += static_cast<long>(env) * S;
  v_out += static_cast<long>(env) * S;
  acts += static_cast<long>(env) * S * HA;
  mean_out += env * HA;
  std_out += env * HA;
  extern __shared__ float4 smem_f4[];
  float* v = reinterpret_cast<float*>(smem_f4);
  float* score = v + S;
  float* red = score + S;

  float lmax = __int_as_float(0xff800000), lmin = __int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < S; i += kThreads) {
    float x = v_in[i];
    x = (x == x && fabsf(x) <= 3.0e38f) ? x : 0.f;
    v[i] = x;
    v_out[i] = x;
    lmax = fmaxf(lmax, x);
    lmin = fminf(lmin, x);
  }
  const float vmax = block_reduce(lmax, red, MaxOp());
  float lo = block_reduce(lmin, red, MinOp());
  float hi = __fadd_rn(__fadd_rn(vmax, __fmul_rn(0.001f, fabsf(vmax))), 1.f);
  for (int it = 0; it < 32; ++it) {
    const float mid = __fadd_rn(lo, __fmul_rn(0.5f, __fsub_rn(hi, lo)));
    const bool ge = count_ge(v, S, mid, red) >= E;
    lo = ge ? mid : lo;
    hi = ge ? hi : mid;
  }
  const float n1 = count_ge(v, S, hi, red);
  const float nb = __fsub_rn(count_ge(v, S, lo, red), n1);
  const float wb = __fdiv_rn(__fsub_rn(E, n1), fmaxf(nb, 1.f));

  float ls = 0.f;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const float x = v[i];
    const float wgt = x >= hi ? 1.f : (x >= lo ? wb : 0.f);
    const float s = __fmul_rn(expf(__fmul_rn(temperature, __fsub_rn(x, vmax))), wgt);
    score[i] = s;
    ls += s;
  }
  const float total = block_reduce(ls, red, SumOp());
  float ld = 0.f;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    score[i] = __fdiv_rn(score[i], total);
    ld += score[i];
  }
  const float denom = __fadd_rn(block_reduce(ld, red, SumOp()), 1e-9f);

  // one warp per column of the [S, HA] actions
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < HA; c += kWarps) {
    float m = 0.f;
    for (int s = lane; s < S; s += 32) m += score[s] * acts[s * HA + c];
    m = __fdiv_rn(warp_sum(m), denom);
    float q = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float dv = acts[s * HA + c] - m;
      q += score[s] * dv * dv;
    }
    const float sd = fminf(fmaxf(sqrtf(__fdiv_rn(warp_sum(q), denom)), min_std), max_std);
    if (lane == 0) {
      const float mk = amask[c % A];
      mean_out[c] = m * mk;
      std_out[c] = sd * mk;
    }
  }
}

template <int RT, int NP>
int launch_pi(const Weights& w, const Dims& d, const Plan& pl, float lsmin, float lsdif, int N,
              int n_pi, const float* z0, long zn, const float* pi_eps, long pn, float* pi_acts,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pi_rollout_kernel<RT, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_per_env = (n_pi + RT - 1) / RT;
  pi_rollout_kernel<RT, NP><<<N * blocks_per_env, kBlock, pl.bytes, stream>>>(
      w, d, pl, lsmin, lsdif, n_pi, blocks_per_env, z0, zn, pi_eps, pn, pi_acts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdm

// Each launch function runs on `stream` and returns cudaGetLastError()
// (the pi rollout: kNoPlan when no row tile fits the widths).
// pi rollout of env e: z0 + e*zn ([L]), pi_eps + e*pn ([n_pi, HA]);
// pi_acts [N, n_pi, HA].
extern "C" int tdm_pi_rollout(const void* const* wptrs, const int* dims, float lsmin,
                              float lsdif, int N, int n_pi, const float* z0, long zn,
                              const float* pi_eps, long pn, float* pi_acts, void* stream) {
  using namespace tdm;
  Weights w;
  for (int i = 0; i < kNumOps; ++i) w.p[i] = wptrs[i];
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const Plan pl = pick_plan(d);
  if (pl.shape < 0) return kNoPlan;
  return with_shape(pl.shape, [&](auto t) {
    return launch_pi<decltype(t)::rt, decltype(t)::np>(w, d, pl, lsmin, lsdif, N, n_pi, z0, zn,
                                                        pi_eps, pn, pi_acts,
                                                        static_cast<cudaStream_t>(stream));
  });
}

// out = {rows per block, shared bytes, ring stages, blocks per SM} of the
// pi-rollout kernel at these dims; returns an error code.
extern "C" int tdm_pi_rollout_plan(const int* dims, int* out) {
  using namespace tdm;
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const Plan pl = pick_plan(d);
  return with_shape(pl.shape, [&](auto t) {
    return plan_report(pi_rollout_kernel<decltype(t)::rt, decltype(t)::np>, pl, out);
  });
}

// mean/std [N, HA]; noise of env e: noise + e*nn ([S, HA]); pi_acts
// [N, n_pi, HA]; acts [N, S, HA].
extern "C" int tdm_sample(const float* mean, const float* stdv, const float* noise, long nn,
                          const float* pi_acts, const float* amask, int N, int S, int HA,
                          int A, int n_pi, float* acts, void* stream) {
  const long n = static_cast<long>(N) * S * HA;
  const int threads = 256;
  tdm::sample_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(mean, stdv, noise, nn, pi_acts,
                                                            amask, N, S, HA, A, n_pi, acts);
  return static_cast<int>(cudaGetLastError());
}

// v_in, v_out [N, S]; acts [N, S, HA]; mean_out, std_out [N, HA].
extern "C" int tdm_elite(const float* v_in, const float* acts, const float* amask, int N,
                         int S, int HA, int A, int num_elites, float temperature, float min_std,
                         float max_std, float* v_out, float* mean_out, float* std_out,
                         void* stream) {
  using namespace tdm;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(S) + kWarps + 1);
  cudaError_t err = cudaFuncSetAttribute(
      elite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  elite_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      v_in, acts, amask, S, HA, A, static_cast<float>(num_elites), temperature, min_std,
      max_std, v_out, mean_out, std_out);
  return static_cast<int>(cudaGetLastError());
}
