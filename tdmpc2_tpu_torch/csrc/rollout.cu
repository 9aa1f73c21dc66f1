// Reward + dynamics rollout: the H-step discounted model return and the
// final latent, for S action sequences (single-task).
//
// Replaces the TPU kernel _rollout_kernel (tdmpc2_tpu/ops/pallas_rollout.py,
// launched by rollout_prepared / fused_value_rollout). For each row:
//   G   = sum_t discs[t] * symexp(two_hot(reward(z_t, a_t)))
//   z_H = dyn(... dyn(z_0, a_0) ..., a_{H-1})        (f32, not rounded)
//
// It is value.cu's first half on the same row-tile engine (mlp_rows.cuh):
// RT rows a block with every activation of the rollout in shared memory,
// products on the tensor cores, packed bf16 weights streamed from L2 into
// a ring of shared-memory stages by bulk copies, dot inputs rounded to bf16
// and f32 sums as the TPU kernel does with dot_dtype=bf16. The last
// dynamics step writes its SimNorm output to z_H in f32 from the
// accumulators, because z_H is written out instead of feeding another dot.
//
// Bound: at the default 5M model, S=512, H=3 one call does ~4.2 GFLOP of
// bf16-input products (~4.2 us at 989 TFLOP/s) against ~5 MB of weights,
// latents and actions (~1.5 us at 3.35 TB/s): compute-bound. Each block
// streams the ~8 MB of packed reward and dynamics weights of the H steps
// from L2, ~0.07 ms at ~64 bytes a cycle per SM.
#include "mlp_rows.cuh"

namespace tdm {

template <int RT, int NP>
__global__ void __launch_bounds__(kBlock, 1)
rollout_kernel(Weights w, Dims d, Plan pl, int S, const float* z0, long zs,
               const float* actions, long ats, long ass, const float* discs, float* G_out,
               float* zH) {
  extern __shared__ uint4 smem_u4[];
  const Tile tl(smem_u4, pl, d);
  const Heads hd(w, d, pl);
  const int row0 = blockIdx.x * RT;
  const int nrows = min(RT, S - row0);
  float* G = tl.s0;  // discounted reward sum
  float* r = tl.s1;  // decoded reward of the current step

  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < d.H; ++t) {
      for (int i = 0; i < 3; ++i) tl.mats[n++] = hd.rew(i);
      for (int i = 0; i < 3; ++i) tl.mats[n++] = hd.dyn(i);
    }
  }
  load_z(tl, d, z0, zs, row0, nrows);
  if (threadIdx.x < RT) G[threadIdx.x] = 0.f;
  ring_init(tl, pl);
  __syncthreads();
  if (threadIdx.x >= kThreads) {
    produce(tl, pl, 6 * d.H);
    return;
  }
  Stream st(tl, pl);
  for (int t = 0; t < d.H; ++t) {
    put_actions(tl, d, actions + t * ats, ass, row0, nrows);
    reward<RT, NP>(st, tl, d, w, hd, r);
    if (threadIdx.x < RT) G[threadIdx.x] += discs[t] * r[threadIdx.x];
    const bool last = t + 1 == d.H;
    dynamics<RT, NP>(st, tl, d, w, hd, last ? zH + static_cast<long>(row0) * d.L : nullptr,
                     nrows);
  }
  if (threadIdx.x < nrows) G_out[row0 + threadIdx.x] = G[threadIdx.x];
}

template <int RT, int NP>
int launch_rollout(const Weights& w, const Dims& d, const Plan& pl, int S, const float* z0,
                   long zs, const float* actions, long ats, long ass, const float* discs,
                   float* G, float* zH, cudaStream_t stream) {
  const cudaError_t err = opt_in_smem(rollout_kernel<RT, NP>, pl.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  rollout_kernel<RT, NP><<<(S + RT - 1) / RT, kBlock, pl.bytes, stream>>>(
      w, d, pl, S, z0, zs, actions, ats, ass, discs, G, zH);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdm

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// kNoPlan when no row tile fits the widths. Only the dynamics and reward
// operands and `bins` of wptrs are read.
extern "C" int tdm_rollout(const void* const* wptrs, const int* dims, int S, const float* z0,
                           long zs, const float* actions, long ats, long ass,
                           const float* discs, float* G, float* zH, void* stream) {
  using namespace tdm;
  Weights w;
  for (int i = 0; i < kNumOps; ++i) w.p[i] = wptrs[i];
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const Plan pl = pick_plan(d);
  if (pl.shape < 0) return kNoPlan;
  return with_shape(pl.shape, [&](auto t) {
    return launch_rollout<decltype(t)::rt, decltype(t)::np>(
        w, d, pl, S, z0, zs, actions, ats, ass, discs, G, zH, static_cast<cudaStream_t>(stream));
  });
}

// out = {rows per block, shared bytes, ring stages, blocks per SM} of the
// rollout kernel at these dims; returns an error code.
extern "C" int tdm_rollout_plan(const int* dims, int* out) {
  using namespace tdm;
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const Plan pl = pick_plan(d);
  return with_shape(pl.shape, [&](auto t) {
    return plan_report(rollout_kernel<decltype(t)::rt, decltype(t)::np>, pl, out);
  });
}
