// Reward + dynamics rollout: the H-step discounted model return and the
// final latent, for S action sequences (single-task).
//
// Replaces the TPU kernel _rollout_kernel (tdmpc2_tpu/ops/pallas_rollout.py,
// launched by rollout_prepared / fused_value_rollout). For each row:
//   G   = sum_t discs[t] * symexp(two_hot(reward(z_t, a_t)))
//   z_H = dyn(... dyn(z_0, a_0) ..., a_{H-1})        (f32, not rounded)
//
// It is value.cu without the policy and Q tail: the same row-block code
// (mlp_rows.cuh), one block per kRows rows with every activation of the
// rollout in shared memory, bf16 weights read from L2, dot inputs rounded
// to bf16 and f32 accumulation as the TPU kernel does with
// dot_dtype=bf16. The last dynamics step keeps its SimNorm output in f32,
// because z_H is written out instead of feeding another dot.
//
// Bound: at the default 5M model, S=512, H=3 one call does ~4.2 GFLOP of
// bf16-input products (~4.2 us at 989 TFLOP/s) against ~5 MB of weights,
// latents and actions (~1.5 us at 3.35 TB/s): compute-bound. Like value.cu
// this first version runs its products on the FMA pipes, far from that
// bound; the tensor-core redesign of the row-block code serves both.
#include "mlp_rows.cuh"

namespace tdm {

__global__ void __launch_bounds__(kThreads)
rollout_kernel(Weights w, Dims d, int S, const float* z0, long zs, const float* actions,
               long ats, long ass, const float* discs, float* G_out, float* zH) {
  extern __shared__ float4 smem_f4[];
  const RowSmem sm(reinterpret_cast<float*>(smem_f4), d);
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, S - row0);
  float* G = sm.s0;   // discounted reward sum
  float* r = sm.s1;   // decoded reward of the current step

  load_z(sm, d, z0, zs, row0, nrows);
  if (threadIdx.x < kRows) G[threadIdx.x] = 0.f;
  for (int t = 0; t < d.H; ++t) {
    for (int i = threadIdx.x; i < kRows * d.A; i += kThreads) {
      const int rr = i / d.A, c = i % d.A;
      sm.a[rr * sm.ldA + c] =
          rr < nrows ? bf16r(actions[t * ats + (row0 + rr) * ass + c]) : 0.f;
    }
    __syncthreads();
    hidden2(sm, d, sm.z, sm.ldL, d.L, w.bf(rWz), sm.a, sm.ldA, d.A, w.bf(rWa), w.f(rb0),
            w.f(rg0), w.f(re0), w.bf(rW1), w.f(rb1), w.f(rg1), w.f(re1));
    mm_rows(sm.h2, sm.ldM, d.M, w.bf(rW2), nullptr, 0, 0, nullptr, w.f(rb2), d.B, sm.lg,
            sm.ldB);
    __syncthreads();
    two_hot_rows(sm.lg, sm.ldB, d.B, w.f(bins), r);
    __syncthreads();
    if (threadIdx.x < kRows) G[threadIdx.x] += discs[t] * r[threadIdx.x];
    dynamics_rows(sm, d, w, t + 1 < d.H);
  }
  if (threadIdx.x < nrows) G_out[row0 + threadIdx.x] = G[threadIdx.x];
  for (int i = threadIdx.x; i < nrows * d.L; i += kThreads) {
    const int rr = i / d.L, c = i % d.L;
    zH[static_cast<long>(row0 + rr) * d.L + c] = sm.z[rr * sm.ldL + c];
  }
}

}  // namespace tdm

// Launch on `stream`; returns cudaGetLastError() after the launch. Only
// the dynamics and reward weights and `bins` of wptrs are read.
extern "C" int tdm_rollout(const void* const* wptrs, const int* dims, int S, const float* z0,
                           long zs, const float* actions, long ats, long ass,
                           const float* discs, float* G, float* zH, void* stream) {
  using namespace tdm;
  Weights w;
  for (int i = 0; i < kNumWeights; ++i) w.p[i] = wptrs[i];
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  const size_t smem = RowSmem::bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (S + kRows - 1) / kRows;
  rollout_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, d, S, z0, zs, actions, ats, ass, discs, G, zH);
  return static_cast<int>(cudaGetLastError());
}
