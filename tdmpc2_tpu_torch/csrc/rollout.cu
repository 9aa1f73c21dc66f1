// Reward + dynamics rollout: the H-step discounted model return and the
// final latent, for S action sequences (single-task).
//
// Replaces the TPU kernel _rollout_kernel (tdmpc2_tpu/ops/pallas_rollout.py,
// launched by rollout_prepared / fused_value_rollout). For each row:
//   G   = sum_t discs[t] * symexp(two_hot(reward(z_t, a_t)))
//   z_H = dyn(... dyn(z_0, a_0) ..., a_{H-1})        (f32, not rounded)
//
// It runs on the layer-per-launch engine (mlp_wide.cuh) at every width:
// per step, the actions staged (the latent too at t = 0), the reward
// head's three layers, the dynamics' three; each layer a tiled product over
// (column tile x row tile) blocks on the tensor cores, then a row kernel
// (LayerNorm and Mish, the two-hot decode into G, SimNorm into the next
// step's bf16 input, and at the last step z_H in f32). Dot inputs are
// rounded to bf16 and sums kept in f32, as the TPU kernel does with
// dot_dtype=bf16.
//
// Bound: at the default 5M model, S=512, H=3 one call does ~4.2 GFLOP of
// bf16-input products (~4.2 us at 989 TFLOP/s) against ~5 MB of weights,
// latents and actions (~1.5 us at 3.35 TB/s): compute-bound, but far
// smaller than the 39 launches' fixed costs. The row-tile version it
// replaces ran 16 blocks (one a 32-row tile) that each streamed all ~8 MB
// of the step's packed weights from L2; here each layer spreads over
// (columns / 128) x (S / 128) blocks.
#include "mlp_wide.cuh"

// Launch on `stream`; returns cudaGetLastError() after the last launch, or
// kNoPlan when the widths are above the wide engine's. Only the dynamics
// and reward operands and `bins` of wptrs are read. z0 [S, L] rows zs
// apart (0 broadcasts one row); actions [H, S, A] with strides ats, ass, 1;
// discs [H]; G [S] receives the return and zH [S, L] the final latent. The
// scratch buffers (x, h, y; ops/wide.py) and their row strides follow;
// `launched` receives the number of launches.
extern "C" int tdm_rollout(const void* const* wptrs, const int* dims, int S, const float* z0,
                           long zs, const float* actions, long ats, long ass,
                           const float* discs, float* G, float* zH,
                           const void* const* scratch, const long* lds, int* launched,
                           void* stream) {
  using namespace tdm;
  Scratch sc = scratch_from(scratch, lds);
  sc.G = G;
  sc.q = nullptr;
  sc.term = nullptr;
  Wide wd(wptrs, dims, 1, S, nullptr, 1, sc, static_cast<cudaStream_t>(stream));
  if (!wide_fits(wd.d)) return kNoPlan;
  for (int t = 0; t < wd.d.H; ++t) {
    StageArgs s{};
    s.t = t;
    s.load_z = t == 0;
    s.z0 = z0;
    s.zs = zs;
    s.actions = actions;
    s.ats = ats;
    s.ass = ass;
    s.G = G;
    wd.stage(s);
    wd.reward(discs, 0, t);
    wd.dynamics(t + 1 == wd.d.H ? zH : nullptr);
  }
  *launched = wd.launched;
  return wd.err;
}
