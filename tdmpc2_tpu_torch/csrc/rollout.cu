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
// (columns / 128) x (S / 64) blocks (the wide engine's small tile).
#include "mlp_wide.cuh"

// Launch on `stream`; returns cudaGetLastError() after the last launch, or
// kNoPlan when the widths are above the wide engine's. Only the dynamics
// and reward operands and `bins` of wptrs are read. z0 [S, L] rows zs
// apart (0 broadcasts one row); actions [H, S, A] with strides ats, ass, 1;
// discs [H]; G [S] receives the return and zH [S, L] the final latent. The
// scratch buffers (x, h, y; ops/wide.py) and their row strides follow;
// `launched` [6] receives the number of launches and of products, row
// kernels, stagings, u products and fused layers among them.
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
  wd.report(launched);
  return wd.err;
}

// One product of the wide engine on given operands, as Wide::gemm launches
// it for the model dims `dims` and N envs of S rows, for the checks and
// timings of chip_smoke.py and tests/test_torch_cuda.py (no path calls
// it): y = x . W + bias with x [N*S, ldx] bf16 (its first 16 kt columns
// read), W the wide layout [heads, ncols, 16 kt] bf16 (heads = num_q where
// `head` is not null), or the first 16 kt columns of its rows, ldw apart
// (0: 16 kt; a block of a first layer's wide layout), bias b[task * bt +
// head * bh + c] (b1[c - split] from column split on), task [N] or null,
// head[e * hn] or null; y [N*S, ldy]
// f32 receives the product, or its partial rows pstride columns apart when
// K is split (the engine's rule, gemm_splits). plan receives {rows and
// columns of a tile, consumer warpgroups, splits, stages a split, pstride,
// tiles in x, y, z, blocks launched}; launched [6] as above.
extern "C" int tdm_wide_gemm(const int* dims, int N, int S, const void* x, long ldx, int kt,
                             const void* w, long ldw, int ncols, const float* b, long bt,
                             long bh, const float* b1, int split, const int* task, int ntask,
                             const int* head, long hn, float* y, long ldy, int* plan,
                             int* launched, void* stream) {
  using namespace tdm;
  const void* none[kNumOps] = {};
  Scratch sc{};
  sc.y = y;
  sc.ldy = ldy;
  Wide wd(none, dims, N, S, task, ntask, sc, static_cast<cudaStream_t>(stream));
  if (!wide_fits(wd.d)) return kNoPlan;
  if (ldw != 0 && ldw < 16L * kt) return static_cast<int>(cudaErrorInvalidValue);
  wd.gemm(static_cast<const uint16_t*>(x), ldx, kt, w, ncols, b, bt, bh, head, hn, b1, split,
          ldw);
  const GemmPlan& p = wd.last;
  const int out[10] = {p.bm, p.bn, p.wgs, p.splits, p.kchunk, p.pstride,
                       p.gx, p.gy, p.gz, p.blocks};
  for (int i = 0; i < 10; ++i) plan[i] = out[i];
  wd.report(launched);
  return wd.err;
}

// One row kernel of the wide engine on given operands, as Wide::rows
// launches it after a product, for the checks and timings of chip_smoke.py
// and tests/test_torch_cuda.py (no path calls it; ops/wide.py rows): mode
// (RowMode) on the rows of N envs of S rows of y [N*S, ldy] f32, each the
// product's row or its nsplit partial rows pstride columns apart, at the
// widths of dims (ncols: M, L, B, 2A or 1 by the mode; SimNorm's group, A).
// p = {gain, beta, head, bins, dst, fdst, G, q, term, term_at, discs, out,
// eps, amask}, n = {gh, hn, nhead, ldd, dpad, ldf, dn, t, en, es, amn}, as
// RowArgs reads them. plan receives {threads a row, row groups a block, ring
// stages, shared bytes a block, blocks launched, blocks the card holds};
// launched [6] as above.
extern "C" int tdm_wide_rows(const int* dims, int mode, int N, int S, const float* y, long ldy,
                             int nsplit, int pstride, const void* const* p, const long* n,
                             float lsmin, float lsdif, int* plan, int* launched,
                             void* stream) {
  using namespace tdm;
  const void* none[kNumOps] = {};
  Scratch sc{};
  sc.y = const_cast<float*>(y);
  sc.ldy = ldy;
  Wide wd(none, dims, N, S, nullptr, 1, sc, static_cast<cudaStream_t>(stream));
  if (!wide_fits(wd.d) || mode < kRowHidden || mode > kRowTerm) return kNoPlan;
  if (nsplit < 1 || nsplit > kWMaxSplits || (n[4] & 3) != 0) return cudaErrorInvalidValue;
  const int widths[7] = {wd.d.M, wd.d.L, wd.d.B, wd.d.B, wd.d.B, 2 * wd.d.A, 1};
  RowArgs a = wd.row_args(mode, widths[mode]);
  auto f = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  a.gain = f(0);
  a.beta = f(1);
  a.head = static_cast<const int*>(p[2]);
  a.bins = f(3);
  a.dst = static_cast<uint16_t*>(const_cast<void*>(p[4]));
  a.fdst = f(5);
  a.G = f(6);
  a.q = f(7);
  a.term = f(8);
  a.term_at = static_cast<int*>(const_cast<void*>(p[9]));
  a.discs = f(10);
  a.out = f(11);
  a.eps = f(12);
  a.amask = f(13);
  a.gh = n[0];
  a.hn = n[1];
  a.nhead = static_cast<int>(n[2]);
  a.ldd = n[3];
  a.dpad = static_cast<int>(n[4]);
  a.ldf = n[5];
  a.dn = n[6];
  a.t = static_cast<int>(n[7]);
  a.en = n[8];
  a.es = n[9];
  a.amn = n[10];
  a.lsmin = lsmin;
  a.lsdif = lsdif;
  wd.last.splits = nsplit;
  wd.last.pstride = pstride;
  wd.rows(a);
  for (int i = 0; i < 6; ++i) plan[i] = wd.row_plan[i];
  wd.report(launched);
  return wd.err;
}

// The u product of a folded first layer alone (fold_u_kernel, as
// Wide::hidden2 launches it at a value step's t = 0), for the checks and
// timings of chip_smoke.py and tests/test_torch_cuda.py (no path calls it;
// ops/wide.py fold_u): u = zb . W for the N envs' latents zb [N, ldz]
// bf16 (its first 16 kt columns read), W the latent block of a first
// layer's wide layout (column c's 16 kt weights at W + c ldw, bf16); u f32
// receives split z's partial row of env e at u + z N ldu + e ldu, as many
// splits as the plan's (ops/wide.py fold_splits). plan receives {env tiles
// of 64 a block, splits, stages a split, floats from one split's rows to
// the next, blocks in x, y, z, blocks launched}; launched [6] as above.
extern "C" int tdm_wide_fold_u(const int* dims, int N, const void* zb, long ldz, int kt,
                               const void* w, long ldw, int ncols, float* u, long ldu,
                               int* plan, int* launched, void* stream) {
  using namespace tdm;
  const void* none[kNumOps] = {};
  Scratch sc{};
  Wide wd(none, dims, N, 1, nullptr, 1, sc, static_cast<cudaStream_t>(stream));
  if (!wide_fits(wd.d)) return kNoPlan;
  if (ldw < 16L * kt || ldz < 16L * kt) return static_cast<int>(cudaErrorInvalidValue);
  wd.fold_u(static_cast<const uint16_t*>(zb), ldz, kt, w, ldw, ncols, N, u, ldu);
  const FoldPlan& p = wd.fold;
  const long out[8] = {p.ke, p.splits, p.kchunk, p.pstride, p.gx, p.gy, p.gz, p.blocks};
  for (int i = 0; i < 8; ++i) plan[i] = static_cast<int>(out[i]);
  wd.report(launched);
  return wd.err;
}

// The fused folded layer alone (fold_hidden_kernel, as Wide::hidden2
// launches it after the u product), for the checks and timings of
// chip_smoke.py and tests/test_torch_cuda.py (no path calls it; ops/wide.py
// fold_hidden): for each row r of N envs of S rows, h = mish(LN(x_a[r] .
// Wa + (u[env] + b[task[env] * bt]))) at the widths of dims (M columns, A
// actions): x_a the rows' action columns [N*S, ldx] bf16 (A values, zeros
// to up16(A)), Wa the action block of the layout (column c's weights at w
// + c ldw, bf16), u env e's nsplit partial rows at u + z pstride + e ldu,
// summed in order, then env e's row of the bias table b added (task [N]
// or null: task 0, of ntask), gain and beta [M] f32; h [N*S, ldh] bf16
// receives the row and zeros from M to up16(M). plan receives {threads a
// row, row groups a block, action chunks of 8, shared bytes a block,
// blocks launched, blocks the card holds}; launched [6] as above.
extern "C" int tdm_wide_fold_hidden(const int* dims, int N, int S, const void* x, long ldx,
                                    const void* w, long ldw, const float* u, long ldu,
                                    long pstride, int nsplit, const float* b, long bt,
                                    const int* task, int ntask, const float* gain,
                                    const float* beta, void* h, long ldh, int* plan,
                                    int* launched, void* stream) {
  using namespace tdm;
  const void* none[kNumOps] = {};
  Scratch sc{};
  Wide wd(none, dims, N, S, task, ntask, sc, static_cast<cudaStream_t>(stream));
  if (!wide_fits(wd.d)) return kNoPlan;
  wd.fold.splits = nsplit;
  wd.fold.pstride = pstride;
  wd.fold_hidden(static_cast<const uint16_t*>(x), ldx, w, ldw, u, ldu, b, bt, gain, beta,
                 static_cast<uint16_t*>(h), ldh, up16(wd.d.M));
  for (int i = 0; i < 6; ++i) plan[i] = wd.row_plan[i];
  wd.report(launched);
  return wd.err;
}

#ifdef TDM_CYCLES
// The row kernel's block-0 cycle counters (mlp_wide.cuh g_row_cycles) into
// out [5], then zeroed.
extern "C" int tdm_row_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tdm::g_row_cycles, sizeof(tdm::g_row_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(tdm::g_row_cycles, zero, sizeof(zero)));
}
#endif
