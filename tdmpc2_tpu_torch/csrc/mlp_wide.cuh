// Layer-per-launch MLP engine on Hopper's tensor cores: the value, pi-rollout
// and rollout kernels at widths that no row tile of mlp_rows.cuh holds
// (above 2048 columns: model_size 317's mlp_dim 4096), and the rollout
// kernel at every width. It serves the TPU kernels _value_kernel
// (tdmpc2_tpu/ops/pallas_rollout.py:437), _rollout_kernel (:50) and the pi
// rollout of _cem_kernel (tdmpc2_tpu/ops/pallas_cem.py:53).
//
// The row-tile engine keeps a block's rows in shared memory for a whole
// rollout, which needs a layer's whole output row in one block's
// accumulators. Here each layer is its own launch over every row of the
// step: a tiled product over a grid of (column tile x row tile) blocks
// writes the layer's f32 pre-activation to device memory, and a row kernel
// after it does what needs the whole row: LayerNorm then Mish, the SimNorm
// groups, the two-hot decode over the bins, the pi head's tanh / log-std,
// the termination gate, the rounding to bf16 of the next layer's input. A
// kernel boundary is the only synchronisation across blocks.
//
// The product (gemm_kernel): y = x . W + bias, bf16 inputs, f32 sums, f32
// output rows (the row kernel needs the whole f32 row for LayerNorm). A
// block owns BM rows and BN columns: 128 x 256 (two consumer warpgroups of
// 64 rows) where a layer is wider than 2048 columns and an env has more than
// 64 rows, else 64 x 128 (one consumer warpgroup: the pi rollout's 24 rows
// an env, the rollout at model_size 1-48). The tile follows from S and the
// widths (wide_large), never from N. 256 columns where registers allow it:
// a consumer thread holds 128 f32 accumulators, in the 232 registers that
// setmaxnreg gives it (the producer warpgroup keeps 40); the wider tile
// reads x from L2 half as often as 128 columns would (x is read N / BN
// times, the weights R / BM times), and at 4096 x 4096 on 40,960 rows that
// traffic would otherwise need more than L2 delivers.
//
// Each consumer warpgroup runs wgmma.mma_async m64nBNk16 (bf16 x bf16 ->
// f32) on operands in shared memory and keeps the sum in the wgmma
// accumulators across the whole K. One producer thread stages both
// operands with TMA (cp.async.bulk.tensor, 128-byte swizzle, 64 deep in K a
// stage) into a ring of kWStages stages: a stage is complete when its full
// mbarrier has counted the copies' bytes, and the consumers hand it back on
// its empty mbarrier once the wgmma group that read it has retired. There
// is no __syncthreads in the K loop, and no block waits on another. The
// blocks are persistent: as many as the card holds at once (one an SM for
// the large tile, two for the small) walk the tiles in order, column tiles
// fastest, and the producer runs on into the next tile's stages while the
// consumers store the last one's, so a tile's first stages arrive during
// the previous tile's epilogue. The tensor maps are encoded on the host at each launch from that launch's
// pointers (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links to the runtime alone) and
// passed as __grid_constant__ parameters: x's rows [R, K], and the weights'
// wide layout [heads, N, K] (ops/value.py wide_matrix: each matrix
// transposed, its K blocks zero-padded to 16 as the activation rows are),
// so that both operands are K-major. K and rows past a tensor's end arrive
// as zeros.
//
// Order of the sums: every output element is its wgmma accumulator's sum
// over K in 16-deep steps from the first (or from its split's first) in
// order, whatever N, S and the block's other rows are, so an N-env launch
// equals N one-env launches bit for bit. Where the bias or the weights
// depend on the env (a multi-task model's per-task bias rows, the Q heads)
// a block's rows stay inside one env, as the value kernel's
// blocks_per_env; elsewhere the row tiles run over all R rows (bpe = 0),
// which packs the pi rollout's 24-row envs.
//
// Narrow outputs (one column tile: the bins, the policy's 2A columns, the
// termination logit): at one env 4 blocks would walk a 4096-deep K alone.
// There K is split over up to 8 blocks (gemm_splits, from the widths
// alone); each writes an f32 partial row pstride columns after the last in
// the same row of y, the bias in the first, and the row kernel sums them in
// order in every mode, whichever layer the output is. No atomics.
//
// A first layer on z||a rows whose latent is one row an env (a value
// step's t = 0 with zs = 0, the planner's) is taken apart as the TPU
// kernel takes it, x W = z Wz + a Wa (Wide::hidden2, folded), by two
// kernels of their own (the fold section below): fold_u_kernel, the N
// envs' latents (zb, which the staging writes once an env) times the
// layout's latent block, on env rows packed into shared tiles, K split
// over blocks into partial rows of u; then fold_hidden_kernel, which sums
// an env's partial rows of u and its task's bias row once, and for each
// row adds the A action columns times the action block in f32 to it and
// applies LayerNorm + Mish, writing the bf16 hidden row: the f32
// pre-activation never reaches device memory. Only the f32 order of the
// sum changes. Where the fused layer's staged action block does not fit
// in shared memory (fold_fits: more than 25 actions at 4096 columns), and
// on episodic tasks, nothing folds (value.cu value_wide).
//
// Why the sums stay in the accumulators: the tensor cores round toward zero
// where an f32 add rounds to nearest (mlp_rows.cuh mma16816), at most about
// an ulp of the running sum a 16-deep step: over K = 4096 at most 256 ulps
// of |x| . |W|, 3e-5 of it, inside the product checks' 1e-4 (chip_smoke.py,
// tests/test_torch_cuda.py). Taking each k-tile's products alone and adding
// them to f32 registers, as the first version did, cost a CUDA-core add for
// every 32 tensor-core flops.
//
// Bound: a layer of K x N on R rows reads K N bf16 weights and R K bf16
// inputs, writes R N f32 outputs and does R K N multiply-adds: at K = N =
// 4096 it is compute-bound above ~600 rows (1.37 TFLOP at R = 40,960: 1.39
// ms at 989 TFLOP/s); at one env (512 rows) its 64 blocks fill half the
// SMs; a narrow output is bound by reading x.
//
// The row kernels read the product's f32 rows once and write bf16 rows (or
// a few scalars a row): bound by bytes, 0.30 ms for LayerNorm + Mish on
// 40,960 rows of 4096 columns (16 KB in, 8 KB out a row). row_kernel (the
// LayerNorm modes) streams the rows: persistent blocks of row groups, each
// group of TPR threads (32 to 256, from the width alone, up to 16 columns
// a thread, so at most 4096) owning a row at a time; its rows arrive by
// bulk copies (cp.async.bulk, no tensor map) into a ring of row buffers in
// shared memory, counted on an mbarrier each, so a group's next rows are in
// flight while it computes this one. Threads read 16 bytes of the ring and
// write 8 bytes of bf16 at a time; gain and beta stay in registers; the
// statistics are summed in a fixed tree in f32 in the plain version's order
// (the mean, then the centred variance) with warp shuffles and one exchange
// a statistic among the group's warps on its named barrier; Mish takes the quotient
// from the reciprocal's estimate. It runs at ~80% of the bytes bound at 4096
// columns, held by instruction issue (PERF.md §6). row_narrow_kernel
// (the two-hot decode, the policy's action, the termination gate) packs
// several rows a warp, and sums a split product's partial rows with 16-byte
// loads in order. No arithmetic depends on the block or the row count, so
// an N-env launch equals N one-env launches bit for bit.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime

#include <mutex>

#include "mlp_rows.cuh"

namespace tdm {

constexpr int kWK = 64;                  // K depth of a stage: one 128-byte swizzle row of bf16
constexpr int kWStages = 4;
constexpr int kWideCols = 2048;          // above this widest layer, the large tile
constexpr int kWMaxSplits = 8;           // K splits of a narrow output at most

// A product block: WGS consumer warpgroups of 64 rows and BN columns, then
// one producer warpgroup (its first thread issues the copies). Registers:
// 65,536 / (threads x min_blocks) a thread at launch; setmaxnreg lowers the
// producer's to 40 and raises the consumers' by what that frees.
template <int WGS, int BN>
struct WTile {
  static constexpr int wgs = WGS, bm = 64 * WGS, bn = BN;
  static constexpr int threads = 128 * (WGS + 1);
  static constexpr int min_blocks = WGS == 2 ? 1 : 2;
  static constexpr int stage_a = bm * kWK * 2, stage_b = bn * kWK * 2;
  // the stages from a 1024-byte boundary (the swizzle's period), then the
  // full and empty mbarriers
  static constexpr int smem = 1024 + kWStages * (stage_a + stage_b) + 16 * kWStages;
  static constexpr int launch_regs = (65536 / (threads * min_blocks)) & ~7;
  static constexpr int prod_regs = 40;
  static constexpr int cons_regs = ((launch_regs * (WGS + 1) - prod_regs) / WGS) & ~7;
};
using WLarge = WTile<2, 256>;   // 128 x 256, one block an SM
using WSmall = WTile<1, 128>;   // 64 x 128, two blocks an SM

constexpr int kWRowThreads = 256;       // a row kernel's block
constexpr int kWChunks = 4;             // float4 chunks of a row a LayerNorm thread holds
constexpr int kWMaxCols = kWRowThreads * kWChunks * 4;
constexpr int kWRowRing = 64 * 1024;    // bytes of a LayerNorm block's ring of rows
constexpr int kWRowStages = 8;          // row buffers a row group at most

// The sampled mode's operands, each env's through an env stride: mean and
// std [H*A], noise [S, H*A] and the n_pi policy-prior rows pi_acts
// [n_pi, H*A] (rows H*A apart); the sampled actions acts [N, S, H*A].
// mean == nullptr: the actions are given.
struct Sampling {
  const float* mean;
  long mn;
  const float* stdv;
  long sn;
  const float* noise;
  long nn;
  const float* pi_acts;
  long pn;
  int n_pi;
  float* acts;
};

// Whether the wide engine takes these widths: the row kernel's 4096
// columns, and SimNorm groups of 2 to 16 that divide the latent.
inline bool wide_fits(const Dims& d) {
  const bool group_ok = d.G == 2 || d.G == 4 || d.G == 8 || d.G == 16;
  return group_ok && d.L % d.G == 0 && d.L <= kWMaxCols && d.M <= kWMaxCols &&
         d.B <= kWMaxCols && 2 * d.A <= kWMaxCols && d.A >= 1;
}

// The product's tile at these widths and S rows an env: WLarge where the
// widest layer is above 2048 columns and an env has more than 64 rows,
// else WSmall.
inline bool wide_large(const Dims& d, int S) {
  const int Lp = up16(d.L), Mp = up16(d.M), Bp = up16(d.B);
  const int widest = Mp > Lp ? (Mp > Bp ? Mp : Bp) : (Lp > Bp ? Lp : Bp);
  return widest > kWideCols && S > 64;
}

// K splits of a product of ncols columns and nk stages on tiles of bn
// columns, into rows of y ldy wide: 1 unless one column tile holds the
// output; then splits of at least 8 stages, at most kWMaxSplits, and no
// more partial rows of up16(ncols) columns than a row of y holds.
inline int gemm_splits(int ncols, int bn, int nk, long ldy) {
  if (ncols > bn) return 1;
  long s = nk / 8;
  const long fit = ldy / up16(ncols);
  if (s > kWMaxSplits) s = kWMaxSplits;
  if (s > fit) s = fit;
  return s < 1 ? 1 : static_cast<int>(s);
}

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

// mbar_wait for the product's ring, bounded: a wait that outlasts 2^26
// polls (far beyond any copy's or wgmma's latency) traps, so that a fault in
// the ring's accounting ends the launch with an error instead of a hang.
__device__ __forceinline__ void ring_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == (1u << 26)) asm volatile("trap;\n");
  }
}

__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// TMA: the box at coordinates (c0 innermost, c1[, c2]) of `map` into shared
// memory at dst, its bytes counted on `bar`.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// The wgmma descriptor of a K-major operand tile in shared memory as TMA
// writes it with a 128-byte swizzle: rows of 64 bf16 (128 bytes), 8-row
// groups 1024 bytes apart, the tile on a 1024-byte boundary. A 16-deep
// step further in K is 32 bytes further: + 2 on the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and its wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d (m64 x n128, f32, 64 registers a thread) += A (64 x 16, shared, K-major)
// . B (16 x 128, shared, K-major), both through 128-byte-swizzle descriptors.
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n256, f32, 128 registers a thread) += A (64 x 16, shared, K-major)
// . B (16 x 256, shared, K-major), both through 128-byte-swizzle descriptors.
__device__ __forceinline__ void wgmma256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n64, f32, 32 registers a thread) += A (64 x 16, shared, K-major)
// . B (16 x 64, shared, K-major), both through 128-byte-swizzle descriptors.
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) {
    wgmma256(d, da, db);
  } else {
    wgmma128(d, da, db);
  }
}

// One layer's product: y[row, c] = x[row, :K] . W_head[:K, c] + bias[c] for
// c < ncols, the rows of N envs of S rows each (row env * S + s). x and W
// come through the kernel's tensor maps.
struct GemmArgs {
  float* y;           // f32 output, ldy apart (even); split z's partial at y + z * pstride
  long ldy;
  int ncols;
  const float* b;     // bias of column c: b[task * bt + head * bh + c]
  long bt, bh;
  const float* b1;    // columns c >= split: b1[c - split] (the pi head's log-std)
  int split;
  const int* task;    // [N] task ids, or null (task 0)
  int ntask;
  const int* head;    // env e's head index at head[e * hn] (a Q head), or null
  long hn;
  int nhead;
  int S;              // rows an env
  int bpe;            // row tiles an env; 0: row tiles over all R rows
  long R;
  int nk;             // stages of K (kWK deep) in all
  int kchunk;         // stages a split
  int pstride;        // columns from one partial row to the next
  int gx, gy, gz;     // tiles: column tiles, row tiles, K splits
};

// One output tile of a product: its rows (inside one env when bpe > 0),
// that env's head, its columns and its split's K stages. Tile t runs
// column tiles fastest, then row tiles, then splits.
struct GemmTile {
  long row0;
  int nrows, env, head, n0, z, ks0, n;
};

template <class Tl>
__device__ __forceinline__ GemmTile gemm_tile(const GemmArgs& a, int t) {
  GemmTile u;
  const int yz = t / a.gx, y = yz % a.gy;
  u.z = yz / a.gy;
  u.n0 = (t % a.gx) * Tl::bn;
  u.env = 0;
  if (a.bpe > 0) {
    u.env = y / a.bpe;
    const int r0 = (y % a.bpe) * Tl::bm;
    u.row0 = static_cast<long>(u.env) * a.S + r0;
    u.nrows = min(Tl::bm, a.S - r0);
  } else {
    u.row0 = static_cast<long>(y) * Tl::bm;
    u.nrows = static_cast<int>(min(static_cast<long>(Tl::bm), a.R - u.row0));
  }
  u.head = a.head == nullptr ? 0 : min(max(a.head[u.env * a.hn], 0), a.nhead - 1);
  u.ks0 = u.z * a.kchunk;
  u.n = min(a.nk, u.ks0 + a.kchunk) - u.ks0;
  return u;
}

// Persistent: each block walks the tiles blockIdx.x, + gridDim.x, ...; the
// producer runs on into the next tile's stages while the consumers store
// the last one's, and the ring's stage and phase run on across tiles.
template <class Tl>
__global__ void __launch_bounds__(Tl::threads, Tl::min_blocks)
    gemm_kernel(const GemmArgs a, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw) {
  extern __shared__ __align__(1024) uint8_t wide_smem[];
  const uint32_t sA = (smem_u32(wide_smem) + 1023u) & ~1023u;
  const uint32_t sB = sA + kWStages * Tl::stage_a;
  const uint32_t full = sB + kWStages * Tl::stage_b, empty = full + 8 * kWStages;
  const int wg = threadIdx.x >> 7;
  const int ntiles = a.gx * a.gy * a.gz;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, Tl::wgs * 4);   // a warp of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == Tl::wgs) {
    // the producer warpgroup: its first thread keeps the ring full
    reg_dealloc<Tl::prod_regs>();
    if (threadIdx.x == Tl::wgs * 128) {
      uint32_t it = 0;   // stages issued, across tiles
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const GemmTile u = gemm_tile<Tl>(a, t);
        for (int i = 0; i < u.n; ++i, ++it) {
          const uint32_t st = it % kWStages;
          if (it >= kWStages) ring_wait(empty + 8 * st, (it / kWStages - 1) & 1);
          expect_tx(full + 8 * st, Tl::stage_a + Tl::stage_b);
          const int k = (u.ks0 + i) * kWK;
          tma_2d(sA + st * Tl::stage_a, &tx, k, static_cast<int>(u.row0), full + 8 * st);
          tma_3d(sB + st * Tl::stage_b, &tw, k, u.n0, u.head, full + 8 * st);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of each tile
  reg_alloc<Tl::cons_regs>();
  const uint32_t aoff = wg * 64 * kWK * 2;
  const bool releaser = (threadIdx.x & 31) == 0;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  const int rw = wg * 64 + w * 16 + g;
  uint32_t it = 0;   // stages consumed, across tiles
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const GemmTile u = gemm_tile<Tl>(a, t);
    float acc[Tl::bn / 2];
#pragma unroll
    for (int i = 0; i < Tl::bn / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < u.n; ++i, ++it) {
      const uint32_t st = it % kWStages;
      ring_wait(full + 8 * st, (it / kWStages) & 1);
      const uint64_t da = sw128_desc(sA + st * Tl::stage_a + aoff);
      const uint64_t db = sw128_desc(sB + st * Tl::stage_b);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWK / 16; ++k) wgmma<Tl::bn>(acc, da + 2 * k, db + 2 * k);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();
      // the previous stage's group has retired: its stage goes back to the producer
      if (i > 0 && releaser) mbar_arrive(empty + 8 * ((it - 1) % kWStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (u.n > 0 && releaser) mbar_arrive(empty + 8 * ((it - 1) % kWStages));

    // epilogue: thread (warp w, lane 4 g + q) holds rows 16 w + g (+ 8) of
    // its warpgroup's 64 at columns 8 j + 2 q (+ 1), j < BN / 8
    const int task = a.task == nullptr ? 0 : min(max(a.task[u.env], 0), a.ntask - 1);
    const bool first = u.z == 0;
    const float* bias = a.b + task * a.bt + u.head * a.bh;
    float* yb = a.y + u.row0 * a.ldy + u.z * a.pstride;
#pragma unroll
    for (int j = 0; j < Tl::bn / 8; ++j) {
      const int col = u.n0 + 8 * j + 2 * q;
      float bv[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int cc = col + x;
        if (first && cc < a.ncols)
          bv[x] = cc < a.split ? __ldg(bias + cc) : __ldg(a.b1 + cc - a.split);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = rw + 8 * hf;
        if (row >= u.nrows || col >= a.ncols) continue;
        float* yr = yb + static_cast<long>(row) * a.ldy + col;
        const float v0 = acc[4 * j + 2 * hf] + bv[0], v1 = acc[4 * j + 2 * hf + 1] + bv[1];
        if (col + 1 < a.ncols) {
          *reinterpret_cast<float2*>(yr) = make_float2(v0, v1);
        } else {
          yr[0] = v0;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Row-wise work
// ---------------------------------------------------------------------------

enum RowMode { kRowHidden, kRowLatent, kRowReward, kRowQ0, kRowQ1, kRowPi, kRowTerm };

// Cycle counters of the row kernel's block 0, thread 0, with -DTDM_CYCLES
// (`chip_smoke.py --cycles`; otherwise nothing), summed over its rows: [0]
// the rows, [1] waiting for a row (until its values are in registers), [2]
// the row's statistics, [3] the activation and the stores, [4] rows.
#ifdef TDM_CYCLES
__device__ unsigned long long g_row_cycles[5];
#define TDM_ROW_MARK(t, dep)  \
  asm volatile("" ::"f"(dep)); \
  const long long t = clock64()
#define TDM_ROW_ADD(i, t0, t1) \
  if (blockIdx.x == 0 && threadIdx.x == 0) g_row_cycles[i] += (t1) - (t0)
#else
#define TDM_ROW_MARK(t, dep)
#define TDM_ROW_ADD(i, t0, t1)
#endif

struct RowArgs {
  int mode;
  const float* y;   // the product's rows, ldy apart
  long ldy;
  int nsplit;       // partial rows of a split product, pstride columns apart (1: none)
  int pstride;
  int ncols;        // the layer's width
  const float *gain, *beta;  // LayerNorm (hidden, latent): + head * gh
  long gh;
  const int* head;  // env e's head index at head[e * hn] (the Q heads' LayerNorm), or null
  long hn;
  int nhead;
  int group;        // SimNorm group (latent)
  const float* bins;  // two-hot (reward, Q)
  uint16_t* dst;    // bf16 output row `row` at dst + row * ldd: hidden, latent or actions
  long ldd;
  int dpad;         // columns of dst written, zeros from ncols (pi: from A) on
  float* fdst;      // f32 output at fdst + row * ldf (z_H; the pi rollout's actions), or null
  long ldf;
  float *G, *q, *term;  // per-row scalars [R]; term may be null (no gate: 0)
  int* term_at;     // [R] or null
  const float* discs;  // env e's discount discs[e * dn + t]
  long dn;
  int t;
  float* out;       // Q1: the value [R]
  const float* eps; // pi: eps[e * en + s * es + c]
  long en, es;
  const float* amask;  // pi: mask [A] of env e at amask + e * amn, or null (ones)
  long amn;
  float lsmin, lsdif;
  int A;
  int S;            // rows an env
  long R;           // rows in all
};

// Mish as JAX _mish computes it (z = exp(min(x, 15)) + 1, then x (z^2 - 1)
// / (z^2 + 1)), the quotient through the reciprocal's estimate (within 2
// ulps: the denominator is in [2, 1.1e13], no guard for tiny ones) where
// the row tiles' mish (mlp_rows.cuh) rounds it exactly.
// 1 / x within an ulp, for normal x well inside the f32 range.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float mish_rcp(float x) {
  const float z = expf(fminf(x, 15.f)) + 1.f;
  const float z2 = z * z;
  return x * (z2 - 1.f) * rcp_approx(z2 + 1.f);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Sum over the TPR threads of a row group (a multiple of 32) in a fixed
// tree: the warp's lanes by shuffles, then the group's warps in order
// through red (a slot a warp), on the group's own named barrier.
template <int TPR>
__device__ __forceinline__ float group_sum(float x, float* red, int bar) {
  x = warp_sum(x);
  if constexpr (TPR > 32) {
    if ((threadIdx.x & 31) == 0) red[(threadIdx.x % TPR) >> 5] = x;
    bar_sync(bar, TPR);
    x = red[0];
#pragma unroll
    for (int k = 1; k < TPR / 32; ++k) x += red[k];
  } else {
    __syncwarp();
  }
  return x;
}

// SimNorm of four consecutive columns, groups of G: within them (G <= 4),
// or with the lanes that hold the group's other chunks (the G / 4 lanes
// next to this one: a thread's chunks sit TPR chunks apart, TPR a multiple
// of 32, so a group's chunks are adjacent lanes of one warp).
template <int G>
__device__ __forceinline__ void simnorm4(float (&v)[4]) {
  if constexpr (G >= 4) {
    float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
#pragma unroll
    for (int o = 1; o < G / 4; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = expf(v[k] - m);
    float se = (e[0] + e[1]) + (e[2] + e[3]);
#pragma unroll
    for (int o = 1; o < G / 4; o <<= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
    const float r = rcp_approx(se);   // se is in [1, G]
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = e[k] * r;
  } else {
#pragma unroll
    for (int p = 0; p < 4; p += 2) {
      const float m = fmaxf(v[p], v[p + 1]);
      const float e0 = expf(v[p] - m), e1 = expf(v[p + 1] - m);
      const float r = rcp_approx(e0 + e1);
      v[p] = e0 * r;
      v[p + 1] = e1 * r;
    }
  }
}

// The LayerNorm modes, ACT the activation after it: Mish (kActMish),
// SimNorm over groups of 8 (kActSimNorm8: every published size) or of the
// config's group (kActSimNorm). A row group of TPR threads owns a row at a
// time (TPR from the width alone, Wide::rows: 256 at 4096 columns, 128 at
// 1376, 32 at 512), thread lr the float4 chunks lr + i TPR (i < kWChunks):
// the columns 4 (lr + i TPR) .. + 3. A block holds kWRowThreads / TPR
// groups and stays for the launch, each group taking a run of consecutive
// rows (so a Q head's gain and beta, kept in registers, change once or
// twice a group). The staging: a group's rows arrive by 1-D bulk copies
// (cp.async.bulk, no tensor map: one copy a row, its split product's
// partial rows with it) into a ring of `stages` row buffers in shared
// memory, each counted on its full mbarrier; the group's first thread
// issues the first `stages` copies and refills a buffer as soon as the
// group's first reduction shows that every thread has read it, so the next
// rows stream in while this one's statistics, activation and stores run.
// The bound is the bytes (an f32 row in, a bf16 row out), but at 4096
// columns instruction issue holds the kernel at ~80% of it (reading every
// row from L2 takes as long; PERF.md §6). So the activation is a
// template parameter (no branch between a thread's elements), Mish's
// quotient comes from rcp.approx, the partial-row loop runs only where K
// was split, masks apply to a row's last chunk only, and the launch bounds
// hold 80 registers so that 3 blocks share an SM.
enum RowAct { kActMish = 0, kActSimNorm = 1, kActSimNorm8 = 8 };

template <int TPR, int ACT>
__global__ void __launch_bounds__(kWRowThreads, 3)
    row_kernel(const RowArgs a, int stages, int floats) {
  constexpr int RG = kWRowThreads / TPR;
  extern __shared__ __align__(16) float row_ring[];
  __shared__ float red[2 * kWRowThreads / 32];  // [group][mean, variance][warp]
  const int grp = threadIdx.x / TPR, lr = threadIdx.x % TPR, w = lr >> 5;
  const uint32_t bytes = static_cast<uint32_t>(floats) * 4;
  const uint32_t bars0 = smem_u32(row_ring) + RG * stages * bytes;
  const uint32_t bars = bars0 + 8 * grp * stages;
  const uint32_t ring = smem_u32(row_ring) + grp * stages * bytes;
  const float* gring = row_ring + static_cast<long>(grp) * stages * floats;
  float* gred = red + grp * 2 * (TPR / 32);
  const int bar = 1 + grp;
  if (threadIdx.x == 0) {
    for (int i = 0; i < RG * stages; ++i) mbar_init(bars0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the group's rows: a run of consecutive rows (an env's, mostly)
  const long groups = static_cast<long>(gridDim.x) * RG;
  const long per = (a.R + groups - 1) / groups;
  const long first = (static_cast<long>(blockIdx.x) * RG + grp) * per;
  const long n = first < a.R ? min(per, a.R - first) : 0;
  const bool producer = lr == 0;
  if (producer)
    for (int k = 0; k < stages && k < n; ++k)
      bulk_copy(ring + k * bytes, a.y + (first + k) * a.ldy, bytes, bars + 8 * k);

  const int nc = a.ncols, nch = (nc + 3) >> 2, dch = a.dpad >> 2;
  const bool fvec = a.fdst != nullptr && (a.ldf & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(a.fdst) & 15) == 0;
  float gw[kWChunks][4], bw[kWChunks][4];
  int cur = -1;
  for (long k = 0; k < n; ++k) {
    TDM_ROW_MARK(c0, 0.f);
    const int s = static_cast<int>(k % stages);
    const long row = first + k;
    const int env = static_cast<int>(row / a.S);
    const int h = a.head == nullptr ? 0 : min(max(a.head[env * a.hn], 0), a.nhead - 1);
    if (h != cur) {
      const float* gn = a.gain + h * a.gh;
      const float* bt = a.beta + h * a.gh;
#pragma unroll
      for (int i = 0; i < kWChunks; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * (lr + i * TPR) + e;
          gw[i][e] = c < nc ? __ldg(gn + c) : 0.f;
          bw[i][e] = c < nc ? __ldg(bt + c) : 0.f;
        }
      }
      cur = h;
    }
    ring_wait(bars + 8 * s, static_cast<uint32_t>((k / stages) & 1));
    const float* st = gring + s * floats;
    // the row, its partial rows summed in order where K was split
    float v[kWChunks][4];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int j = lr + i * TPR;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < nch) {
        x = *reinterpret_cast<const float4*>(st + 4 * j);
        for (int p = 1; p < a.nsplit; ++p) {   // a split product's partial rows
          const float4 u = *reinterpret_cast<const float4*>(st + p * a.pstride + 4 * j);
          x.x += u.x;
          x.y += u.y;
          x.z += u.z;
          x.w += u.w;
        }
      }
      v[i][0] = x.x;
      v[i][1] = x.y;
      v[i][2] = x.z;
      v[i][3] = x.w;
      if (4 * j + 4 > nc) {   // the row's last chunk, or past it
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][e] = 4 * j + e < nc ? v[i][e] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sum += v[i][e];
    }
    TDM_ROW_MARK(c1, sum);
    const float mu = group_sum<TPR>(sum, gred, bar) / nc;
    // every thread of the group has read buffer s: it takes the row `stages` on
    if (producer && k + stages < n) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(ring + s * bytes, a.y + (row + stages) * a.ldy, bytes, bars + 8 * s);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int j = lr + i * TPR;
      if (4 * j + 4 <= nc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ss += (v[i][e] - mu) * (v[i][e] - mu);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = v[i][e] - mu;
          ss += 4 * j + e < nc ? d * d : 0.f;
        }
      }
    }
    const float rstd = rsqrtf(group_sum<TPR>(ss, gred + TPR / 32, bar) / nc + 1e-5f);
    TDM_ROW_MARK(c2, rstd);
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      if (i * TPR + 32 * w >= dch) continue;  // the warp holds none of dst's columns
      const int j = lr + i * TPR;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = fmaf((v[i][e] - mu) * rstd, gw[i][e], bw[i][e]);
        v[i][e] = ACT == kActMish ? mish_rcp(y) : y;
      }
      if (4 * j + 4 > nc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][e] = 4 * j + e < nc ? v[i][e] : 0.f;
      }
      if constexpr (ACT == kActSimNorm8) {
        simnorm4<8>(v[i]);
      } else if constexpr (ACT == kActSimNorm) {
        switch (a.group) {
          case 2: simnorm4<2>(v[i]); break;
          case 4: simnorm4<4>(v[i]); break;
          case 16: simnorm4<16>(v[i]); break;
          default: simnorm4<8>(v[i]); break;
        }
      }
      if constexpr (ACT != kActMish) {
        if (4 * j + 4 > nc) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[i][e] = 4 * j + e < nc ? v[i][e] : 0.f;
        }
      }
      if (j < dch)
        *reinterpret_cast<uint2*>(a.dst + row * a.ldd + 4 * j) =
            make_uint2(bf16x2_bits(v[i][0], v[i][1]), bf16x2_bits(v[i][2], v[i][3]));
      if (a.fdst != nullptr && j < nch) {
        float* f = a.fdst + row * a.ldf + 4 * j;
        if (fvec && 4 * j + 3 < nc) {
          *reinterpret_cast<float4*>(f) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * j + e < nc) f[e] = v[i][e];
        }
      }
    }
    TDM_ROW_MARK(c3, v[0][0]);
    TDM_ROW_ADD(0, c0, c3);
    TDM_ROW_ADD(1, c0, c1);
    TDM_ROW_ADD(2, c1, c2);
    TDM_ROW_ADD(3, c2, c3);
    TDM_ROW_ADD(4, 0, 1);
  }
}

// The narrow modes: the two-hot decode (reward, Q0, Q1), the policy's
// action, the termination gate, each a product's one column tile split over
// K into up to 8 partial rows. LPR lanes a row (from the width alone), 32
// / LPR rows a warp; the warps stay for the launch and walk the rows. Each
// lane sums its columns' partial rows in order with 16-byte loads straight
// from device memory (two-hot; the policy's and the gate's columns one at a
// time), all of a row's loads issued together: a row is a few hundred
// bytes, and the many resident warps keep enough of them in flight without
// a ring.
template <int LPR>
__global__ void __launch_bounds__(kWRowThreads) row_narrow_kernel(const RowArgs a) {
  constexpr int kKeep = 2;   // chunks of a two-hot row a lane keeps in registers
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, l = lane % LPR;
  const long warps = static_cast<long>(gridDim.x) * (kWRowThreads / 32);
  const long warp = static_cast<long>(blockIdx.x) * (kWRowThreads / 32) + (threadIdx.x >> 5);
  const int nc = a.ncols, nch = (nc + 3) >> 2;
  const long ps = a.pstride;
  const bool two_hot = a.mode == kRowReward || a.mode == kRowQ0 || a.mode == kRowQ1;
  float bn[kKeep][4];
#pragma unroll
  for (int i = 0; i < kKeep; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (l + i * LPR) + e;
      bn[i][e] = two_hot && c < nc ? __ldg(a.bins + c) : 0.f;
    }
  const float ninf = __int_as_float(0xff800000);
  for (long base = warp * RPW; base < a.R; base += warps * RPW) {
    const long row = base + lane / LPR;
    const bool live = row < a.R;
    const long rr = live ? row : a.R - 1;   // a slot past the last row stores nothing
    const int env = static_cast<int>(rr / a.S);
    const float* yr = a.y + rr * a.ldy;
    // column c of the product: its partial rows summed in order
    auto yat = [&](int c) {
      float v = yr[c];
#pragma unroll
      for (int p = 1; p < kWMaxSplits; ++p)
        if (p < a.nsplit) v += yr[p * ps + c];
      return v;
    };
    auto chunk = [&](int j) {
      float4 x = __ldg(reinterpret_cast<const float4*>(yr + 4 * j));
#pragma unroll
      for (int p = 1; p < kWMaxSplits; ++p) {
        if (p < a.nsplit) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(yr + p * ps + 4 * j));
          x.x += u.x;
          x.y += u.y;
          x.z += u.z;
          x.w += u.w;
        }
      }
      return x;
    };

    if (a.mode == kRowTerm) {
      if (live && l == 0) {
        const float hit = yat(0) > 0.f ? 1.f : 0.f;
        if (a.term_at != nullptr && a.term[rr] == 0.f && hit != 0.f) a.term_at[rr] = a.t + 1;
        a.term[rr] = fminf(a.term[rr] + hit, 1.f);
      }
      continue;
    }
    if (a.mode == kRowPi) {
      // columns [0, A) the mean, [A, 2A) the raw log-std
      const int s = static_cast<int>(rr - static_cast<long>(env) * a.S);
      for (int c = l; c < a.dpad; c += LPR) {
        float act = 0.f;
        if (c < a.A) {
          const float m = a.amask != nullptr ? a.amask[env * a.amn + c] : 1.f;
          const float e = a.eps[env * a.en + s * a.es + c];
          const float mean = __fmul_rn(yat(c), m);
          const float ls = a.lsmin + 0.5f * a.lsdif * (tanhf(yat(a.A + c)) + 1.f);
          act = tanhf(mean + __fmul_rn(e, m) * expf(ls));
          if (live && a.fdst != nullptr) a.fdst[rr * a.ldf + c] = act;
        }
        if (live) a.dst[rr * a.ldd + c] = bf16_bits(act);
      }
      continue;
    }

    // two-hot decode: symexp(softmax(logits) . bins); a lane keeps kKeep
    // chunks, and reads again any past them (above 8 LPR bins)
    float v[kKeep][4];
    float mx = ninf;
#pragma unroll
    for (int i = 0; i < kKeep; ++i) {
      const int j = l + i * LPR;
      const float4 x = j < nch ? chunk(j) : make_float4(ninf, ninf, ninf, ninf);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[i][e] = 4 * j + e < nc ? xs[e] : ninf;
        mx = fmaxf(mx, v[i][e]);
      }
    }
    for (int j = l + kKeep * LPR; j < nch; j += LPR) {
      const float4 x = chunk(j);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      for (int e = 0; e < 4; ++e)
        if (4 * j + e < nc) mx = fmaxf(mx, xs[e]);
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float se = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < kKeep; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * (l + i * LPR) + e < nc) {
          const float ex = expf(v[i][e] - mx);
          se += ex;
          sb += ex * bn[i][e];
        }
    for (int j = l + kKeep * LPR; j < nch; j += LPR) {
      const float4 x = chunk(j);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      for (int e = 0; e < 4; ++e)
        if (4 * j + e < nc) {
          const float ex = expf(xs[e] - mx);
          se += ex;
          sb += ex * __ldg(a.bins + 4 * j + e);
        }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      se += __shfl_xor_sync(0xffffffffu, se, o);
      sb += __shfl_xor_sync(0xffffffffu, sb, o);
    }
    if (!live || l != 0) continue;
    const float x = sb / se;
    const float r = copysignf(expm1f(fabsf(x)), x);
    const float term = a.term != nullptr ? a.term[rr] : 0.f;
    if (a.mode == kRowReward) {
      a.G[rr] += a.discs[env * a.dn + a.t] * ((1.f - term) * r);
    } else if (a.mode == kRowQ0) {
      a.q[rr] = 0.f + r;
    } else {
      const float qs = a.q[rr] + r;
      a.out[rr] = a.G[rr] + a.discs[env * a.dn + a.t] * ((1.f - term) * (qs / 2.f));
    }
  }
}

// ---------------------------------------------------------------------------
// Staging of each step's inputs
// ---------------------------------------------------------------------------

// Step t's inputs of the z||a buffer x [R, Lp + Ap] (rows ldx apart), R
// = N S rows: the actions in [Lp, Lp + A), zeros to Ap: given (actions + e
// * an + t * ats + s * ass), sampled (value.cu's formula, also written in
// f32 to sp.acts), or none (zeros: the pi rollout writes its own). With
// load_z also the per-row scalars zeroed and the latent z0 (env e, row s
// at z0 + e * zn + s * zs; zs = 0 broadcasts one row) rounded to bf16:
// into the latent columns [0, L) of every row, zeros to Lp; or, folded (zb
// not null: value_wide at t = 0 with zs = 0), into env e's row of zb [N,
// Lp] only, and the latent columns of x left as they are.
//
// Bound by bytes: the latent's copy into every row (at N = 80 envs of 512
// rows, 114 MB of bf16 for 80 distinct rows, 0.034 ms at 3.35 TB/s) where
// it is written, else the action columns (3.3 MB). So the latent is
// written only where a row's latent differs from its env's (the pi
// rollout's and the rollout's first step, a value step's latent of a row
// each): the folded first layers (Wide::hidden2) take it from zb once an
// env. The design: a thread a row for the actions and the scalars (its A
// actions, the Ap bf16 columns as 16-byte stores), a warp a row for the
// latent (float4 reads, 16-byte stores of 8 bf16, a broadcast row read from
// L1 by the block's rows of the env), a warp an env for zb; 32-bit row
// arithmetic (one divide by S a row); the grid sized to the rows, no loop
// over elements.
struct StageArgs {
  uint16_t* x;
  long ldx;
  int L, Lp, A, Ap, H, t, load_z;
  const float* z0;
  long zn, zs;
  const float* actions;
  long an, ats, ass;
  Sampling sp;
  const float* amask;
  long amn;
  float *G, *q, *term;
  int* term_at;
  uint16_t* zb;     // folded: [N, Lp] (rows Lp apart), or null
  int S, N, R;
  int rpb;          // rows a block of rows
  int row_blocks;   // blocks of rows; the blocks after them write zb, a warp an env
  int vec;          // z0's rows start on 16 bytes (zn, zs multiples of 4): float4 reads
};

constexpr int kStageLatentRows = 16;   // rows a block where the latent is written

// Column c (< A) of env `env`'s row s's action at step t: given, sampled,
// or 0 (none). Reads only: the sampled values go to acts after a chunk's
// reads.
__device__ __forceinline__ float stage_action(const StageArgs& a, int env, int s, int c) {
  if (a.actions != nullptr)
    return __ldg(a.actions + env * a.an + a.t * a.ats + s * a.ass + c);
  if (a.sp.mean == nullptr) return 0.f;
  const int HA = a.H * a.A, k = a.t * a.A + c;
  const long at = static_cast<long>(s) * HA + k;
  float v;
  if (s < a.sp.n_pi) {
    v = __ldg(a.sp.pi_acts + env * a.sp.pn + at);
  } else {
    v = fminf(fmaxf(__fadd_rn(__ldg(a.sp.mean + env * a.sp.mn + k),
                              __fmul_rn(__ldg(a.sp.stdv + env * a.sp.sn + k),
                                        __ldg(a.sp.noise + env * a.sp.nn + at))),
                    -1.f),
              1.f);
  }
  return v * __ldg(a.amask + env * a.amn + c);
}

// One row's actions (its action columns, 16 bytes at a time: a chunk's 8
// values read together, then stored; sampled ones also to acts in f32)
// and, with load_z, its scalars zeroed.
__device__ __forceinline__ void stage_actions(const StageArgs& a, int row) {
  const int env = row / a.S, s = row - env * a.S;
  if (a.load_z) {
    if (a.G != nullptr) a.G[row] = 0.f;
    if (a.q != nullptr) a.q[row] = 0.f;
    if (a.term != nullptr) a.term[row] = 0.f;
    if (a.term_at != nullptr) a.term_at[row] = 0;
  }
  uint16_t* xr = a.x + static_cast<long>(row) * a.ldx + a.Lp;
  const bool sampled = a.actions == nullptr && a.sp.mean != nullptr;
  float* acts =
      sampled ? a.sp.acts + static_cast<long>(row) * (a.H * a.A) + a.t * a.A : nullptr;
  for (int c0 = 0; c0 < a.Ap; c0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c0 + j < a.A ? stage_action(a, env, s, c0 + j) : 0.f;
    if (sampled) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + j < a.A) acts[c0 + j] = v[j];
    }
    *reinterpret_cast<uint4*>(xr + c0) =
        make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]), bf16x2_bits(v[4], v[5]),
                   bf16x2_bits(v[6], v[7]));
  }
}

// Latent columns [8k, 8k + 8) of the row z as 8 bf16 (zeros from L on).
__device__ __forceinline__ uint4 latent_chunk(const StageArgs& a, const float* z, int k) {
  const int c = 8 * k;
  float v[8];
  if (a.vec && c + 8 <= a.L) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(z + c));
    const float4 r = __ldg(reinterpret_cast<const float4*>(z + c + 4));
    v[0] = p.x, v[1] = p.y, v[2] = p.z, v[3] = p.w, v[4] = r.x, v[5] = r.y, v[6] = r.z,
    v[7] = r.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c + j < a.L ? __ldg(z + c + j) : 0.f;
  }
  return make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]), bf16x2_bits(v[4], v[5]),
                    bf16x2_bits(v[6], v[7]));
}

// A warp writes the latent row z into dst's Lp columns: lane l the 16-byte
// chunks l, l + 32, ..., four chunks' reads issued before their stores.
__device__ __forceinline__ void stage_latent(const StageArgs& a, const float* z, uint16_t* dst,
                                             int lane) {
  const int nch = a.Lp >> 3;
  for (int k0 = lane; k0 < nch; k0 += 4 * 32) {
    uint4 out[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      out[u] = k0 + 32 * u < nch ? latent_chunk(a, z, k0 + 32 * u) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k0 + 32 * u < nch) *reinterpret_cast<uint4*>(dst + 8 * (k0 + 32 * u)) = out[u];
  }
}

// Blocks [0, row_blocks) each own rpb rows: a thread a row for the actions
// and scalars, and where the latent goes into x (load_z, not folded) a
// warp a row for it; the blocks after them (folded) a warp an env for zb.
__global__ void __launch_bounds__(256) stage_kernel(const StageArgs a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if (static_cast<int>(blockIdx.x) >= a.row_blocks) {
    const int e = (static_cast<int>(blockIdx.x) - a.row_blocks) * warps + warp;
    if (e < a.N) {
      stage_latent(a, a.z0 + e * a.zn, a.zb + static_cast<long>(e) * a.Lp, lane);
    }
    return;
  }
  const int r0 = static_cast<int>(blockIdx.x) * a.rpb;
  const int nrows = min(a.rpb, a.R - r0);
  if (static_cast<int>(threadIdx.x) < nrows) stage_actions(a, r0 + threadIdx.x);
  if (a.load_z && a.zb == nullptr) {
    for (int i = warp; i < nrows; i += warps) {
      const int row = r0 + i, env = row / a.S, s = row - env * a.S;
      stage_latent(a, a.z0 + env * a.zn + s * a.zs, a.x + static_cast<long>(row) * a.ldx,
                   lane);
    }
  }
}

// ---------------------------------------------------------------------------
// The folded first layer (a value step's t = 0, the latent one row an env)
// ---------------------------------------------------------------------------
//
// u = zb . Wz (fold_u_kernel): N rows of Lp latent columns
// against the layout's 4096 x 1376 latent block, 11.3 MB of weights for at
// most a few hundred KB of latents, so the bound is reading Wz once. The
// product runs with its operands swapped, as wgmma's A side has 64 rows:
// a consumer warpgroup's 64 output columns (Wz's rows, K contiguous in the
// wide layout) are the A operand, the envs the B operand, 64 of them an
// env tile (m64n64k16). All the envs share one row tile (two env tiles a
// block above 64 envs, more tiles above 128): Wz's stages are read once
// and multiplied into every env's accumulators. 32 column tiles of 128
// leave most SMs idle, so K is split over kFoldTiles / column tiles blocks
// (from the widths alone: 4 at 317, 6 stages of 64 a split, all of a
// split's stages in flight at once in a 6-stage ring); each split writes a
// partial row of u, and the consumer sums them in order. Every element's
// sum runs over its split's K
// in 16-deep steps in the same m64n64k16 instruction whatever N is, so an
// N-env launch equals N one-env launches bit for bit.
//
// h = mish(LN(a Wa + (u[env] + b0[task[env]]))) (fold_hidden_kernel): the
// rows' A action columns against the layout's action block, u's row of the
// env with its task's bias row added, LayerNorm and Mish as
// row_kernel<TPR, kActMish> computes them (the same
// statistics in the same order, mish_rcp), the bf16 row written: bound by
// that write (8 KB a row at 4096 columns). The f32 pre-activation stays in
// registers. A block stages the action block once, [A][columns] bf16 in
// shared memory (48 KB at A = 6, 8 KB an action at 4096 columns: fold_fits
// bounds A), then its row groups walk runs of
// consecutive rows as row_kernel's do, up to four rows of an env at a
// time: each action weight read from shared memory and widened once for
// them all, and both statistics' barriers shared. The env's u (its partial
// rows summed in order, then its bias row, when the env changes) and the
// rows' actions sit in shared memory, gain and beta are read through L1.
// Where every thread's
// chunks are whole and inside the row (4096 columns, 256 threads of 16) a
// specialisation drops the ragged edge's guards: with them the four rows'
// values no longer fit the 128 registers of two blocks an SM and spill.
// The sum of each element: fmaf(a_k, w_k, .) from 0 for k = 0 .. A - 1,
// then + (u + the bias), the same whatever the row's neighbours or N.

constexpr int kFoldCols = 128;     // u's columns a block: two consumer warpgroups of 64
constexpr int kFoldEnvs = 64;      // envs an env tile: the wgmma's N
constexpr int kFoldTiles = 128;    // u's blocks that the K split aims at, about one an SM
constexpr int kFoldStages = 6;     // the u product's ring

// The u product's block: two consumer warpgroups, then the producer
// warpgroup; KE env tiles of 64.
template <int KE>
struct FTile {
  static constexpr int wgs = 2, ke = KE;
  static constexpr int threads = 128 * (wgs + 1);
  static constexpr int stage_a = kFoldCols * kWK * 2;         // Wz: 128 columns x 64 K
  static constexpr int stage_b = KE * kFoldEnvs * kWK * 2;    // zb: KE x 64 envs x 64 K
  static constexpr int smem = 1024 + kFoldStages * (stage_a + stage_b) + 16 * kFoldStages;
  static constexpr int launch_regs = (65536 / threads) & ~7;
  static constexpr int prod_regs = 40;
  static constexpr int cons_regs = ((launch_regs * (wgs + 1) - prod_regs) / wgs) & ~7;
};

// K splits of u over its ncols columns and nk stages: kFoldTiles blocks
// over the column tiles, at most kWMaxSplits, at least 2 stages a split.
inline int fold_splits(int ncols, int nk) {
  const int gx = (ncols + kFoldCols - 1) / kFoldCols;
  int s = kFoldTiles / gx;
  if (s > kWMaxSplits) s = kWMaxSplits;
  if (s > nk / 2) s = nk / 2;
  return s < 1 ? 1 : s;
}

struct FoldArgs {
  float* u;          // split z's partial row of env e at u + z * pstride + e * ldu
  long ldu, pstride;
  int ncols, N;
  int nk, kchunk;    // stages of K (kWK deep) in all, and a split's
  int gx, gy, gz;    // column tiles, tiles of KE x 64 envs, splits
};

// One block a tile: column tiles fastest, then env tiles, then splits.
template <int KE>
__global__ void __launch_bounds__(FTile<KE>::threads, 1)
    fold_u_kernel(const FoldArgs a, const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tz) {
  using Tl = FTile<KE>;
  extern __shared__ __align__(1024) uint8_t wide_smem[];
  const uint32_t sA = (smem_u32(wide_smem) + 1023u) & ~1023u;
  const uint32_t sB = sA + kFoldStages * Tl::stage_a;
  const uint32_t full = sB + kFoldStages * Tl::stage_b, empty = full + 8 * kFoldStages;
  const int wg = threadIdx.x >> 7;
  const int t = blockIdx.x;
  const int c0 = (t % a.gx) * kFoldCols;
  const int e0 = (t / a.gx) % a.gy * (KE * kFoldEnvs);
  const int z = t / (a.gx * a.gy);
  const int ks0 = z * a.kchunk;
  const int n = min(a.nk, ks0 + a.kchunk) - ks0;
  // the env tiles that hold an env (a tile past N is neither copied nor multiplied)
  const int live = min(KE, (a.N - e0 + kFoldEnvs - 1) / kFoldEnvs);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFoldStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, Tl::wgs * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == Tl::wgs) {
    reg_dealloc<Tl::prod_regs>();
    if (threadIdx.x == Tl::wgs * 128) {
      for (int i = 0; i < n; ++i) {
        const int st = i % kFoldStages;
        if (i >= kFoldStages) ring_wait(empty + 8 * st, (i / kFoldStages - 1) & 1);
        expect_tx(full + 8 * st, Tl::stage_a + live * kFoldEnvs * kWK * 2);
        const int k = (ks0 + i) * kWK;
        tma_2d(sA + st * Tl::stage_a, &tw, k, c0, full + 8 * st);
        for (int j = 0; j < live; ++j)
          tma_2d(sB + st * Tl::stage_b + j * kFoldEnvs * kWK * 2, &tz, k, e0 + j * kFoldEnvs,
                 full + 8 * st);
      }
    }
    return;
  }

  // a consumer warpgroup: columns [c0 + 64 wg, + 64) of u for every env of the tile
  reg_alloc<Tl::cons_regs>();
  const bool releaser = (threadIdx.x & 31) == 0;
  // thread (warp w, lane 4 g + q) holds columns 16 w + g (+ 8) of its
  // warpgroup's 64 for envs 8 i + 2 q (+ 1) of each env tile
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  float acc[KE][32];
#pragma unroll
  for (int j = 0; j < KE; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[j][r] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int st = i % kFoldStages;
    ring_wait(full + 8 * st, (i / kFoldStages) & 1);
    const uint64_t da = sw128_desc(sA + st * Tl::stage_a + wg * 64 * kWK * 2);
#pragma unroll
    for (int j = 0; j < KE; ++j) fence_acc(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KE; ++j) {
      if (j < live) {
        const uint64_t db = sw128_desc(sB + st * Tl::stage_b + j * kFoldEnvs * kWK * 2);
#pragma unroll
        for (int k = 0; k < kWK / 16; ++k) wgmma64(acc[j], da + 2 * k, db + 2 * k);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < KE; ++j) fence_acc(acc[j]);
    wgmma_wait<1>();
    if (i > 0 && releaser) mbar_arrive(empty + 8 * ((i - 1) % kFoldStages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < KE; ++j) fence_acc(acc[j]);
  if (n > 0 && releaser) mbar_arrive(empty + 8 * ((n - 1) % kFoldStages));

  // epilogue: the partial row
  float* ub = a.u + z * a.pstride;
#pragma unroll
  for (int j = 0; j < KE; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int e = e0 + j * kFoldEnvs + 8 * i + 2 * q + x;
        if (e >= a.N) continue;
        float* ue = ub + static_cast<long>(e) * a.ldu;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = c0 + wg * 64 + 16 * w + g + 8 * hf;
          if (c >= a.ncols) continue;
          ue[c] = acc[j][4 * i + 2 * hf + x];
        }
      }
    }
  }
}

struct FoldRowArgs {
  const uint16_t* x;   // row r's action columns at x + r * ldx: A bf16, zeros after
  long ldx;
  const uint16_t* w;   // the action block: column c's weights at w + c * ldw
  long ldw;
  const float* u;      // env e's u: its partial rows at u + z * pstride + e * ldu, z < nsplit
  long ldu, pstride;
  int nsplit;
  const float* b;      // env e's bias row at b + task[e] * bt
  long bt;
  const int* task;     // [N] task ids, or null (task 0)
  int ntask;
  const float *gain, *beta;
  uint16_t* dst;       // bf16 row r at dst + r * ldd: the values, zeros from ncols to dpad
  long ldd;
  int dpad, ncols, A;
  int ak;              // chunks of 8 action columns a row: A <= 8 ak
  int wstride;         // columns of a staged action row: ncols up to a multiple of 4
  int S;               // rows an env
  long R;
};

constexpr int kFoldActRows = 128;   // a group's rows of actions in shared memory
constexpr int kFoldRows = 4;        // rows of an env a step at most
constexpr int kFoldBlocks = 2;      // the fused layer's blocks an SM (its launch bounds)

// Sums of NR values over the TPR threads of a row group, each in
// group_sum's tree (NR = 1: group_sum's), through red's NR slots a warp and
// one barrier.
template <int TPR, int NR>
__device__ __forceinline__ void group_sums(float (&x)[NR], float* red, int bar) {
#pragma unroll
  for (int r = 0; r < NR; ++r) x[r] = warp_sum(x[r]);
  if constexpr (TPR > 32) {
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int r = 0; r < NR; ++r) red[NR * ((threadIdx.x % TPR) >> 5) + r] = x[r];
    }
    bar_sync(bar, TPR);
#pragma unroll
    for (int r = 0; r < NR; ++r) x[r] = red[r];
#pragma unroll
    for (int k = 1; k < TPR / 32; ++k)
#pragma unroll
      for (int r = 0; r < NR; ++r) x[r] += red[NR * k + r];
  } else {
    __syncwarp();
  }
}

// Env e's u on the thread's chunks, its partial rows summed in order, then
// its task's bias row added, into the group's u row in shared memory (su):
// each thread writes and later reads only its own chunks, so no barrier
// guards it.
template <int TPR>
__device__ __forceinline__ void fold_u_row(const FoldRowArgs& a, int env, int lr, float* su) {
  const int nc = a.ncols, nch = (nc + 3) >> 2;
  const float* ue = a.u + static_cast<long>(env) * a.ldu;
  const int task = a.task == nullptr ? 0 : min(max(__ldg(a.task + env), 0), a.ntask - 1);
  const float* be = a.b + static_cast<long>(task) * a.bt;
#pragma unroll
  for (int i = 0; i < kWChunks; ++i) {
    const int j = lr + i * TPR;
    if (j < nch) {
      float4 s = __ldg(reinterpret_cast<const float4*>(ue + 4 * j));
      for (int p = 1; p < a.nsplit; ++p) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(ue + p * a.pstride + 4 * j));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      float b4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) b4[e] = 4 * j + e < nc ? __ldg(be + 4 * j + e) : 0.f;
      s.x += b4[0];
      s.y += b4[1];
      s.z += b4[2];
      s.w += b4[3];
      *reinterpret_cast<float4*>(su + 4 * j) = s;
    }
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// Columns 4 j .. 4 j + 3 of an f32 row p (zeros from nc on), through L1;
// FULL: all of them below nc.
template <bool FULL>
__device__ __forceinline__ void load4(const float* p, int j, int nc, float (&out)[4]) {
  if (FULL || 4 * j + 4 <= nc) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + 4 * j));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = 4 * j + e < nc ? __ldg(p + 4 * j + e) : 0.f;
  }
}

// NR rows (1, 2 or 4, of one env) from `row` on: the pre-activation of
// each column the thread owns, then row_kernel's LayerNorm + Mish, into
// dst. The rows' actions at sa (a.ak uint4 a row, read as the product
// needs them) and the env's u row (its bias added) at su, both in shared
// memory; gain and beta read through L1 once for the NR rows. AK = 1: at
// most 8 actions, the product's loop unrolled; AK = 0: any A.
template <int TPR, int AK, int NR, bool FULL>
__device__ __forceinline__ void fold_rows(const FoldRowArgs& a, long row, const uint16_t* sw,
                                          const uint4* sa, const float* su, float* gred,
                                          int bar, int lr, int w) {
  TDM_ROW_MARK(c0, 0.f);
  const int nc = a.ncols, nch = (nc + 3) >> 2, dch = a.dpad >> 2;
  const uint32_t* sa32 = reinterpret_cast<const uint32_t*>(sa);   // bf16 pairs
  // a sum over nc columns divided by nc: by its exact reciprocal where nc is
  // a power of two (the same correctly rounded quotient, no division)
  const float inv_nc = (nc & (nc - 1)) == 0 ? 1.f / nc : 0.f;
  // pre = (sum over k of a_k w_k in order, in f32) + (u + b): ops/wide.py
  // fold_plain's association (the action product, then u's row with its
  // bias)
  float v[NR][kWChunks][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < kWChunks; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[r][i][e] = 0.f;
  const int arow = AK > 0 ? 4 * AK : 4 * a.ak;   // bf16 pairs of a row's actions
  auto action = [&](int k) {
    float ak[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const uint32_t pair = sa32[r * arow + (k >> 1)];
      ak[r] = (k & 1) ? bf16_hi(pair) : bf16_lo(pair);
    }
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int j = lr + i * TPR;
      if (FULL || j < nch) {
        const uint2 wv = *reinterpret_cast<const uint2*>(sw + k * a.wstride + 4 * j);
        const float w4[4] = {bf16_lo(wv.x), bf16_hi(wv.x), bf16_lo(wv.y), bf16_hi(wv.y)};
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[r][i][e] = fmaf(ak[r], w4[e], v[r][i][e]);
      }
    }
  };
  if constexpr (AK > 0) {
#pragma unroll
    for (int k = 0; k < 8 * AK; ++k) {
      if (k >= a.A) break;
      action(k);
    }
  } else {
    for (int k = 0; k < a.A; ++k) action(k);
  }
#pragma unroll
  for (int i = 0; i < kWChunks; ++i) {
    const int j = lr + i * TPR;
    if (FULL || j < nch) {
      const float4 u4 = *reinterpret_cast<const float4*>(su + 4 * j);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        v[r][i][0] += u4.x;
        v[r][i][1] += u4.y;
        v[r][i][2] += u4.z;
        v[r][i][3] += u4.w;
      }
    }
  }
  TDM_ROW_MARK(c1, v[0][0][0]);
  // the statistics: row_kernel's sums in its order
  float mu[NR], rstd[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    mu[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int j = lr + i * TPR;
      if (!FULL && 4 * j + 4 > nc) {   // the row's last chunk, or past it
#pragma unroll
        for (int e = 0; e < 4; ++e) v[r][i][e] = 4 * j + e < nc ? v[r][i][e] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) mu[r] += v[r][i][e];
    }
  }
  group_sums<TPR, NR>(mu, gred, bar);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    mu[r] = inv_nc != 0.f ? mu[r] * inv_nc : mu[r] / nc;
    rstd[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int j = lr + i * TPR;
      if (FULL || 4 * j + 4 <= nc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rstd[r] += (v[r][i][e] - mu[r]) * (v[r][i][e] - mu[r]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = v[r][i][e] - mu[r];
          rstd[r] += 4 * j + e < nc ? d * d : 0.f;
        }
      }
    }
  }
  // the variances in slots of their own, whatever NR: a step's reads of its
  // means and the next step's writes of its means are a barrier apart
  group_sums<TPR, NR>(rstd, gred + kFoldRows * (TPR / 32), bar);
#pragma unroll
  for (int r = 0; r < NR; ++r)
    rstd[r] = rsqrtf((inv_nc != 0.f ? rstd[r] * inv_nc : rstd[r] / nc) + 1e-5f);
  TDM_ROW_MARK(c2, rstd[NR - 1]);
  float last = 0.f;
#pragma unroll
  for (int i = 0; i < kWChunks; ++i) {
    if (!FULL && i * TPR + 32 * w >= dch) continue;  // the warp holds none of dst's columns
    const int j = lr + i * TPR;
    float g4[4], b4[4];
    load4<FULL>(a.gain, j, nc, g4);
    load4<FULL>(a.beta, j, nc, b4);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = mish_rcp(fmaf((v[r][i][e] - mu[r]) * rstd[r], g4[e], b4[e]));
      if (!FULL && 4 * j + 4 > nc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = 4 * j + e < nc ? o[e] : 0.f;
      }
      if (FULL || j < dch)
        *reinterpret_cast<uint2*>(a.dst + (row + r) * a.ldd + 4 * j) =
            make_uint2(bf16x2_bits(o[0], o[1]), bf16x2_bits(o[2], o[3]));
      last = o[3];
    }
  }
  TDM_ROW_MARK(c3, last);
  TDM_ROW_ADD(0, c0, c3);
  TDM_ROW_ADD(1, c0, c1);
  TDM_ROW_ADD(2, c1, c2);
  TDM_ROW_ADD(3, c2, c3);
  TDM_ROW_ADD(4, 0, NR);
  (void)last;
}

// Persistent blocks of kWRowThreads / TPR row groups (TPR from the width
// alone, as row_kernel's); a.ak chunks of 8 action columns a row (AK as
// fold_rows'). A group
// copies the actions of kFoldActRows of its rows at a time into shared
// memory (a thread a row), so that a row's product waits on no load from
// device memory, and takes kFoldRows rows of an env a step, fewer at an
// env's or a chunk's end: per row a quarter of the barriers, the action
// weights' shared-memory reads and their widening to f32. The env's u row
// (its bias added) sits in shared memory too (each thread's own chunks),
// so that the registers hold the rows' values and little else.

// Dynamic shared bytes of the fused layer at dims (tpr threads a row): the
// action block [A][wstride] bf16 (on 16 bytes), then each group's
// kFoldActRows rows of actions (a.ak uint4 each), then each group's u row
// (f32).
inline int fold_hidden_smem(const Dims& d, int tpr) {
  const int wstride = (d.M + 3) & ~3, rg = kWRowThreads / tpr, ak = (d.A + 7) / 8;
  return ((d.A * wstride * 2 + 15) & ~15) + rg * kFoldActRows * ak * 16 + rg * wstride * 4;
}

// Threads a row of the fused layer (and of row_kernel's LayerNorm modes)
// at ncols columns: kWChunks float4 chunks a thread.
inline int fold_tpr(int ncols) {
  int tpr = 32;
  while (tpr < kWRowThreads && ncols > tpr * kWChunks * 4) tpr *= 2;
  return tpr;
}

// The fused layer's statistics slots: [group][mean, variance][a warp's NR]
constexpr int kFoldRed = 2 * kFoldRows * kWRowThreads / 32;

// Whether a value step may fold at these widths: the fused layer's staged
// action block and row buffers fit in a block's shared memory (at 4096
// columns up to 25 actions).
inline bool fold_fits(const Dims& d) {
  return fold_hidden_smem(d, fold_tpr(d.M)) + kFoldRed * 4 <= kSmemMax;
}

template <int TPR, int AK, bool FULL>
__global__ void __launch_bounds__(kWRowThreads, kFoldBlocks)
    fold_hidden_kernel(const FoldRowArgs a) {
  constexpr int RG = kWRowThreads / TPR;
  // fold_hidden_smem's layout
  extern __shared__ __align__(16) uint16_t fold_w[];
  __shared__ float red[kFoldRed];
  const int grp = threadIdx.x / TPR, lr = threadIdx.x % TPR, w = lr >> 5;
  float* gred = red + grp * 2 * kFoldRows * (TPR / 32);
  const int bar = 1 + grp, ak = a.ak;
  uint4* sact0 = reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(fold_w) +
                                          ((a.A * a.wstride * 2 + 15) & ~15));
  uint4* sact = sact0 + grp * kFoldActRows * ak;
  float* su = reinterpret_cast<float*>(sact0 + RG * kFoldActRows * ak) + grp * a.wstride;
  // the action block, transposed: action k's weights of columns c at
  // fold_w[k * wstride + c]; a chunk of 8 actions at a time, a thread's
  // kFoldStageCols columns' loads issued together, then their stores
  constexpr int kFoldStageCols = 8;
  for (int h = 0; h < ak; ++h) {
    for (int c0 = threadIdx.x; c0 < a.wstride; c0 += kFoldStageCols * kWRowThreads) {
      uint4 wc[kFoldStageCols];
#pragma unroll
      for (int u = 0; u < kFoldStageCols; ++u) {
        const int c = c0 + u * kWRowThreads;
        const uint4* p = reinterpret_cast<const uint4*>(a.w + static_cast<long>(c) * a.ldw);
        wc[u] = c < a.ncols ? __ldg(p + h) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kFoldStageCols; ++u) {
        const int c = c0 + u * kWRowThreads;
        if (c >= a.wstride) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (8 * h + k >= a.A) break;
          const uint32_t pair = k < 2 ? wc[u].x : k < 4 ? wc[u].y : k < 6 ? wc[u].z : wc[u].w;
          fold_w[(8 * h + k) * a.wstride + c] =
              static_cast<uint16_t>((k & 1) ? pair >> 16 : pair & 0xffffu);
        }
      }
    }
  }
  __syncthreads();

  // the group's rows: a run of consecutive rows, as row_kernel's
  const long groups = static_cast<long>(gridDim.x) * RG;
  const long per = (a.R + groups - 1) / groups;
  const long first = (static_cast<long>(blockIdx.x) * RG + grp) * per;
  const long n = first < a.R ? min(per, a.R - first) : 0;
  int cur = -1;
  for (long k0 = 0; k0 < n; k0 += kFoldActRows) {
    const int cn = static_cast<int>(min(static_cast<long>(kFoldActRows), n - k0));
    // the chunk's actions; the group's earlier reads of the buffer are done
    // (each row's statistics pass a group barrier after its last read)
    for (int r = lr; r < cn; r += TPR) {
      const uint4* p = reinterpret_cast<const uint4*>(a.x + (first + k0 + r) * a.ldx);
      for (int h = 0; h < ak; ++h) sact[r * ak + h] = __ldg(p + h);
    }
    if constexpr (TPR > 32) {
      bar_sync(bar, TPR);
    } else {
      __syncwarp();
    }
    for (int k = 0; k < cn;) {
      const long row = first + k0 + k;
      const int env = static_cast<int>(row / a.S);
      if (env != cur) {
        fold_u_row<TPR>(a, env, lr, su);
        cur = env;
      }
      if (kFoldRows == 4 && k + 3 < cn && (row + 3) / a.S == env) {
        fold_rows<TPR, AK, kFoldRows, FULL>(a, row, fold_w, sact + k * ak, su, gred, bar, lr,
                                            w);
        k += kFoldRows;
      } else if (k + 1 < cn && (row + 1) / a.S == env) {
        fold_rows<TPR, AK, 2, FULL>(a, row, fold_w, sact + k * ak, su, gred, bar, lr, w);
        k += 2;
      } else {
        fold_rows<TPR, AK, 1, FULL>(a, row, fold_w, sact + k * ak, su, gred, bar, lr, w);
        k += 1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: a step's launches
// ---------------------------------------------------------------------------

// Device buffers of one call, allocated by the wrapper (ops/wide.py
// scratch): x the z||a rows [R, ldx] bf16, h the hidden rows [R, ldh]
// bf16, y the product [R, ldy] f32, the per-row G, q, term [R] f32; for a
// value step's folded first layers zb the envs' latents [N, Lp] bf16 and u
// the latent's share of a first layer as kWMaxSplits partial rows an env
// [kWMaxSplits, N, Mp] f32 (null where the call folds nothing).
struct Scratch {
  uint16_t* x;
  uint16_t* h;
  float* y;
  float *G, *q, *term;
  long ldx, ldh, ldy;
  uint16_t* zb;
  float* u;
};

inline Scratch scratch_from(const void* const* p, const long* ld) {
  auto f = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  auto b = [&](int i) { return static_cast<uint16_t*>(const_cast<void*>(p[i])); };
  return Scratch{b(0), b(1), f(2), f(3), f(4), f(5), ld[0], ld[1], ld[2], b(6), f(7)};
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (the library is not linked to libcuda); null if the driver has none.
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a bf16 tensor of `rank` dims at p: sizes dim and byte
// strides of dims 1.. (innermost first), boxes of `box`, 128-byte swizzle,
// zeros past the ends.
inline cudaError_t encode_bf16(CUtensorMap* m, const void* p, int rank, const cuuint64_t* dim,
                               const cuuint64_t* stride, const cuuint32_t* box) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r =
      fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank), const_cast<void*>(p),
         dim, stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Before the first launch of a tile: its shared memory opted into, the
// registers it launches with read back, and the blocks the card holds at
// once (`resident`: blocks an SM x SMs, the persistent grid's most).
// setmaxnreg moves registers inside the block's pool, and the consumers'
// increase waits for the producer's decrease: with fewer registers at
// launch than the split assumes it would wait forever, so such a build
// refuses to launch instead.
template <class Tl>
cudaError_t prepare_gemm(int* resident = nullptr) {
  cudaError_t e = opt_in_smem(gemm_kernel<Tl>, Tl::smem);
  if (e != cudaSuccess) return e;
  static int regs = -1, blocks = 0;
  if (regs < 0) {
    cudaFuncAttributes fa{};
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaFuncGetAttributes(&fa, gemm_kernel<Tl>);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_kernel<Tl>, Tl::threads,
                                                        Tl::smem);
    if (e != cudaSuccess) return e;
    regs = fa.numRegs;
    blocks = sms * per_sm;
  }
  if (resident != nullptr) *resident = blocks;
  if (blocks < 1) return cudaErrorLaunchOutOfResources;
  return regs >= Tl::launch_regs ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

// prepare_gemm's checks for the u product's block of KE env tiles.
template <int KE>
cudaError_t prepare_fold_u() {
  using Tl = FTile<KE>;
  cudaError_t e = opt_in_smem(fold_u_kernel<KE>, Tl::smem);
  if (e != cudaSuccess) return e;
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes fa{};
    e = cudaFuncGetAttributes(&fa, fold_u_kernel<KE>);
    if (e != cudaSuccess) return e;
    regs = fa.numRegs;
  }
  return regs >= Tl::launch_regs ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

// Before a row kernel's launch with `smem` bytes of dynamic shared memory:
// the blocks the card holds at once (blocks an SM x SMs, the persistent
// grid's most) and the memory opted into, asked once per (kernel, bytes,
// device) and kept: a launch that finds its entry makes no attribute or
// occupancy call. A mutex guards the table (and opt_in_smem's, which only
// a miss reaches).
template <class K>
cudaError_t prepare_rows(K* kernel, int smem, int* resident) {
  struct Entry {
    const void* kernel;
    int dev, smem, blocks;
  };
  static Entry table[64];
  static int used = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* k = reinterpret_cast<const void*>(kernel);
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (table[i].kernel == k && table[i].dev == dev && table[i].smem == smem) {
      *resident = table[i].blocks;
      return cudaSuccess;
    }
  if (smem > 0) e = opt_in_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWRowThreads, smem);
  if (e != cudaSuccess) return e;
  *resident = sms * per_sm;
  if (used < 64) table[used++] = Entry{k, dev, smem, *resident};
  return *resident > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

// The launch plan of one product (tests/wide_mirror.py gemm_plan mirrors
// it): the tile, the K splits, the tiles' grid and the blocks launched.
struct GemmPlan {
  int bm, bn, wgs, splits, kchunk, pstride, gx, gy, gz, blocks;
};

// The launch plan of the u product (tests/wide_mirror.py fold_u_plan
// mirrors it): env tiles of 64 a block, the K splits and their stages, the
// floats from one split's partial rows to the next, the grid of blocks.
struct FoldPlan {
  int ke, splits, kchunk;
  long pstride;
  int gx, gy, gz, blocks;
};

// One call's launches on `stream`, stopping at the first error (`err`);
// `launched` counts them, `gemms`, `rowk`, `stagings`, `fold_us` and
// `fold_hs` the products, row kernels, stagings, u products and fused
// folded layers among them, each where it launches.
struct Wide {
  Weights w;
  Dims d;
  int N, S;
  long R;
  const int* task;
  int ntask;
  Scratch sc;
  cudaStream_t stream;
  int err = 0, launched = 0, gemms = 0, rowk = 0, stagings = 0, fold_us = 0, fold_hs = 0;
  bool large;          // the product's tile (wide_large)
  GemmPlan last{};     // the last product's plan: the row kernel reads its partials
  FoldPlan fold{};     // the last u product's plan: the fused layer sums its partials
  int row_plan[6] = {};  // the last row kernel's: threads a row, row groups a
                         // block, ring stages, shared bytes, blocks, resident blocks
  int Lp, Ap, Mp, kz, kl, km;

  Wide(const void* const* wptrs, const int* dims, int N_, int S_, const int* task_, int ntask_,
       const Scratch& sc_, cudaStream_t st)
      : d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]}, N(N_), S(S_),
        R(static_cast<long>(N_) * S_), task(task_), ntask(ntask_), sc(sc_), stream(st) {
    for (int i = 0; i < kNumOps; ++i) w.p[i] = wptrs[i];
    large = wide_large(d, S);
    Lp = up16(d.L);
    Ap = up16(d.A);
    Mp = up16(d.M);
    kz = (Lp + Ap) / 16;
    kl = Lp / 16;
    km = Mp / 16;
  }

  void check_launch() {
    ++launched;
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) err = static_cast<int>(e);
  }

  // out [6]: the launches, then the products, the row kernels, the
  // stagings, the u products and the fused folded layers among them
  void report(int* out) const {
    out[0] = launched;
    out[1] = gemms;
    out[2] = rowk;
    out[3] = stagings;
    out[4] = fold_us;
    out[5] = fold_hs;
  }

  // y <- x . W (+ bias) on the call's rows: x's rows ldx apart, K = 16 kt
  // columns; W the wide layout [heads, ncols, 16 kt] of a matrix (heads =
  // num_q where `head` picks each env's), or its first 16 kt columns of
  // rows ldw apart; K splits as gemm_splits gives them.
  void gemm(const uint16_t* x, long ldx, int kt, const void* W, int ncols, const float* b,
            long bt, long bh, const int* head = nullptr, long hn = 0,
            const float* b1 = nullptr, int split = -1, long ldw = 0) {
    if (err) return;
    const int nheads = head == nullptr ? 1 : (d.NQ > 0 ? d.NQ : 1);
    GemmArgs a{sc.y, sc.ldy, ncols, b, bt, bh, b1, split < 0 ? ncols : split, task, ntask,
               head, hn, nheads, S, 0, R, (16 * kt + kWK - 1) / kWK, 0, up16(ncols), 0, 0, 0};
    // the rows of a block stay in one env where its bias or weights depend on the env
    const bool per_env = head != nullptr || (task != nullptr && ntask > 1 && bt != 0);
    const long lw = ldw > 0 ? ldw : 16L * kt;
    if (large) {
      launch_gemm<WLarge>(a, x, ldx, 16 * kt, W, lw, per_env);
    } else {
      launch_gemm<WSmall>(a, x, ldx, 16 * kt, W, lw, per_env);
    }
  }

  template <class Tl>
  void launch_gemm(GemmArgs a, const uint16_t* x, long ldx, int K, const void* W, long ldw,
                   bool per_env) {
    int resident = 0;
    cudaError_t e = prepare_gemm<Tl>(&resident);
    int s = gemm_splits(a.ncols, Tl::bn, a.nk, a.ldy);
    if (e == cudaSuccess && (s > 1 && static_cast<long>(s) * a.pstride > a.ldy))
      e = cudaErrorInvalidValue;   // the partial rows must fit a row of y
    a.kchunk = (a.nk + s - 1) / s;
    s = (a.nk + a.kchunk - 1) / a.kchunk;
    a.bpe = per_env ? (a.S + Tl::bm - 1) / Tl::bm : 0;
    const long gy = per_env ? static_cast<long>(N) * a.bpe : (a.R + Tl::bm - 1) / Tl::bm;
    a.gx = (a.ncols + Tl::bn - 1) / Tl::bn;
    a.gy = static_cast<int>(gy);
    a.gz = s;
    const long tiles = static_cast<long>(a.gx) * a.gy * a.gz;
    last = GemmPlan{Tl::bm, Tl::bn, Tl::wgs, s, a.kchunk, a.pstride, a.gx, a.gy, a.gz,
                    static_cast<int>(tiles < resident ? tiles : resident)};
    CUtensorMap tx, tw;
    if (e == cudaSuccess) {
      const cuuint64_t dim[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(a.R)};
      const cuuint64_t stride[1] = {static_cast<cuuint64_t>(ldx) * 2};
      const cuuint32_t box[2] = {kWK, Tl::bm};
      e = encode_bf16(&tx, x, 2, dim, stride, box);
    }
    if (e == cudaSuccess) {
      // K columns of each of the ncols rows, ldw apart (the whole K of a
      // matrix, or one block of it: the latent's or the actions' share of
      // a first layer)
      const cuuint64_t dim[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(a.ncols),
                                 static_cast<cuuint64_t>(a.nhead)};
      const cuuint64_t stride[2] = {static_cast<cuuint64_t>(ldw) * 2,
                                    static_cast<cuuint64_t>(ldw) * a.ncols * 2};
      const cuuint32_t box[3] = {kWK, Tl::bn, 1};
      e = encode_bf16(&tw, W, 3, dim, stride, box);
    }
    if (e != cudaSuccess) {
      err = static_cast<int>(e);
      return;
    }
    gemm_kernel<Tl><<<last.blocks, Tl::threads, Tl::smem, stream>>>(a, tx, tw);
    ++gemms;
    check_launch();
  }

  // The row kernel after a product (tests/wide_mirror.py row_plan mirrors
  // its plan): the LayerNorm modes on row groups of TPR threads, 32 to 256
  // from the width, with a ring of row buffers a group (as many as
  // kWRowRing holds, 1 to kWRowStages); the narrow modes on LPR lanes a
  // row. Persistent: as many blocks as the card holds, or as the rows need.
  void rows(RowArgs a) {
    if (err) return;
    a.y = sc.y;
    a.ldy = sc.ldy;
    a.nsplit = last.splits;
    a.pstride = last.pstride;
    a.S = S;
    a.R = R;
    if (a.mode == kRowHidden || a.mode == kRowLatent) {
      int tpr = 32;
      while (tpr < kWRowThreads && a.ncols > tpr * kWChunks * 4) tpr *= 2;
      const int rg = kWRowThreads / tpr;
      const int floats = (a.nsplit - 1) * a.pstride + ((a.ncols + 3) & ~3);
      int stages = kWRowRing / (rg * floats * 4);
      stages = stages < 1 ? 1 : (stages > kWRowStages ? kWRowStages : stages);
      const long smem = static_cast<long>(rg) * stages * (floats * 4 + 8);
      if (smem > kSmemMax) {   // a row and its partial rows too wide to stage
        err = static_cast<int>(cudaErrorInvalidValue);
        return;
      }
      const int sm = static_cast<int>(smem);
      if (a.mode == kRowHidden) {
        launch_ln<kActMish>(tpr, rg, stages, sm, a, floats);
      } else if (a.group == 8) {
        launch_ln<kActSimNorm8>(tpr, rg, stages, sm, a, floats);
      } else {
        launch_ln<kActSimNorm>(tpr, rg, stages, sm, a, floats);
      }
      return;
    }
    int lpr = 1;   // the gate: a lane a row
    if (a.mode == kRowPi) {
      while (lpr < 32 && lpr < a.A) lpr *= 2;
    } else if (a.mode != kRowTerm) {
      const int nch = (a.ncols + 3) / 4;
      while (lpr < 32 && 2 * lpr < nch) lpr *= 2;   // two chunks a lane
    }
    const int rg = kWRowThreads / lpr;
    switch (lpr) {
      case 1: launch_rows(row_narrow_kernel<1>, 1, rg, 0, 0, a); break;
      case 2: launch_rows(row_narrow_kernel<2>, 2, rg, 0, 0, a); break;
      case 4: launch_rows(row_narrow_kernel<4>, 4, rg, 0, 0, a); break;
      case 8: launch_rows(row_narrow_kernel<8>, 8, rg, 0, 0, a); break;
      case 16: launch_rows(row_narrow_kernel<16>, 16, rg, 0, 0, a); break;
      default: launch_rows(row_narrow_kernel<32>, 32, rg, 0, 0, a); break;
    }
  }

  template <int ACT>
  void launch_ln(int tpr, int rg, int stages, int sm, const RowArgs& a, int floats) {
    switch (tpr) {
      case 32: launch_rows(row_kernel<32, ACT>, 32, rg, stages, sm, a, stages, floats); break;
      case 64: launch_rows(row_kernel<64, ACT>, 64, rg, stages, sm, a, stages, floats); break;
      case 128:
        launch_rows(row_kernel<128, ACT>, 128, rg, stages, sm, a, stages, floats);
        break;
      default:
        launch_rows(row_kernel<256, ACT>, 256, rg, stages, sm, a, stages, floats);
        break;
    }
  }

  // One row kernel: `rg` rows a block at once, persistent blocks.
  template <class K, class... Args>
  void launch_rows(K* kernel, int tpr, int rg, int stages, int smem, Args... args) {
    int resident = 0;
    const cudaError_t e = prepare_rows(kernel, smem, &resident);
    const long want = (R + rg - 1) / rg;
    const int blocks = static_cast<int>(want < resident ? (want > 0 ? want : 1) : resident);
    const int plan[6] = {tpr, rg, stages, smem, blocks, resident};
    for (int i = 0; i < 6; ++i) row_plan[i] = plan[i];
    if (e != cudaSuccess) {
      err = static_cast<int>(e);
      return;
    }
    kernel<<<blocks, kWRowThreads, smem, stream>>>(args...);
    ++rowk;
    check_launch();
  }

  // One staging launch: the grid from the rows (a block of 64 rows, a
  // thread a row; kStageLatentRows rows and a warp a row where the latent
  // goes into x), then a block of 2 envs a warp each when folded (a.zb).
  void stage(StageArgs a) {
    if (err) return;
    a.x = sc.x;
    a.ldx = sc.ldx;
    a.L = d.L;
    a.Lp = Lp;
    a.A = d.A;
    a.Ap = Ap;
    a.H = d.H;
    a.S = S;
    a.N = N;
    a.R = static_cast<int>(R);
    const bool latent_rows = a.load_z && a.zb == nullptr;
    const int threads = latent_rows ? 256 : 64;
    a.rpb = latent_rows ? kStageLatentRows : threads;
    a.row_blocks = static_cast<int>((R + a.rpb - 1) / a.rpb);
    const int env_blocks = a.zb != nullptr ? (N + threads / 32 - 1) / (threads / 32) : 0;
    auto on16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    a.vec = on16(a.z0) && a.zn % 4 == 0 && a.zs % 4 == 0;
    // 16-byte stores: x's rows (and zb's) start on 16 bytes; rows counted in 32 bits
    if (!on16(a.x) || a.ldx % 8 != 0 || (a.zb != nullptr && (!on16(a.zb) || !a.load_z))
        || R >= (1L << 31) || (a.load_z && a.z0 == nullptr)) {
      err = static_cast<int>(cudaErrorInvalidValue);
      return;
    }
    stage_kernel<<<a.row_blocks + env_blocks, threads, 0, stream>>>(a);
    ++stagings;
    check_launch();
  }

  // u = zb . W[:, :16 kt] on n envs' latents (zb's rows ldz apart; W's
  // rows ldw apart) into the partial rows of u (rows ldu apart, n ldu
  // floats from one split's to the next): the plan of FoldPlan, from the
  // widths and n.
  void fold_u(const uint16_t* zb, long ldz, int kt, const void* W, long ldw, int ncols, int n,
              float* u, long ldu) {
    if (err) return;
    FoldArgs a{};
    a.u = u;
    a.ldu = ldu;
    a.pstride = static_cast<long>(n) * ldu;
    a.ncols = ncols;
    a.N = n;
    a.nk = (16 * kt + kWK - 1) / kWK;
    int s = fold_splits(ncols, a.nk);
    a.kchunk = (a.nk + s - 1) / s;
    s = (a.nk + a.kchunk - 1) / a.kchunk;
    const int ke = n > kFoldEnvs ? 2 : 1;
    a.gx = (ncols + kFoldCols - 1) / kFoldCols;
    a.gy = (n + ke * kFoldEnvs - 1) / (ke * kFoldEnvs);
    a.gz = s;
    fold = FoldPlan{ke, s, a.kchunk, a.pstride, a.gx, a.gy, a.gz, a.gx * a.gy * a.gz};
    cudaError_t e = ke == 2 ? prepare_fold_u<2>() : prepare_fold_u<1>();
    if (e == cudaSuccess && (n < 1 || ldu % 4 != 0 || ldu < ncols))
      e = cudaErrorInvalidValue;
    CUtensorMap tw, tz;
    if (e == cudaSuccess) {
      const cuuint64_t dim[2] = {static_cast<cuuint64_t>(16 * kt), static_cast<cuuint64_t>(ncols)};
      const cuuint64_t stride[1] = {static_cast<cuuint64_t>(ldw) * 2};
      const cuuint32_t box[2] = {kWK, kFoldCols};
      e = encode_bf16(&tw, W, 2, dim, stride, box);
    }
    if (e == cudaSuccess) {
      const cuuint64_t dim[2] = {static_cast<cuuint64_t>(16 * kt), static_cast<cuuint64_t>(n)};
      const cuuint64_t stride[1] = {static_cast<cuuint64_t>(ldz) * 2};
      const cuuint32_t box[2] = {kWK, kFoldEnvs};
      e = encode_bf16(&tz, zb, 2, dim, stride, box);
    }
    if (e != cudaSuccess) {
      err = static_cast<int>(e);
      return;
    }
    if (ke == 2) {
      fold_u_kernel<2><<<fold.blocks, FTile<2>::threads, FTile<2>::smem, stream>>>(a, tw, tz);
    } else {
      fold_u_kernel<1><<<fold.blocks, FTile<1>::threads, FTile<1>::smem, stream>>>(a, tw, tz);
    }
    ++fold_us;
    check_launch();
  }

  // h = mish(LN(x_a . Wa + (u[env] + b[task[env] * bt]))) on the call's
  // rows: x_a the rows' action columns (rows ldx apart, A values and zeros
  // to 16), Wa the action block (column c's weights at Wa + c ldw), u the
  // last u product's partial rows (rows ldu apart), b the bias table (the
  // call's task ids), gain and beta [M]; into dst (rows ldd apart, zeros
  // from M to dpad). The plan (threads a row, row groups a block, action
  // chunks of 8, shared bytes, blocks, resident blocks) into row_plan.
  void fold_hidden(const uint16_t* xa, long ldx, const void* Wa, long ldw, const float* u,
                   long ldu, const float* b, long bt, const float* gain, const float* beta,
                   uint16_t* dst, long ldd, int dpad) {
    if (err) return;
    FoldRowArgs a{};
    a.x = xa;
    a.ldx = ldx;
    a.w = static_cast<const uint16_t*>(Wa);
    a.ldw = ldw;
    a.u = u;
    a.ldu = ldu;
    a.pstride = fold.pstride;
    a.nsplit = fold.splits;
    a.b = b;
    a.bt = bt;
    a.task = task;
    a.ntask = ntask;
    a.gain = gain;
    a.beta = beta;
    a.dst = dst;
    a.ldd = ldd;
    a.dpad = dpad;
    a.ncols = d.M;
    a.A = d.A;
    a.ak = (d.A + 7) / 8;
    a.wstride = (d.M + 3) & ~3;
    a.S = S;
    a.R = R;
    auto on16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    // 16-byte reads of the actions, the weights and u; 8-byte stores of dst
    if (!fold_fits(d) || !on16(xa) || ldx % 8 != 0 || !on16(Wa) || ldw % 8 != 0 ||
        !on16(u) || !on16(gain) || !on16(beta) || b == nullptr ||
        ldu % 4 != 0 || a.pstride % 4 != 0 || a.nsplit < 1 || a.nsplit > kWMaxSplits ||
        (reinterpret_cast<uintptr_t>(dst) & 7) != 0 || ldd % 4 != 0 || dpad % 4 != 0) {
      err = static_cast<int>(cudaErrorInvalidValue);
      return;
    }
    const int tpr = fold_tpr(d.M), sm = fold_hidden_smem(d, tpr);
    // every thread's chunks full and inside the row (4096 columns: 256
    // threads of 16): the kernel without the ragged edge's guards, its
    // product unrolled for up to 8 actions (mt80's 6); the other widths
    // reach the wide engine with more than 32 actions (mlp_rows.cuh
    // pick_plan) or between 2048 and 4096 columns
    const bool full = tpr == kWRowThreads && d.M == tpr * kWChunks * 4 && dpad == d.M;
    switch (full ? (a.ak == 1 ? 1 : 0) : tpr) {
      case 1: launch_fold_h(fold_hidden_kernel<256, 1, true>, tpr, sm, a); break;
      case 0: launch_fold_h(fold_hidden_kernel<256, 0, true>, tpr, sm, a); break;
      case 32: launch_fold_h(fold_hidden_kernel<32, 0, false>, tpr, sm, a); break;
      case 64: launch_fold_h(fold_hidden_kernel<64, 0, false>, tpr, sm, a); break;
      case 128: launch_fold_h(fold_hidden_kernel<128, 0, false>, tpr, sm, a); break;
      default: launch_fold_h(fold_hidden_kernel<256, 0, false>, tpr, sm, a); break;
    }
  }

  template <class K>
  void launch_fold_h(K* kernel, int tpr, int smem, const FoldRowArgs& a) {
    int resident = 0;
    const cudaError_t e = prepare_rows(kernel, smem, &resident);
    const int rg = kWRowThreads / tpr;
    const long want = (R + rg - 1) / rg;
    const int blocks = static_cast<int>(want < resident ? (want > 0 ? want : 1) : resident);
    const int plan[6] = {tpr, rg, a.ak, smem, blocks, resident};
    for (int i = 0; i < 6; ++i) row_plan[i] = plan[i];
    if (e != cudaSuccess) {
      err = static_cast<int>(e);
      return;
    }
    kernel<<<blocks, kWRowThreads, smem, stream>>>(a);
    ++fold_hs;
    check_launch();
  }

  RowArgs row_args(int mode, int ncols) const {
    RowArgs a{};
    a.mode = mode;
    a.ncols = ncols;
    a.group = d.G;
    a.bins = w.f(bins);
    a.term = sc.term;
    a.A = d.A;
    return a;
  }

  // A NormedLinear + Mish layer from x (kt k-tiles) into h.
  void hidden(const uint16_t* x, long ldx, int kt, int op, const float* b, long bt, long bh,
              const float* gain, const float* beta, const int* head = nullptr, long hn = 0) {
    gemm(x, ldx, kt, w.p[op], d.M, b, bt, bh, head, hn);
    mish_rows(gain, beta, head, hn);
  }

  // LayerNorm + Mish of the last product's rows into h.
  void mish_rows(const float* gain, const float* beta, const int* head, long hn) {
    RowArgs r = row_args(kRowHidden, d.M);
    r.gain = gain;
    r.beta = beta;
    r.gh = d.M;
    r.head = head;
    r.hn = hn;
    r.nhead = d.NQ > 0 ? d.NQ : 1;
    r.dst = sc.h;
    r.ldd = sc.ldh;
    r.dpad = Mp;
    rows(r);
  }

  // The first two layers of a head: op0 from x (kt k-tiles; its bias a row
  // of a task table), op0 + 4 from h. Folded (a z||a first layer at t = 0,
  // each env's latent in zb: value_wide with zs = 0), op0's product is
  // split as x W = z Wz + a Wa, the TPU kernel's split
  // (tdmpc2_tpu/ops/pallas_rollout.py:484): u = zb . W[:, :Lp] on the N
  // envs' latents (fold_u), then LayerNorm + Mish of the action columns of
  // x . W[:, Lp:] + (u[env] + b0[task[env]]) on every row, in one launch
  // (fold_hidden).
  void hidden2(int kt, int op0, const int* head = nullptr, long hn = 0, bool folded = false) {
    const bool qh = op0 == qP0;
    const long bt = qh ? static_cast<long>(d.NQ) * d.M : d.M;
    const long bh = qh ? d.M : 0;
    if (folded) {
      const uint16_t* W = static_cast<const uint16_t*>(w.p[op0]);
      const long ldw = 16L * kz;
      fold_u(sc.zb, Lp, kl, W, ldw, d.M, N, sc.u, Mp);
      fold_hidden(sc.x + Lp, sc.ldx, W + Lp, ldw, sc.u, Mp, w.f(op0 + 1), bt, w.f(op0 + 2),
                  w.f(op0 + 3), sc.h, sc.ldh, Mp);
    } else {
      hidden(sc.x, sc.ldx, kt, op0, w.f(op0 + 1), bt, bh, w.f(op0 + 2), w.f(op0 + 3), head,
             hn);
    }
    hidden(sc.h, sc.ldh, km, op0 + 4, w.f(op0 + 5), 0, bh, w.f(op0 + 6), w.f(op0 + 7), head, hn);
  }

  // z_{t+1} = SimNorm(LN(dynamics)) into the latent columns of x; f32 into
  // zH (rows L apart) too when zH is not null.
  void dynamics(float* zH = nullptr, bool folded = false) {
    hidden2(kz, dP0, nullptr, 0, folded);
    gemm(sc.h, sc.ldh, km, w.p[dP2], d.L, w.f(db2), 0, 0);
    RowArgs r = row_args(kRowLatent, d.L);
    r.gain = w.f(dg2);
    r.beta = w.f(de2);
    r.dst = sc.x;
    r.ldd = sc.ldx;
    r.dpad = Lp;
    r.fdst = zH;
    r.ldf = d.L;
    rows(r);
  }

  // G += discs[t] * (1 - term) * reward(z_t, a_t)
  void reward(const float* discs, long dn, int t, bool folded = false) {
    hidden2(kz, rP0, nullptr, 0, folded);
    gemm(sc.h, sc.ldh, km, w.p[rP2], d.B, w.f(rb2), 0, 0);
    RowArgs r = row_args(kRowReward, d.B);
    r.G = sc.G;
    r.discs = discs;
    r.dn = dn;
    r.t = t;
    rows(r);
  }

  // The sticky termination flag after step t's dynamics.
  void termination(int t, int* term_at) {
    hidden2(kl, tP0);
    gemm(sc.h, sc.ldh, km, w.p[tP2], 1, w.f(tb2), 0, 0);
    RowArgs r = row_args(kRowTerm, 1);
    r.t = t;
    r.term_at = term_at;
    rows(r);
  }

  // The policy's action on the latent columns of x into its action
  // columns (bf16), and in f32 to acts (rows ldf apart) when not null.
  void policy(const float* eps, long en, long es, const float* amask, long amn, float lsmin,
              float lsdif, float* acts = nullptr, long ldf = 0) {
    hidden2(kl, pP0);
    gemm(sc.h, sc.ldh, km, w.p[pP2], 2 * d.A, w.f(pbm), 0, 0, nullptr, 0, w.f(pbl), d.A);
    RowArgs r = row_args(kRowPi, 2 * d.A);
    r.eps = eps;
    r.en = en;
    r.es = es;
    r.amask = amask;
    r.amn = amn;
    r.lsmin = lsmin;
    r.lsdif = lsdif;
    r.dst = sc.x + Lp;
    r.ldd = sc.ldx;
    r.dpad = Ap;
    r.fdst = acts;
    r.ldf = ldf;
    rows(r);
  }

  // Q head j of each env (qidx + e * qn + j) on z||a: j = 0 keeps it in q,
  // j = 1 writes the value out = G + discs[H] (1 - term) (q + Q) / 2.
  void q_head(int j, const int* qidx, long qn, const float* discs, long dn, float* out) {
    const int* hd = qidx + j;
    hidden2(kz, qP0, hd, qn);
    gemm(sc.h, sc.ldh, km, w.p[qP2], d.B, w.f(qb2), 0, d.B, hd, qn);
    RowArgs r = row_args(j == 0 ? kRowQ0 : kRowQ1, d.B);
    r.G = sc.G;
    r.q = sc.q;
    r.discs = discs;
    r.dn = dn;
    r.t = d.H;
    r.out = out;
    rows(r);
  }
};

template <class Tl>
int wide_plan_report(int* out) {
  out[0] = Tl::bm;
  out[1] = Tl::bn;
  out[2] = kWK;
  out[3] = kWStages;
  out[4] = Tl::smem;
  out[5] = 0;
  out[6] = Tl::wgs;
  out[7] = 0;
  const cudaError_t err = prepare_gemm<Tl>();
  cudaFuncAttributes fa{};
  if (cudaFuncGetAttributes(&fa, gemm_kernel<Tl>) == cudaSuccess) out[7] = fa.numRegs;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[5], gemm_kernel<Tl>, Tl::threads, Tl::smem));
}

}  // namespace tdm

// out = {rows and columns of a product block, its K depth a stage, stages,
// shared bytes, product blocks per SM, consumer warpgroups, registers a
// thread at launch} of the product at these dims and S rows an env;
// returns an error code.
extern "C" int tdm_wide_plan(const int* dims, int S, int* out) {
  using namespace tdm;
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  return wide_large(d, S) ? wide_plan_report<WLarge>(out) : wide_plan_report<WSmall>(out);
}

// The engine the value and pi-rollout kernels take at these dims: 0 the
// row tiles (mlp_rows.cuh pick_plan), 1 the wide engine, kNoPlan neither.
extern "C" int tdm_engine(const int* dims) {
  using namespace tdm;
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  if (pick_plan(d).shape >= 0) return 0;
  return wide_fits(d) ? 1 : kNoPlan;
}
