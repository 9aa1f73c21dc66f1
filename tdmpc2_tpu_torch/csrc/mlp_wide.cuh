// Layer-per-launch MLP engine on Hopper's tensor cores: the value, pi-rollout
// and rollout kernels at widths that no row tile of mlp_rows.cuh holds
// (above 2048 columns: model_size 317's mlp_dim 4096), and the rollout
// kernel at every width.
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
// The product (gemm_kernel): a block owns T rows of one env and T columns
// (T = 128 above 2048 columns, else 64: WTile); 8 warps, 2 (T/2 rows each)
// x 4 (T/4 columns each), run
// mma.sync.m16n8k16 (bf16 x bf16 -> f32). A fragments come from a bf16
// activation tile in shared memory through ldmatrix; B fragments from the
// packed weights (ops/value.py pack_matrix, the row-tile engine's layout),
// whose k-tile of a column tile is one contiguous run, one 16-byte shared
// load per lane. Both are staged by cp.async, kWStages deep, kWKT k-tiles
// a stage. Each k-tile's products are taken alone and added to the f32 sums
// (mma16816: the tensor cores truncate). The K loop runs over the layer's
// whole input width in order, and the tile shape is fixed, so every output
// element's sum is formed in one order whatever N and S are, and a row
// tile never straddles two envs (as the value kernel's blocks_per_env), so
// that its Q heads and task bias rows are one env's: an N-env launch equals
// N one-env launches bit for bit.
//
// The row kernel (row_kernel): TPR threads a row (32 to 256, from the
// width), 16 values a thread at most (so at most 4096 columns), the row's
// statistics summed in a fixed tree in f32 in the plain version's order
// (mean, then the centred variance).
//
// Bound: a layer of K x N on R rows moves K N bf16 weights and R (K + N)
// activations and does R K N multiply-adds; at model_size 317 (K = N =
// 4096) the work is compute-bound on the card above ~600 rows. This first
// version runs mma.sync, not wgmma, and writes each pre-activation to
// device memory in f32 (the row statistics need the whole row).
#pragma once

#include "mlp_rows.cuh"

namespace tdm {

constexpr int kWKT = 4;                  // k-tiles (16 deep) a stage
constexpr int kWStages = 3;
constexpr int kWThreads = 256;
constexpr int kWLdA = kWKT * 16 + 8;     // bf16 row stride of an A stage (+8: ldmatrix banks)
constexpr int kWideCols = 2048;          // above this widest layer, the large tile

// A product block of T rows x T columns: T = 128 where the widest layer is
// above 2048 columns (model_size 317), else 64 (the rollout at model_size
// 1-48: four times the blocks of a small layer). The shape follows from
// the widths alone.
template <int T>
struct WTile {
  static constexpr int bm = T, bn = T, pairs = T / 16;
  static constexpr int mt = T / 32;   // m-tiles of a warp (8 warps: 2 x 4)
  static constexpr int jp = T / 64;   // column pairs of a warp
  static constexpr int stage_a = T * kWLdA * 2;
  static constexpr int stage_b = kWKT * pairs * 512;
  static constexpr int smem = kWStages * (stage_a + stage_b);
};

constexpr int kWRowThreads = 256;
constexpr int kWVals = 16;               // values a thread of the row kernel
constexpr int kWMaxCols = kWRowThreads * kWVals;

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

// The product block's side at these widths (WTile).
inline int wide_tile(const Dims& d) {
  const int Lp = up16(d.L), Mp = up16(d.M), Bp = up16(d.B);
  const int widest = Mp > Lp ? (Mp > Bp ? Mp : Bp) : (Lp > Bp ? Lp : Bp);
  return widest > kWideCols ? 128 : 64;
}

// ---------------------------------------------------------------------------
// The product
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// One layer's product: y[row, c] = x[row, :16 kt] . W[:, c] + bias[c] for
// c < ncols, the rows of N envs of S rows each (row env * S + s).
struct GemmArgs {
  const uint16_t* x;  // bf16 activations, ldx apart (a multiple of 8)
  long ldx;
  const uint4* w;     // packed matrix: kt k-tiles of np column pairs
  int kt, np;
  long wh;            // uint4s from one head's packed matrix to the next
  const float* b;     // bias of column c: b[task * bt + head * bh + c]
  long bt, bh;
  const float* b1;    // columns c >= split: b1[c - split] (the pi head's log-std)
  int split;
  float* y;           // f32 output, ldy apart (even)
  long ldy;
  int ncols;
  const int* task;    // [N] task ids, or null (task 0)
  int ntask;
  const int* head;    // env e's head index at head[e * hn] (a Q head), or null
  long hn;
  int nhead;
  int S, bpe;         // rows an env, row tiles an env
};

template <int T>
__global__ void __launch_bounds__(kWThreads, 2) gemm_kernel(const GemmArgs a) {
  using Tl = WTile<T>;
  extern __shared__ uint4 wide_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int env = blockIdx.y / a.bpe;
  const int r0 = (blockIdx.y % a.bpe) * Tl::bm;
  const int nrows = min(Tl::bm, a.S - r0);
  const long rowbase = static_cast<long>(env) * a.S + r0;
  const int p0 = blockIdx.x * Tl::pairs;
  const int npb = min(Tl::pairs, a.np - p0);
  const int task = a.task == nullptr ? 0 : min(max(a.task[env], 0), a.ntask - 1);
  const int head = a.head == nullptr ? 0 : min(max(a.head[env * a.hn], 0), a.nhead - 1);
  const uint4* W = a.w + head * a.wh;
  const uint32_t sA = smem_u32(wide_smem);
  const uint32_t sB = sA + kWStages * Tl::stage_a;
  const int nk = (a.kt + kWKT - 1) / kWKT;

  // stage `st` <- k-tiles [kt0, kt0 + n): the A rows (zeros past nrows) and
  // the column tile's pairs of each k-tile. A whole stage of a whole column
  // tile (all but the ragged edges) indexes by shifts.
  auto load = [&](int st, int kt0) {
    const int n = min(kWKT, a.kt - kt0);
    const uint32_t dA = sA + st * Tl::stage_a;
    const uint32_t dB = sB + st * Tl::stage_b;
    if (n == kWKT && npb == Tl::pairs) {
#pragma unroll
      for (int i = tid; i < Tl::bm * kWKT * 2; i += kWThreads) {
        const int r = i / (kWKT * 2), c = i % (kWKT * 2);
        const bool ok = r < nrows;
        const uint16_t* src = a.x + (ok ? (rowbase + r) * a.ldx + kt0 * 16 + c * 8 : 0);
        cp16(dA + (r * kWLdA + c * 8) * 2, src, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = tid; i < kWKT * Tl::pairs * 32; i += kWThreads) {
        const int l = i & 31, j = (i >> 5) % Tl::pairs, k = (i >> 5) / Tl::pairs;
        cp16(dB + ((k * Tl::pairs + j) * 32 + l) * 16,
             W + (static_cast<long>(kt0 + k) * a.np + p0 + j) * 32 + l, 16);
      }
      return;
    }
    for (int i = tid; i < Tl::bm * n * 2; i += kWThreads) {
      const int r = i / (n * 2), c = i % (n * 2);
      const bool ok = r < nrows;
      const uint16_t* src = a.x + (ok ? (rowbase + r) * a.ldx + kt0 * 16 + c * 8 : 0);
      cp16(dA + (r * kWLdA + c * 8) * 2, src, ok ? 16 : 0);
    }
    for (int i = tid; i < n * npb * 32; i += kWThreads) {
      const int l = i & 31, j = (i >> 5) % npb, k = (i >> 5) / npb;
      cp16(dB + ((k * Tl::pairs + j) * 32 + l) * 16,
           W + (static_cast<long>(kt0 + k) * a.np + p0 + j) * 32 + l, 16);
    }
  };

  float c[Tl::mt][Tl::jp][2][4];
#pragma unroll
  for (int mt = 0; mt < Tl::mt; ++mt)
#pragma unroll
    for (int j = 0; j < Tl::jp; ++j)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int x = 0; x < 4; ++x) c[mt][j][t][x] = 0.f;

  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < nk) load(s, s * kWKT);
    cp_commit();
  }
  // m-tiles with rows, pairs with columns: warp-uniform, so the ldmatrix and
  // mma instructions below never sit under a divergent branch
  const int mrow = wm * (Tl::bm / 2);
  for (int ks = 0; ks < nk; ++ks) {
    cp_wait<kWStages - 2>();
    __syncthreads();
    {  // refill the stage every warp finished before the barrier
      const int nx = ks + kWStages - 1;
      if (nx < nk) load(nx % kWStages, nx * kWKT);
      cp_commit();
    }
    const int st = ks % kWStages;
    const int n = min(kWKT, a.kt - ks * kWKT);
    const uint32_t aS = sA + st * Tl::stage_a, bS = sB + st * Tl::stage_b;
    // one k-tile of the stage: the same products in the same order whether
    // the loop below runs unrolled (a whole stage) or not
    auto ktile = [&](int i) {
      uint32_t af[Tl::mt][4];
#pragma unroll
      for (int mt = 0; mt < Tl::mt; ++mt)
        if (mrow + mt * 16 < nrows)
          ldsm_x4(af[mt], aS + ((mrow + mt * 16 + (lane & 15)) * kWLdA + i * 16 +
                                (lane >> 4) * 8) * 2);
#pragma unroll
      for (int j = 0; j < Tl::jp; ++j) {
        const int pair = wn * Tl::jp + j;
        if (pair >= npb) continue;
        const uint4 b = lds128(bS + ((i * Tl::pairs + pair) * 32 + lane) * 16);
#pragma unroll
        for (int mt = 0; mt < Tl::mt; ++mt) {
          if (mrow + mt * 16 >= nrows) continue;
          float k16[2][4];
          mma16816(k16[0], af[mt], b.x, b.y);
          mma16816(k16[1], af[mt], b.z, b.w);
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int x = 0; x < 4; ++x) c[mt][j][t][x] += k16[t][x];
        }
      }
    };
    if (n == kWKT) {
#pragma unroll
      for (int i = 0; i < kWKT; ++i) ktile(i);
    } else {
      for (int i = 0; i < n; ++i) ktile(i);
    }
  }
  cp_wait<0>();

  const float* bias = a.b + task * a.bt + head * a.bh;
#pragma unroll
  for (int j = 0; j < Tl::jp; ++j) {
    const int pair = wn * Tl::jp + j;
    if (pair >= npb) continue;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int col = (p0 + pair) * 16 + t * 8 + 2 * q;
      float bv[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int cc = col + x;
        bv[x] = cc >= a.ncols ? 0.f : cc < a.split ? __ldg(bias + cc) : __ldg(a.b1 + cc - a.split);
      }
#pragma unroll
      for (int mt = 0; mt < Tl::mt; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = mrow + mt * 16 + g + 8 * hf;
          if (row >= nrows) continue;
          float* yr = a.y + (rowbase + row) * a.ldy + col;
          const float v0 = c[mt][j][t][2 * hf] + bv[0], v1 = c[mt][j][t][2 * hf + 1] + bv[1];
          if (col + 1 < a.ncols) {
            *reinterpret_cast<float2*>(yr) = make_float2(v0, v1);
          } else if (col < a.ncols) {
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

struct RowArgs {
  int mode;
  const float* y;   // the product's rows, ldy apart
  long ldy;
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

// Sum (or maximum) over the TPR threads of a row (TPR a multiple of 32),
// in a fixed tree: the warp's lanes, then the row's warps in order.
template <int TPR, bool kMax>
__device__ __forceinline__ float row_all(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if constexpr (TPR > 32) {
    __syncthreads();  // the last reduction's reads are done
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    const int w0 = (threadIdx.x / TPR) * (TPR / 32);
    x = red[w0];
#pragma unroll
    for (int k = 1; k < TPR / 32; ++k) x = kMax ? fmaxf(x, red[w0 + k]) : x + red[w0 + k];
  }
  return x;
}

template <int TPR>
__global__ void __launch_bounds__(kWRowThreads) row_kernel(const RowArgs a) {
  constexpr int RPB = kWRowThreads / TPR;
  __shared__ float red[kWRowThreads / 32];
  const int lr = threadIdx.x % TPR;
  const long row = static_cast<long>(blockIdx.x) * RPB + threadIdx.x / TPR;
  const bool live = row < a.R;
  const long rr = live ? row : 0;
  const int env = static_cast<int>(rr / a.S);
  const float* yr = a.y + rr * a.ldy;
  const int nc = a.ncols;

  if (a.mode == kRowPi) {
    // columns [0, A) the mean, [A, 2A) the raw log-std
    if (!live) return;
    const int s = static_cast<int>(rr - static_cast<long>(env) * a.S);
    for (int c = lr; c < a.dpad; c += TPR) {
      float act = 0.f;
      if (c < a.A) {
        const float m = a.amask != nullptr ? a.amask[env * a.amn + c] : 1.f;
        const float e = a.eps[env * a.en + s * a.es + c];
        const float mean = __fmul_rn(yr[c], m);
        const float ls = a.lsmin + 0.5f * a.lsdif * (tanhf(yr[a.A + c]) + 1.f);
        act = tanhf(mean + __fmul_rn(e, m) * expf(ls));
        if (a.fdst != nullptr) a.fdst[rr * a.ldf + c] = act;
      }
      a.dst[rr * a.ldd + c] = bf16_bits(act);
    }
    return;
  }
  if (a.mode == kRowTerm) {
    if (!live || lr != 0) return;
    const float hit = yr[0] > 0.f ? 1.f : 0.f;
    if (a.term_at != nullptr && a.term[rr] == 0.f && hit != 0.f) a.term_at[rr] = a.t + 1;
    a.term[rr] = fminf(a.term[rr] + hit, 1.f);
    return;
  }

  float v[kWVals];
  if (a.mode == kRowHidden || a.mode == kRowLatent) {
    const int h = a.head == nullptr ? 0 : min(max(a.head[env * a.hn], 0), a.nhead - 1);
    const float* gn = a.gain + h * a.gh;
    const float* bt = a.beta + h * a.gh;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWVals; ++i) {
      const int c = lr + i * TPR;
      v[i] = live && c < nc ? yr[c] : 0.f;
      s += v[i];
    }
    const float mu = row_all<TPR, false>(s, red) / nc;
    s = 0.f;
#pragma unroll
    for (int i = 0; i < kWVals; ++i) {
      const float dv = v[i] - mu;
      s += lr + i * TPR < nc ? dv * dv : 0.f;
    }
    const float rstd = rsqrtf(row_all<TPR, false>(s, red) / nc + 1e-5f);
#pragma unroll
    for (int i = 0; i < kWVals; ++i) {
      const int c = lr + i * TPR;
      const bool ok = c < nc;
      float y = (v[i] - mu) * rstd * (ok ? __ldg(gn + c) : 0.f) + (ok ? __ldg(bt + c) : 0.f);
      if (a.mode == kRowHidden) y = mish(y);
      v[i] = ok ? y : 0.f;
    }
    if (a.mode == kRowLatent) {
      // SimNorm over groups of G consecutive columns: G consecutive lanes
      // of one warp (TPR is a multiple of 32), groups never straddle nc
#pragma unroll
      for (int i = 0; i < kWVals; ++i) {
        float m = v[i];
        for (int o = 1; o < a.group; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const float e = expf(v[i] - m);
        float se = e;
        for (int o = 1; o < a.group; o <<= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
        v[i] = lr + i * TPR < nc ? e / se : 0.f;
      }
    }
    if (!live) return;
#pragma unroll
    for (int i = 0; i < kWVals; ++i) {
      const int c = lr + i * TPR;
      if (c < a.dpad) a.dst[rr * a.ldd + c] = bf16_bits(v[i]);
      if (a.fdst != nullptr && c < nc) a.fdst[rr * a.ldf + c] = v[i];
    }
    return;
  }

  // two-hot decode: symexp(softmax(logits) . bins)
  const float ninf = __int_as_float(0xff800000);
  float mx = ninf;
#pragma unroll
  for (int i = 0; i < kWVals; ++i) {
    const int c = lr + i * TPR;
    v[i] = live && c < nc ? yr[c] : ninf;
    mx = fmaxf(mx, v[i]);
  }
  mx = row_all<TPR, true>(mx, red);
  float se = 0.f, sb = 0.f;
#pragma unroll
  for (int i = 0; i < kWVals; ++i) {
    const int c = lr + i * TPR;
    if (c < nc) {
      const float ex = expf(v[i] - mx);
      se += ex;
      sb += ex * __ldg(a.bins + c);
    }
  }
  se = row_all<TPR, false>(se, red);
  sb = row_all<TPR, false>(sb, red);
  if (!live || lr != 0) return;
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

// ---------------------------------------------------------------------------
// Staging of each step's inputs
// ---------------------------------------------------------------------------

// Step t's inputs of the z||a buffer x [R, Lp + Ap]: with load_z, the
// latent z0 (env e, row s at z0 + e * zn + s * zs; zs = 0 broadcasts one
// row) rounded to bf16 in [0, L), zeros to Lp, and the per-row scalars
// zeroed; the actions in [Lp, Lp + A), zeros to Ap: given (actions + e * an
// + t * ats + s * ass), sampled (value.cu's formula), or none (zeros: the
// pi rollout writes its own).
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
  int S;
  long R;
};

__global__ void __launch_bounds__(256) stage_kernel(const StageArgs a) {
  const int w = a.load_z ? a.Lp + a.Ap : a.Ap;
  const long total = a.R * w;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const long row = i / w;
    const int col = static_cast<int>(i % w) + (a.load_z ? 0 : a.Lp);
    const int env = static_cast<int>(row / a.S);
    const int s = static_cast<int>(row - static_cast<long>(env) * a.S);
    uint16_t bits = 0;
    if (col < a.Lp) {
      if (col < a.L) bits = bf16_bits(a.z0[env * a.zn + s * a.zs + col]);
      if (col == 0) {
        if (a.G != nullptr) a.G[row] = 0.f;
        if (a.q != nullptr) a.q[row] = 0.f;
        if (a.term != nullptr) a.term[row] = 0.f;
        if (a.term_at != nullptr) a.term_at[row] = 0;
      }
    } else if (col - a.Lp < a.A) {
      const int c = col - a.Lp;
      if (a.actions != nullptr) {
        bits = bf16_bits(a.actions[env * a.an + a.t * a.ats + s * a.ass + c]);
      } else if (a.sp.mean != nullptr) {
        const int HA = a.H * a.A, k = a.t * a.A + c;
        const long at = static_cast<long>(s) * HA + k;
        float v;
        if (s < a.sp.n_pi) {
          v = a.sp.pi_acts[env * a.sp.pn + at];
        } else {
          v = fminf(fmaxf(__fadd_rn(a.sp.mean[env * a.sp.mn + k],
                                    __fmul_rn(a.sp.stdv[env * a.sp.sn + k],
                                              a.sp.noise[env * a.sp.nn + at])),
                          -1.f),
                    1.f);
        }
        v *= a.amask[env * a.amn + c];
        a.sp.acts[row * HA + k] = v;
        bits = bf16_bits(v);
      }
    }
    a.x[row * a.ldx + col] = bits;
  }
}

// ---------------------------------------------------------------------------
// Host side: a step's launches
// ---------------------------------------------------------------------------

// Device buffers of one call, allocated by the wrapper (ops/wide.py
// scratch): x the z||a rows [R, ldx] bf16, h the hidden rows [R, ldh]
// bf16, y the product [R, ldy] f32, and the per-row G, q, term [R] f32.
struct Scratch {
  uint16_t* x;
  uint16_t* h;
  float* y;
  float *G, *q, *term;
  long ldx, ldh, ldy;
};

inline Scratch scratch_from(const void* const* p, const long* ld) {
  return Scratch{static_cast<uint16_t*>(const_cast<void*>(p[0])),
                 static_cast<uint16_t*>(const_cast<void*>(p[1])),
                 static_cast<float*>(const_cast<void*>(p[2])),
                 static_cast<float*>(const_cast<void*>(p[3])),
                 static_cast<float*>(const_cast<void*>(p[4])),
                 static_cast<float*>(const_cast<void*>(p[5])),
                 ld[0], ld[1], ld[2]};
}

// One call's launches on `stream`, stopping at the first error (`err`);
// `launched` counts them.
struct Wide {
  Weights w;
  Dims d;
  int N, S;
  long R;
  const int* task;
  int ntask;
  Scratch sc;
  cudaStream_t stream;
  int err = 0, launched = 0;
  int tile;  // the product block's side (wide_tile)
  int Lp, Ap, Mp, kz, kl, km, npM, npL, npB, npH;

  Wide(const void* const* wptrs, const int* dims, int N_, int S_, const int* task_, int ntask_,
       const Scratch& sc_, cudaStream_t st)
      : d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]}, N(N_), S(S_),
        R(static_cast<long>(N_) * S_), task(task_), ntask(ntask_), sc(sc_), stream(st) {
    for (int i = 0; i < kNumOps; ++i) w.p[i] = wptrs[i];
    tile = wide_tile(d);
    Lp = up16(d.L);
    Ap = up16(d.A);
    Mp = up16(d.M);
    kz = (Lp + Ap) / 16;
    kl = Lp / 16;
    km = Mp / 16;
    npM = Mp / 16;
    npL = Lp / 16;
    npB = up16(d.B) / 16;
    npH = up16(2 * d.A) / 16;
  }

  void check_launch() {
    ++launched;
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) err = static_cast<int>(e);
  }

  // y <- x . W (+ bias): the matrix `op` of head `head` (Q: per env)
  void gemm(const uint16_t* x, long ldx, int kt, int op, int np, int ncols, const float* b,
            long bt, long bh, const int* head = nullptr, long hn = 0,
            const float* b1 = nullptr, int split = -1) {
    if (err) return;
    GemmArgs a{x, ldx, w.w(op), kt, np, static_cast<long>(kt) * np * 32, b, bt, bh, b1,
               split < 0 ? ncols : split, sc.y, sc.ldy, ncols, task, ntask, head, hn,
               d.NQ > 0 ? d.NQ : 1, S, 0};
    if (tile == 128) {
      launch_gemm<128>(a);
    } else {
      launch_gemm<64>(a);
    }
  }

  template <int T>
  void launch_gemm(GemmArgs a) {
    const cudaError_t e = opt_in_smem(gemm_kernel<T>, WTile<T>::smem);
    if (e != cudaSuccess) {
      err = static_cast<int>(e);
      return;
    }
    a.bpe = (S + T - 1) / T;
    const dim3 grid((a.np + WTile<T>::pairs - 1) / WTile<T>::pairs, N * a.bpe);
    gemm_kernel<T><<<grid, kWThreads, WTile<T>::smem, stream>>>(a);
    check_launch();
  }

  void rows(RowArgs a) {
    if (err) return;
    a.y = sc.y;
    a.ldy = sc.ldy;
    a.S = S;
    a.R = R;
    int tpr = 32;
    if (a.mode != kRowPi && a.mode != kRowTerm)
      while (tpr < kWRowThreads && a.ncols > tpr * kWVals) tpr *= 2;
    const long rpb = kWRowThreads / tpr;
    const unsigned blocks = static_cast<unsigned>((R + rpb - 1) / rpb);
    switch (tpr) {
      case 32: row_kernel<32><<<blocks, kWRowThreads, 0, stream>>>(a); break;
      case 64: row_kernel<64><<<blocks, kWRowThreads, 0, stream>>>(a); break;
      case 128: row_kernel<128><<<blocks, kWRowThreads, 0, stream>>>(a); break;
      default: row_kernel<256><<<blocks, kWRowThreads, 0, stream>>>(a); break;
    }
    check_launch();
  }

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
    a.R = R;
    const long total = R * (a.load_z ? Lp + Ap : Ap);
    const long blocks = (total + 255) / 256;
    stage_kernel<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(a);
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
    gemm(x, ldx, kt, op, npM, d.M, b, bt, bh, head, hn);
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
  // of a task table), op0 + 4 from h.
  void hidden2(int kt, int op0, const int* head = nullptr, long hn = 0) {
    const bool qh = op0 == qP0;
    const long bt = qh ? static_cast<long>(d.NQ) * d.M : d.M;
    const long bh = qh ? d.M : 0;
    hidden(sc.x, sc.ldx, kt, op0, w.f(op0 + 1), bt, bh, w.f(op0 + 2), w.f(op0 + 3), head, hn);
    hidden(sc.h, sc.ldh, km, op0 + 4, w.f(op0 + 5), 0, bh, w.f(op0 + 6), w.f(op0 + 7), head, hn);
  }

  // z_{t+1} = SimNorm(LN(dynamics)) into the latent columns of x; f32 into
  // zH (rows L apart) too when zH is not null.
  void dynamics(float* zH = nullptr) {
    hidden2(kz, dP0);
    gemm(sc.h, sc.ldh, km, dP2, npL, d.L, w.f(db2), 0, 0);
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
  void reward(const float* discs, long dn, int t) {
    hidden2(kz, rP0);
    gemm(sc.h, sc.ldh, km, rP2, npB, d.B, w.f(rb2), 0, 0);
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
    gemm(sc.h, sc.ldh, km, tP2, 1, 1, w.f(tb2), 0, 0);
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
    gemm(sc.h, sc.ldh, km, pP2, npH, 2 * d.A, w.f(pbm), 0, 0, nullptr, 0, w.f(pbl), d.A);
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
    gemm(sc.h, sc.ldh, km, qP2, npB, d.B, w.f(qb2), 0, d.B, hd, qn);
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

}  // namespace tdm

namespace tdm {
template <int T>
int wide_plan_report(int* out) {
  out[0] = WTile<T>::bm;
  out[1] = WTile<T>::bn;
  out[2] = kWKT * 16;
  out[3] = kWStages;
  out[4] = WTile<T>::smem;
  out[5] = 0;
  const cudaError_t err = opt_in_smem(gemm_kernel<T>, WTile<T>::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[5], gemm_kernel<T>, kWThreads, WTile<T>::smem));
}
}  // namespace tdm

// out = {rows and columns of a product block, its K depth a stage, stages,
// shared bytes, product blocks per SM} at these dims; returns an error code.
extern "C" int tdm_wide_plan(const int* dims, int* out) {
  using namespace tdm;
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  return wide_tile(d) == 128 ? wide_plan_report<128>(out) : wide_plan_report<64>(out);
}

// The engine the value and pi-rollout kernels take at these dims: 0 the
// row tiles (mlp_rows.cuh pick_plan), 1 the wide engine, kNoPlan neither.
extern "C" int tdm_engine(const int* dims) {
  using namespace tdm;
  const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6]};
  if (pick_plan(d).shape >= 0) return 0;
  return wide_fits(d) ? 1 : kNoPlan;
}
