"""The packed weight layout of the tensor-core kernels (CPU).

`prepare_value_params` adds, for bf16 weights, a packed copy of every
matrix (`ops.value.pack_matrix`): zero-padded to multiples of 16 and laid
out in the order the kernels load their mma B fragments
(csrc/mlp_rows.cuh). These tests read the packed copies back through the
kernels' index map, written here from the kernel's side (lane 4g + q of
k-tile kt and column pair p holds, at position 4t + 2r + h, the element
W[16kt + 8r + 2q + h, 16p + 8t + g]):

- every packed matrix of a bf16 prep unpacks to its [in, out] blocks bit
  for bit, with zeros in the padding, at the widths of model_size 1, 5, 19
  and 48 (B = 101, A = 2, the stacked Q heads and the episodic head);
- a product accumulated k-tile by k-tile through the packed fragments, as
  the kernels multiply, equals x @ W in f32 exactly (integer-valued data,
  so every sum is exact), on the z||a K axis with its padded blocks, on
  the padded bins, and on the narrow pi and termination heads.

And the build's reports that `chip_smoke.py` prints beside the plans: the
registers and spills parsed from `nvcc -Xptxas -v`, and the error that a
width no row tile fits raises.
"""

import types

import numpy as np
import pytest
import torch

from tdmpc2_tpu_torch.config import MODEL_SIZE
from tdmpc2_tpu_torch.models import layers
from tdmpc2_tpu_torch.ops import _build
from tdmpc2_tpu_torch.ops import value as tv
from torch_threads import one_torch_thread  # noqa: F401


def _up16(n):
    return -(-n // 16) * 16


def _positions(n_elems, Np):
    """(k, n) of each element of one packed [Kp, Np] matrix, by the
    kernels' index map."""
    pos = np.arange(n_elems)
    i, lane = pos % 8, (pos // 8) % 32
    pair, kt = (pos // 256) % (Np // 16), pos // (256 * (Np // 16))
    g, q = lane // 4, lane % 4
    t, r, h = i // 4, (i // 2) % 2, i % 2
    return 16 * kt + 8 * r + 2 * q + h, 16 * pair + 8 * t + g


def _bits(x):
    return x.contiguous().view(torch.int16).numpy()


def kernel_read(packed, Kp, Np):
    """The [Kp, Np] matrix (int16 bits) that the kernels read from one
    packed matrix; each position must be written exactly once."""
    k, n = _positions(packed.numel(), Np)
    W = np.zeros((Kp, Np), np.int16)
    seen = np.zeros((Kp, Np), np.int32)
    W[k, n] = _bits(packed)
    np.add.at(seen, (k, n), 1)
    assert packed.numel() == Kp * Np and (seen == 1).all()
    return W


def _padded(blocks, along_n=False):
    """The kernels' view of the [in, out] blocks: K blocks each padded to
    16 rows (or N blocks side by side), N padded to 16, as int16 bits."""
    mats = [_bits(b) for b in blocks]
    if along_n:
        mats = [np.concatenate(mats, axis=1)]
    rows = [np.pad(m, ((0, _up16(m.shape[0]) - m.shape[0]), (0, 0))) for m in mats]
    W = np.concatenate(rows, axis=0)
    return np.pad(W, ((0, 0), (0, _up16(W.shape[1]) - W.shape[1])))


def _params(size, A=2, B=101):
    dims = MODEL_SIZE[size]
    L, M, nq = dims['latent_dim'], dims['mlp_dim'], dims.get('num_q', 5)
    g = torch.Generator().manual_seed(size)
    mlp = lambda i, o, **kw: layers.mlp_init(g, i, [M, M], o, **kw)  # noqa: E731
    params = {'dynamics': mlp(L + A, L, final_normed=True), 'reward': mlp(L + A, B),
              'pi': mlp(L, 2 * A), 'termination': mlp(L, 1),
              'Qs': layers.ensemble_init(nq, lambda: mlp(L + A, B))}
    cfg = types.SimpleNamespace(latent_dim=L, action_dim=A, vmin=-10.0, vmax=10.0,
                                episodic=True)
    return params, cfg


@pytest.mark.parametrize('size', [1, 5, 19, 48])
def test_packed_matrices_unpack_bit_for_bit(size):
    params, cfg = _params(size)
    prep = tv.prepare_value_params(params, cfg, torch.bfloat16)
    assert set(tv.PACKED) <= set(prep)
    for key, parts in tv.PACKED.items():
        packed, blocks = prep[key], [prep[p] for p in parts]
        along_n = key == 'pP2'
        if key[0] == 'q':     # stacked heads: one packed matrix per head
            want = [_padded([b[h] for b in blocks]) for h in range(packed.shape[0])]
            got = [kernel_read(packed[h], *w.shape) for h, w in enumerate(want)]
        else:
            want = [_padded(blocks, along_n)]
            got = [kernel_read(packed, *want[0].shape)]
        assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=key)


def _product(packed, X, Kp, Np):
    """X [R, Kp] times the packed matrix, accumulated k-tile by k-tile in
    f32 from the B fragments (the kernels' order of k-tiles)."""
    k, n = _positions(packed.numel(), Np)
    vals = packed.float().numpy()
    per_tile = 256 * (Np // 16)
    C = np.zeros((X.shape[0], Np), np.float32)
    for kt in range(Kp // 16):
        s = slice(kt * per_tile, (kt + 1) * per_tile)
        contrib = np.zeros_like(C)
        np.add.at(contrib.T, n[s], (X[:, k[s]] * vals[s]).T)
        C += contrib
    return C


@pytest.mark.parametrize('case', ['z||a', 'bins', 'pi head', 'termination'])
def test_product_through_packed_layout(case):
    """Integer-valued weights and inputs: every product and sum is exact in
    f32, so the packed product must equal x @ W with no tolerance."""
    rng = np.random.default_rng(0)
    R, L, A, M, B = 24, 40, 3, 48, 101

    def ints(*shape):
        return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    if case == 'z||a':
        blocks, x_parts = [ints(L, M), ints(A, M)], [ints(R, L), ints(R, A)]
    elif case == 'bins':
        blocks, x_parts = [ints(M, B)], [ints(R, M)]
    elif case == 'pi head':
        blocks, x_parts = [ints(M, A), ints(M, A)], [ints(R, M)]
    else:
        blocks, x_parts = [ints(M, 1)], [ints(R, M)]
    along_n = case == 'pi head'
    bf = [b.to(torch.bfloat16) for b in blocks]
    packed = tv.pack_matrix(*bf, cat_dim=-1 if along_n else -2)
    W = torch.cat(blocks, dim=-1 if along_n else 0)
    N = W.shape[1]
    # the kernels' activation row: each K block padded to 16 with zeros
    X = torch.cat([torch.nn.functional.pad(x, (0, _up16(x.shape[1]) - x.shape[1]))
                   for x in x_parts], dim=1).numpy()
    Kp, Np = X.shape[1], _up16(N)
    C = _product(packed, X, Kp, Np)
    want = (torch.cat(x_parts, dim=1) @ W).numpy()
    np.testing.assert_array_equal(C[:, :N], want)
    np.testing.assert_array_equal(C[:, N:], 0)     # padded columns: zero weights


def test_f32_prep_has_no_packed_copies_and_is_refused_by_the_kernels():
    params, cfg = _params(1)
    prep32 = tv.prepare_value_params(params, cfg, torch.float32)
    assert not set(tv.PACKED) & set(prep32)
    with pytest.raises(ValueError, match='prepared weight dP0: missing'):
        tv.check_prep(prep32, torch.device('cpu'), 8)
    tv.check_prep(tv.prepare_value_params(params, cfg, torch.bfloat16),
                  torch.device('cpu'), 8)


def test_ptxas_report_names_kernels_with_their_row_tiles():
    report = """\
ptxas info    : Function properties for _ZN3tdm10wide_layerILi32ELi4EEENS_6StreamES1_
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Compiling entry function '_ZN3tdm12value_kernelILi32ELi4EEEvNS_7WeightsE' for 'sm_90a'
ptxas info    : Function properties for _ZN3tdm12value_kernelILi32ELi4EEEvNS_7WeightsE
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 152 registers, used 2 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3tdm12value_kernelILi32ELi4ELb1EEEvNS_7WeightsE' for 'sm_90a'
ptxas info    : Used 160 registers, used 2 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3tdm12elite_kernelEPKfS1_' for 'sm_90a'
ptxas info    : Used 40 registers, used 1 barriers
"""
    assert _build.ptxas_usage(report) == {
        'wide_layer<32,4>': (None, 8, 12), 'value_kernel<32,4>': (152, 0, 0),
        'value_kernel<32,4,1>': (160, 0, 0), 'elite_kernel': (40, 0, 0)}


def test_ptxas_report_names_the_wide_products_by_tile():
    """The wide engine's product kernels, templated on a tile type
    (csrc/mlp_wide.cuh gemm_kernel<WTile<WGS, BN>>), are named by the
    integers nested in it: consumer warpgroups and columns."""
    report = """\
ptxas info    : Compiling entry function '_ZN3tdm11gemm_kernelINS_5WTileILi2ELi256EEEEEvNS_8GemmArgsE14CUtensorMap_stS4_' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3tdm11gemm_kernelINS_5WTileILi1ELi128EEEEEvNS_8GemmArgsE14CUtensorMap_stS4_' for 'sm_90a'
ptxas info    : Used 128 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3tdm10row_kernelILi256EEEvNS_7RowArgsE' for 'sm_90a'
ptxas info    : Used 80 registers, used 1 barriers
"""
    assert _build.ptxas_usage(report) == {
        'gemm_kernel<2,256>': (168, 0, 0), 'gemm_kernel<1,128>': (128, 0, 0),
        'row_kernel<256>': (80, 0, 0)}


def test_no_row_tile_raises_value_error_naming_the_widths():
    dims = (1376, 4096, 2, 101, 8, 8, 3)
    with pytest.raises(ValueError, match='L=1376, M=4096, A=2, B=101, num_q=8'):
        _build.check(None, _build.NO_PLAN, 'value kernel', dims)
