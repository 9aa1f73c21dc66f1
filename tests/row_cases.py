"""The wide engine's row kernel on given operands: its cases, their
operands and the check against its plain version.

One copy shared by the card tests (tests/test_torch_cuda.py) and
chip_smoke.py's row phase, which loads this file by its path. Each case
is one launch of ops/wide.py `rows` (the library's `tdm_wide_rows`) held
against `rows_plain` on the same operands. It imports neither jax nor the
JAX package.
"""

ROW_CASES = (   # (label, mode, per-env heads)
    ('LayerNorm + Mish', 'hidden', False),
    ('LayerNorm + Mish, per-env heads', 'hidden', True),
    ('LayerNorm + SimNorm', 'latent', False),
    ('two-hot: reward', 'reward', False), ('two-hot: Q0', 'q0', False),
    ('two-hot: Q1', 'q1', False), ('pi head', 'pi', False), ('termination gate', 'term', False))
# The narrow outputs' rows are 8 partial rows of a split product (their
# products' K split, gemm_splits), as the value step gives them.
ROW_SPLITS = 8
# bf16 outputs: at most one bf16 step from the plain version's (the f32
# order of the statistics ahead of the rounding); f32 outputs 1e-4.
ROW_BF16_REL, ROW_BF16_ABS = 2.0 ** -7, 1e-6
ROW_F32_TOL = dict(rtol=1e-4, atol=1e-4)


def row_operands(mode, R, S, g, dims, heads=False, fdst=False):
    """The operands of one row-kernel launch at `dims` (L, M, A, B, NQ, G,
    H) on R rows (N = R / S envs): y [R, y_width] (the product's rows; 8
    partial rows of up16 columns for the narrow outputs), NaN wherever the
    kernel must not read; the mode's weights, per-env inputs and outputs
    (dst and fdst NaN where it must not write), drawn on the card from the
    generator g. Returns (the rows / rows_plain keywords, their names per
    row, per env)."""
    import torch
    from tdmpc2_tpu_torch.ops import wide
    dev = torch.device('cuda')
    L, M, A, B, NQ, G_, H = dims
    N, ncols = R // S, wide.row_width(mode, dims)
    narrow = mode not in ('hidden', 'latent')
    nsplit, pstride = (ROW_SPLITS, -(-ncols // 16) * 16) if narrow else (1, 0)
    y = torch.full((R, wide.y_width(dims)), float('nan'), device=dev)
    for p_ in range(nsplit):
        y[:, p_ * pstride:p_ * pstride + ncols] = torch.randn(
            R, ncols, device=dev, generator=g) * (0.7 if narrow else 1.5)
    kw = dict(y=y, nsplit=nsplit, pstride=pstride)
    if not narrow:
        shape = (NQ, ncols) if heads else (ncols,)
        kw['gain'] = 1 + 0.2 * torch.randn(shape, device=dev, generator=g)
        kw['beta'] = 0.2 * torch.randn(shape, device=dev, generator=g)
        if heads:
            kw['head'] = torch.randint(0, NQ, (N,), device=dev, generator=g,
                                       dtype=torch.int32)
        dpad = -(-ncols // 16) * 16
        ldd = dpad + (16 if mode == 'latent' else 0)    # the latent's rows carry the actions
        kw.update(dst=torch.full((R, ldd), float('nan'), device=dev, dtype=torch.bfloat16),
                  dpad=dpad)
        if fdst:
            kw['fdst'] = torch.full((R, ncols), float('nan'), device=dev)
    elif mode == 'pi':
        Lp = -(-L // 16) * 16
        x = torch.full((R, Lp + 16), float('nan'), device=dev, dtype=torch.bfloat16)
        amask = (torch.rand(N, A, device=dev, generator=g) < 0.8).float()
        kw.update(dst=x[:, Lp:], dpad=16, fdst=torch.full((R, A), float('nan'), device=dev),
                  eps=torch.randn(N, S, A, device=dev, generator=g), amask=amask,
                  log_std_min=-10.0, log_std_dif=12.0)
    elif mode == 'term':
        term = (torch.rand(R, device=dev, generator=g) < 0.3).float()
        kw.update(term=term, term_at=(term * 1).to(torch.int32), t=1)
    else:
        kw.update(bins=torch.linspace(-10, 10, B, device=dev),
                  G=torch.randn(R, device=dev, generator=g),
                  q=torch.randn(R, device=dev, generator=g),
                  term=(torch.rand(R, device=dev, generator=g) < 0.3).float(),
                  discs=torch.rand(N, H + 1, device=dev, generator=g),
                  out=torch.full((R,), float('nan'), device=dev),
                  t=1 if mode == 'reward' else H)
    per_row = [k for k in ('y', 'dst', 'fdst', 'G', 'q', 'term', 'term_at', 'out') if k in kw]
    per_env = [k for k in ('head', 'discs', 'eps', 'amask') if k in kw]
    return kw, per_row, per_env


def row_clone(kw, per_row, per_env, e=None, S=None):
    """A copy of the operands whose outputs can be written (the rows of
    env e alone, when given)."""
    out = dict(kw)
    for k in per_row:
        if kw[k] is not None:
            out[k] = (kw[k] if e is None else kw[k][e * S:(e + 1) * S]).clone()
    if e is not None:
        for k in per_env:
            out[k] = kw[k][e:e + 1]
    return out


def row_outputs(mode, kw):
    """{name: tensor} of what a launch of `mode` writes."""
    names = {'hidden': ('dst', 'fdst'), 'latent': ('dst', 'fdst'), 'pi': ('dst', 'fdst'),
             'reward': ('G',), 'q0': ('q',), 'q1': ('out',), 'term': ('term', 'term_at')}
    return {k: kw[k] for k in names[mode] if kw.get(k) is not None}


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def hold_rows(tag, got, want, dpad):
    """The kernel's outputs against rows_plain's: bf16 within one step
    (ROW_BF16_REL of |plain| + ROW_BF16_ABS), f32 within ROW_F32_TOL, the
    gate's flags exactly, dst untouched past dpad. Returns (the largest share
    of its tolerance any value used, the largest |err|)."""
    import torch
    worst = (0.0, 0.0)
    for k, x in got.items():
        w = want[k]
        if k == 'dst':
            if not bool(torch.isnan(x[:, dpad:].float()).all()):
                raise AssertionError(f'row kernel {tag}: dst written past dpad {dpad}')
            x, w = x[:, :dpad].float(), w[:, :dpad].float()
            room = ROW_BF16_REL * w.abs() + ROW_BF16_ABS
        elif k in ('term', 'term_at'):
            if not torch.equal(x, w):
                raise AssertionError(f'row kernel {tag}: {k} differs from the plain version')
            continue
        else:
            room = ROW_F32_TOL['atol'] + ROW_F32_TOL['rtol'] * w.abs()
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f'row kernel {tag}: non-finite {k}')
        use = float(((x - w).abs() / room).max())
        if use > 1:
            raise AssertionError(f'row kernel {tag}: {k} max |err| '
                                 f'{_max_err(x, w):.3g}, {use:.3f} of its tolerance')
        worst = (max(worst[0], use), max(worst[1], _max_err(x, w)))
    return worst
