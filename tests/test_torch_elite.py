"""The elite kernel's algorithm (csrc/cem.cu `elite_kernel`), mirrored in
numpy f32, against the TPU kernel's counting bisection.

The TPU kernel (tdmpc2_tpu/ops/pallas_cem.py:198-210) and its plain
version (`ops.cem.elite_moments_plain`) find the elite threshold by 32
bisection steps, each counting the values at or above the midpoint. The
card's kernel counts in one warp until at most 32 values are left in
[lo, hi), then takes t, the E-th largest value counted with multiplicity,
among them and runs the remaining steps on scalars (mid <= t stands for
count(v >= mid) >= E). Both must give the same lo and hi bit for bit, for
distinct, tied, guarded (NaN, inf, +-3e38) values and any E in 1..S. Its
moment pass reads only the rows at or above lo (the others weigh exactly
0) and adds per-slot partial sums in a tree; that order is held against
the plain version at 1e-5. The kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tdmpc2_tpu_torch.ops import cem
from torch_threads import one_torch_thread  # noqa: F401

F = np.float32
HUGE = F(3.0e38)
CAND = 32      # csrc/cem.cu kEliteCand


def guard(v):
    v = np.asarray(v, F)
    with np.errstate(invalid='ignore'):
        ok = (v == v) & (np.abs(v) <= HUGE)
    return np.where(ok, v, F(0))


def start(v):
    vmax = v.max()
    hi = F(F(vmax + F(F(0.001) * np.abs(vmax))) + F(1))
    return vmax, v.min(), hi


def mid_of(lo, hi):
    with np.errstate(over='ignore', invalid='ignore'):
        return F(lo + F(F(0.5) * F(hi - lo)))


def count_bisect(v, E):
    """pallas_cem.py:198-210 and elite_moments_plain: 32 counting steps."""
    _, lo, hi = start(v)
    for _ in range(32):
        mid = mid_of(lo, hi)
        if np.count_nonzero(v >= mid) >= E:
            lo = mid
        else:
            hi = mid
    return lo, hi


def select_bisect(v, E):
    """The premise alone: t selected first, then 32 steps on scalars."""
    t = np.sort(v)[::-1][E - 1]
    _, lo, hi = start(v)
    for _ in range(32):
        mid = mid_of(lo, hi)
        if mid <= t:
            lo = mid
        else:
            hi = mid
    return lo, hi


def kernel_bisect(v, E):
    """elite_kernel's order: count while more than CAND values are in
    [lo, hi), then rank those (select_in) and finish on scalars."""
    _, lo, hi = start(v)
    c_lo, c_hi, it = v.size, 0, 0
    while it < 32 and c_lo - c_hi > CAND:
        mid = mid_of(lo, hi)
        c = np.count_nonzero(v >= mid)
        if c >= E:
            lo, c_lo = mid, c
        else:
            hi, c_hi = mid, c
        it += 1
    if it < 32:
        inside = v[(v >= lo) & (v < hi)]
        assert inside.size == c_lo - c_hi and 1 <= E - c_hi <= inside.size <= CAND
        need = E - c_hi
        gt = (inside[None, :] > inside[:, None]).sum(1)
        ge = (inside[None, :] >= inside[:, None]).sum(1)
        t = inside[np.flatnonzero((gt < need) & (need <= ge))[0]]
        for _ in range(it, 32):
            mid = mid_of(lo, hi)
            if mid <= t:
                lo = mid
            else:
                hi = mid
    return lo, hi


def bits(x):
    return int(np.asarray(x, F).view(np.uint32))


def assert_same_threshold(v, E):
    v = guard(v)
    ref = count_bisect(v, E)
    for got in (kernel_bisect(v, E), select_bisect(v, E)):
        assert (bits(got[0]), bits(got[1])) == (bits(ref[0]), bits(ref[1])), (
            got, ref, E, v.size)


def make_values(kind, S, rng):
    if kind == 'distinct':
        return rng.normal(size=S).astype(F)
    if kind == 'integer-tied':
        return rng.integers(-3, 4, size=S).astype(F)
    if kind == 'all-tied':
        return np.full(S, 0.25, F)
    v = rng.normal(size=S).astype(F)
    if kind == 'huge':
        v[::5] = F(3.0e38)
        v[1::7] = F(-3.0e38)
        v[2::11] = np.inf
        v[3::13] = F(3.3e38)        # beyond the guard: 0
        return v
    v[::7] = np.nan                 # 'nan'
    v[1::9] = -np.inf
    return v


KINDS = ('distinct', 'integer-tied', 'all-tied', 'huge', 'nan')


@pytest.mark.parametrize('S', [77, 600])
@pytest.mark.parametrize('E', ['1', 'S'])
@pytest.mark.parametrize('kind', KINDS)
def test_selection_premise_gives_the_counting_bisection(kind, E, S):
    v = make_values(kind, S, np.random.default_rng(S))
    assert_same_threshold(v, 1 if E == '1' else S)


def test_selection_premise_at_every_elite_count():
    rng = np.random.default_rng(7)
    for kind in KINDS:
        v = make_values(kind, 130, rng)
        for E in range(1, 131):
            assert_same_threshold(v, E)


_values = st.one_of(
    st.floats(width=32),                                   # NaN, inf, huge too
    st.floats(-4.0, 4.0, width=32),
    st.integers(-3, 3).map(float),                          # ties
    st.sampled_from([3.0e38, -3.0e38, 3.3e38, -np.inf, np.nan]))


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(_values, min_size=1, max_size=160), st.data())
def test_selection_premise_property(values, data):
    E = data.draw(st.integers(1, len(values)))
    assert_same_threshold(np.array(values, F), E)


def test_counting_bisection_mirrors_the_jax_kernel_lines():
    """The numpy mirror is the TPU kernel's loop: the same lines in jnp on
    the CPU give the same lo and hi bit for bit."""
    def bisect(v, E):
        vmax = jnp.max(v)
        lo0, hi0 = jnp.min(v), vmax + 0.001 * jnp.abs(vmax) + 1.0

        def step(_, lh):
            lo, hi = lh
            mid = lo + 0.5 * (hi - lo)
            cnt = jnp.sum((v >= mid).astype(jnp.float32))
            return jnp.where(cnt >= E, mid, lo), jnp.where(cnt >= E, hi, mid)
        return jax.lax.fori_loop(0, 32, step, (lo0, hi0))
    run = jax.jit(bisect)
    rng = np.random.default_rng(3)
    for kind in KINDS:
        v = guard(make_values(kind, 200, rng))
        for E in (1, 17, 64, 200):
            lo, hi = run(jnp.asarray(v), jnp.float32(E))
            ref = count_bisect(v, E)
            assert (bits(lo), bits(hi)) == (bits(ref[0]), bits(ref[1])), (kind, E)


def kernel_moments(v, acts, amask, E, T, min_std, max_std):
    """elite_kernel's moments: the weighted rows only (v >= lo), listed lane
    by lane (value i is lane i % 32's), list entry k summed in slot
    k % slots (32 // HA slots of a column below HA = 32, else one), slots
    added in a tree; scores normalised by the sum's reciprocal, denom as
    total / total + 1e-9, divisions by denom as products with 1 / denom."""
    v = guard(v)
    vmax = v.max()
    lo, hi = kernel_bisect(v, E)
    n1, nlo = np.count_nonzero(v >= hi), np.count_nonzero(v >= lo)
    wb = F(F(E - n1) / F(max(nlo - n1, 1)))
    rows = np.flatnonzero(v >= lo)
    rows = rows[np.lexsort((rows // 32, rows % 32))]
    s = (np.exp(F(T) * (v[rows] - vmax)) * np.where(v[rows] >= hi, F(1), wb)).astype(F)
    total = s.sum(dtype=F)
    inv = F(F(1) / total)
    sn = (s * inv).astype(F)
    inv_d = F(F(1) / F(F(total * inv) + F(1e-9)))
    a = acts[rows]
    slots = 32 // a.shape[1] if a.shape[1] < 32 else 1

    def slot_sums(x):        # [nw, HA] -> [HA]: per slot, then the tree
        parts = [x[j::slots].sum(0, dtype=F) for j in range(slots)]
        o = 1
        while o < slots:
            for j in range(0, slots - o, 2 * o):
                parts[j] = parts[j] + parts[j + o]
            o *= 2
        return parts[0]
    m = slot_sums(sn[:, None] * a) * inv_d
    q = slot_sums(sn[:, None] * (a - m) ** 2) * inv_d
    std = np.clip(np.sqrt(q), min_std, max_std)
    mask = np.tile(amask, acts.shape[1] // amask.size)
    return (m * mask).astype(F), (std * mask).astype(F), v


@pytest.mark.parametrize('HA,A', [(6, 2), (114, 38)])
@pytest.mark.parametrize('kind', KINDS)
def test_weighted_rows_moments_match_plain(kind, HA, A):
    S, E = 300, 17
    rng = np.random.default_rng(HA)
    v = make_values(kind, S, rng)
    if kind == 'huge':      # T (v - vmax) stays finite: the plain score has no 0 * inf
        v = np.where(np.abs(v) > 1e30, F(1e30), v).astype(F)
    acts = rng.uniform(-1, 1, (S, HA)).astype(F)
    amask = np.ones(A, F)
    amask[-1] = 0
    kw = dict(num_elites=E, temperature=0.5, min_std=0.05, max_std=2.0)
    got = kernel_moments(v, acts, amask, E, 0.5, 0.05, 2.0)
    ref = cem.elite_moments_plain(torch.from_numpy(v)[None], torch.from_numpy(acts)[None],
                                  torch.from_numpy(amask), **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r[0].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('kind', ('distinct', 'integer-tied', 'all-tied', 'nan'))
def test_plain_weights_are_the_thresholds(kind):
    """elite_moments_plain's weights, read through identity actions at
    temperature 0 (score = weight), are those of kernel_bisect's lo, hi."""
    S, E = 96, 13
    v = guard(make_values(kind, S, np.random.default_rng(11)))
    lo, hi = kernel_bisect(v, E)
    n1, nlo = np.count_nonzero(v >= hi), np.count_nonzero(v >= lo)
    w = np.where(v >= hi, F(1), np.where(v >= lo, F(F(E - n1) / F(max(nlo - n1, 1))), F(0)))
    mean, _, _ = cem.elite_moments_plain(
        torch.from_numpy(v)[None], torch.eye(S)[None], torch.ones(1), num_elites=E,
        temperature=0.0, min_std=0.0, max_std=1.0)
    np.testing.assert_allclose(mean[0].numpy(), w / w.sum(), rtol=1e-6, atol=1e-7)
    assert np.array_equal(mean[0].numpy() > 0, w > 0)
