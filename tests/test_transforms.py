"""Transform oracle tests: every (BC pair, staggering) transform must exactly
diagonalize the 1D second-difference operator assembled from the reference's
ghost/boundary-row semantics (set_bc bound.f90:202-399, tridmatrix
initsolver.f90:127-169), and each (fwd, bwd) pair must be an exact inverse."""
import numpy as np
import pytest
import jax.numpy as jnp

from cales_tpu.ops import transforms as tr
from cales_tpu.poisson import tridmatrix


def dense_lap_1d(bc: str, c_or_f: str, n: int) -> np.ndarray:
    """Dense uniform-spacing 1D operator (solved sub-block only)."""
    ones = np.ones(n + 2)
    a, b, c = tridmatrix(bc, n, ones, ones, c_or_f)
    m = n
    if c_or_f == 'f' and bc in ('DD', 'ND'):
        m = n - 1
    L = np.zeros((m, m))
    for k in range(m):
        L[k, k] = b[k]
        if k > 0:
            L[k, k - 1] = a[k]
        if k < m - 1:
            L[k, k + 1] = c[k]
    if bc == 'PP':
        L[0, m - 1] = a[0]
        L[m - 1, 0] = c[m - 1]
    return L


CASES = [(bc, cf) for bc in ('PP', 'NN', 'DD', 'ND', 'DN') for cf in ('c', 'f')]


@pytest.mark.parametrize("bc,cf", CASES)
@pytest.mark.parametrize("n", [8, 13, 16])
def test_diagonalization(bc, cf, n):
    t = tr.make_transform(bc, cf, n)
    L = dense_lap_1d(bc, cf, n)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(L.shape[0])
    if t.kind == 'fft':
        lhs = np.fft.fft(L @ x)
        rhs = t.lam * np.fft.fft(x)
    else:
        lhs = t.fwd_mat @ (L @ x)
        rhs = t.lam * (t.fwd_mat @ x)
    np.testing.assert_allclose(lhs, rhs, atol=1e-10)


@pytest.mark.parametrize("bc,cf", CASES)
@pytest.mark.parametrize("n", [8, 13])
def test_roundtrip(bc, cf, n):
    t = tr.make_transform(bc, cf, n)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 4, t.nsolve))
    xj = jnp.asarray(x)
    if t.kind == 'fft':
        back = np.asarray(jnp.fft.irfft(jnp.fft.rfft(xj, axis=-1), n=n, axis=-1))
    else:
        back = np.asarray(tr.bwd(t, tr.fwd(t, xj, axis=-1), axis=-1, n=n,
                                 real_out=True))
    np.testing.assert_allclose(back, x, atol=1e-10)


def test_axis_application():
    """matmul transform along axis -2 must equal explicit per-column apply."""
    t = tr.make_transform('NN', 'c', 12)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 12, 7))
    out = np.asarray(tr.fwd(t, jnp.asarray(x), axis=-2))
    ref = np.einsum('kj,zjx->zkx', t.fwd_mat, x)
    np.testing.assert_allclose(out, ref, atol=1e-10)


def test_fft_complex_path():
    """PP on complex input must use the full FFT with full-length eigenvalues."""
    t = tr.make_transform('PP', 'c', 16)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16)) + 1j * rng.standard_normal((4, 16))
    L = dense_lap_1d('PP', 'c', 16)
    lhs = np.asarray(tr.fwd(t, jnp.asarray(x @ L.T), axis=-1))
    rhs = t.lam * np.asarray(tr.fwd(t, jnp.asarray(x), axis=-1))
    np.testing.assert_allclose(lhs, rhs, atol=1e-10)


@pytest.mark.parametrize("n", [8, 13, 16])
def test_pp_mat_diagonalization_and_roundtrip(n):
    """The real half-complex DFT operator matrix (PP as a dense matmul) must
    diagonalize the circulant second-difference operator and invert exactly."""
    t = tr.make_transform('PP', 'c', n, pp_mat=True)
    assert t.kind == 'mat' and t.nsolve == n
    L = dense_lap_1d('PP', 'c', n)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(t.fwd_mat @ (L @ x), t.lam * (t.fwd_mat @ x),
                               atol=1e-10)
    np.testing.assert_allclose(t.bwd_mat @ (t.fwd_mat @ x), x, atol=1e-12)


def test_pp_mat_solver_matches_fft():
    """Full Poisson solve: matmul periodic transforms == rfft transforms."""
    from cales_tpu.config import Config
    from cales_tpu.grid import make_grid_from_config
    from cales_tpu import poisson

    cfg = Config(ng=(16, 12, 10), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.3,
                 visci=100.0, dtype='float64')
    grid = make_grid_from_config(cfg)
    cbc = ('PP', 'PP', 'NN')
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal((10, 12, 16))
    # remove the singular-mode component (dzf-weighted mean)
    wz = grid.dzf[1:11][:, None, None]
    rhs -= (rhs * wz).sum() / (wz.sum() * 12 * 16)
    out = {}
    for mode in ('fft', 'mat'):
        sv = poisson.make_solver(cfg.replace(ptransform=mode), grid, 
                                 (cbc[0], cbc[1], cbc[2]), ('c', 'c', 'c'))
        assert sv.trx.kind == ('fft' if mode == 'fft' else 'mat')
        out[mode] = np.asarray(poisson.solve(sv, jnp.asarray(rhs)))
    a, b = out['fft'], out['mat']
    a, b = a - a.mean(), b - b.mean()
    np.testing.assert_allclose(a, b, atol=1e-10)
