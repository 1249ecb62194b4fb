"""The batched z-sweep kernel (ops/zsweep.py) in Pallas interpret mode
against the lax.scan Thomas solvers (ops/tridiag.py), and the z-solver
dispatch of the Poisson solve.  The kernel's compiled form runs on the GPU
only; chip_smoke.py checks it there against the same references."""
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cales_tpu import poisson
from cales_tpu.config import Config
from cales_tpu.grid import make_grid
from cales_tpu.ops.tridiag import thomas, thomas_periodic
from cales_tpu.ops.zsweep import thomas_z


def _system(bcz, c_or_f, n, alpha, rng):
    """Rows (a, b, c) of the z operator of a stretched channel grid, as the
    Poisson (alpha None) or Helmholtz (I + alpha*L) solve assembles them;
    and the number of solved rows (the face-staggered Dirichlet tail row
    passes through)."""
    grid = make_grid(1 if bcz != 'PP' else 0, n, 0.9 if bcz != 'PP' else 0.0,
                     2.0)
    a, b, c = poisson.tridmatrix(bcz, n, grid.dzci, grid.dzfi, c_or_f)
    if alpha is not None:
        a, b, c = a * alpha, b * alpha + 1.0, c * alpha
    qz = 1 if (c_or_f == 'f' and bcz[1] == 'D') else 0
    return a, b, c, n - qz


CASES = {
    # name: (bcz, c_or_f, alpha, complex, dtype, (ny, nx), with_lam)
    'poisson_NN_complex_f64': ('NN', 'c', None, True, np.float64, (4, 9), True),
    'poisson_DD_real_f64': ('DD', 'c', None, False, np.float64, (3, 16), True),
    'poisson_ND_complex_f32': ('ND', 'c', None, True, np.float32, (4, 9), True),
    'poisson_PP_complex_f64': ('PP', 'c', None, True, np.float64, (4, 9), True),
    'helmholtz_DD_f64': ('DD', 'c', -0.03, False, np.float64, (4, 16), True),
    'helmholtz_DD_qz_tail_f64': ('DD', 'f', -0.03, True, np.float64, (4, 9),
                                 True),
    'helmholtz_PP_f64': ('PP', 'c', -0.03, False, np.float64, (2, 16), True),
    'z_only_impdiff_1d_f64': ('DD', 'c', -0.05, False, np.float64, (5, 12),
                              False),
    'z_only_impdiff_1d_qz_f32': ('DD', 'f', -0.05, False, np.float32, (5, 12),
                                 False),
    'ragged_x_width_f64': ('NN', 'c', None, False, np.float64, (3, 67), True),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_sweep_kernel_matches_thomas(case):
    bcz, cf, alpha, cplx, dtype, (ny, nx), with_lam = CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    n = 12
    a, b, c, nzs = _system(bcz, cf, n, alpha, rng)
    shape = (nzs, ny, nx)
    r = rng.standard_normal(shape)
    if cplx:
        r = r + 1j * rng.standard_normal(shape)
    lam = None
    if with_lam:
        # strictly negative modified wavenumbers: no singular column here
        lam = -rng.uniform(0.5, 40.0, (ny, nx))
        if alpha is not None:
            lam = lam * alpha
    cdt = (np.complex64 if dtype == np.float32 else np.complex128)
    r = r.astype(cdt if cplx else dtype)
    periodic = bcz == 'PP'
    with jax.enable_x64(dtype == np.float64):
        rj = jnp.asarray(r)
        lamj = None if lam is None else jnp.asarray(lam, dtype)
        got = thomas_z(rj, a[:nzs], b[:nzs], c[:nzs], lamj,
                       periodic=periodic, interpret=True, block=16)
        ref_fn = thomas_periodic if periodic else thomas
        ref = ref_fn(a[:nzs], b[:nzs], c[:nzs], rj, lam=lamj,
                     regularize=False)
        got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == shape and got.dtype == r.dtype
    tol = 2e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize('bcz', ['NN', 'PP'])
def test_sweep_kernel_pins_singular_mode(bcz):
    """A pure-Neumann or periodic z system at lam = 0 is singular: the
    kernel pins x[0] = 0 (NN) or x[n-1] = 0 (PP) on that column, which
    differs from the eps-regularized scan only by a constant along z; the
    other columns match exactly."""
    rng = np.random.default_rng(5)
    n, ny, nx = 10, 2, 8
    a, b, c, _ = _system(bcz, 'c', n, None, rng)
    grid = make_grid(1 if bcz == 'NN' else 0, n, 0.9 if bcz == 'NN' else 0.0,
                     2.0)
    lam = -rng.uniform(1.0, 5.0, (ny, nx))
    lam[0, 0] = 0.0
    r = rng.standard_normal((n, ny, nx))
    # compatible RHS on the singular column: zero dzf-weighted sum
    w = grid.dzf[1:n + 1]
    r[:, 0, 0] -= (r[:, 0, 0] * w).sum() / w.sum()
    got = np.asarray(thomas_z(jnp.asarray(r), a, b, c, jnp.asarray(lam),
                              pin_tol=1e-9, periodic=bcz == 'PP',
                              interpret=True, block=16))
    col = got[:, 0, 0]
    assert abs(col[0 if bcz == 'NN' else -1]) < 1e-12
    # the pinned column solves the operator up to the gauge
    L = np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    if bcz == 'PP':
        L[0, -1], L[-1, 0] = a[0], c[-1]
    np.testing.assert_allclose(L @ col, r[:, 0, 0], atol=1e-9)
    ref_fn = thomas_periodic if bcz == 'PP' else thomas
    ref = np.asarray(ref_fn(a, b, c, jnp.asarray(r), lam=jnp.asarray(lam),
                            regularize=False))
    mask = np.ones((ny, nx), bool)
    mask[0, 0] = False
    np.testing.assert_allclose(got[:, mask], ref[:, mask], atol=1e-12)


def test_thomas_dispatch_by_platform():
    """zsolver='thomas' runs the sweep kernel on one GPU and the lax.scan
    sweep elsewhere (GSPMD cannot partition the kernel on a mesh); 'auto'
    takes the sweep where it runs, else the eig contractions."""
    assert poisson.thomas_impl('gpu') == 'sweep'
    assert poisson.thomas_impl('gpu', sharded=True) == 'scan'
    assert poisson.thomas_impl('cpu') == 'scan'
    assert poisson.resolve_zsolver('auto', 'gpu', False) == 'thomas'
    assert poisson.resolve_zsolver('auto', 'gpu', True) == 'eig'
    assert poisson.resolve_zsolver('auto', 'cpu', False) == 'eig'
    assert poisson.resolve_zsolver('thomas', 'cpu', False) == 'thomas'
    cfg = Config(ng=(8, 4, 6), l=(1.0, 1.0, 1.0), dtype='float64')
    grid = make_grid(0, 6, 0.0, 1.0)
    args = (cfg, grid, ('PP', 'PP', 'NN'), ('c',) * 3)
    sv_g = poisson.make_solver(*args, zsolver='thomas', platform='gpu')
    sv_c = poisson.make_solver(*args, zsolver='thomas')
    sv_e = poisson.make_solver(*args)
    assert poisson.z_solver_name(sv_g) == 'thomas (sweep)'
    assert poisson.z_solver_name(sv_c) == 'thomas (scan)'
    assert poisson.z_solver_name(sv_e).startswith('eig')
