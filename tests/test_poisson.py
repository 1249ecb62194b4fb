"""3D direct-solver residual tests: L p = rhs to near machine precision for a
matrix of BC combinations x staggerings, on stretched z grids (SURVEY §7.2
stage 4; reference solver.f90:20-80, initsolver.f90)."""
import numpy as np
import pytest
import jax.numpy as jnp

from cales_tpu.config import Config
from cales_tpu.grid import make_grid
from cales_tpu.poisson import make_solver, solve, tridmatrix
from tests.test_transforms import dense_lap_1d


def dense_lap_z(bc, c_or_f, grid):
    n = grid.n
    a, b, c = tridmatrix(bc, n, grid.dzci, grid.dzfi, c_or_f)
    m = n - 1 if (c_or_f == 'f' and bc[1] == 'D') else n
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


def apply_lap3d(p, cbc, c_or_f, cfg, grid):
    nx, ny, nz = cfg.ng
    dli = cfg.dli
    Lx = dense_lap_1d(cbc[0], c_or_f[0], nx) * dli[0] ** 2
    Ly = dense_lap_1d(cbc[1], c_or_f[1], ny) * dli[1] ** 2
    Lz = dense_lap_z(cbc[2], c_or_f[2], grid)
    sx, sy, sz = Lx.shape[0], Ly.shape[0], Lz.shape[0]
    pb = p[:sz, :sy, :sx]
    out = np.einsum('ab,zyb->zya', Lx, pb)
    out += np.einsum('ab,zbx->zax', Ly, pb)
    out += np.einsum('ab,byx->ayx', Lz, pb)
    return out, (sz, sy, sx)


CASES = [
    # (cbc_x, cbc_y, cbc_z, c_or_f, singular)
    (('PP', 'PP', 'PP'), ('c', 'c', 'c'), True),    # tri-periodic pressure
    (('PP', 'PP', 'NN'), ('c', 'c', 'c'), True),    # channel pressure
    (('PP', 'NN', 'NN'), ('c', 'c', 'c'), True),    # duct pressure
    (('NN', 'NN', 'NN'), ('c', 'c', 'c'), True),    # cavity pressure
    (('PP', 'PP', 'DD'), ('f', 'c', 'c'), False),   # u Helmholtz (channel)
    (('PP', 'PP', 'DD'), ('c', 'f', 'c'), False),   # v Helmholtz
    (('PP', 'PP', 'DD'), ('c', 'c', 'f'), False),   # w Helmholtz
    (('DD', 'PP', 'DD'), ('f', 'c', 'c'), False),   # u with x walls (duct-x)
    (('ND', 'PP', 'NN'), ('c', 'c', 'c'), False),   # mixed ND
    (('DN', 'DD', 'NN'), ('c', 'c', 'c'), False),   # mixed DN
    (('DD', 'DD', 'DD'), ('f', 'c', 'c'), False),   # face DD in x
    (('NN', 'DD', 'DD'), ('f', 'c', 'c'), False),   # face NN in x
    (('ND', 'DD', 'DD'), ('f', 'c', 'c'), False),   # face ND in x
    (('DN', 'DD', 'DD'), ('f', 'c', 'c'), False),   # face DN in x
]


@pytest.mark.parametrize("cbc,c_or_f,singular", CASES)
def test_poisson_residual(cbc, c_or_f, singular):
    ng = (16, 12, 10)
    cfg = Config(ng=ng, l=(1.3, 0.9, 2.0), gtype=1, gr=0.8, dtype='float64')
    grid = make_grid(cfg.gtype, ng[2], cfg.gr, cfg.l[2])
    sv = make_solver(cfg, grid, cbc, c_or_f)

    rng = np.random.default_rng(42)
    rhs = rng.standard_normal((ng[2], ng[1], ng[0]))
    if singular:
        # discrete compatibility: the left null vector of the z-tridiagonal is
        # dzf-weighted (the physical divergence RHS satisfies this exactly)
        w = grid.dzf[1:ng[2] + 1]
        wmean = (rhs * w[:, None, None]).sum() / (w.sum() * ng[0] * ng[1])
        rhs = rhs - wmean

    p = np.asarray(solve(sv, jnp.asarray(rhs)))
    lap, (sz, sy, sx) = apply_lap3d(p, cbc, c_or_f, cfg, grid)
    res = lap - rhs[:sz, :sy, :sx]
    scale = max(np.abs(rhs).max(), 1.0)
    np.testing.assert_allclose(res / scale, 0.0, atol=1e-8)


def test_helmholtz_residual():
    """(I + alpha L) p = rhs, the Crank-Nicolson viscous solve
    (main.f90:424-443)."""
    ng = (16, 12, 10)
    cfg = Config(ng=ng, l=(1.0, 1.0, 2.0), gtype=1, gr=1.1, dtype='float64')
    grid = make_grid(cfg.gtype, ng[2], cfg.gr, cfg.l[2])
    cbc, c_or_f = ('PP', 'PP', 'DD'), ('f', 'c', 'c')
    sv = make_solver(cfg, grid, cbc, c_or_f)
    alpha = -0.37
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((ng[2], ng[1], ng[0]))
    p = np.asarray(solve(sv, jnp.asarray(rhs), alpha=alpha))
    lap, (sz, sy, sx) = apply_lap3d(p, cbc, c_or_f, cfg, grid)
    res = p[:sz, :sy, :sx] + alpha * lap - rhs[:sz, :sy, :sx]
    np.testing.assert_allclose(res, 0.0, atol=1e-10)


def test_poisson_periodic_z():
    """Tri-periodic with periodic tridiagonal path in z (gaussel_periodic)."""
    ng = (8, 8, 12)
    cfg = Config(ng=ng, l=(1.0, 1.0, 1.0), gtype=1, gr=0.0, dtype='float64')
    grid = make_grid(1, ng[2], 0.0, cfg.l[2])
    cbc, c_or_f = ('PP', 'PP', 'PP'), ('c', 'c', 'c')
    sv = make_solver(cfg, grid, cbc, c_or_f)
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((ng[2], ng[1], ng[0]))
    rhs -= rhs.mean()
    p = np.asarray(solve(sv, jnp.asarray(rhs)))
    lap, _ = apply_lap3d(p, cbc, c_or_f, cfg, grid)
    res = lap - rhs
    res -= res.mean()
    np.testing.assert_allclose(res, 0.0, atol=1e-9)


def test_eig_matches_thomas():
    """The matrix-diagonalization z-solver must agree with the Thomas
    scan to machine precision (both paths kept; zsolver 'auto' picks per
    platform)."""
    ng = (16, 12, 10)
    cfg = Config(ng=ng, l=(1.3, 0.9, 2.0), gtype=1, gr=0.8, dtype='float64')
    grid = make_grid(cfg.gtype, ng[2], cfg.gr, cfg.l[2])
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal((ng[2], ng[1], ng[0]))
    w = grid.dzf[1:ng[2] + 1]
    for cbc, cf in ((('PP', 'PP', 'NN'), ('c', 'c', 'c')),
                    (('PP', 'PP', 'PP'), ('c', 'c', 'c')),
                    (('PP', 'PP', 'DD'), ('c', 'c', 'f'))):
        if 'D' not in (cbc[2] + cbc[0] + cbc[1]):
            # compatible (dzf-weighted zero-mean) RHS: with an incompatible
            # RHS the eps-pivot (thomas) and null-space projection (eig)
            # legitimately differ in the singular column
            wm = (rhs * w[:, None, None]).sum() / (w.sum() * ng[0] * ng[1])
            r = rhs - wm
        else:
            r = rhs
        sv_e = make_solver(cfg, grid, cbc, cf, zsolver='eig')
        sv_t = make_solver(cfg, grid, cbc, cf, zsolver='thomas')
        pe = np.asarray(solve(sv_e, jnp.asarray(r)))
        pt = np.asarray(solve(sv_t, jnp.asarray(r)))
        if 'D' not in cbc[2] + cbc[0] + cbc[1]:
            pe = pe - pe.mean()
            pt = pt - pt.mean()
        np.testing.assert_allclose(pe, pt, atol=2e-9)
