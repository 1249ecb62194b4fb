"""FFT/matrix eigenfunction-expansion direct Poisson/Helmholtz solver.

JAX rebuild of the reference solver stack:
  * setup: /root/reference/src/initsolver.f90:17-169 (eigenvalues, tridmatrix)
  * solve: /root/reference/src/solver.f90:20-233 (transform -> batched Thomas
    in z -> inverse transform), solver_gpu.f90:32-477
  * BC inhomogeneity planes: /root/reference/src/bound.f90:447-617
    (cmpt_rhs_b / bc_rhs / updt_rhs_b)

Arrays are (nz, ny, nx); transforms act along x (axis -1) then y (axis -2),
then a batched Thomas sweep runs along z (axis 0).  On a device mesh the
re-shardings between those stages become XLA all-to-alls — the analogue of the
reference's cuDecomp pencil transposes (solver_gpu.f90:80-158).

Normalization: all transform pairs are exact inverses, so the reference's
``normfft`` scalar (fft.f90:62-142) is identically 1 here.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .config import Config
from .grid import Grid
from .ops import transforms as tr
from .ops.tridiag import thomas, thomas_periodic


def tridmatrix(bc: str, n: int, dzci: np.ndarray, dzfi: np.ndarray,
               c_or_f: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """z tridiagonal coefficients (initsolver.f90:127-169).  dzci/dzfi are the
    (n+2,) inverse-spacing arrays with ghost entries."""
    k = np.arange(1, n + 1)
    if c_or_f == 'c':
        a = dzfi[k] * dzci[k - 1]
        c = dzfi[k] * dzci[k]
    else:
        a = dzfi[k] * dzci[k]
        c = dzfi[k + 1] * dzci[k]
    b = -(a + c)
    factor = {'P': 0.0, 'D': -1.0, 'N': 1.0}
    if c_or_f == 'c':
        b[0] += factor[bc[0]] * a[0]
        b[-1] += factor[bc[1]] * c[-1]
    else:
        if bc[0] == 'N':
            b[0] += factor[bc[0]] * a[0]
        if bc[1] == 'N':
            b[-1] += factor[bc[1]] * c[-1]
    return a, b, c


def _z_eigendecomposition(a, b, c, weights, periodic):
    """Eigendecomposition of the z tridiagonal operator T (matrix
    diagonalization method; replaces the sequential Thomas sweep with two
    dense matmuls along z — no loop-carried dependency).

    T is similar to a symmetric matrix via D^{1/2} with D = diag(weights):
    weights = dzf (cell-centered z) or dzc (face-centered z) make
    (D T)_{k,k-1} == (D T)_{k-1,k}, so M = D^{1/2} T D^{-1/2} is symmetric
    and T = D^{-1/2} Q L Q^T D^{1/2} with Q orthonormal from eigh
    (numerically stable for stretched grids).  If the similarity fails (e.g.
    periodic z with a non-periodic stretching), falls back to a general
    eigendecomposition.

    Returns (Vl, Vr, lamz) float64 with solve((T + s I) x = r) as
    x = Vr @ (Vl @ r / (lamz + s)).
    """
    n = len(b)
    T = np.zeros((n, n))
    for k in range(n):
        T[k, k] = b[k]
        if k > 0:
            T[k, k - 1] = a[k]
        if k < n - 1:
            T[k, k + 1] = c[k]
    if periodic:
        T[0, n - 1] = a[0]
        T[n - 1, 0] = c[n - 1]
    d = np.sqrt(weights[1:n + 1])
    M = (d[:, None] * T) / d[None, :]
    if np.allclose(M, M.T, rtol=1e-12, atol=1e-12):
        lamz, Q = np.linalg.eigh(0.5 * (M + M.T))
        Vl = Q.T * d[None, :]          # Q^T D^{1/2}
        Vr = Q / d[:, None]            # D^{-1/2} Q
    else:
        lam_c, V = np.linalg.eig(T)
        if np.abs(lam_c.imag).max() > 1e-10 or np.abs(V.imag).max() > 1e-10:
            # genuinely complex spectrum (e.g. periodic z on a stretched grid):
            # a real eigendecomposition does not exist — refuse rather than
            # silently truncate; the caller should use zsolver='thomas'.
            raise ValueError(
                "z operator has a complex eigendecomposition (periodic z with "
                "a stretched grid?); use zsolver='thomas' for this config")
        idx = np.argsort(lam_c.real)
        lamz = lam_c.real[idx]
        Vr = V.real[:, idx]
        Vl = np.linalg.inv(Vr)
    return Vl, Vr, lamz


@dataclass(frozen=True)
class DirectSolver:
    """Prebuilt direct solver for one field (pressure or a velocity component)."""
    ng: tuple[int, int, int]
    c_or_f: tuple[str, str, str]
    bcx: str
    bcy: str
    bcz: str
    trx: tr.Transform1D
    try_: tr.Transform1D
    a: np.ndarray          # (nz,) float64
    b: np.ndarray
    c: np.ndarray
    lamx: np.ndarray       # scaled by dxi^2, full-length float64
    lamy: np.ndarray       # scaled by dyi^2
    # z eigen-solver operators (matrix diagonalization method)
    zVl: np.ndarray | None = None    # (nzs, nzs)
    zVr: np.ndarray | None = None
    lamz: np.ndarray | None = None   # (nzs,)
    zsolver: str = 'eig'             # 'eig' (dense matmuls) | 'thomas' (sweep)
    zimpl: str = 'scan'              # thomas only: 'sweep' (GPU kernel) | 'scan'

    @property
    def qz(self) -> int:
        # last z plane excluded for face-staggered Dirichlet top (solver.f90:55-56)
        return 1 if (self.c_or_f[2] == 'f' and self.bcz[1] == 'D') else 0


def make_solver(cfg: Config, grid: Grid, cbc, c_or_f,
                zsolver: str = 'eig', platform: str = 'cpu',
                sharded: bool = False) -> DirectSolver:
    """cbc: per-direction BC pairs [(lo,hi) x 3] as two-letter strings.
    platform / sharded: where the solve runs (picks the Thomas
    implementation, see thomas_impl)."""
    nx, ny, nz = cfg.ng
    dli = cfg.dli

    # periodic directions: FFT unless the dense DFT operator is asked for
    pp_mat = cfg.ptransform == 'mat'
    trx = tr.make_transform(cbc[0], c_or_f[0], nx, pp_mat=pp_mat)
    try_ = tr.make_transform(cbc[1], c_or_f[1], ny, pp_mat=pp_mat)
    a, b, c = tridmatrix(cbc[2], nz, grid.dzci, grid.dzfi, c_or_f[2])
    lamx = trx.lam * dli[0] ** 2
    lamy = try_.lam * dli[1] ** 2
    qz = 1 if (c_or_f[2] == 'f' and cbc[2][1] == 'D') else 0
    nzs = nz - qz
    weights = grid.dzf if c_or_f[2] == 'c' else grid.dzc
    zVl = zVr = lamz = None
    if zsolver == 'eig':
        try:
            zVl, zVr, lamz = _z_eigendecomposition(a[:nzs], b[:nzs], c[:nzs],
                                                   weights, cbc[2] == 'PP')
        except ValueError:
            import warnings
            warnings.warn('z eigendecomposition unavailable for this config; '
                          "falling back to zsolver='thomas'")
            zsolver = 'thomas'
    return DirectSolver(ng=cfg.ng, c_or_f=tuple(c_or_f), bcx=cbc[0], bcy=cbc[1],
                        bcz=cbc[2], trx=trx, try_=try_, a=a, b=b, c=c,
                        lamx=lamx, lamy=lamy, zVl=zVl, zVr=zVr, lamz=lamz,
                        zsolver=zsolver, zimpl=thomas_impl(platform, sharded))


def resolve_zsolver(zsolver: str, platform: str, sharded: bool) -> str:
    """The z solver a Simulation uses for Config.zsolver='auto'.

    On one GPU the batched Thomas sweep kernel wins: 0.759 vs 1.145 ms per
    solve alone and 24.12 vs 24.86 ms per channel-LES step against the eig
    contractions (512x256x256 f32, H100 80GB HBM3 at 400 W, PERF.md).
    Elsewhere, and on a device mesh (where GSPMD partitions the dense
    contractions along z-local pencils), the eig contractions; the
    lax.scan sweep is 7x slower than either on the GPU."""
    if zsolver != 'auto':
        return zsolver
    return 'thomas' if thomas_impl(platform, sharded) == 'sweep' else 'eig'


def thomas_impl(platform: str, sharded: bool = False) -> str:
    """Implementation of zsolver='thomas': the batched z-sweep kernel
    (ops/zsweep.py) on one GPU, else a lax.scan sweep (GSPMD partitions the
    scan; it cannot partition the kernel)."""
    return 'sweep' if platform == 'gpu' and not sharded else 'scan'


def solve(sv: DirectSolver, p, alpha=None, hints=None):
    """Solve L p_new = p (Poisson) or (I + alpha*L) p_new = p (Helmholtz,
    main.f90:424-443 with alpha = -nu*dt_rk/2) in place of the input RHS.

    p: (nz, ny, nx) interior array.  Returns the solution with excluded
    boundary slices (face-staggered Dirichlet) passed through unchanged.

    `hints` (parallel.mesh.ShardingHints): sharding constraints around each
    stage; GSPMD lowers the reshardings to the all-to-all pencil transposes
    of the reference (solver_gpu.f90:80-158)."""
    nz, ny, nx = p.shape
    sx, sy = sv.trx.nsolve, sv.try_.nsolve
    tail_x = p[..., sx:]
    body = p[..., :sx]
    tail_y = body[:, sy:, :]
    body = body[:, :sy, :]

    # forward transforms: x (axis -1) then y.  When both directions are
    # operator matrices and no mesh is attached, the y stages run in a
    # (z, x, y) transposed layout with ONE explicit transpose each way —
    # y-minor matmuls without the per-stage moveaxis round trips
    both_mat = (sv.trx.kind == 'mat' and sv.try_.kind == 'mat'
                and hints is None)
    # on a mesh each transform sits between two identical sharding
    # constraints that keep its own axis local: GSPMD then never partitions
    # the transform itself (its distributed-FFT rewrite breaks on the
    # unevenly split nx//2+1 spectral axis)
    ident = lambda a: a
    hx = hints.x_local if hints is not None else ident
    hy = hints.y_local if hints is not None else ident
    hz = hints.z_local if hints is not None else ident
    body = hx(tr.fwd(sv.trx, hx(body), axis=-1))
    x_was_fft = sv.trx.kind == 'fft'
    if both_mat:
        body = jnp.swapaxes(body, 1, 2)          # (z, x, y)
        body = tr.fwd(sv.try_, body, axis=-1)
    else:
        body = hy(tr.fwd(sv.try_, hy(body), axis=-2))
    y_was_rfft = (sv.try_.kind == 'fft') and not x_was_fft
    body = hz(body)

    # eigenvalue grids matching the spectral shape; assembled in-trace from
    # the 1D profiles (a precomputed 2D/3D grid would inline as a huge literal)
    rdt = body.real.dtype if jnp.iscomplexobj(body) else body.dtype
    lamx_np = sv.lamx[: nx // 2 + 1] if x_was_fft else sv.lamx
    lamy_np = sv.lamy[: ny // 2 + 1] if y_was_rfft else sv.lamy
    if both_mat:
        # spectral layout is (z, kx, ky)
        lamxy = (jnp.asarray(lamx_np, dtype=rdt)[:, None]
                 + jnp.asarray(lamy_np, dtype=rdt)[None, :])
    else:
        lamxy = (jnp.asarray(lamy_np, dtype=rdt)[:, None]
                 + jnp.asarray(lamx_np, dtype=rdt)[None, :])
    lam_scale = float(np.abs(lamx_np).max() + np.abs(lamy_np).max())

    # z-direction solve with modified-wavenumber diagonal shift
    qz = sv.qz
    zsol = _z_stage(sv, body[: nz - qz], lamxy, lam_scale, alpha)
    body = jnp.concatenate([zsol, body[nz - qz:]], axis=0) if qz else zsol

    # inverse transforms: y then x
    if both_mat:
        body = tr.bwd(sv.try_, body, axis=-1, n=sy, real_out=not x_was_fft)
        body = jnp.swapaxes(body, 1, 2)          # back to (z, y, x)
    else:
        body = hy(tr.bwd(sv.try_, hy(body), axis=-2, n=sy,
                         real_out=not x_was_fft))
    body = hx(tr.bwd(sv.trx, hx(body), axis=-1, n=sx, real_out=True))
    body = body.real if jnp.iscomplexobj(body) else body
    body = body.astype(p.dtype)
    if hints is not None:
        body = hints.field(body)

    if tail_y.shape[1]:
        body = jnp.concatenate([body, tail_y], axis=1)
    if tail_x.shape[-1]:
        body = jnp.concatenate([body, tail_x], axis=-1)
    return body


def _z_stage(sv: DirectSolver, zbody, lamxy, lam_scale, alpha):
    """z solve of the (nzs, ...) spectral RHS with the diagonal shift
    `lamxy` (None: no x/y shift).  alpha None: Poisson, whose pure
    Neumann/periodic mode is exactly singular; else the Helmholtz operator
    (I + alpha*L), never singular."""
    nzs = zbody.shape[0]
    rdt = zbody.real.dtype if jnp.iscomplexobj(zbody) else zbody.dtype
    if sv.zsolver == 'eig':
        # matrix diagonalization method: two dense (nz, nz) contractions
        # along z instead of a sequential sweep (see _z_eigendecomposition)
        lam3 = jnp.asarray(sv.lamz, dtype=rdt)[:, None, None]
        if lamxy is not None:
            lam3 = lam3 + lamxy[None, :, :]
        if alpha is not None:
            inv = 1.0 / (lam3 * alpha + 1.0)
        else:
            # project out the (exactly) singular constant mode instead of the
            # reference's eps-regularized pivot (solver.f90:165-169)
            scale = float(np.abs(sv.lamz).max()) + lam_scale
            tol = np.finfo(np.dtype(rdt)).eps * scale * 4.0
            inv = jnp.where(jnp.abs(lam3) > tol, 1.0 / lam3, 0.0)
        hat = tr.contract_leading(sv.zVl, zbody) * inv
        return tr.contract_leading(sv.zVr, hat).astype(zbody.dtype)
    a, b, c = sv.a, sv.b, sv.c
    lam = lamxy
    if alpha is not None:
        a, b, c = a * alpha, b * alpha + 1.0, c * alpha
        lam = None if lamxy is None else lamxy * alpha
    periodic = sv.bcz == 'PP'
    if sv.zimpl == 'sweep':
        from .ops import zsweep
        # the singular Poisson mode (pure Neumann or periodic z at
        # lamxy = 0) is pinned to a zero gauge instead of eps pivots
        pin_tol = None
        if alpha is None and sv.bcz in ('NN', 'PP'):
            pin_tol = np.finfo(np.dtype(rdt)).eps * lam_scale * 4.0
        return zsweep.thomas_z(zbody, a[:nzs], b[:nzs], c[:nzs], lam,
                               pin_tol=pin_tol, periodic=periodic)
    # eps pivots only for the exactly singular pure-Poisson mode
    reg = alpha is None
    if periodic:
        return thomas_periodic(a, b, c, zbody, lam=lam, regularize=reg)
    return thomas(a[:nzs], b[:nzs], c[:nzs], zbody, lam=lam, regularize=reg)


def z_solver_name(sv: DirectSolver) -> str:
    if sv.zsolver == 'eig':
        return 'eig (dense z eigenbasis contractions)'
    return f'thomas ({sv.zimpl})'


def solve_z_only(sv: DirectSolver, p, alpha, bc_planes=None):
    """z-implicit-only Helmholtz solve (I + alpha*Lz) p = rhs with no x/y
    transforms (solver_gaussel_z, solver.f90:182-233; the _IMPDIFF_1D path).

    bc_planes: optional ((ny, nx) lo, hi) z-face RHS boundary planes
    (updt_rhs_b) added to rows 0 / (nz - qz - 1)."""
    nz = p.shape[0]
    qz = sv.qz
    if bc_planes is not None:
        p = p.at[0].add(jnp.asarray(bc_planes[0], p.dtype))
        p = p.at[nz - qz - 1].add(jnp.asarray(bc_planes[1], p.dtype))
    zsol = _z_stage(sv, p[: nz - qz], None, 0.0, alpha)
    return jnp.concatenate([zsol, p[nz - qz:]], axis=0) if qz else zsol


# ---------------------------------------------------------------------------
# BC inhomogeneity planes (bound.f90:447-617)
# ---------------------------------------------------------------------------

def rhs_bound_planes(cfg: Config, grid: Grid, cbc, c_or_f, bcvals):
    """Compute the additive RHS boundary planes (cmpt_rhs_b/bc_rhs,
    bound.f90:447-560).

    bcvals: per-direction pair of 2D arrays or scalars, bcvals[idir][ibound];
    shapes: x-planes (nz, ny), y-planes (nz, nx), z-planes (ny, nx).
    Returns dict {('x'|'y'|'z', 0|1): plane ndarray}.
    """
    nx, ny, nz = cfg.ng
    dl = cfg.dl
    dzc, dzf = grid.dzc, grid.dzf
    if c_or_f[2] == 'c':
        dzc01 = (dzc[0], dzc[nz])
        dzf01 = (dzf[1], dzf[nz])
    else:
        dzc01 = (dzc[1], dzc[nz - 1])
        dzf01 = (dzf[1], dzf[nz])
    metr = {
        0: ((dl[0], dl[0]), (dl[0], dl[0])),
        1: ((dl[1], dl[1]), (dl[1], dl[1])),
        2: (dzc01, dzf01),
    }
    out = {}
    for idir, key in ((0, 'x'), (1, 'y'), (2, 'z')):
        dlc, dlf = metr[idir]
        for ib in range(2):
            # scalar BC values stay scalar (broadcast at use-site; avoids
            # inlining full-plane literals into the jitted program)
            bcv = np.asarray(bcvals[idir][ib], dtype=np.float64)
            letter = cbc[idir][ib]
            cf = c_or_f[idir]
            if letter == 'P':
                plane = bcv * 0.0
            elif letter == 'D':
                fac = 2.0 if cf == 'c' else 1.0
                plane = -fac * bcv / (dlc[ib] * dlf[ib])
            else:  # 'N'
                sgn = 1.0 if ib == 0 else -1.0
                div = dlf[ib] if cf == 'c' else dlc[ib]
                plane = sgn * bcv / div
            out[(key, ib)] = plane
    return out


def rhs_bound_planes_dyn(cfg: Config, grid: Grid, cbc, c_or_f, bc_planes):
    """Traced variant of rhs_bound_planes for dynamic (wall-model-updated) BC
    planes (cmpt_rhs_b called per substep, main.f90:425-469).

    bc_planes[idir][ibound]: padded-transverse jnp planes; cropped to interior
    here.  cbc: per-direction (lo, hi) letter pairs.
    """
    nx, ny, nz = cfg.ng
    dl = cfg.dl
    dzc, dzf = grid.dzc, grid.dzf
    if c_or_f[2] == 'c':
        dzc01 = (dzc[0], dzc[nz])
        dzf01 = (dzf[1], dzf[nz])
    else:
        dzc01 = (dzc[1], dzc[nz - 1])
        dzf01 = (dzf[1], dzf[nz])
    metr = {0: ((dl[0], dl[0]), (dl[0], dl[0])),
            1: ((dl[1], dl[1]), (dl[1], dl[1])),
            2: (dzc01, dzf01)}
    ishape = {0: (nz, ny), 1: (nz, nx), 2: (ny, nx)}
    out = {}
    for idir, key in ((0, 'x'), (1, 'y'), (2, 'z')):
        dlc, dlf = metr[idir]
        for ib in range(2):
            val = bc_planes[idir][ib]
            if hasattr(val, 'ndim') and getattr(val, 'ndim', 0) == 2:
                bcv = val[1:-1, 1:-1]
            else:
                bcv = jnp.full(ishape[idir], val)
            letter = cbc[idir][ib]
            cf = c_or_f[idir]
            if letter == 'P':
                plane = jnp.zeros_like(bcv)
            elif letter == 'D':
                fac = 2.0 if cf == 'c' else 1.0
                plane = -fac * bcv / (dlc[ib] * dlf[ib])
            else:
                sgn = 1.0 if ib == 0 else -1.0
                div = dlf[ib] if cf == 'c' else dlc[ib]
                plane = sgn * bcv / div
            out[(key, ib)] = plane
    return out


def add_rhs_bound(cfg: Config, c_or_f, cbc, rhs, planes):
    """Add boundary planes onto the solver RHS (updt_rhs_b, bound.f90:562-617).
    rhs: (nz, ny, nx).  Statically-zero planes (all-periodic / homogeneous
    BCs, the common production case) skip the six dynamic-update-slice
    passes entirely."""
    if all(isinstance(p, (int, float, np.floating, np.ndarray))
           and np.all(np.asarray(p) == 0.0) for p in planes.values()):
        return rhs
    nx, ny, nz = cfg.ng
    q = [0, 0, 0]
    for idir in range(3):
        if c_or_f[idir] == 'f' and cbc[idir][1] == 'D':
            q[idir] = 1
    dt = rhs.dtype
    px0 = jnp.asarray(planes[('x', 0)], dtype=dt)
    px1 = jnp.asarray(planes[('x', 1)], dtype=dt)
    py0 = jnp.asarray(planes[('y', 0)], dtype=dt)
    py1 = jnp.asarray(planes[('y', 1)], dtype=dt)
    pz0 = jnp.asarray(planes[('z', 0)], dtype=dt)
    pz1 = jnp.asarray(planes[('z', 1)], dtype=dt)
    rhs = rhs.at[:, :, 0].add(px0)
    rhs = rhs.at[:, :, nx - 1 - q[0]].add(px1)
    rhs = rhs.at[:, 0, :].add(py0)
    rhs = rhs.at[:, ny - 1 - q[1], :].add(py1)
    rhs = rhs.at[0, :, :].add(pz0)
    rhs = rhs.at[nz - 1 - q[2], :, :].add(pz1)
    return rhs
