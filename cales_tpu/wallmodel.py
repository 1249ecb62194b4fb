"""Wall models: log-law (Newton on u_tau) and laminar.

Port of /root/reference/src/wmodel.f90: per wall-modeled face, the
wall-parallel velocity is interpolated to the matching height ``hwm`` between
the two bracketing cells (wmodel.f90:119-131), made wall-relative
(vel_relative, 275-286), fed to the log-law Newton iteration (288-326) or the
laminar profile (327-333), and the resulting tau_w/visc is written as a
Neumann BC value for the parallel components (151,168,202,219,253,269).

Vectorized: the Newton iteration runs vectorized over the entire boundary
plane with a fixed iteration count (reference converges in 3-7 iterations at
|du_tau/u_tau| < 0.5e-4, wmodel.f90:288-297; a fixed 12 iterations of the
quadratically-convergent update is bitwise-stable once converged and keeps the
computation jit-compatible with static shapes).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .config import KAP_LOG, B_LOG

WM_LOG = 1
WM_LAM = -1
N_NEWTON = 12


def wallmodel_tauw(mtype: int, uh, vh, h: float, l1d: float, visc: float):
    """tau_w components aligned with (uh, vh) (wmodel.f90:288-335)."""
    eps = jnp.finfo(uh.dtype).eps
    upar = jnp.sqrt(uh * uh + vh * vh)
    if mtype == WM_LOG:
        utau = jnp.maximum(jnp.sqrt(upar / h * visc),
                           visc / h * np.exp(-KAP_LOG * B_LOG))
        for _ in range(N_NEWTON):
            f = upar / utau - (1.0 / KAP_LOG) * jnp.log(h * utau / visc) - B_LOG
            fp = -(1.0 / utau) * (upar / utau + 1.0 / KAP_LOG)
            utau = jnp.abs(utau - f / fp)
        tauw_tot = utau * utau
    elif mtype == WM_LAM:
        dl = 0.5 * l1d
        umax = upar / (h / dl * (2.0 - h / dl))
        tauw_tot = 2.0 / dl * umax * visc
    else:
        raise ValueError(f'unknown wall model type {mtype}')
    return tauw_tot * uh / (upar + eps), tauw_tot * vh / (upar + eps)


def _rel(v1, v2, coef, mag):
    return (1.0 - coef) * v1 + coef * v2 - mag


def find_index_wm(cfg, grid):
    """Interpolation index per wall-modeled face (initbc, bound.f90:812-865):
    the stored index is the cell *further* from the wall.  hwm outside the
    first..last cell-center band is rejected (sanity.f90:233-241 checks all
    wall-normal directions, not just z)."""
    nx, ny, nz = cfg.ng
    dl = cfg.dl
    h = cfg.hwm

    def err(d):
        raise ValueError(f'hwm={h} outside the first..last cell-center band '
                         f'in direction {d} (sanity.f90:233-241)')

    idx = [[0, 0], [0, 0], [0, 0]]
    for ib in range(2):
        if cfg.lwm[ib][0] != 0:
            if not 0.5 * dl[0] < h < (nx - 0.5) * dl[0]:
                err('x')
            i = 1 if ib == 0 else nx
            if ib == 0:
                while (i - 0.5) * dl[0] < h:
                    i += 1
            else:
                while (nx - i + 0.5) * dl[0] < h:
                    i -= 1
            idx[0][ib] = i
        if cfg.lwm[ib][1] != 0:
            if not 0.5 * dl[1] < h < (ny - 0.5) * dl[1]:
                err('y')
            j = 1 if ib == 0 else ny
            if ib == 0:
                while (j - 0.5) * dl[1] < h:
                    j += 1
            else:
                while (ny - j + 0.5) * dl[1] < h:
                    j -= 1
            idx[1][ib] = j
        if cfg.lwm[ib][2] != 0:
            if not grid.zc[1] < h < grid.zc[nz]:
                err('z')
            k = 1 if ib == 0 else nz
            if ib == 0:
                while grid.zc[k] < h:
                    k += 1
            else:
                while cfg.l[2] - grid.zc[k] < h:
                    k -= 1
            idx[2][ib] = k
    return tuple(tuple(r) for r in idx)


def update_wallmodel_bcs(cfg, grid, up, vp, wp, bcu, bcv, bcw,
                         bcu_mag, bcv_mag, bcw_mag, index_wm):
    """Recompute the Neumann BC planes on every wall-modeled face from the
    current (padded) velocity (updt_wallmodelbc, wmodel.f90:19-63).

    bc*_mag are the static wall-velocity magnitudes (initbc bcu_mag=bcu,
    bound.f90:797-801).  Returns updated (bcu, bcv, bcw) plane pytrees.
    """
    from .ops.boundary import bc_plane_shapes, ensure_plane
    nx, ny, nz = cfg.ng
    dl = cfg.dl
    h, visc = cfg.hwm, cfg.visc
    visci = 1.0 / visc
    zc, zf, dzc = grid.zc, grid.zf, grid.dzc
    dtype = up.dtype
    shapes = bc_plane_shapes(cfg.ng)

    def promote(vals):
        """scalar BC values -> full planes (built in-trace, cheap broadcasts)
        for the faces this routine slices or updates."""
        out = []
        for idir, key in ((0, 'x'), (1, 'y'), (2, 'z')):
            out.append([ensure_plane(vals[idir][ib], shapes[key], dtype)
                        for ib in range(2)])
        return out

    bcu = promote(bcu)
    bcv = promote(bcv)
    bcw = promote(bcw)
    bcu_mag = promote(bcu_mag)
    bcv_mag = promote(bcv_mag)
    bcw_mag = promote(bcw_mag)

    # weight for interpolating cell-centered values to w's face heights
    wei = ((zf - zc) / dzc)[:, None]           # (nz+2, 1)

    for ib in range(2):
        # ---------------- x walls (wmodel.f90:119-170) ----------------
        if cfg.lwm[ib][0] != 0:
            mtype = cfg.lwm[ib][0]
            i2 = index_wm[0][ib]
            i1 = i2 - 1 if ib == 0 else i2 + 1
            coef = ((h - (i1 - 0.5) * dl[0]) / dl[0] if ib == 0
                    else (h - (nx - i1 + 0.5) * dl[0]) / dl[0])
            sgn = 1.0 if ib == 0 else -1.0
            V1, V2 = vp[:, :, i1], vp[:, :, i2]          # (nz+2, ny+2)
            W1, W2 = wp[:, :, i1], wp[:, :, i2]
            # bcv%x over (j=0..ny, k=1..nz)
            v1 = V1[1:nz + 1, 0:ny + 1]
            v2 = V2[1:nz + 1, 0:ny + 1]
            w1 = 0.25 * (W1[1:nz + 1, 0:ny + 1] + W1[1:nz + 1, 1:ny + 2]
                         + W1[0:nz, 0:ny + 1] + W1[0:nz, 1:ny + 2])
            w2 = 0.25 * (W2[1:nz + 1, 0:ny + 1] + W2[1:nz + 1, 1:ny + 2]
                         + W2[0:nz, 0:ny + 1] + W2[0:nz, 1:ny + 2])
            vm = bcv_mag[0][ib][1:nz + 1, 0:ny + 1]
            wm_ = 0.25 * (bcw_mag[0][ib][1:nz + 1, 0:ny + 1]
                          + bcw_mag[0][ib][1:nz + 1, 1:ny + 2]
                          + bcw_mag[0][ib][0:nz, 0:ny + 1]
                          + bcw_mag[0][ib][0:nz, 1:ny + 2])
            t1, _ = wallmodel_tauw(mtype, _rel(v1, v2, coef, vm),
                                   _rel(w1, w2, coef, wm_), h, cfg.l[0], visc)
            bcv[0][ib] = bcv[0][ib].at[1:nz + 1, 0:ny + 1].set(sgn * visci * t1)
            # bcw%x over (j=1..ny, k=0..nz) with z interpolation weight
            wei_k = wei[0:nz + 1]
            v1 = 0.5 * ((1 - wei_k) * (V1[0:nz + 1, 0:ny] + V1[0:nz + 1, 1:ny + 1])
                        + wei_k * (V1[1:nz + 2, 0:ny] + V1[1:nz + 2, 1:ny + 1]))
            v2 = 0.5 * ((1 - wei_k) * (V2[0:nz + 1, 0:ny] + V2[0:nz + 1, 1:ny + 1])
                        + wei_k * (V2[1:nz + 2, 0:ny] + V2[1:nz + 2, 1:ny + 1]))
            w1 = W1[0:nz + 1, 1:ny + 1]
            w2 = W2[0:nz + 1, 1:ny + 1]
            vmg = bcv_mag[0][ib]
            vm = 0.5 * ((1 - wei_k) * (vmg[0:nz + 1, 0:ny] + vmg[0:nz + 1, 1:ny + 1])
                        + wei_k * (vmg[1:nz + 2, 0:ny] + vmg[1:nz + 2, 1:ny + 1]))
            wm_ = bcw_mag[0][ib][0:nz + 1, 1:ny + 1]
            _, t2 = wallmodel_tauw(mtype, _rel(v1, v2, coef, vm),
                                   _rel(w1, w2, coef, wm_), h, cfg.l[0], visc)
            bcw[0][ib] = bcw[0][ib].at[0:nz + 1, 1:ny + 1].set(sgn * visci * t2)

        # ---------------- y walls (wmodel.f90:171-221) ----------------
        if cfg.lwm[ib][1] != 0:
            j2 = index_wm[1][ib]
            j1 = j2 - 1 if ib == 0 else j2 + 1
            bcu[1][ib], bcw[1][ib] = y_wall_wm_planes(
                cfg, grid, up[:, j1, :], up[:, j2, :],
                wp[:, j1, :], wp[:, j2, :],
                bcu_mag[1][ib], bcw_mag[1][ib], bcu[1][ib], bcw[1][ib],
                ib, index_wm)

        # ---------------- z walls (wmodel.f90:222-272) ----------------
        if cfg.lwm[ib][2] != 0:
            k2 = index_wm[2][ib]
            k1 = k2 - 1 if ib == 0 else k2 + 1
            bcu[2][ib], bcv[2][ib] = z_wall_wm_planes(
                cfg, grid, up[k1], up[k2], vp[k1], vp[k2],
                bcu_mag[2][ib], bcv_mag[2][ib], bcu[2][ib], bcv[2][ib],
                ib, index_wm)

    to_t = lambda x: tuple(tuple(p) for p in x)
    return to_t(bcu), to_t(bcv), to_t(bcw)

def y_wall_wm_planes(cfg, grid, U1, U2, W1, W2, umag, wmag, bcu_y, bcw_y,
                     ib, index_wm):
    """The y-wall branch of the wall-model BC update (wmodel.f90:171-221)
    on explicit padded (nz+2, nx+2) velocity ROWS at (j1, j2) — shared by
    the full-field update above and the sliced-row fast path
    (timeloop._wm_bcs_fast, duct-WMLES class).  Returns the updated
    (bcu_y, bcw_y) planes for face ib."""
    nx, ny, nz = cfg.ng
    dl = cfg.dl
    h, visc = cfg.hwm, cfg.visc
    visci = 1.0 / visc
    zc, zf, dzc = grid.zc, grid.zf, grid.dzc
    wei = ((zf - zc) / dzc)[:, None]           # (nz+2, 1)
    mtype = cfg.lwm[ib][1]
    j2 = index_wm[1][ib]
    j1 = j2 - 1 if ib == 0 else j2 + 1
    coef = ((h - (j1 - 0.5) * dl[1]) / dl[1] if ib == 0
            else (h - (ny - j1 + 0.5) * dl[1]) / dl[1])
    sgn = 1.0 if ib == 0 else -1.0
    # bcu%y over (i=0..nx, k=1..nz)
    u1 = U1[1:nz + 1, 0:nx + 1]
    u2 = U2[1:nz + 1, 0:nx + 1]
    w1 = 0.25 * (W1[1:nz + 1, 0:nx + 1] + W1[1:nz + 1, 1:nx + 2]
                 + W1[0:nz, 0:nx + 1] + W1[0:nz, 1:nx + 2])
    w2 = 0.25 * (W2[1:nz + 1, 0:nx + 1] + W2[1:nz + 1, 1:nx + 2]
                 + W2[0:nz, 0:nx + 1] + W2[0:nz, 1:nx + 2])
    um = umag[1:nz + 1, 0:nx + 1]
    wm_ = 0.25 * (wmag[1:nz + 1, 0:nx + 1] + wmag[1:nz + 1, 1:nx + 2]
                  + wmag[0:nz, 0:nx + 1] + wmag[0:nz, 1:nx + 2])
    t1, _ = wallmodel_tauw(mtype, _rel(u1, u2, coef, um),
                           _rel(w1, w2, coef, wm_), h, cfg.l[1], visc)
    bcu_y = bcu_y.at[1:nz + 1, 0:nx + 1].set(sgn * visci * t1)
    # bcw%y over (i=1..nx, k=0..nz)
    wei_k = wei[0:nz + 1]
    u1 = 0.5 * ((1 - wei_k) * (U1[0:nz + 1, 0:nx] + U1[0:nz + 1, 1:nx + 1])
                + wei_k * (U1[1:nz + 2, 0:nx] + U1[1:nz + 2, 1:nx + 1]))
    u2 = 0.5 * ((1 - wei_k) * (U2[0:nz + 1, 0:nx] + U2[0:nz + 1, 1:nx + 1])
                + wei_k * (U2[1:nz + 2, 0:nx] + U2[1:nz + 2, 1:nx + 1]))
    w1 = W1[0:nz + 1, 1:nx + 1]
    w2 = W2[0:nz + 1, 1:nx + 1]
    um = 0.5 * ((1 - wei_k) * (umag[0:nz + 1, 0:nx] + umag[0:nz + 1, 1:nx + 1])
                + wei_k * (umag[1:nz + 2, 0:nx] + umag[1:nz + 2, 1:nx + 1]))
    wm_ = wmag[0:nz + 1, 1:nx + 1]
    _, t2 = wallmodel_tauw(mtype, _rel(u1, u2, coef, um),
                           _rel(w1, w2, coef, wm_), h, cfg.l[1], visc)
    bcw_y = bcw_y.at[0:nz + 1, 1:nx + 1].set(sgn * visci * t2)
    return bcu_y, bcw_y


def z_wall_wm_planes(cfg, grid, U1, U2, V1, V2, umag, vmag, bcu_z, bcv_z,
                     ib, index_wm):
    """The z-wall branch of the wall-model BC update on explicit padded
    (ny+2, nx+2) velocity ROWS at (k1, k2) — shared by the full-field
    update above and the sliced-row update (Simulation._wm_bcs_fast).
    Returns the updated (bcu_z, bcv_z) planes for face ib."""
    nx, ny, nz = cfg.ng
    h, visc = cfg.hwm, cfg.visc
    visci = 1.0 / visc
    zc, dzc = grid.zc, grid.dzc
    mtype = cfg.lwm[ib][2]
    k2 = index_wm[2][ib]
    k1 = k2 - 1 if ib == 0 else k2 + 1
    coef = ((h - zc[k1]) / dzc[k1] if ib == 0
            else (h - (cfg.l[2] - zc[k1])) / dzc[k2])
    sgn = 1.0 if ib == 0 else -1.0
    # bcu%z over (i=0..nx, j=1..ny)
    u1 = U1[1:ny + 1, 0:nx + 1]
    u2 = U2[1:ny + 1, 0:nx + 1]
    v1 = 0.25 * (V1[1:ny + 1, 0:nx + 1] + V1[1:ny + 1, 1:nx + 2]
                 + V1[0:ny, 0:nx + 1] + V1[0:ny, 1:nx + 2])
    v2 = 0.25 * (V2[1:ny + 1, 0:nx + 1] + V2[1:ny + 1, 1:nx + 2]
                 + V2[0:ny, 0:nx + 1] + V2[0:ny, 1:nx + 2])
    um = umag[1:ny + 1, 0:nx + 1]
    vm = 0.25 * (vmag[1:ny + 1, 0:nx + 1] + vmag[1:ny + 1, 1:nx + 2]
                 + vmag[0:ny, 0:nx + 1] + vmag[0:ny, 1:nx + 2])
    t1, _ = wallmodel_tauw(mtype, _rel(u1, u2, coef, um),
                           _rel(v1, v2, coef, vm), h, cfg.l[2], visc)
    bcu_z = bcu_z.at[1:ny + 1, 0:nx + 1].set(sgn * visci * t1)
    # bcv%z over (i=1..nx, j=0..ny)
    u1 = 0.25 * (U1[0:ny + 1, 0:nx] + U1[0:ny + 1, 1:nx + 1]
                 + U1[1:ny + 2, 0:nx] + U1[1:ny + 2, 1:nx + 1])
    u2 = 0.25 * (U2[0:ny + 1, 0:nx] + U2[0:ny + 1, 1:nx + 1]
                 + U2[1:ny + 2, 0:nx] + U2[1:ny + 2, 1:nx + 1])
    v1 = V1[0:ny + 1, 1:nx + 1]
    v2 = V2[0:ny + 1, 1:nx + 1]
    um = 0.25 * (umag[0:ny + 1, 0:nx] + umag[0:ny + 1, 1:nx + 1]
                 + umag[1:ny + 2, 0:nx] + umag[1:ny + 2, 1:nx + 1])
    vm = vmag[0:ny + 1, 1:nx + 1]
    _, t2 = wallmodel_tauw(mtype, _rel(u1, u2, coef, um),
                           _rel(v1, v2, coef, vm), h, cfg.l[2], visc)
    bcv_z = bcv_z.at[0:ny + 1, 1:nx + 1].set(sgn * visci * t2)
    return bcu_z, bcv_z
