"""Fused stencil kernels of the physics layer, written as shifted-slice
expressions on ghost-padded (nz+2, ny+2, nx+2) arrays so XLA fuses them into
single bandwidth-bound passes (the analogue of the reference's OpenACC
collapse(3) loop kernels).

Reference parity:
  * momentum_rhs  <- mom_xyz_ad      /root/reference/src/mom.f90:17-309
  * fillps        <- fillps          /root/reference/src/fillps.f90:14-48
  * correc        <- correc          /root/reference/src/correc.f90:14-68
  * updatep       <- updatep         /root/reference/src/updatep.f90:14-50
  * divergence    <- chkdiv          /root/reference/src/chkdiv.f90:16-52
  * cfl_dt        <- chkdt           /root/reference/src/chkdt.f90:17-99
  * strain_rate   <- strain_rate     /root/reference/src/sgs.f90:1019-1110
  * filter3d/2d   <- filter3d/2d     /root/reference/src/sgs.f90:616-680,824-848
  * interp_center <- interpolate     /root/reference/src/sgs.f90:850-870

Discretization: 2nd-order central differences on a staggered grid, advection
in divergence form, full eddy-viscous stress tensor with nu_t interpolated to
faces/edges.  Index map: padded python [k, j, i] == reference (i, j, k).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _sh(P, k, j, i):
    """interior-shifted view of padded P: element [kk,jj,ii] = P[kk+1+k, ...]."""
    nz, ny, nx = P.shape[0] - 2, P.shape[1] - 2, P.shape[2] - 2
    return P[1 + k:1 + k + nz, 1 + j:1 + j + ny, 1 + i:1 + i + nx]


def _zb(arr1d, lo, hi):
    """broadcast a z-metric slice [lo:hi] to (nz,1,1)."""
    return jnp.asarray(arr1d[lo:hi])[:, None, None]


def momentum_rhs(up, vp, wp, sp, visc, dxi, dyi, dzci, dzfi, with_sgs=True):
    """Momentum RHS (advection + molecular & eddy viscous terms, no pressure).

    up, vp, wp, sp: padded velocity & eddy viscosity; visc: molecular.
    Returns per component (expl, dif_xy, dif_z):
      expl   = advection + full eddy-stress divergence,
      dif_xy = molecular x/y diffusion, dif_z = molecular z diffusion,
    so the caller assembles explicit/implicit splits at runtime (the
    reference's _IMPDIFF/_IMPDIFF_1D compile branches, mom.f90:277-303).
    with_sgs=False: sp is never read (see momentum_rhs_core).
    """
    nz = up.shape[0] - 2
    metrics = {
        'dzci_c': _zb(dzci, 1, nz + 1),   # dzci(k)
        'dzci_m': _zb(dzci, 0, nz),       # dzci(k-1)
        'dzfi_c': _zb(dzfi, 1, nz + 1),   # dzfi(k)
        'dzfi_p': _zb(dzfi, 2, nz + 2),   # dzfi(k+1)
    }

    def V(P, k=0, j=0, i=0):
        return _sh(P, k, j, i)

    return momentum_rhs_core(V, metrics.__getitem__, up, vp, wp, sp,
                             visc, dxi, dyi, with_sgs=with_sgs)


def momentum_rhs_core(V, M, up, vp, wp, sp, visc, dxi, dyi, with_sgs=True):
    """The discretization itself, written against an accessor interface so
    any evaluator of the same formulas (mom.f90:17-309) shares them:
      V(field, k=, j=, i=) -> interior-shifted view;
      M(name) -> z metric broadcast ('dzci_c','dzci_m','dzfi_c','dzfi_p').

    with_sgs=False (sgstype 'none'): visct == 0 identically, so the eddy
    stress-tensor terms (the only consumers of sp) are exact zeros — sp is
    never read and those terms are elided.  Bitwise-identical to the
    with_sgs=True evaluation on a zero sp (adding exact float zeros is the
    identity), which the parity test checks.
    """
    dzci_c = M('dzci_c')
    dzci_m = M('dzci_m')
    dzfi_c = M('dzfi_c')
    dzfi_p = M('dzfi_p')

    u_ccc, v_ccc, w_ccc = V(up), V(vp), V(wp)

    # shared shifted reads + edge derivatives (mom.f90:145-150,190-195,
    # 235-240: u_jp==v_ip, u_kp==w_ip, v_kp==w_jp)
    u_pcc = V(up, i=1)
    u_cpc = V(up, j=1)
    u_ccp = V(up, k=1)
    u_mcc_f = V(up, i=-1)
    v_pcc, v_cmc = V(vp, i=1), V(vp, j=-1)
    v_cpc, v_ccp = V(vp, j=1), V(vp, k=1)
    w_pcc, w_ccm = V(wp, i=1), V(wp, k=-1)
    w_cpc = V(wp, j=1)
    if with_sgs:
        s_ccc = V(sp)
        s_pcc = V(sp, i=1)
        s_cpc, s_ppc = V(sp, j=1), V(sp, j=1, i=1)
        s_ccp, s_pcp = V(sp, k=1), V(sp, k=1, i=1)
        s_cpp = V(sp, k=1, j=1)

        visc_e_xy = 0.25 * (s_ccc + s_pcc + s_cpc + s_ppc)
        visc_e_xz = 0.25 * (s_ccc + s_pcc + s_ccp + s_pcp)
        visc_e_yz = 0.25 * (s_ccc + s_cpc + s_ccp + s_cpp)

    dudy_e = (u_cpc - u_ccc) * dyi      # du/dy at the (i+1/2, j+1/2) edge
    dudz_e = (u_ccp - u_ccc) * dzci_c   # du/dz at the (i+1/2, k+1/2) edge
    dvdx_e = (v_pcc - v_ccc) * dxi
    dvdz_e = (v_ccp - v_ccc) * dzci_c
    dwdx_e = (w_pcc - w_ccc) * dxi
    dwdy_e = (w_cpc - w_ccc) * dyi

    # ---- u momentum ----
    u_mcc = u_mcc_f
    u_cmc = V(up, j=-1)
    u_ccm = V(up, k=-1)
    v_pmc = V(vp, j=-1, i=1)
    w_pcm = V(wp, k=-1, i=1)

    dudx_ip = (u_pcc - u_ccc) * dxi
    dudx_im = (u_ccc - u_mcc) * dxi
    dudy_jp = dudy_e
    dudy_jm = (u_ccc - u_cmc) * dyi
    dudz_kp = dudz_e
    dudz_km = (u_ccc - u_ccm) * dzci_m

    uu_ip = 0.25 * (u_pcc + u_ccc) * (u_ccc + u_pcc)
    uu_im = 0.25 * (u_mcc + u_ccc) * (u_ccc + u_mcc)
    vu_jp = 0.25 * (v_pcc + v_ccc) * (u_ccc + u_cpc)
    vu_jm = 0.25 * (v_pmc + v_cmc) * (u_ccc + u_cmc)
    wu_kp = 0.25 * (w_pcc + w_ccc) * (u_ccc + u_ccp)
    wu_km = 0.25 * (w_pcm + w_ccm) * (u_ccc + u_ccm)

    dudtd_xy = visc * ((dudx_ip - dudx_im) * dxi
                       + (dudy_jp - dudy_jm) * dyi)
    dudtd_z = visc * (dudz_kp - dudz_km) * dzfi_c
    dudt = (-(uu_ip - uu_im) * dxi - (vu_jp - vu_jm) * dyi
            - (wu_kp - wu_km) * dzfi_c)
    if with_sgs:
        s_cmc, s_pmc = V(sp, j=-1), V(sp, j=-1, i=1)
        s_ccm, s_pcm = V(sp, k=-1), V(sp, k=-1, i=1)
        visc_ip, visc_im = s_pcc, s_ccc
        visc_jp = visc_e_xy
        visc_jm = 0.25 * (s_ccc + s_pcc + s_cmc + s_pmc)
        visc_kp = visc_e_xz
        visc_km = 0.25 * (s_ccc + s_pcc + s_ccm + s_pcm)
        dvdx_jp = dvdx_e
        dvdx_jm = (v_pmc - v_cmc) * dxi
        dwdx_kp = dwdx_e
        dwdx_km = (w_pcm - w_ccm) * dxi
        dudt = (dudt
                + (visc_ip * 2.0 * dudx_ip - visc_im * 2.0 * dudx_im) * dxi
                + (visc_jp * (dudy_jp + dvdx_jp) - visc_jm * (dudy_jm + dvdx_jm)) * dyi
                + (visc_kp * (dudz_kp + dwdx_kp) - visc_km * (dudz_km + dwdx_km)) * dzfi_c)
    u_out = (dudt, dudtd_xy, dudtd_z)

    # ---- v momentum ----
    v_pcc_f, v_mcc = v_pcc, V(vp, i=-1)
    v_cmc_f = v_cmc
    v_ccm = V(vp, k=-1)
    u_mpc = V(up, j=1, i=-1)
    w_cpm = V(wp, k=-1, j=1)

    dvdx_ip = dvdx_e
    dvdx_im = (v_ccc - v_mcc) * dxi
    dvdy_jp = (v_cpc - v_ccc) * dyi
    dvdy_jm = (v_ccc - v_cmc_f) * dyi
    dvdz_kp = dvdz_e
    dvdz_km = (v_ccc - v_ccm) * dzci_m

    uv_ip = 0.25 * (u_ccc + u_cpc) * (v_ccc + v_pcc_f)
    uv_im = 0.25 * (u_mcc_f + u_mpc) * (v_ccc + v_mcc)
    vv_jp = 0.25 * (v_ccc + v_cpc) * (v_ccc + v_cpc)
    vv_jm = 0.25 * (v_ccc + v_cmc_f) * (v_ccc + v_cmc_f)
    wv_kp = 0.25 * (w_ccc + w_cpc) * (v_ccc + v_ccp)
    wv_km = 0.25 * (w_ccm + w_cpm) * (v_ccc + v_ccm)

    dvdtd_xy = visc * ((dvdx_ip - dvdx_im) * dxi
                       + (dvdy_jp - dvdy_jm) * dyi)
    dvdtd_z = visc * (dvdz_kp - dvdz_km) * dzfi_c
    dvdt = (-(uv_ip - uv_im) * dxi - (vv_jp - vv_jm) * dyi
            - (wv_kp - wv_km) * dzfi_c)
    if with_sgs:
        s_mcc, s_mpc = V(sp, i=-1), V(sp, j=1, i=-1)
        s_cpm = V(sp, k=-1, j=1)
        s_ccm_v = V(sp, k=-1)
        visc_ip = visc_e_xy
        visc_im = 0.25 * (s_ccc + s_cpc + s_mcc + s_mpc)
        visc_jp, visc_jm = s_cpc, s_ccc
        visc_kp = visc_e_yz
        visc_km = 0.25 * (s_ccc + s_cpc + s_ccm_v + s_cpm)
        dudy_ip = dudy_e
        dudy_im = (u_mpc - u_mcc_f) * dyi
        dwdy_kp = dwdy_e
        dwdy_km = (w_cpm - w_ccm) * dyi
        dvdt = (dvdt
                + (visc_ip * (dvdx_ip + dudy_ip) - visc_im * (dvdx_im + dudy_im)) * dxi
                + (visc_jp * 2.0 * dvdy_jp - visc_jm * 2.0 * dvdy_jm) * dyi
                + (visc_kp * (dvdz_kp + dwdy_kp) - visc_km * (dvdz_km + dwdy_km)) * dzfi_c)
    v_out = (dvdt, dvdtd_xy, dvdtd_z)

    # ---- w momentum ----
    w_pcc_f, w_mcc = w_pcc, V(wp, i=-1)
    w_cpc_f, w_cmc = w_cpc, V(wp, j=-1)
    w_ccp, w_ccm_f = V(wp, k=1), w_ccm
    u_mcp = V(up, k=1, i=-1)
    u_ccp_f = u_ccp
    v_cmp = V(vp, k=1, j=-1)
    v_ccp_f = v_ccp
    v_cmc_w = v_cmc

    dwdx_ip = dwdx_e
    dwdx_im = (w_ccc - w_mcc) * dxi
    dwdy_jp = dwdy_e
    dwdy_jm = (w_ccc - w_cmc) * dyi
    dwdz_kp = (w_ccp - w_ccc) * dzfi_p
    dwdz_km = (w_ccc - w_ccm_f) * dzfi_c

    uw_ip = 0.25 * (u_ccc + u_ccp_f) * (w_ccc + w_pcc_f)
    uw_im = 0.25 * (u_mcc_f + u_mcp) * (w_ccc + w_mcc)
    vw_jp = 0.25 * (v_ccc + v_ccp_f) * (w_ccc + w_cpc_f)
    vw_jm = 0.25 * (v_cmc_w + v_cmp) * (w_ccc + w_cmc)
    ww_kp = 0.25 * (w_ccc + w_ccp) * (w_ccc + w_ccp)
    ww_km = 0.25 * (w_ccc + w_ccm_f) * (w_ccc + w_ccm_f)

    dwdtd_xy = visc * ((dwdx_ip - dwdx_im) * dxi
                       + (dwdy_jp - dwdy_jm) * dyi)
    dwdtd_z = visc * (dwdz_kp - dwdz_km) * dzci_c
    dwdt = (-(uw_ip - uw_im) * dxi - (vw_jp - vw_jm) * dyi
            - (ww_kp - ww_km) * dzci_c)
    if with_sgs:
        s_mcc_w = V(sp, i=-1)
        s_mcp = V(sp, k=1, i=-1)
        s_cmp = V(sp, k=1, j=-1)
        s_cmc2 = V(sp, j=-1)
        visc_ip = visc_e_xz
        visc_im = 0.25 * (s_ccc + s_ccp + s_mcc_w + s_mcp)
        visc_jp = visc_e_yz
        visc_jm = 0.25 * (s_ccc + s_ccp + s_cmc2 + s_cmp)
        visc_kp, visc_km = s_ccp, s_ccc
        dudz_ip = dudz_e
        dudz_im = (u_mcp - u_mcc_f) * dzci_c
        dvdz_jp = dvdz_e
        dvdz_jm = (v_cmp - v_cmc_w) * dzci_c
        dwdt = (dwdt
                + (visc_ip * (dwdx_ip + dudz_ip) - visc_im * (dwdx_im + dudz_im)) * dxi
                + (visc_jp * (dwdy_jp + dvdz_jp) - visc_jm * (dwdy_jm + dvdz_jm)) * dyi
                + (visc_kp * 2.0 * dwdz_kp - visc_km * 2.0 * dwdz_km) * dzci_c)
    w_out = (dwdt, dwdtd_xy, dwdtd_z)

    return (u_out, v_out, w_out)


def fillps(up, vp, wp, dti, dxi, dyi, dzfi):
    """RHS of the pressure-correction Poisson equation: div(u)/dt_rk
    (fillps.f90:14-48)."""
    nz = up.shape[0] - 2
    dzfi_c = _zb(dzfi, 1, nz + 1)
    return ((_sh(wp, 0, 0, 0) - _sh(wp, -1, 0, 0)) * dti * dzfi_c
            + (_sh(vp, 0, 0, 0) - _sh(vp, 0, -1, 0)) * (dti * dyi)
            + (_sh(up, 0, 0, 0) - _sh(up, 0, 0, -1)) * (dti * dxi))


def correc(up, vp, wp, pp, dt, dxi, dyi, dzci):
    """Projection: u -= dt * grad(p) on faces (correc.f90:14-68).

    Operates on padded arrays (the reference's loops extend over the
    0:n(+1) ghost range).  Returns interior (u, v, w) plus the updated
    lower-wall normal-face planes (Fortran index 0) for the state.
    """
    nz = up.shape[0] - 2
    dzci_full = jnp.asarray(dzci)[:, None, None]  # (nz+2,1,1), index k = Fortran k
    # u(i) -= dt*dxi*(p(i+1)-p(i)) for i=0..n
    u_new = up[:, :, :-1] - dt * dxi * (pp[:, :, 1:] - pp[:, :, :-1])
    v_new = vp[:, :-1, :] - dt * dyi * (pp[:, 1:, :] - pp[:, :-1, :])
    w_new = wp[:-1, :, :] - dt * dzci_full[:-1] * (pp[1:, :, :] - pp[:-1, :, :])
    u = u_new[1:-1, 1:-1, 1:]
    v = v_new[1:-1, 1:, 1:-1]
    w = w_new[1:, 1:-1, 1:-1]
    vlo = (u_new[:, :, 0], v_new[:, 0, :], w_new[0, :, :])
    return u, v, w, vlo


def updatep(ppad, p, alpha, impdiff, impdiff_1d, dxi, dyi, dzci, dzfi):
    """p += pp (+ alpha * L(pp) correction under implicit diffusion)
    (updatep.f90:14-50).  ppad: padded correction; p: interior pressure."""
    pp_c = _sh(ppad, 0, 0, 0)
    if not impdiff:
        return p + pp_c
    nz = p.shape[0]
    dzci_c = _zb(dzci, 1, nz + 1)
    dzci_m = _zb(dzci, 0, nz)
    dzfi_c = _zb(dzfi, 1, nz + 1)
    lap_z = ((_sh(ppad, 1, 0, 0) - pp_c) * dzci_c
             - (pp_c - _sh(ppad, -1, 0, 0)) * dzci_m) * dzfi_c
    lap = lap_z
    if not impdiff_1d:
        lap = lap + (_sh(ppad, 0, 0, 1) - 2 * pp_c + _sh(ppad, 0, 0, -1)) * dxi ** 2 \
                  + (_sh(ppad, 0, 1, 0) - 2 * pp_c + _sh(ppad, 0, -1, 0)) * dyi ** 2
    return p + pp_c + alpha * lap


def divergence(up, vp, wp, dxi, dyi, dzfi, mask=(False, False, False)):
    """(divtot, divmax) of the velocity field (chkdiv.f90:16-52).

    mask: per logical direction (x, y, z), exclude the first/last cell planes
    from the reductions (_MASK_DIVERGENCE_CHECK analogue for inflow/outflow
    boundaries whose edge cells are not divergence-free by construction)."""
    nz = up.shape[0] - 2
    dzfi_c = _zb(dzfi, 1, nz + 1)
    div = ((_sh(wp, 0, 0, 0) - _sh(wp, -1, 0, 0)) * dzfi_c
           + (_sh(vp, 0, 0, 0) - _sh(vp, 0, -1, 0)) * dyi
           + (_sh(up, 0, 0, 0) - _sh(up, 0, 0, -1)) * dxi)
    if any(mask):
        sl = tuple(slice(1, -1) if mask[d] else slice(None) for d in (2, 1, 0))
        div = div[sl]
    return jnp.sum(div), jnp.max(jnp.abs(div))


def cfl_dt(up, vp, wp, sp, visc, dl, dzci, dzfi, impdiff, impdiff_1d, eps):
    """Maximum stable dt (chkdt.f90:17-99): advective (sqrt(3) RK3 CFL) and
    diffusive (0.4125) limits, eddy viscosity included."""
    nz = up.shape[0] - 2
    dxi, dyi = 1.0 / dl[0], 1.0 / dl[1]
    dzfi_c = _zb(dzfi, 1, nz + 1)
    dzci_c = _zb(dzci, 1, nz + 1)

    def V(P, k=0, j=0, i=0):
        return _sh(P, k, j, i)

    ux = jnp.abs(V(up))
    vx = 0.25 * jnp.abs(V(vp) + V(vp, j=-1) + V(vp, i=1) + V(vp, j=-1, i=1))
    wx = 0.25 * jnp.abs(V(wp) + V(wp, k=-1) + V(wp, i=1) + V(wp, k=-1, i=1))
    uy = 0.25 * jnp.abs(V(up) + V(up, j=1) + V(up, j=1, i=-1) + V(up, i=-1))
    vy = jnp.abs(V(vp))
    wy = 0.25 * jnp.abs(V(wp) + V(wp, j=1) + V(wp, j=1, k=-1) + V(wp, k=-1))
    uz = 0.25 * jnp.abs(V(up) + V(up, i=-1) + V(up, i=-1, k=1) + V(up, k=1))
    vz = 0.25 * jnp.abs(V(vp) + V(vp, j=-1) + V(vp, j=-1, k=1) + V(vp, k=1))
    wz = jnp.abs(V(wp))
    dtix = ux * dxi + vx * dyi + wx * dzfi_c
    dtiy = uy * dxi + vy * dyi + wy * dzfi_c
    dtiz = uz * dxi + vz * dyi + wz * dzci_c
    dti = jnp.max(jnp.maximum(jnp.maximum(dtix, dtiy), dtiz))

    dl2i = dxi * dxi + dyi * dyi
    viscx = 0.5 * (V(sp) + V(sp, i=1))
    viscy = 0.5 * (V(sp) + V(sp, j=1))
    viscz = 0.5 * (V(sp) + V(sp, k=1))
    dtidx = viscx * (dl2i + dzfi_c ** 2)
    dtidy = viscy * (dl2i + dzfi_c ** 2)
    dtidz = viscz * (dl2i + dzci_c ** 2)
    if not impdiff:
        dtidx = dtidx + visc * (dl2i + dzfi_c ** 2)
        dtidy = dtidy + visc * (dl2i + dzfi_c ** 2)
        dtidz = dtidz + visc * (dl2i + dzci_c ** 2)
    elif impdiff_1d:
        dtidx = dtidx + visc * dl2i
        dtidy = dtidy + visc * dl2i
        dtidz = dtidz + visc * dl2i
    dtid = jnp.max(jnp.maximum(jnp.maximum(dtidx, dtidy), dtidz))

    dti = jnp.where(dti == 0.0, 1.0, dti)
    dtid = jnp.where(dtid == 0.0, eps, dtid)
    return jnp.minimum(0.4125 / dtid, 1.732 / dti)


def strain_rate(up, vp, wp, dzci, dzfi, dxi, dyi, with_sij=False):
    """Cell-centered S_ij and |S| = sqrt(2 S_ij S_ij) (sgs.f90:1019-1110):
    diagonal terms exact at centers, off-diagonals edge-averaged (.125)."""
    nz = up.shape[0] - 2
    metrics = {
        'dzci_c': _zb(dzci, 1, nz + 1),
        'dzci_m': _zb(dzci, 0, nz),
        'dzfi_c': _zb(dzfi, 1, nz + 1),
    }

    def V(P, k=0, j=0, i=0):
        return _sh(P, k, j, i)

    return strain_rate_core(V, metrics.__getitem__, up, vp, wp, dxi, dyi,
                            with_sij=with_sij)


def strain_rate_core(V, M, up, vp, wp, dxi, dyi, with_sij=False):
    """strain_rate discretization against the (V, M) accessor interface
    (see momentum_rhs_core)."""
    dzci_c = M('dzci_c')
    dzci_m = M('dzci_m')
    dzfi_c = M('dzfi_c')

    s11 = (V(up) - V(up, i=-1)) * dxi
    s22 = (V(vp) - V(vp, j=-1)) * dyi
    s33 = (V(wp) - V(wp, k=-1)) * dzfi_c
    s12 = 0.125 * ((V(up, j=1) - V(up)) * dyi + (V(vp, i=1) - V(vp)) * dxi
                   + (V(up) - V(up, j=-1)) * dyi + (V(vp, j=-1, i=1) - V(vp, j=-1)) * dxi
                   + (V(up, j=1, i=-1) - V(up, i=-1)) * dyi + (V(vp) - V(vp, i=-1)) * dxi
                   + (V(up, i=-1) - V(up, j=-1, i=-1)) * dyi
                   + (V(vp, j=-1) - V(vp, j=-1, i=-1)) * dxi)
    s13 = 0.125 * ((V(up, k=1) - V(up)) * dzci_c + (V(wp, i=1) - V(wp)) * dxi
                   + (V(up) - V(up, k=-1)) * dzci_m + (V(wp, k=-1, i=1) - V(wp, k=-1)) * dxi
                   + (V(up, k=1, i=-1) - V(up, i=-1)) * dzci_c + (V(wp) - V(wp, i=-1)) * dxi
                   + (V(up, i=-1) - V(up, k=-1, i=-1)) * dzci_m
                   + (V(wp, k=-1) - V(wp, k=-1, i=-1)) * dxi)
    s23 = 0.125 * ((V(vp, k=1) - V(vp)) * dzci_c + (V(wp, j=1) - V(wp)) * dyi
                   + (V(vp) - V(vp, k=-1)) * dzci_m + (V(wp, k=-1, j=1) - V(wp, k=-1)) * dyi
                   + (V(vp, k=1, j=-1) - V(vp, j=-1)) * dzci_c + (V(wp) - V(wp, j=-1)) * dyi
                   + (V(vp, j=-1) - V(vp, k=-1, j=-1)) * dzci_m
                   + (V(wp, k=-1) - V(wp, k=-1, j=-1)) * dyi)
    s0 = jnp.sqrt(2.0 * (s11 ** 2 + s22 ** 2 + s33 ** 2
                         + 2.0 * (s12 ** 2 + s13 ** 2 + s23 ** 2)))
    if with_sij:
        return s0, (s11, s22, s33, s12, s13, s23)
    return s0


def filter3d(ppad):
    """27-point top-hat test filter = separable (1,2,1)/4 passes along each
    axis (sgs.f90:616-680; the (8,4,2,1)/64 weights factor exactly)."""
    q = 0.25 * (ppad[:, :, :-2] + 2.0 * ppad[:, :, 1:-1] + ppad[:, :, 2:])
    q = 0.25 * (q[:, :-2, :] + 2.0 * q[:, 1:-1, :] + q[:, 2:, :])
    q = 0.25 * (q[:-2, :, :] + 2.0 * q[1:-1, :, :] + q[2:, :, :])
    return q


def filter2d(ppad):
    """9-point wall-parallel (x,y) top-hat filter (sgs.f90:824-848)."""
    q = 0.25 * (ppad[:, :, :-2] + 2.0 * ppad[:, :, 1:-1] + ppad[:, :, 2:])
    q = 0.25 * (q[:, :-2, :] + 2.0 * q[:, 1:-1, :] + q[:, 2:, :])
    return q[1:-1]


def interp_center(up, vp, wp):
    """Velocity interpolated to cell centers (sgs.f90:850-870)."""
    uc = 0.5 * (_sh(up, 0, 0, 0) + _sh(up, 0, 0, -1))
    vc = 0.5 * (_sh(vp, 0, 0, 0) + _sh(vp, 0, -1, 0))
    wc = 0.5 * (_sh(wp, 0, 0, 0) + _sh(wp, -1, 0, 0))
    return uc, vc, wc


def bulk_mean(f, grid_vol_ratio):
    """Volume-weighted mean (utils.f90:16-47); grid_vol_ratio: (nz,) weights
    dx*dy*dzf(k)/V.  Two-stage: plane sums then a tiny weighted dot."""
    plane = jnp.sum(f, axis=(1, 2))
    return jnp.dot(plane, jnp.asarray(grid_vol_ratio, dtype=f.dtype))


def scalar_rhs_core(V, M, up, vp, wp, sp, alpha, dxi, dyi):
    """Passive-scalar advection-diffusion RHS through the accessor
    interface (scal.f90:14-51), evaluated by scal.scalar_rhs.
    V(field, k=, j=, i=) reads a shifted plane; M(name) reads the
    z metric ('dzci_c', 'dzci_m', 'dzfi_c'); alpha = visc/Pr."""
    s_c = V(sp)
    usim = 0.5 * (V(sp, i=-1) + s_c) * V(up, i=-1)
    usip = 0.5 * (V(sp, i=1) + s_c) * V(up)
    vsjm = 0.5 * (V(sp, j=-1) + s_c) * V(vp, j=-1)
    vsjp = 0.5 * (V(sp, j=1) + s_c) * V(vp)
    wskm = 0.5 * (V(sp, k=-1) + s_c) * V(wp, k=-1)
    wskp = 0.5 * (V(sp, k=1) + s_c) * V(wp)
    dsdxp = (V(sp, i=1) - s_c) * dxi
    dsdxm = (s_c - V(sp, i=-1)) * dxi
    dsdyp = (V(sp, j=1) - s_c) * dyi
    dsdym = (s_c - V(sp, j=-1)) * dyi
    dsdzp = (V(sp, k=1) - s_c) * M('dzci_c')
    dsdzm = (s_c - V(sp, k=-1)) * M('dzci_m')
    return (dxi * (-usip + usim) + (dsdxp - dsdxm) * alpha * dxi
            + dyi * (-vsjp + vsjm) + (dsdyp - dsdym) * alpha * dyi
            + M('dzfi_c') * (-wskp + wskm)
            + (dsdzp - dsdzm) * alpha * M('dzfi_c'))
