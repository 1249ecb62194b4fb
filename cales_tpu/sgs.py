"""SGS eddy-viscosity models: none / static Smagorinsky (van Driest damped) /
dynamic Smagorinsky (Germano–Lilly).

Port of /root/reference/src/sgs.f90:
  * dispatch + models: cmpt_sgs (21-386)
  * one-sided wall handling via ghost extrapolation: extrapolate (682-767)
  * filter-ratio field alpha^2 (4.0 interior, 2.52 first off-wall layer):
    cmpt_alph2 (769-822)
  * test filters: filter3d (616-680, separable here), filter2d (824-848)
  * averaging over homogeneous directions: ave0d/ave1d/ave2d (388-614) —
    the compile-time #define _DIT/_CHANNEL/_DUCT/_CAVITY choice becomes the
    runtime config ``dsmag_avg``.

All pieces are jit-traceable; averages over homogeneous directions are plain
means (psum-compatible when sharded).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .config import Config, C_SMAG
from .grid import Grid
from .ops import boundary as bnd
from .ops import stencil as st


def extrapolate(p, iface, flags, factors):
    """Linear extrapolation of ghost planes at flagged walls
    (sgs.f90:682-767).  p: padded field; iface: 0 (cell-centered) or 1/2/3
    (the component's own face direction, skipped); flags[(ib,idir)]: bool;
    factors: (f_lo_z, f_hi_z) z-direction stretching factors.

    Ghost faces are re-attached by slice+concatenate (fusible) rather
    than .at[].set (full-array dynamic-update-slice); see ops/boundary.py.
    """
    f0, f1 = factors

    def replace(q, axis, lo, do_lo, hi, do_hi):
        parts = []
        idx_lo = [slice(None)] * 3
        idx_lo[axis] = slice(1, None) if do_lo else slice(None)
        if do_hi:
            idx_lo[axis] = slice(1, -1) if do_lo else slice(0, -1)
        body = q[tuple(idx_lo)]
        if do_lo:
            parts.append(jnp.expand_dims(lo, axis))
        parts.append(body)
        if do_hi:
            parts.append(jnp.expand_dims(hi, axis))
        return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else body

    if iface != 1 and (flags.get((0, 0)) or flags.get((1, 0))):
        p = replace(p, 2,
                    2.0 * p[:, :, 1] - p[:, :, 2], bool(flags.get((0, 0))),
                    2.0 * p[:, :, -2] - p[:, :, -3], bool(flags.get((1, 0))))
    if iface != 2 and (flags.get((0, 1)) or flags.get((1, 1))):
        p = replace(p, 1,
                    2.0 * p[:, 1, :] - p[:, 2, :], bool(flags.get((0, 1))),
                    2.0 * p[:, -2, :] - p[:, -3, :], bool(flags.get((1, 1))))
    if iface != 3 and (flags.get((0, 2)) or flags.get((1, 2))):
        p = replace(p, 0,
                    (1.0 + f0) * p[1] - f0 * p[2], bool(flags.get((0, 2))),
                    (1.0 + f1) * p[-2] - f1 * p[-3], bool(flags.get((1, 2))))
    return p


class SGSSetup:
    """Static (trace-time) SGS data derived from config + grid."""

    def __init__(self, cfg: Config, grid: Grid, cbcvel_eff):
        nx, ny, nz = cfg.ng
        self.cfg = cfg
        self.cbcvel = cbcvel_eff
        # wall flags: Dirichlet normal-component faces (sgs.f90:76-81)
        self.wall_flags = {}
        self.lwm_flags = {}
        for idir in range(3):
            for ib in range(2):
                self.wall_flags[(ib, idir)] = cbcvel_eff[ib][idir][idir] == 'D'
                self.lwm_flags[(ib, idir)] = cfg.lwm[ib][idir] != 0
        dzci = grid.dzci
        dzc = grid.dzc
        # z extrapolation factors (sgs.f90:705-717)
        self.fac_cbc = (1.0, 1.0)
        self.fac_lwm = (dzc[0] * dzci[1], dzc[nz] * dzci[nz - 1])
        # filter width Delta = (dx dy dzf)^(1/3) (sgs.f90:148)
        self.delta = (cfg.dl[0] * cfg.dl[1] * grid.dzf[1:nz + 1]) ** (1.0 / 3.0)
        # van Driest wall-distance profiles as *1D* arrays, broadcast in
        # the step (a precomputed 3D field would be inlined as a megabyte
        # HLO literal and wreck compile time)
        dl = cfg.dl
        i = np.arange(1, nx + 1)
        j = np.arange(1, ny + 1)
        zc = grid.zc[1:nz + 1]
        self.dw1d = [
            (dl[0] * (i - 0.5), 2),          # x-low:  varies along axis 2
            (dl[0] * (nx - i + 0.5), 2),     # x-high
            (dl[1] * (j - 0.5), 1),          # y-low:  varies along axis 1
            (dl[1] * (ny - j + 0.5), 1),     # y-high
            (zc.copy(), 0),                  # z-low:  varies along axis 0
            (cfg.l[2] - zc, 0),              # z-high
        ]
        self.is_wall6 = [self.wall_flags[(ib, idir)]
                         for idir in range(3) for ib in range(2)]
        self.any_wall = any(self.is_wall6)

    def alph2_field(self, shape, dtype):
        """alpha^2 filter-ratio field, built in-trace (sgs.f90:769-822):
        4.0 interior, 2.52 first off-wall layer (2.52 everywhere for the 2D
        filter)."""
        if self.cfg.filter_2d:
            return jnp.full(shape, 2.52, dtype=dtype)
        a = jnp.full(shape, 4.0, dtype=dtype)
        if self.wall_flags[(0, 0)]:
            a = a.at[:, :, 0].set(2.52)
        if self.wall_flags[(1, 0)]:
            a = a.at[:, :, -1].set(2.52)
        if self.wall_flags[(0, 1)]:
            a = a.at[:, 0, :].set(2.52)
        if self.wall_flags[(1, 1)]:
            a = a.at[:, -1, :].set(2.52)
        if self.wall_flags[(0, 2)]:
            a = a.at[0].set(2.52)
        if self.wall_flags[(1, 2)]:
            a = a.at[-1].set(2.52)
        return a


def _wall_tauw_planes(setup, up, vp, wp, dxi, dyi, dzci, visc):
    """|tau_w| estimate at each of the 6 walls from one-sided gradients
    (sgs.f90:117-143), broadcast to 3D."""
    nz = up.shape[0] - 2
    out = []
    # x-low / x-high: gradients of v, w across the first/last x faces
    t1 = vp[1:-1, 1:-1, 1] - vp[1:-1, 1:-1, 0] + vp[1:-1, 0:-2, 1] - vp[1:-1, 0:-2, 0]
    t2 = wp[1:-1, 1:-1, 1] - wp[1:-1, 1:-1, 0] + wp[0:-2, 1:-1, 1] - wp[0:-2, 1:-1, 0]
    out.append(jnp.sqrt(t1 ** 2 + t2 ** 2)[:, :, None] * dxi)
    t1 = vp[1:-1, 1:-1, -2] - vp[1:-1, 1:-1, -1] + vp[1:-1, 0:-2, -2] - vp[1:-1, 0:-2, -1]
    t2 = wp[1:-1, 1:-1, -2] - wp[1:-1, 1:-1, -1] + wp[0:-2, 1:-1, -2] - wp[0:-2, 1:-1, -1]
    out.append(jnp.sqrt(t1 ** 2 + t2 ** 2)[:, :, None] * dxi)
    # y-low / y-high: gradients of u, w
    t1 = up[1:-1, 1, 1:-1] - up[1:-1, 0, 1:-1] + up[1:-1, 1, 0:-2] - up[1:-1, 0, 0:-2]
    t2 = wp[1:-1, 1, 1:-1] - wp[1:-1, 0, 1:-1] + wp[0:-2, 1, 1:-1] - wp[0:-2, 0, 1:-1]
    out.append(jnp.sqrt(t1 ** 2 + t2 ** 2)[:, None, :] * dyi)
    t1 = up[1:-1, -2, 1:-1] - up[1:-1, -1, 1:-1] + up[1:-1, -2, 0:-2] - up[1:-1, -1, 0:-2]
    t2 = wp[1:-1, -2, 1:-1] - wp[1:-1, -1, 1:-1] + wp[0:-2, -2, 1:-1] - wp[0:-2, -1, 1:-1]
    out.append(jnp.sqrt(t1 ** 2 + t2 ** 2)[:, None, :] * dyi)
    # z-low / z-high: gradients of u, v, metric dzci(0) / dzci(nz)
    t1 = up[1, 1:-1, 1:-1] - up[0, 1:-1, 1:-1] + up[1, 1:-1, 0:-2] - up[0, 1:-1, 0:-2]
    t2 = vp[1, 1:-1, 1:-1] - vp[0, 1:-1, 1:-1] + vp[1, 0:-2, 1:-1] - vp[0, 0:-2, 1:-1]
    out.append((jnp.sqrt(t1 ** 2 + t2 ** 2) * dzci[0])[None, :, :])
    t1 = up[-2, 1:-1, 1:-1] - up[-1, 1:-1, 1:-1] + up[-2, 1:-1, 0:-2] - up[-1, 1:-1, 0:-2]
    t2 = vp[-2, 1:-1, 1:-1] - vp[-1, 1:-1, 1:-1] + vp[-2, 0:-2, 1:-1] - vp[-1, 0:-2, 1:-1]
    out.append((jnp.sqrt(t1 ** 2 + t2 ** 2) * dzci[nz + 1 - 1])[None, :, :])
    return out


def smag_visct(setup: SGSSetup, cfg, grid, up, vp, wp):
    """Static Smagorinsky with van Driest damping (sgs.f90:69-152)."""
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    visc = cfg.visc
    # one-sided gradients at wall-modeled walls via extrapolated copies
    ue = extrapolate(up, 1, setup.lwm_flags, setup.fac_lwm)
    ve = extrapolate(vp, 2, setup.lwm_flags, setup.fac_lwm)
    we = extrapolate(wp, 3, setup.lwm_flags, setup.fac_lwm)
    s0 = st.strain_rate(ue, ve, we, grid.dzci, grid.dzfi, dxi, dyi)
    delta = jnp.asarray(setup.delta, dtype=s0.dtype)[:, None, None]
    if not setup.any_wall:
        fd = 1.0
    else:
        tauw6 = _wall_tauw_planes(setup, up, vp, wp, dxi, dyi, grid.dzci, visc)
        active = [m for m in range(6) if setup.is_wall6[m]]
        axes = {setup.dw1d[m][1] for m in active}
        if len(axes) == 1:
            # walls along a single direction (channel/Couette class): the
            # nearest-wall choice is a static 1D mask along that axis —
            # one select instead of a chain of minimum/where passes
            ax = axes.pop()
            profs = np.stack([setup.dw1d[m][0] for m in active])
            near = np.argmin(profs, axis=0)            # (n_ax,) static
            dw_1d = profs[near, np.arange(profs.shape[1])]
            shape1 = [1, 1, 1]
            shape1[ax] = len(dw_1d)
            dw_min = jnp.asarray(dw_1d, dtype=s0.dtype).reshape(shape1)
            if len(active) == 1:
                tauw_s = jnp.broadcast_to(tauw6[active[0]], s0.shape)
            else:
                mask = jnp.asarray(near == 0).reshape(shape1)
                tauw_s = jnp.where(mask,
                                   jnp.broadcast_to(tauw6[active[0]], s0.shape),
                                   jnp.broadcast_to(tauw6[active[1]], s0.shape))
        else:
            # general case (duct/cavity): sequential running-min over the six
            # walls (first minimum wins ties, matching the reference's minloc,
            # sgs.f90:104-146); distances broadcast from 1D profiles in-trace
            dw_min = jnp.full_like(s0, 1e30)
            tauw_s = jnp.zeros_like(s0)
            for m in active:
                prof, ax = setup.dw1d[m]
                shape1 = [1, 1, 1]
                shape1[ax] = len(prof)
                dw_m = jnp.broadcast_to(
                    jnp.asarray(prof, dtype=s0.dtype).reshape(shape1), s0.shape)
                closer = dw_m < dw_min
                tauw_s = jnp.where(closer,
                                   jnp.broadcast_to(tauw6[m], s0.shape), tauw_s)
                dw_min = jnp.minimum(dw_min, dw_m)
        tauw_s = 0.5 * visc * tauw_s
        dw_plus = dw_min * jnp.sqrt(tauw_s) / visc
        fd = 1.0 - jnp.exp(-dw_plus / 25.0)
    return (C_SMAG * delta * fd) ** 2 * s0


def dsmag_visct(setup: SGSSetup, cfg, grid, up, vp, wp, bcs_vals, bc_static,
                pad_vel_fn):
    """Dynamic Smagorinsky (Germano–Lilly, sgs.f90:153-380).

    pad_vel_fn(u, v, w) must apply the filtered-velocity BC fill (the
    reference's bounduvw with is_updt_wm=.false., sgs.f90:256-257).
    Returns the *total* eddy viscosity field (clipped >= 0).
    """
    dxi, dyi = cfg.dli[0], cfg.dli[1]
    dzci, dzfi = grid.dzci, grid.dzfi
    dl, dzc = cfg.dl[:2], grid.dzc
    cbcs = tuple((cfg.cbcsgs[0][d], cfg.cbcsgs[1][d]) for d in range(3))

    def boundp(f):
        return bnd.pad_scalar(f, cbcs, bcs_vals, dl, dzc)

    use2d = cfg.filter_2d
    filt = st.filter2d if use2d else st.filter3d

    def filt_prod(interior_fields):
        """boundp + (3D: extrapolate at walls) + test filter, per field."""
        outs = []
        for f in interior_fields:
            fp = boundp(f)
            if not use2d:
                fp = extrapolate(fp, 0, setup.wall_flags, setup.fac_cbc)
            outs.append(filt(fp))
        return outs

    # grid-level strain rate with one-sided wall-model gradients
    ue = extrapolate(up, 1, setup.lwm_flags, setup.fac_lwm)
    ve = extrapolate(vp, 2, setup.lwm_flags, setup.fac_lwm)
    we = extrapolate(wp, 3, setup.lwm_flags, setup.fac_lwm)
    s0, sij = st.strain_rate(ue, ve, we, dzci, dzfi, dxi, dyi, with_sij=True)
    visct = s0

    # Mij: filtered(|S| Sij) (sgs.f90:189-223)
    s0p = boundp(s0)
    sijp = [boundp(s) for s in sij]
    prods_pad = [s0p * sp_ for sp_ in sijp]  # |S| Sij with ghosts for the filter
    if not use2d:
        prods_pad = [extrapolate(q, 0, setup.wall_flags, setup.fac_cbc)
                     for q in prods_pad]
    mij = [filt(q) for q in prods_pad]

    # filtered velocity (sgs.f90:225-260)
    if not use2d:
        ue2 = extrapolate(up, 1, setup.wall_flags, setup.fac_cbc)
        ve2 = extrapolate(vp, 2, setup.wall_flags, setup.fac_cbc)
        we2 = extrapolate(wp, 3, setup.wall_flags, setup.fac_cbc)
        ufi, vfi, wfi = filt(ue2), filt(ve2), filt(we2)
    else:
        ufi, vfi, wfi = filt(up), filt(vp), filt(wp)
    ufp, vfp, wfp = pad_vel_fn(ufi, vfi, wfi)
    ufp = extrapolate(ufp, 1, setup.lwm_flags, setup.fac_lwm)
    vfp = extrapolate(vfp, 2, setup.lwm_flags, setup.fac_lwm)
    wfp = extrapolate(wfp, 3, setup.lwm_flags, setup.fac_lwm)
    s0f, sijf = st.strain_rate(ufp, vfp, wfp, dzci, dzfi, dxi, dyi, with_sij=True)
    alph2 = setup.alph2_field(s0.shape, s0.dtype)
    mij = [2.0 * (m - alph2 * s0f * sf) for m, sf in zip(mij, sijf)]

    # Lij (sgs.f90:274-327)
    uc, vc, wc = st.interp_center(up, vp, wp)
    ucp, vcp, wcp = boundp(uc), boundp(vc), boundp(wc)
    pairs = [(ucp, ucp), (vcp, vcp), (wcp, wcp), (ucp, vcp), (ucp, wcp), (vcp, wcp)]
    prods_pad = [a * b for a, b in pairs]
    if not use2d:
        prods_pad = [extrapolate(q, 0, setup.wall_flags, setup.fac_cbc)
                     for q in prods_pad]
        ucp = extrapolate(ucp, 0, setup.wall_flags, setup.fac_cbc)
        vcp = extrapolate(vcp, 0, setup.wall_flags, setup.fac_cbc)
        wcp = extrapolate(wcp, 0, setup.wall_flags, setup.fac_cbc)
    lij = [filt(q) for q in prods_pad]
    ucf, vcf, wcf = filt(ucp), filt(vcp), filt(wcp)
    fpairs = [(ucf, ucf), (vcf, vcf), (wcf, wcf), (ucf, vcf), (ucf, wcf), (vcf, wcf)]
    lij = [l - a * b for l, (a, b) in zip(lij, fpairs)]

    # contraction + homogeneous-direction averaging (sgs.f90:328-370)
    num = sum(m * l for m, l in zip(mij[:3], lij[:3])) \
        + 2.0 * sum(m * l for m, l in zip(mij[3:], lij[3:]))
    den = sum(m * m for m in mij[:3]) + 2.0 * sum(m * m for m in mij[3:])
    avg = cfg.dsmag_avg
    if avg == 'dit':
        wz = jnp.asarray(grid.dzf[1:s0.shape[0] + 1] / cfg.l[2], dtype=s0.dtype)
        wz = wz[:, None, None] / (s0.shape[1] * s0.shape[2])
        num = jnp.sum(num * wz) * jnp.ones_like(num)
        den = jnp.sum(den * wz) * jnp.ones_like(den)
    elif avg == 'channel':
        num = jnp.mean(num, axis=(1, 2), keepdims=True) * jnp.ones_like(num)
        den = jnp.mean(den, axis=(1, 2), keepdims=True) * jnp.ones_like(den)
    elif avg == 'duct':
        num = jnp.mean(num, axis=2, keepdims=True) * jnp.ones_like(num)
        den = jnp.mean(den, axis=2, keepdims=True) * jnp.ones_like(den)
    # 'cavity': no averaging
    visct = visct * num / den
    return jnp.maximum(visct, 0.0)
