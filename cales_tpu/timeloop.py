"""Time integration: RK3 + pressure projection, fully jitted per step.

JAX rebuild of the reference hot loop:
  * RK3 low-storage update      /root/reference/src/rk.f90:17-121
  * substep orchestration       /root/reference/src/main.f90:417-507
  * bulk-velocity forcing       rk.f90:197-222, mom.f90:311-335
  * implicit Crank–Nicolson viscous solves (runtime ``impdiff``/``impdiff_1d``
    instead of compile flags)   main.f90:423-491

One full time step (3 RK substeps, each with momentum RHS, projection solve,
BC fills, SGS update) compiles to a single XLA program; the Python driver only
handles cadenced I/O and dt refresh (main.f90:405-619).  Each substep follows
the reference's sequence (SURVEY §3.2): momentum + RK update, bulk forcing,
CN Helmholtz solves, projection, SGS.
"""
from __future__ import annotations

from typing import NamedTuple, Any

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config, RK_COEFF, effective_cbcvel
from .grid import Grid
from . import poisson
from .ops import boundary as bnd
from .ops import stencil as st
from .ops import transforms as tr
from .runtime import default_device
from . import sgs as sgsmod
from . import wallmodel as wm
from . import scal as scalmod


class State(NamedTuple):
    u: Any
    v: Any
    w: Any
    p: Any
    visct: Any
    vlo: Any          # (u_lo, v_lo, w_lo) lower-wall normal-face planes
    rhs_old: Any      # (du, dv, dw) previous-substep explicit RHS
    time: Any
    istep: Any
    s: Any = None         # optional passive scalar (scal.f90)
    dsdt_old: Any = None  # previous-substep scalar RHS (rk.f90:149-150)


class Simulation:
    """Static solver setup + jitted step function.

    mesh: optional jax.sharding.Mesh ('gy','gx') for multi-device domain
    decomposition; fields shard (z, y:gy, x:gx) and the Poisson stages
    reshard via constraint hints (parallel/mesh.py).

    The step is traced in the configuration's own precision whatever the
    process-wide ``jax_enable_x64`` flag says, so float32 and float64
    Simulations can share one process.
    """

    def __init__(self, cfg: Config, grid: Grid, mesh=None):
        from .parallel.mesh import ShardingHints
        self.mesh = mesh
        self.hints = ShardingHints(mesh) if mesh is not None else None
        self.cfg = cfg
        self.grid = grid
        self.dtype = cfg.np_dtype
        self.device = default_device(mesh)
        self.cbcvel = effective_cbcvel(cfg)
        self.cbcpre = tuple((cfg.cbcpre[0][d], cfg.cbcpre[1][d]) for d in range(3))
        cbcpre_pairs = tuple(cfg.cbc_pre(d) for d in range(3))
        nx, ny, nz = cfg.ng

        # Poisson solver for the pressure correction (initsolver, main.f90:312)
        platform = self.device.platform
        sharded = mesh is not None
        zsolver = poisson.resolve_zsolver(cfg.zsolver, platform, sharded)
        self.solver_p = poisson.make_solver(cfg, grid, cbcpre_pairs, ('c', 'c', 'c'),
                                            zsolver=zsolver, platform=platform,
                                            sharded=sharded)
        # static BC value planes (initbc, bound.f90:726-806)
        by_dir = lambda vals: tuple(tuple(vals[ib][idir] for ib in range(2))
                                    for idir in range(3))
        self.bcp_vals = bnd.make_bc_values(cfg.ng, by_dir(cfg.bcpre), self.dtype)
        self.bcs_vals = bnd.make_bc_values(cfg.ng, by_dir(cfg.bcsgs), self.dtype)
        bcvel_by_dir = lambda ivel: tuple(
            tuple(cfg.bcvel[ib][idir][ivel] for ib in range(2)) for idir in range(3))
        self.bcu_vals = bnd.make_bc_values(cfg.ng, bcvel_by_dir(0), self.dtype)
        self.bcv_vals = bnd.make_bc_values(cfg.ng, bcvel_by_dir(1), self.dtype)
        self.bcw_vals = bnd.make_bc_values(cfg.ng, bcvel_by_dir(2), self.dtype)
        # wall-model state
        self.has_wm = any(cfg.lwm[ib][d] != 0 for ib in range(2) for d in range(3))
        self.index_wm = wm.find_index_wm(cfg, grid) if self.has_wm else None
        # y/z-only wall models with scalar static BCs: update the wm
        # Neumann planes from sliced rows instead of full-field pads (four
        # rows are read; the pad would write three whole fields).  The
        # wall model never reads dynamically-filled ghosts — the generic
        # path pads with the STATIC values before updating — so row slices
        # x/y- (z walls) or x/z-filled (y walls) with the static scalars
        # are bit-identical inputs.
        scalar_bcs = all(
            np.isscalar(b[idir][ib]) or np.ndim(b[idir][ib]) == 0
            for b in (self.bcu_vals, self.bcv_vals, self.bcw_vals)
            for idir in range(3) for ib in range(2))
        self._wm_fast = (
            self.has_wm
            and not any(cfg.lwm[ib][0] != 0 for ib in range(2))
            and scalar_bcs)
        # pressure BC RHS planes (cmpt_rhs_b, main.f90:317)
        self.rhsb_p = poisson.rhs_bound_planes(
            cfg, grid, self.cbcpre, ('c', 'c', 'c'),
            tuple(tuple(cfg.bcpre[ib][d] for ib in range(2)) for d in range(3)))
        # Helmholtz solvers for implicit diffusion (main.f90:318-334)
        self.c_or_f = {0: ('f', 'c', 'c'), 1: ('c', 'f', 'c'), 2: ('c', 'c', 'f')}
        if cfg.impdiff:
            self.solver_vel = []
            for ivel in range(3):
                cbc = tuple(self.cbcvel[0][d][ivel] + self.cbcvel[1][d][ivel]
                            for d in range(3))
                self.solver_vel.append(
                    poisson.make_solver(cfg, grid, cbc, self.c_or_f[ivel],
                                        zsolver=zsolver, platform=platform,
                                        sharded=sharded))
        # SGS setup
        self.sgs_setup = sgsmod.SGSSetup(cfg, grid, self.cbcvel)
        # bulk-forcing volume weights (main.f90:282-283)
        vol = cfg.l[0] * cfg.l[1] * cfg.l[2]
        self.gvr_c = (cfg.dl[0] * cfg.dl[1] * grid.dzc[1:nz + 1] / vol).astype(self.dtype)
        self.gvr_f = (cfg.dl[0] * cfg.dl[1] * grid.dzf[1:nz + 1] / vol).astype(self.dtype)

        # pin the (z-major, x-minor) layout on single-device GPU runs:
        # 2.5% faster per channel-LES step on an H100 (PERF.md)
        self._use_layout_pin = (mesh is None
                                and self.device.platform == 'gpu')

        # benchmark instrumentation: skip the pressure solve (pp = 0) so the
        # Poisson fraction can be measured by difference (bench.py --matrix);
        # set BEFORE the first step call (the step traces lazily)
        self.ablate_solve = False
        self._step = jax.jit(self._step_impl)
        self._chk = jax.jit(self._chk_impl)
        self._init_jit = jax.jit(self._init_impl)

    # ------------------------------------------------------------------
    def exec_path(self) -> str:
        """One-line description of how this Simulation runs — logged at
        startup (the reference prints its decomposition/backends,
        initmpi.f90:104-139): device, transform per axis, z solver and
        the matmul precision of the operator contractions."""
        sv = self.solver_p
        dev = f'{self.device.platform} ({self.device.device_kind})'
        if self.mesh is not None:
            dev += f', mesh {dict(self.mesh.shape)}'
        return (f'{dev}; transforms x={sv.trx.kind} y={sv.try_.kind}; '
                f'z solver {poisson.z_solver_name(sv)}; '
                f'matmul precision {tr.precision_name(self.dtype)}; '
                f'{self.cfg.dtype}')

    def _x64(self):
        # trace and run in the config's precision: with x64 on, the float64
        # grid metrics would otherwise promote a float32 step
        return jax.enable_x64(self.dtype == np.float64)

    # ------------------------------------------------------------------
    def initial_state(self, u, v, w, p) -> State:
        dt = self.dtype
        with self._x64():
            z = lambda a: jnp.asarray(a, dtype=dt)
            u, v, w, p = z(u), z(v), z(w), z(p)
            zeros = jnp.zeros_like(u)
            nx, ny, nz = self.cfg.ng
            vlo = (jnp.zeros((nz + 2, ny + 2), dt),
                   jnp.zeros((nz + 2, nx + 2), dt),
                   jnp.zeros((ny + 2, nx + 2), dt))
            sfield = None
            ds_old = None
            if self.cfg.scalar:
                sfield = (jnp.ones_like(u) if self.cfg.iniscal == 'uni'
                          else jnp.zeros_like(u))
                ds_old = jnp.zeros_like(u)
            st0 = State(u=u, v=v, w=w, p=p, visct=zeros, vlo=vlo,
                        rhs_old=(zeros, zeros, zeros),
                        time=jnp.zeros((), dt),
                        istep=jnp.zeros((), jnp.int32),
                        s=sfield, dsdt_old=ds_old)
            return self._init_jit(st0)

    def _init_impl(self, st0: State):
        # initial BC fill + SGS (main.f90:370-375)
        u, v, w = st0.u, st0.v, st0.w
        bcu, bcv, bcw = self._dynamic_bcs(u, v, w)
        up, vp, wp, vlo = bnd.pad_velocity(
            u, v, w, self.cbcvel, bcu, bcv, bcw, self.cfg.dl, self.grid.dzc,
            self.grid.dzf, vlo=None, is_correc=False)
        visct = self._compute_sgs(up, vp, wp).astype(self.dtype)
        u_i, v_i, w_i = (up[1:-1, 1:-1, 1:-1], vp[1:-1, 1:-1, 1:-1],
                         wp[1:-1, 1:-1, 1:-1])
        return st0._replace(u=u_i, v=v_i, w=w_i, vlo=vlo, visct=visct)

    # ------------------------------------------------------------------
    def _dynamic_bcs(self, u, v, w):
        """Velocity BC planes; wall-modeled faces get fresh Neumann values
        from the log-law (bounduvw is_updt_wm path, bound.f90:120-123)."""
        bcu, bcv, bcw = self.bcu_vals, self.bcv_vals, self.bcw_vals
        if not self.has_wm:
            return bcu, bcv, bcw
        if self._wm_fast:
            return self._wm_bcs_fast(u, v, w)
        return self._wm_bcs_full(u, v, w)

    def _wm_bcs_full(self, u, v, w):
        """Wall-model BC update from full-field pads (any wall topology)."""
        bcu, bcv, bcw = self.bcu_vals, self.bcv_vals, self.bcw_vals
        up, vp, wp, _ = bnd.pad_velocity(
            u, v, w, self.cbcvel, bcu, bcv, bcw, self.cfg.dl, self.grid.dzc,
            self.grid.dzf, vlo=None, is_correc=False)
        return wm.update_wallmodel_bcs(
            self.cfg, self.grid, up, vp, wp, bcu, bcv, bcw,
            self.bcu_vals, self.bcv_vals, self.bcw_vals, self.index_wm)

    def _row_pad_xy(self, plane, ivel):
        """x/y ghost fill of one (ny, nx) z-row — the only rows the z-wall
        wall model reads (scalar x/y BCs, gated by _wm_fast)."""
        face_key = ('x', 'y', 'z')[ivel]
        bcs = (self.bcu_vals, self.bcv_vals, self.bcw_vals)[ivel]
        dl = self.cfg.dl
        s = plane[None]
        for key, idir in (('x', 0), ('y', 1)):
            axis = bnd.AX[key]
            lts = (self.cbcvel[0][idir][ivel], self.cbcvel[1][idir][ivel])
            dr = (dl[idir], dl[idir])
            if key == face_key:
                s = bnd._set_face(s, axis, lts, bcs[idir], dr)
            else:
                s = bnd._set_centered(s, axis, lts, bcs[idir], dr)
        return s[0]

    def _row_pad_xz(self, plane, ivel):
        """x/z ghost fill of one (nz, nx) y-row (static scalar BCs)."""
        face_key = ('x', 'y', 'z')[ivel]
        bcs = (self.bcu_vals, self.bcv_vals, self.bcw_vals)[ivel]
        dl = self.cfg.dl
        dzc, dzf = self.grid.dzc, self.grid.dzf
        nz = plane.shape[0]
        s = plane[:, None, :]
        for key, idir in (('x', 0), ('z', 2)):
            axis = bnd.AX[key]
            lts = (self.cbcvel[0][idir][ivel], self.cbcvel[1][idir][ivel])
            if key == 'x':
                dr_par = dr_nrm = (dl[0], dl[0])
            else:
                dr_par = (float(dzc[0]), float(dzc[nz]))
                dr_nrm = (float(dzf[0]), float(dzf[nz]))
            if key == face_key:
                s = bnd._set_face(s, axis, lts, bcs[idir], dr_nrm)
            else:
                s = bnd._set_centered(s, axis, lts, bcs[idir], dr_par)
        return s[:, 0, :]

    def _wm_bcs_fast(self, u, v, w):
        """y/z-wall wall-model BC update from sliced rows instead of a
        full-field pad (identical numbers: the x->y fill of a z-row only
        reads that row, and likewise the x->z fill of a y-row)."""
        from .ops.boundary import bc_plane_shapes, ensure_plane
        cfg = self.cfg
        shapes = bc_plane_shapes(cfg.ng)
        dtype = u.dtype
        bcu_z = list(self.bcu_vals[2])
        bcv_z = list(self.bcv_vals[2])
        for ib in range(2):
            if cfg.lwm[ib][2] == 0:
                continue
            k2 = self.index_wm[2][ib]
            k1 = k2 - 1 if ib == 0 else k2 + 1
            U1 = self._row_pad_xy(u[k1 - 1], 0)
            U2 = self._row_pad_xy(u[k2 - 1], 0)
            V1 = self._row_pad_xy(v[k1 - 1], 1)
            V2 = self._row_pad_xy(v[k2 - 1], 1)
            umag = ensure_plane(self.bcu_vals[2][ib], shapes['z'], dtype)
            vmag = ensure_plane(self.bcv_vals[2][ib], shapes['z'], dtype)
            bcu_z[ib], bcv_z[ib] = wm.z_wall_wm_planes(
                cfg, self.grid, U1, U2, V1, V2, umag, vmag,
                umag, vmag, ib, self.index_wm)
        bcu_y = list(self.bcu_vals[1])
        bcw_y = list(self.bcw_vals[1])
        for ib in range(2):
            if cfg.lwm[ib][1] == 0:
                continue
            j2 = self.index_wm[1][ib]
            j1 = j2 - 1 if ib == 0 else j2 + 1
            U1 = self._row_pad_xz(u[:, j1 - 1], 0)
            U2 = self._row_pad_xz(u[:, j2 - 1], 0)
            W1 = self._row_pad_xz(w[:, j1 - 1], 2)
            W2 = self._row_pad_xz(w[:, j2 - 1], 2)
            umag = ensure_plane(self.bcu_vals[1][ib], shapes['y'], dtype)
            wmag = ensure_plane(self.bcw_vals[1][ib], shapes['y'], dtype)
            bcu_y[ib], bcw_y[ib] = wm.y_wall_wm_planes(
                cfg, self.grid, U1, U2, W1, W2, umag, wmag,
                umag, wmag, ib, self.index_wm)
        bcu = (self.bcu_vals[0], tuple(bcu_y), tuple(bcu_z))
        bcv = (self.bcv_vals[0], self.bcv_vals[1], tuple(bcv_z))
        bcw = (self.bcw_vals[0], tuple(bcw_y), self.bcw_vals[2])
        return bcu, bcv, bcw

    def _pad_vel(self, u, v, w, bcu, bcv, bcw, vlo=None, is_correc=False):
        return bnd.pad_velocity(u, v, w, self.cbcvel, bcu, bcv, bcw,
                                self.cfg.dl, self.grid.dzc, self.grid.dzf,
                                vlo=vlo, is_correc=is_correc)

    def _lc(self, x):
        if not self._use_layout_pin or x.ndim != 3:
            return x
        from jax.experimental.layout import Layout
        from jax.experimental.layout import with_layout_constraint
        return with_layout_constraint(x, Layout(major_to_minor=(0, 1, 2)))

    def _pad_p(self, p):
        return bnd.pad_scalar(p, self.cbcpre, self.bcp_vals,
                              self.cfg.dl, self.grid.dzc)

    def _pad_s(self, s):
        cbcs = tuple((self.cfg.cbcsgs[0][d], self.cfg.cbcsgs[1][d]) for d in range(3))
        return bnd.pad_scalar(s, cbcs, self.bcs_vals, self.cfg.dl, self.grid.dzc)

    def _pad_scal(self, s):
        cfg = self.cfg
        cbcs = tuple((cfg.cbcscal[0][d], cfg.cbcscal[1][d]) for d in range(3))
        by_dir = tuple(tuple(float(cfg.bcscal[ib][idir]) for ib in range(2))
                       for idir in range(3))
        return bnd.pad_scalar(s, cbcs, by_dir, cfg.dl, self.grid.dzc)

    def _compute_sgs(self, up, vp, wp):
        cfg = self.cfg
        if cfg.sgstype == 'none':
            return jnp.zeros([s - 2 for s in up.shape], dtype=up.dtype)
        if cfg.sgstype == 'smag':
            return sgsmod.smag_visct(self.sgs_setup, cfg, self.grid, up, vp, wp)

        # dynamic Smagorinsky: filtered velocities are re-BC'd with the static
        # planes and no wall-model update (sgs.f90:256-257, bcuf=bcu at init)
        def pad_filtered(uf, vf, wf):
            ufp, vfp, wfp, _ = self._pad_vel(uf, vf, wf, self.bcu_vals,
                                             self.bcv_vals, self.bcw_vals)
            return ufp, vfp, wfp

        return sgsmod.dsmag_visct(self.sgs_setup, cfg, self.grid, up, vp, wp,
                                  self.bcs_vals, None, pad_filtered)

    # ------------------------------------------------------------------
    def _momentum(self, state, u, v, w, p, visct, f1, f2, first):
        """Momentum RHS + RK update (+ scalar advance) on padded fields
        (mom.f90 + rk.f90).  Returns (u, v, w, rhs_old, (rud, rvd, rwd),
        scal_state, (bcu, bcv, bcw)) -- the beginning-of-substep BC
        planes feed the CN Helmholtz RHS."""
        cfg, grid = self.cfg, self.grid
        dxi, dyi = cfg.dli[0], cfg.dli[1]
        dzci, dzfi = grid.dzci, grid.dzfi
        f12 = f1 + f2
        ru_o, rv_o, rw_o = state.rhs_old
        scal_state = None
        # ghosts of the current state (same fill the previous substep left)
        bcu, bcv, bcw = self._dynamic_bcs(u, v, w)
        up, vp, wp, _ = self._pad_vel(u, v, w, bcu, bcv, bcw,
                                      vlo=state.vlo, is_correc=True)
        ppad = self._pad_p(p)
        hs = cfg.sgstype != 'none'
        sp = self._pad_s(visct) if hs else None

        # momentum RHS + explicit/implicit split (rk.f90:74-75,
        # mom.f90:277-303); sgstype 'none' elides the (identically
        # zero) eddy-stress terms and the visct ghost fill
        with jax.named_scope('momentum_rhs'):
            (eu, exyu, ezu), (ev, exyv, ezv), (ew, exyw, ezw) = \
                st.momentum_rhs(up, vp, wp, sp, cfg.visc, dxi, dyi,
                                dzci, dzfi, with_sgs=hs)
        if not cfg.impdiff:
            ru, rv, rw = eu + exyu + ezu, ev + exyv + ezv, ew + exyw + ezw
            rud = rvd = rwd = None
        elif cfg.impdiff_1d:
            ru, rv, rw = eu + exyu, ev + exyv, ew + exyw
            rud, rvd, rwd = ezu, ezv, ezw
        else:
            ru, rv, rw = eu, ev, ew
            rud, rvd, rwd = exyu + ezu, exyv + ezv, exyw + ezw

        # passive scalar advance with the beginning-of-substep velocity
        # (rk_scal, rk.f90:123-195)
        if cfg.scalar:
            spad = self._pad_scal(state.s)
            dsdt = scalmod.scalar_rhs(up, vp, wp, spad, cfg.visc / cfg.pr,
                                      dxi, dyi, dzci, dzfi)
            s_new = state.s + f1 * dsdt + f12 * cfg.ssource
            if not first:
                s_new = s_new + f2 * state.dsdt_old
            if cfg.is_sforced:
                s_new = s_new + (cfg.scalf - st.bulk_mean(s_new, self.gvr_f))
            scal_state = (s_new, dsdt)

        # RK update with pressure gradient + body force (rk.f90:77-94)
        dzci_c = jnp.asarray(dzci[1:u.shape[0] + 1])[:, None, None]
        gpx = dxi * (ppad[1:-1, 1:-1, 2:] - ppad[1:-1, 1:-1, 1:-1])
        gpy = dyi * (ppad[1:-1, 2:, 1:-1] - ppad[1:-1, 1:-1, 1:-1])
        gpz = dzci_c * (ppad[2:, 1:-1, 1:-1] - ppad[1:-1, 1:-1, 1:-1])
        u = u + f1 * ru + f12 * (cfg.bforce[0] - gpx)
        v = v + f1 * rv + f12 * (cfg.bforce[1] - gpy)
        w = w + f1 * rw + f12 * (cfg.bforce[2] - gpz)
        if not first:
            u = u + f2 * ru_o
            v = v + f2 * rv_o
            w = w + f2 * rw_o
        if cfg.impdiff:
            u = u + f12 * rud
            v = v + f12 * rvd
            w = w + f12 * rwd
        return (u, v, w, (ru, rv, rw), (rud, rvd, rwd), scal_state,
                (bcu, bcv, bcw))

    def _bulk_forcing(self, u, v, w):
        """Bulk-velocity forcing controller (rk.f90:197-222 +
        mom.f90:311-335).  Returns (u, v, w, f)."""
        cfg = self.cfg
        f = [jnp.zeros((), u.dtype)] * 3
        if cfg.is_forced[0]:
            f[0] = cfg.velf[0] - st.bulk_mean(u, self.gvr_f)
            u = u + f[0]
        if cfg.is_forced[1]:
            f[1] = cfg.velf[1] - st.bulk_mean(v, self.gvr_f)
            v = v + f[1]
        if cfg.is_forced[2]:
            f[2] = cfg.velf[2] - st.bulk_mean(w, self.gvr_c)
            w = w + f[2]
        return u, v, w, f

    def _cn_stage(self, u, v, w, bcu, bcv, bcw, rud, rvd, rwd, f12, alpha):
        """Crank-Nicolson Helmholtz solves (main.f90:423-491): the
        implicit-diffusion viscous solve per velocity component, z-only
        (impdiff_1d) or full 3D.  No-op when impdiff is off."""
        cfg, grid = self.cfg, self.grid
        if not cfg.impdiff:
            return u, v, w
        out = []
        for ivel, (fld, bcf, rd) in enumerate(((u, bcu, rud), (v, bcv, rvd),
                                               (w, bcw, rwd))):
            fld = fld - 0.5 * f12 * rd
            cbc = tuple((self.cbcvel[0][d][ivel], self.cbcvel[1][d][ivel])
                        for d in range(3))
            cf = self.c_or_f[ivel]
            planes = poisson.rhs_bound_planes_dyn(cfg, grid, cbc, cf, bcf)
            planes = {k: alpha * v_ for k, v_ in planes.items()}
            if cfg.impdiff_1d:
                # _IMPDIFF_1D: only the z-face planes enter the z-only solve
                fld = poisson.solve_z_only(
                    self.solver_vel[ivel], fld, alpha,
                    bc_planes=(planes[('z', 0)], planes[('z', 1)]))
            else:
                fld = poisson.add_rhs_bound(cfg, cf, cbc, fld, planes)
                fld = poisson.solve(self.solver_vel[ivel], fld, alpha=alpha,
                                    hints=self.hints)
            out.append(fld)
        return tuple(out)

    def _projection(self, u, v, w, p, dtrk, alpha):
        """Projection (fillps -> solve -> correc -> updatep on padded
        fields, main.f90:493-503).  Returns (u, v, w, p, vlo, up, vp, wp)
        -- the post-correction padded fields feed the SGS stage."""
        cfg, grid = self.cfg, self.grid
        dxi, dyi = cfg.dli[0], cfg.dli[1]
        dzci, dzfi = grid.dzci, grid.dzfi
        # prediction-velocity BC fill (main.f90:493-494)
        bcu, bcv, bcw = self._dynamic_bcs(u, v, w)
        up, vp, wp, vlo = self._pad_vel(u, v, w, bcu, bcv, bcw,
                                        is_correc=False)

        # projection (main.f90:495-499)
        with jax.named_scope('poisson'):
            rhs = st.fillps(up, vp, wp, 1.0 / dtrk, dxi, dyi, dzfi)
            rhs = poisson.add_rhs_bound(cfg, ('c', 'c', 'c'), self.cbcpre,
                                        rhs, self.rhsb_p)
            pp = (jnp.zeros_like(rhs) if self.ablate_solve else
                  poisson.solve(self.solver_p, rhs, hints=self.hints))
        pppad = self._pad_p(pp)
        u, v, w, vlo = st.correc(up, vp, wp, pppad, dtrk, dxi, dyi, dzci)

        # post-correction BC fill, keeping corrected wall-normal values
        # (main.f90:500-501, is_correc=.true.)
        bcu, bcv, bcw = self._dynamic_bcs(u, v, w)
        up, vp, wp, vlo = self._pad_vel(u, v, w, bcu, bcv, bcw,
                                        vlo=vlo, is_correc=True)

        # pressure update (main.f90:502-503)
        p = st.updatep(pppad, p, alpha, cfg.impdiff, cfg.impdiff_1d,
                       dxi, dyi, dzci, dzfi)
        return u, v, w, p, vlo, up, vp, wp

    def _substep(self, state: State, f1, f2, first=False):
        """first=True: this is RK substep 1, whose f2 coefficient is exactly
        zero (RK_COEFF[0][1]) — the previous-RHS fields are never read."""
        cfg = self.cfg
        f12 = f1 + f2
        u, v, w, p, visct = state.u, state.v, state.w, state.p, state.visct
        if self.hints is not None:
            u, v, w, p, visct = map(self.hints.field, (u, v, w, p, visct))
            if cfg.scalar:
                state = state._replace(s=self.hints.field(state.s))
        u, v, w, p, visct = map(self._lc, (u, v, w, p, visct))

        (u, v, w, rhs_old, (rud, rvd, rwd), scal_state,
         (bcu, bcv, bcw)) = self._momentum(state, u, v, w, p, visct,
                                           f1, f2, first)
        u, v, w, f = self._bulk_forcing(u, v, w)
        alpha = -0.5 * cfg.visc * f12
        u, v, w = self._cn_stage(u, v, w, bcu, bcv, bcw, rud, rvd, rwd,
                                 f12, alpha)
        u, v, w, p, vlo, up, vp, wp = self._projection(u, v, w, p, f12, alpha)

        # SGS eddy viscosity (main.f90:504-506)
        with jax.named_scope('sgs'):
            visct = self._compute_sgs(up, vp, wp)

        if self.hints is not None:
            # pin the output sharding to the canonical field layout —
            # otherwise GSPMD may emit the state in a solver-stage sharding
            # (e.g. z-split) and every step boundary pays an all-to-all
            u, v, w, p, visct = map(self.hints.field, (u, v, w, p, visct))
        upd = dict(u=u, v=v, w=w, p=p, visct=visct, vlo=vlo, rhs_old=rhs_old)
        if cfg.scalar:
            upd['s'], upd['dsdt_old'] = scal_state
            if self.hints is not None:
                upd['s'] = self.hints.field(upd['s'])
                upd['dsdt_old'] = self.hints.field(upd['dsdt_old'])
        return state._replace(**upd), jnp.stack(f)

    def _step_impl(self, state: State, dt):
        """One full time step = 3 RK substeps (main.f90:417-507), one XLA
        program (single dispatch through the runtime per step)."""
        dpdl = jnp.zeros(3, dtype=self.dtype)
        for irk in range(3):
            f1 = RK_COEFF[irk][0] * dt
            f2 = RK_COEFF[irk][1] * dt
            state, f = self._substep(state, f1, f2,
                                     first=(RK_COEFF[irk][1] == 0.0))
            dpdl = dpdl + f
        state = state._replace(time=state.time + dt, istep=state.istep + 1)
        return state, -dpdl / dt

    def step(self, state: State, dt):
        with self._x64():
            return self._step(state, jnp.asarray(dt, dtype=self.dtype))

    def multi_step(self, state: State, dt, nsteps: int) -> State:
        """Advance `nsteps` steps in ONE device program (lax.fori_loop) —
        used for benchmarking (single dispatch, device-side throughput) and
        long unattended advances without host round trips.

        N.B. donates `state`: the input buffers are consumed; always continue
        from the returned state.  `step` does not donate, so library users
        can branch multiple runs from one state."""
        if not hasattr(self, '_multi'):
            def run(state, dt, n):
                def body(_, st):
                    st2, _ = self._step_impl(st, dt)
                    return st2
                return jax.lax.fori_loop(0, n, body, state)
            self._multi = jax.jit(run, static_argnums=2, donate_argnums=0)
        with self._x64():
            return self._multi(state, jnp.asarray(dt, dtype=self.dtype),
                               nsteps)

    # ------------------------------------------------------------------
    def _chk_impl(self, state: State):
        """dt limit + divergence diagnostics (chkdt.f90, chkdiv.f90)."""
        cfg = self.cfg
        bcu, bcv, bcw = self._dynamic_bcs(state.u, state.v, state.w)
        up, vp, wp, _ = self._pad_vel(state.u, state.v, state.w, bcu, bcv, bcw,
                                      vlo=state.vlo, is_correc=True)
        sp = self._pad_s(state.visct)
        eps = float(np.finfo(self.dtype).eps)
        dt_cfl = st.cfl_dt(up, vp, wp, sp, cfg.visc, cfg.dl, self.grid.dzci,
                           self.grid.dzfi, cfg.impdiff, cfg.impdiff_1d, eps)
        mask = (False,) * 3
        if cfg.mask_divergence_check:
            mask = tuple(cfg.cbc_pre(d) != 'PP' for d in range(3))
        divtot, divmax = st.divergence(up, vp, wp, cfg.dli[0], cfg.dli[1],
                                       self.grid.dzfi, mask=mask)
        return dt_cfl, divtot, divmax

    def check(self, state: State):
        with self._x64():
            dt_cfl, divtot, divmax = self._chk(state)
        return float(dt_cfl), float(divtot), float(divmax)

    def padded_state(self, state: State):
        """Ghost-filled (up, vp, wp, ppad, sppad) with the solver's exact BC
        semantics (incl. wall-model Neumann values and retained wall faces) —
        used by the statistics layer, which must read the same ghost values
        as the reference's out1d routines do through boundp/bounduvw
        (output.f90:509-1061)."""
        if not hasattr(self, '_padded_jit'):
            def impl(state):
                bcu, bcv, bcw = self._dynamic_bcs(state.u, state.v, state.w)
                up, vp, wp, _ = self._pad_vel(state.u, state.v, state.w,
                                              bcu, bcv, bcw,
                                              vlo=state.vlo, is_correc=True)
                return up, vp, wp, self._pad_p(state.p), self._pad_s(state.visct)
            self._padded_jit = jax.jit(impl)
        with self._x64():
            return tuple(np.asarray(a) for a in self._padded_jit(state))

    def pick_dt(self, dt_cfl: float) -> float:
        cfg = self.cfg
        if cfg.dt_f > 0:
            return cfg.dt_f
        return min(cfg.cfl * dt_cfl, cfg.dtmax)
