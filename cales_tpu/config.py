"""Runtime configuration for the JAX CaLES rebuild.

Mirrors the reference's ``input.nml`` namelists ``&dns``/``&les``
(``/root/reference/src/param.f90:95-120``) plus every compile-time ``#ifdef``
of the reference turned into a runtime switch
(``/root/reference/configs/flags.mk.example:84-140``, SURVEY.md §5.6).

Boundary conditions are one-letter strings 'P' (periodic), 'D' (Dirichlet),
'N' (Neumann) per (face 0/1, direction x/y/z, velocity component), as in the
reference (``param.f90:58-63``).

Index conventions used throughout this package:
  * logical sizes/BCs are ordered (x, y, z) like the reference;
  * **array layout is (z, y, x)** (C order).  This matches the Fortran
    column-major (x fastest) memory layout bit-for-bit while keeping x
    contiguous (batched FFTs along the last axis, coalesced loads) and z on
    the leading axis (tridiagonal sweeps walk contiguous (ny, nx) planes).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

# RK3 low-storage coefficients, reference param.f90:27-30
RK_COEFF = ((32.0 / 60.0, 0.0),
            (25.0 / 60.0, -17.0 / 60.0),
            (45.0 / 60.0, -25.0 / 60.0))
KAP_LOG = 0.41     # param.f90:31
B_LOG = 5.20       # param.f90:32
C_SMAG = 0.11      # param.f90:33

X, Y, Z = 0, 1, 2  # logical direction indices

# map logical direction -> array axis for the (z, y, x) layout
DIR_TO_AXIS = {X: 2, Y: 1, Z: 0}
AXIS_TO_DIR = {2: X, 1: Y, 0: Z}


def _t3(v):
    t = tuple(v)
    assert len(t) == 3
    return t


@dataclass(frozen=True)
class Config:
    """Full solver configuration (the reference's &dns + &les namelists)."""

    # --- grid & domain (reference &dns) ---
    ng: tuple[int, int, int]               # global grid (nx, ny, nz)
    l: tuple[float, float, float]          # domain size (lx, ly, lz)
    gtype: int = 1                         # z-grid stretching type (initgrid.f90:20-25)
    gr: float = 0.0                        # stretching parameter

    # --- time stepping ---
    cfl: float = 0.95
    dtmax: float = 1.0e9
    dt_f: float = -1.0                     # fixed dt if > 0
    visci: float = 1.0                     # inverse viscosity (Reynolds number)

    # --- initial condition ---
    inivel: str = 'zer'
    is_wallturb: bool = False

    # --- stopping criteria ---
    nstep: int = 100
    time_max: float = 100.0
    tw_max: float = 0.1
    stop_type: tuple[bool, bool, bool] = (True, False, False)

    # --- checkpoint / output cadences ---
    restart: bool = False
    is_overwrite_save: bool = True
    nsaves_max: int = 0
    icheck: int = 10
    iout0d: int = 10
    iout1d: int = 100
    iout2d: int = 500
    iout3d: int = 1000
    isave: int = 5000

    # --- boundary conditions ---
    # cbcvel[ibound][idir][ivel], like the reference cbcvel(0:1,1:3,1:3)
    cbcvel: tuple = ((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),
                     (('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')))
    bcvel: tuple = (((0.,) * 3,) * 3, ((0.,) * 3,) * 3)
    # cbcpre[ibound][idir]
    cbcpre: tuple = (('P', 'P', 'N'), ('P', 'P', 'N'))
    bcpre: tuple = ((0., 0., 0.), (0., 0., 0.))
    cbcsgs: tuple = (('P', 'P', 'N'), ('P', 'P', 'N'))
    bcsgs: tuple = ((0., 0., 0.), (0., 0., 0.))

    # --- forcing ---
    bforce: tuple[float, float, float] = (0., 0., 0.)
    is_forced: tuple[bool, bool, bool] = (False, False, False)
    velf: tuple[float, float, float] = (0., 0., 0.)

    # --- decomposition (mesh shape over (x, y); z always local) ---
    dims: tuple[int, int] = (1, 1)

    # --- LES (&les namelist) ---
    sgstype: str = 'none'                  # 'none' | 'smag' | 'dsmag'
    lwm: tuple = ((0, 0, 0), (0, 0, 0))    # wall-model type per (face, dir): 0 off, 1 log-law, -1 laminar
    hwm: float = 0.0                       # wall-model matching height
    # dynamic-Smagorinsky averaging directions; replaces the reference's
    # compile-time #define _CHANNEL/_DIT/_DUCT/_CAVITY (sgs.f90:8,359-370).
    # 'dit' -> average over x,y,z; 'channel' -> x,y; 'duct' -> x; 'cavity' -> none
    dsmag_avg: str = 'channel'
    filter_2d: bool = False                # reference _FILTER_2D

    # --- numerics switches (reference compile-time flags -> runtime) ---
    impdiff: bool = False                  # _IMPDIFF
    impdiff_1d: bool = False               # _IMPDIFF_1D (implies impdiff)
    # exclude boundary-adjacent cells of non-periodic directions from the
    # divergence abort check (the reference's _MASK_DIVERGENCE_CHECK build
    # flag, configs/flags.mk.example:129-131; for inflow/outflow cases whose
    # outflow cell is not divergence-free by construction)
    mask_divergence_check: bool = False
    # out3d decimation (the nskip argument of write_visu_3d, out3d.h90 /
    # output.f90:191-242), logical (x, y, z) order
    nskip_out3d: tuple[int, int, int] = (1, 1, 1)
    # running time-average of the out1d channel statistics (the reference
    # leaves this to post-processing; see io/averaging.py)
    stats_avg: bool = False
    dtype: str = 'float32'                 # _SINGLE_PRECISION analogue ('float32'|'float64')
    # z direct solver: 'eig' (dense eigenbasis matmuls), 'thomas' (batched
    # tridiagonal sweep), or 'auto' (poisson.resolve_zsolver: thomas on one
    # GPU, eig elsewhere)
    zsolver: str = 'auto'
    # periodic-direction transform: 'fft' (jnp.fft.rfft, cuFFT on the GPU),
    # 'mat' (real half-complex DFT operator matrix), or 'auto' (= 'fft')
    ptransform: str = 'auto'

    # --- passive scalar (reference ships scal.f90/rk_scal unwired;
    #     here it is an opt-in part of the time loop) ---
    scalar: bool = False
    pr: float = 1.0                        # Prandtl number (alpha = visc/pr)
    iniscal: str = 'zer'                   # 'zer' | 'uni'
    cbcscal: tuple = (('P', 'P', 'N'), ('P', 'P', 'N'))
    bcscal: tuple = ((0., 0., 0.), (0., 0., 0.))
    ssource: float = 0.0
    is_sforced: bool = False
    scalf: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, 'ng', _t3(self.ng))
        object.__setattr__(self, 'l', _t3(self.l))
        if self.impdiff_1d:
            object.__setattr__(self, 'impdiff', True)

    # ---- derived quantities (param.f90:153-157) ----
    @property
    def dl(self):
        return tuple(self.l[i] / self.ng[i] for i in range(3))

    @property
    def dli(self):
        return tuple(1.0 / d for d in self.dl)

    @property
    def visc(self):
        return 1.0 / self.visci

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    # shape of interior arrays in the (z, y, x) layout
    @property
    def shape_zyx(self):
        return (self.ng[2], self.ng[1], self.ng[0])

    def cbc_pre(self, idir: int) -> str:
        """Pressure BC pair for direction idir, e.g. 'PP'."""
        return self.cbcpre[0][idir] + self.cbcpre[1][idir]

    def cbc_vel(self, idir: int, ivel: int) -> str:
        return self.cbcvel[0][idir][ivel] + self.cbcvel[1][idir][ivel]

    def replace(self, **kw) -> 'Config':
        return dataclasses.replace(self, **kw)


def effective_cbcvel(cfg: Config) -> tuple:
    """Velocity BCs after wall-model overrides (bound.f90:746-758):
    on a wall-modeled face the wall-normal component becomes 'D' and the
    wall-parallel components become 'N'."""
    cbc = [[[cfg.cbcvel[ib][idir][ivel] for ivel in range(3)] for idir in range(3)]
           for ib in range(2)]
    for idir in range(3):
        for ib in range(2):
            if cfg.lwm[ib][idir] != 0:
                for ivel in range(3):
                    cbc[ib][idir][ivel] = 'D' if ivel == idir else 'N'
    return tuple(tuple(tuple(r) for r in b) for b in cbc)


def validate(cfg: Config) -> None:
    """Input sanity checks, porting the validation tables of
    /root/reference/src/sanity.f90:33-302."""
    # stop criterion set (sanity.f90:68-77)
    if not any(cfg.stop_type):
        raise ValueError('no stopping criterion selected')
    # BC letters (sanity.f90:114-163)
    cbcvel = effective_cbcvel(cfg)
    for ib in range(2):
        for idir in range(3):
            for ivel in range(3):
                if cbcvel[ib][idir][ivel] not in 'PDN':
                    raise ValueError(f'invalid velocity BC {cbcvel[ib][idir][ivel]}')
            if cfg.cbcpre[ib][idir] not in 'PDN':
                raise ValueError(f'invalid pressure BC {cfg.cbcpre[ib][idir]}')
    # periodicity must be two-sided and component-consistent
    for idir in range(3):
        for ivel in range(3):
            pair = cbcvel[0][idir][ivel] + cbcvel[1][idir][ivel]
            if 'P' in pair and pair != 'PP':
                raise ValueError(f'one-sided periodic velocity BC in dir {idir}')
        pairp = cfg.cbc_pre(idir)
        if 'P' in pairp and pairp != 'PP':
            raise ValueError(f'one-sided periodic pressure BC in dir {idir}')
        # velocity normal-component / pressure compatibility (sanity.f90:165-220)
        pairv = cbcvel[0][idir][idir] + cbcvel[1][idir][idir]
        ok = {('PP', 'PP'), ('ND', 'DN'), ('DN', 'ND'), ('NN', 'DD'), ('DD', 'NN')}
        if (pairv, pairp) not in ok:
            raise ValueError(
                f'velocity/pressure BC pair ({pairv},{pairp}) in dir {idir} not allowed')
    # wall-model walls must have been Dirichlet walls (sanity.f90:221-230)
    for idir in range(3):
        for ib in range(2):
            if cfg.lwm[ib][idir] != 0:
                if cfg.cbcvel[ib][idir][idir] != 'D':
                    raise ValueError('wall model requires a Dirichlet (wall) face')
    # hwm within first..last cell-center band (sanity.f90:233-241), checked in grid setup
    if any(cfg.lwm[ib][idir] != 0 for ib in range(2) for idir in range(3)):
        if not (cfg.hwm > 0.0):
            raise ValueError('wall model height hwm must be positive')
    # implicit diffusion restrictions (sanity.f90:243-270): with impdiff (full 3D),
    # x/y velocity BCs must be P or mirror-symmetric ones handled by the solver
    if cfg.impdiff and not cfg.impdiff_1d:
        for idir in (X, Y):
            for ivel in range(3):
                pair = cbcvel[0][idir][ivel] + cbcvel[1][idir][ivel]
                if pair not in ('PP', 'NN', 'DD', 'ND', 'DN'):
                    raise ValueError('unsupported BC for implicit diffusion')
    # forcing requires a periodic direction (sanity.f90:285-302)
    for idir in range(3):
        if cfg.is_forced[idir] and cfg.cbc_pre(idir) != 'PP':
            raise ValueError(f'forcing in non-periodic direction {idir}')
    if cfg.sgstype not in ('none', 'smag', 'dsmag'):
        raise ValueError(f'unknown SGS model {cfg.sgstype!r}')
    if cfg.dsmag_avg not in ('dit', 'channel', 'duct', 'cavity'):
        raise ValueError(f'unknown dsmag averaging {cfg.dsmag_avg!r}')
    if cfg.zsolver not in ('auto', 'eig', 'thomas'):
        raise ValueError(f'unknown z solver {cfg.zsolver!r}')
    if cfg.ptransform not in ('auto', 'fft', 'mat'):
        raise ValueError(f'unknown periodic transform {cfg.ptransform!r}')
