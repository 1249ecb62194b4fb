"""Flow-case Config builders (see package docstring)."""
from __future__ import annotations

import math

from ..config import Config

PI = math.pi

_P3 = (('P',) * 3,) * 3
_PERIODIC = dict(cbcvel=(_P3, _P3),
                 cbcpre=(('P',) * 3, ('P',) * 3),
                 cbcsgs=(('P',) * 3, ('P',) * 3))
_CHAN_V = (('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D'))
# sgs BC at solid walls is 'D' (value 0) throughout the reference examples:
# the antisymmetric ghost zeroes visct at the wall face, so wall-modeled
# Neumann fluxes stay exactly visc*bc = tauw (see validation/wmles_channel.py)
_CHANNEL = dict(cbcvel=(_CHAN_V, _CHAN_V),
                cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
                cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))


def triperiodic_dns(ng=(64, 64, 64), l=(1., 1., 1.), visci=1000., **kw):
    """Decaying isotropic turbulence box (examples/dns/triperiodic)."""
    return Config(ng=ng, l=l, visci=visci, inivel='zer', **_PERIODIC, **kw)


def taylor_green_2d(ng=(64, 64, 8), visci=100., **kw):
    """2D Taylor-Green with analytic decay (dns/taylor_green_vortex_2d)."""
    return Config(ng=ng, l=(2 * PI, 2 * PI, 1.), visci=visci, inivel='tgw',
                  **_PERIODIC, **kw)


def taylor_green_3d(ng=(64, 64, 64), visci=1600., **kw):
    """3D Taylor-Green vortex (dns/_manuscript_taylor_green_vortex)."""
    return Config(ng=ng, l=(2 * PI,) * 3, visci=visci, inivel='tgv',
                  **_PERIODIC, **kw)


def channel_dns(ng=(128, 96, 96), visci=5640., lz=2.0, gr=1.5, **kw):
    """Turbulent channel DNS, bulk-velocity forced
    (dns/_manuscript_turbulent_channel; visci=5640 -> Re_tau ~ 180)."""
    return Config(ng=ng, l=(4 * PI, 2 * PI, lz), gtype=1, gr=gr, visci=visci,
                  inivel='poi', is_wallturb=True,
                  is_forced=(True, False, False), velf=(1., 0., 0.),
                  **_CHANNEL, **kw)


def channel_les(ng=(128, 96, 96), visci=20000., sgstype='smag', **kw):
    """Wall-resolved channel LES (les/_manuscript_turbulent_channel)."""
    return channel_dns(ng=ng, visci=visci, sgstype=sgstype, **kw)


def channel_wmles(ng=(192, 72, 48), visci=125000., hwm=0.1, **kw):
    """Wall-modeled channel LES, log-law walls
    (les/_manuscript_turbulent_channel_wall_model)."""
    return Config(ng=ng, l=(12.8, 4.8, 2.), gtype=6, visci=visci,
                  inivel='poi', is_wallturb=True,
                  is_forced=(True, False, False), velf=(1., 0., 0.),
                  sgstype='smag', lwm=((0, 0, 1), (0, 0, 1)), hwm=hwm,
                  **_CHANNEL, **kw)


def half_channel(ng=(64, 64, 32), visci=5000., **kw):
    """Half-channel: wall at the bottom, free-slip top
    (dns/half_channel; 'hcp'/'hcl' profiles)."""
    v = (('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D'))
    vt = (('P', 'P', 'P'), ('P', 'P', 'P'), ('N', 'N', 'D'))
    return Config(ng=ng, l=(2 * PI, PI, 1.), visci=visci, inivel='hcp',
                  is_forced=(True, False, False), velf=(1., 0., 0.),
                  cbcvel=(v, vt),
                  cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
                  cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')), **kw)


def couette(ng=(64, 48, 32), visci=1000., uwall=0.5, **kw):
    """Plane Couette flow (dns/couette): walls move at +/- uwall."""
    bcv = [[[0.] * 3 for _ in range(3)] for _ in range(2)]
    bcv[0][2][0] = uwall
    bcv[1][2][0] = -uwall
    return Config(ng=ng, l=(2 * PI, PI, 1.), visci=visci, inivel='cou',
                  bcvel=tuple(tuple(tuple(r) for r in b) for b in bcv),
                  **_CHANNEL, **kw)


def lid_driven_cavity(ng=(64, 64, 64), visci=1000., ulid=1.0, **kw):
    """Lid-driven cavity (examples/dns/lid_driven_cavity and the
    _manuscript variant): fully enclosed box — Dirichlet walls in ALL
    THREE directions — with the z-top lid moving in x, exactly the
    reference's BC table (input.nml cbcvel all 'D', bcvel(1,3,1)=1)."""
    v = (('D', 'D', 'D'), ('D', 'D', 'D'), ('D', 'D', 'D'))
    bcv = [[[0.] * 3 for _ in range(3)] for _ in range(2)]
    bcv[1][2][0] = ulid
    return Config(ng=ng, l=(1., 1., 1.), visci=visci, inivel='zer',
                  cbcvel=(v, v),
                  bcvel=tuple(tuple(tuple(r) for r in b) for b in bcv),
                  cbcpre=(('N', 'N', 'N'), ('N', 'N', 'N')),
                  cbcsgs=(('D', 'D', 'D'), ('D', 'D', 'D')),
                  dsmag_avg='cavity', **kw)


def spanwise_cavity(ng=(16, 64, 64), visci=1000., vlid=1.0, **kw):
    """Spanwise-periodic lid-driven cavity: x periodic, walls in y and z,
    z-top lid moving in Y — the recirculating (y, z) cavity flow with a
    periodic span (the cavity class of bench.py's dsmag matrix entry; at
    laminar Re with a thin span it reproduces the
    2D Ghia cavity exactly — validation/cavity.py)."""
    v = (('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D'))
    bcv = [[[0.] * 3 for _ in range(3)] for _ in range(2)]
    bcv[1][2][1] = vlid
    return Config(ng=ng, l=(1., 1., 1.), visci=visci, inivel='zer',
                  cbcvel=(v, v),
                  bcvel=tuple(tuple(tuple(r) for r in b) for b in bcv),
                  cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
                  cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')),
                  dsmag_avg='cavity', **kw)


def square_duct_les(ng=(96, 48, 48), visci=10000., sgstype='dsmag', **kw):
    """Square duct LES with dynamic Smagorinsky
    (les/_manuscript_turbulent_duct_wall_model class)."""
    v = (('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D'))
    return Config(ng=ng, l=(4 * PI, 2., 2.), gtype=1, gr=1.0, visci=visci,
                  inivel='duc', is_wallturb=True,
                  is_forced=(True, False, False), velf=(1., 0., 0.),
                  cbcvel=(v, v),
                  cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
                  cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')),
                  sgstype=sgstype, dsmag_avg='duct', **kw)


def temporal_boundary_layer(ng=(64, 64, 96), visci=2000., **kw):
    """Temporal boundary layer (dns/temporal_boundary_layer): moving bottom
    wall, free-slip top."""
    vb = (('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D'))
    vt = (('P', 'P', 'P'), ('P', 'P', 'P'), ('N', 'N', 'D'))
    bcv = [[[0.] * 3 for _ in range(3)] for _ in range(2)]
    bcv[0][2][0] = 1.0  # wall velocity
    return Config(ng=ng, l=(10., 5., 12.), gtype=2, gr=1.5, visci=visci,
                  inivel='tbl',
                  cbcvel=(vb, vt),
                  bcvel=tuple(tuple(tuple(r) for r in b) for b in bcv),
                  cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
                  cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')), **kw)


def developing_channel(ng=(64, 64, 64), visci=500., uin=1.0, **kw):
    """Spatially developing channel: Dirichlet inflow / Neumann outflow in x,
    walls in z (dns/developing_channel) — pure BC-driven, no forcing."""
    # cbcvel[ibound][idir][ivel]
    lo = (('D', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))
    hi = (('N', 'N', 'N'), ('P', 'P', 'P'), ('D', 'D', 'D'))
    bcv = [[[0.] * 3 for _ in range(3)] for _ in range(2)]
    bcv[0][0][0] = uin  # inflow velocity
    return Config(ng=ng, l=(12., 3., 1.), visci=visci, inivel='zer',
                  cbcvel=(lo, hi),
                  bcvel=tuple(tuple(tuple(r) for r in b) for b in bcv),
                  cbcpre=(('N', 'P', 'N'), ('D', 'P', 'N')),
                  cbcsgs=(('N', 'P', 'D'), ('N', 'P', 'D')), **kw)
