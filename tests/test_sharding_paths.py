"""Decomposition invariance for every resharding-sensitive solver path.

test_sharding.py covers the smag channel; each configuration here exercises a
different communication pattern through the sharded step (the reference's
shape-agnostic MPI discipline, utils.f90:17-24):

  * dsmag channel  — plane averaging over the sharded x/y axes plus 18 filter
    applications with ghost fills (sgs.f90:153-380, ave1d_channel);
  * dsmag duct     — non-periodic y (DCT y-transform resharding in the Poisson
    solve) + 2D duct averaging over x only (ave2d_duct);
  * wall-model channel — log-law Newton on boundary planes whose inputs are
    gathered from the interior (wmodel.f90:65-273);
  * impdiff / impdiff_1d — 3 extra Helmholtz solves (full transform stack) or
    z-only tridiagonal solves per substep (main.f90:423-491).

All run 3 steps at f64 and compare the (2,4)-mesh result to the single-device
result; tolerance covers reduction reassociation only.
"""
import numpy as np
import jax
import pytest

from cales_tpu.config import Config
from cales_tpu.grid import make_grid_from_config
from cales_tpu.initflow import initflow
from cales_tpu.timeloop import Simulation
from cales_tpu.parallel.mesh import make_mesh, field_sharding

DIMS = (2, 4)


def _perturbed(cfg, grid, scale=1e-2, seed=20260820):
    """initflow ICs + a seeded, fully x/y/z-ASYMMETRIC random perturbation.

    EVERY sharded parity witness in this file must use this instead of bare
    initflow: symmetric startup flows (duct 'duc', channel 'log', 'uni') can
    cancel whole families of ghost-row/lane bugs EXACTLY — the round-4 gx>1
    y-walled correc wrap-row read shipped precisely because y-symmetric
    flows masked the bad read.  The fixed seed makes the noise deterministic,
    so the single-device and sharded runs see bit-identical ICs (the same
    decomposition-invariance discipline as the reference, utils.f90:17-24).
    """
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)

    def pert(f):
        f = np.asarray(f)
        return jnp.asarray(f + scale * rng.standard_normal(f.shape).astype(f.dtype))

    u, v, w, p = initflow(cfg, grid)
    return pert(u), pert(v), pert(w), pert(p)


def _run(cfg, mesh=None, nsteps=3, dt=2e-3):
    grid = make_grid_from_config(cfg)
    u, v, w, p = _perturbed(cfg, grid)
    sim = Simulation(cfg, grid, mesh=mesh)
    s = sim.initial_state(u, v, w, p)
    if mesh is not None:
        sh = field_sharding(mesh)
        s = s._replace(u=jax.device_put(s.u, sh), v=jax.device_put(s.v, sh),
                       w=jax.device_put(s.w, sh), p=jax.device_put(s.p, sh),
                       visct=jax.device_put(s.visct, sh))
    for _ in range(nsteps):
        s, _ = sim.step(s, dt)
    return s


def _compare(cfg, tol=1e-11, dt=2e-3):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    s1 = _run(cfg, dt=dt)
    sN = _run(cfg, mesh=make_mesh(DIMS), dt=dt)
    for name in ('u', 'v', 'w', 'p', 'visct'):
        a = np.asarray(getattr(s1, name))
        b = np.asarray(getattr(sN, name))
        if name == 'p':
            a, b = a - a.mean(), b - b.mean()  # singular-mode gauge
        err = np.abs(a - b).max()
        assert err < tol, f"{name} mismatch across decomposition: {err}"


_channel_bcs = dict(
    cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
    cbcsgs=(('P', 'P', 'N'), ('P', 'P', 'N')))


def test_dsmag_channel_sharded():
    cfg = Config(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, inivel='log', is_wallturb=True, dtype='float64',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='dsmag', dsmag_avg='channel')
    _compare(cfg)


def test_dsmag_duct_sharded():
    # non-periodic y: Poisson y-stage runs the DCT operator path; duct
    # averaging keeps (y, z) structure and averages over x only
    cfg = Config(ng=(32, 16, 16), l=(2 * np.pi, 1.0, 1.0), gtype=1, gr=0.0,
                 visci=1000.0, inivel='log', is_wallturb=False, dtype='float64',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='dsmag', dsmag_avg='duct',
                 cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                          ('D', 'D', 'D')),) * 2,
                 cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
                 cbcsgs=(('P', 'N', 'N'), ('P', 'N', 'N')))
    _compare(cfg)


def test_wallmodel_channel_sharded():
    cfg = Config(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=0.0,
                 visci=20000.0, inivel='log', is_wallturb=True, dtype='float64',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='smag', lwm=((0, 0, 1), (0, 0, 1)), hwm=0.2,
                 **_channel_bcs)
    _compare(cfg)


def test_impdiff_1d_channel_sharded():
    cfg = Config(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, inivel='log', is_wallturb=True, dtype='float64',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='none', impdiff_1d=True, **_channel_bcs)
    _compare(cfg)


def test_impdiff_3d_channel_sharded():
    cfg = Config(ng=(32, 16, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=0.0,
                 visci=1000.0, inivel='log', is_wallturb=True, dtype='float64',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='none', impdiff=True, **_channel_bcs)
    _compare(cfg)
