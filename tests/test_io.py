"""I/O layer tests: namelist parsing against the reference examples,
checkpoint roundtrip + size validation (load.f90:44-52), restart continuity,
stats output."""
import os
from pathlib import Path

import numpy as np
import pytest

from cales_tpu.nml import config_from_nml
from cales_tpu.io import checkpoint as ckpt
from cales_tpu.io import stats
from cales_tpu.config import Config, validate
from cales_tpu.grid import make_grid_from_config

REF_EX = Path('/root/reference/examples')


@pytest.mark.parametrize("case", [
    'dns/triperiodic', 'dns/turbulent_channel_constant_pressure_gradient',
    'dns/_manuscript_turbulent_channel', 'dns/_manuscript_lid_driven_cavity',
    'dns/_manuscript_turbulent_duct', 'dns/couette',
    'les/_manuscript_turbulent_channel',
    'les/_manuscript_turbulent_channel_wall_model',
    'les/_manuscript_turbulent_duct_wall_model',
])
def test_reference_nml_parses_and_validates(case):
    path = REF_EX / case / 'input.nml'
    if not path.exists():
        pytest.skip(f'{path} missing')
    cfg = config_from_nml(str(path))
    validate(cfg)
    assert all(n > 0 for n in cfg.ng)
    assert cfg.visci > 0


def test_nml_values_wall_model():
    """The repo's wall-modeled channel deck (the reference's
    les/_manuscript_turbulent_channel_wall_model case) parses to its own
    values."""
    deck = (Path(__file__).resolve().parent.parent / 'examples'
            / 'turbulent_channel_wmles' / 'input.nml')
    cfg = config_from_nml(str(deck))
    validate(cfg)
    assert cfg.ng == (192, 72, 48)
    assert cfg.l == (12.8, 4.8, 2.0)
    assert cfg.gtype == 6
    assert cfg.visci == 125000.0
    assert cfg.sgstype == 'smag'
    assert cfg.lwm == ((0, 0, 1), (0, 0, 1))
    assert cfg.hwm == 0.1
    assert cfg.stop_type == (True, False, False)
    assert cfg.nstep == 10000
    assert cfg.is_forced == (True, False, False)
    assert cfg.cbcvel[0][2][0] == 'D'  # z-wall Dirichlet for u


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    ng = (8, 6, 4)
    fields = [rng.standard_normal((4, 6, 8)) for _ in range(4)]
    path = tmp_path / 'fld.bin'
    ckpt.save_checkpoint(path, *fields, time=2.5, istep=77)
    u, v, w, p, t, i = ckpt.load_checkpoint(path, ng, np.float64)
    for a, b in zip(fields, (u, v, w, p)):
        np.testing.assert_array_equal(a, b)
    assert t == 2.5 and i == 77
    # size validation (load.f90:44-52)
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(path, (8, 6, 5), np.float64)


def test_checkpoint_fortran_order(tmp_path):
    """Memory layout must match the reference's Fortran column-major stream:
    x fastest, then y, then z."""
    nz, ny, nx = 2, 3, 4
    u = np.arange(nz * ny * nx, dtype=np.float64).reshape(nz, ny, nx)
    z = np.zeros_like(u)
    path = tmp_path / 'fld.bin'
    ckpt.save_checkpoint(path, u, z, z, z, 0.0, 0)
    raw = np.fromfile(path, dtype=np.float64)[: nz * ny * nx]
    # element (i, j, k) fortran-linear index = i + nx*j + nx*ny*k
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                assert raw[i + nx * j + nx * ny * k] == u[k, j, i]


def test_single_point_chan_stats(tmp_path):
    cfg = Config(ng=(8, 6, 10), l=(1., 1., 2.), dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(1)
    nz, ny, nx = 10, 6, 8
    u = rng.standard_normal((nz, ny, nx))
    out = stats.single_point_chan(tmp_path / 'stats', cfg, grid,
                                  u, u * 0.5, u * 0.2, u * 0.1, abs(u) * 1e-3)
    assert out.shape == (27, nz)
    np.testing.assert_allclose(out[0], u.mean(axis=(1, 2)))
    np.testing.assert_allclose(out[3], (u ** 2).mean(axis=(1, 2)))
    assert (tmp_path / 'stats.out').exists()
    assert (tmp_path / 'stats.bin').exists()


def test_reystr_budget_chan(tmp_path):
    cfg = Config(ng=(8, 6, 10), l=(1., 1., 2.), dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(3)
    nz, ny, nx = 10, 6, 8
    u, v, w, p = (rng.standard_normal((nz, ny, nx)) for _ in range(4))
    b = stats.reystr_budget_chan(tmp_path / 'stats', cfg, grid, u, v, w, p)
    assert b.shape == (38, nz)
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b[0], u.mean(axis=(1, 2)))
    np.testing.assert_allclose(b[8], p.mean(axis=(1, 2)))
    assert (tmp_path / 'stats_reystr_budget.out').exists()


def test_restart_continuation(tmp_path):
    """Run 6 steps straight vs 3 + checkpoint/restart + 3: fields must agree
    (the reference's 'set icheck=1 to verify restart' recipe, main.f90:524;
    the first post-restart substep has f2=0 so the zeroed old-RHS buffers do
    not enter, rk.f90:57-61 + param.f90:27-29)."""
    import jax.numpy as jnp
    from cales_tpu.initflow import initflow
    from cales_tpu.timeloop import Simulation

    cfg = Config(ng=(16, 12, 12), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=0.9,
                 visci=500.0, inivel='log', is_wallturb=True, dtype='float64',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0))
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid)
    s0 = sim.initial_state(*initflow(cfg, grid))
    dt = 2e-3

    sA = s0
    for _ in range(6):
        sA, _ = sim.step(sA, dt)

    sB = s0
    for _ in range(3):
        sB, _ = sim.step(sB, dt)
    path = tmp_path / 'fld.bin'
    ckpt.save_checkpoint(path, np.asarray(sB.u), np.asarray(sB.v),
                         np.asarray(sB.w), np.asarray(sB.p),
                         float(sB.time), int(sB.istep))
    u, v, w, p, t, i = ckpt.load_checkpoint(path, cfg.ng, np.float64)
    sC = sim.initial_state(u, v, w, p)
    sC = sC._replace(time=sC.time + t, istep=sC.istep + i)
    for _ in range(3):
        sC, _ = sim.step(sC, dt)

    np.testing.assert_allclose(np.asarray(sC.u), np.asarray(sA.u), atol=1e-12)
    np.testing.assert_allclose(np.asarray(sC.w), np.asarray(sA.w), atol=1e-12)
    assert int(sC.istep) == int(sA.istep) == 6


def test_out1d_directions(tmp_path):
    """Generic profile output in all three directions (out1d,
    output.f90:50-162)."""
    from cales_tpu.io import output as outp
    cfg = Config(ng=(6, 5, 8), l=(1., 1., 2.), gtype=1, gr=0.8, dtype='float64')
    grid = make_grid_from_config(cfg)
    rng = np.random.default_rng(0)
    f = rng.standard_normal((8, 5, 6))
    for idir in (0, 1, 2):
        fn = tmp_path / f'prof{idir}.out'
        outp.out1d(fn, grid, idir, f)
        d = np.loadtxt(fn)
        n_expected = {0: 6, 1: 5, 2: 8}[idir]
        assert d.shape == (n_expected, 2)
    # z profile is the plain plane mean
    d = np.loadtxt(tmp_path / 'prof2.out')
    np.testing.assert_allclose(d[:, 1], f.mean(axis=(1, 2)))
    # y profile is dzf-weighted (output.f90:115-131)
    d = np.loadtxt(tmp_path / 'prof1.out')
    w = grid.dzf[1:9]
    expect = (f * w[:, None, None]).sum(axis=(0, 2)) / (6 * grid.lz)
    np.testing.assert_allclose(d[:, 1], expect)


def test_stats_running_average(tmp_path):
    """stats_avg=True writes a running mean of the out1d matrices equal to
    the mean of the instantaneous snapshot files."""
    from cales_tpu.driver import run
    from cales_tpu.config import Config

    cfg = Config(ng=(16, 16, 12), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=0.7,
                 visci=500.0, inivel='log', is_wallturb=True, dtype='float64',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='smag', iout1d=2, icheck=2, stats_avg=True,
                 cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'),
                          ('D', 'D', 'D')),) * 2,
                 cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
                 cbcsgs=(('P', 'P', 'N'), ('P', 'P', 'N')))
    run(cfg, datadir=tmp_path, max_steps=4, verbose=False)
    snaps = sorted(tmp_path.glob('stats_0*.bin'))
    snaps = [s for s in snaps if 'budget' not in s.name]
    assert len(snaps) == 2
    mats = [np.fromfile(s).reshape(12, 27).T for s in snaps]
    avg_file = tmp_path / 'stats_avg_chan.bin'
    assert avg_file.exists()
    avg = np.fromfile(avg_file).reshape(12, 27).T
    np.testing.assert_allclose(avg, (mats[0] + mats[1]) / 2, atol=1e-14)
    # header records the sample count
    head = (tmp_path / 'stats_avg_chan.out').read_text().splitlines()[0]
    assert '2 samples' in head


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Per-shard checkpoint writes must be byte-identical to the gathered
    writer, and the per-shard loader must reproduce the sharded arrays
    (the MPI-IO subarray analogue, io/sharded.py)."""
    import jax
    if len(jax.devices()) < 8:
        import pytest
        pytest.skip("needs 8 virtual devices")
    from cales_tpu.io import checkpoint as ckpt
    from cales_tpu.io import sharded as shio
    from cales_tpu.parallel.mesh import make_mesh, field_sharding

    ng = (16, 8, 12)   # (nx, ny, nz)
    nx, ny, nz = ng
    rng = np.random.default_rng(7)
    fields_np = [rng.standard_normal((nz, ny, nx)) for _ in range(4)]
    mesh = make_mesh((2, 4))
    sh = field_sharding(mesh)
    fields = [jax.device_put(f, sh) for f in fields_np]

    shio.save_checkpoint_sharded(tmp_path / 'a.bin', fields, ng, 1.25, 42)
    ckpt.save_checkpoint(tmp_path / 'b.bin', *fields_np, 1.25, 42)
    assert (tmp_path / 'a.bin').read_bytes() == (tmp_path / 'b.bin').read_bytes()

    u, v, w, p, t, istep = shio.load_checkpoint_sharded(
        tmp_path / 'a.bin', ng, np.float64, sh)
    assert (t, istep) == (1.25, 42)
    assert u.sharding.is_equivalent_to(sh, 3)
    for a, b in zip((u, v, w, p), fields_np):
        np.testing.assert_array_equal(np.asarray(a), b)
