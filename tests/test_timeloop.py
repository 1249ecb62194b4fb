"""End-to-end RK3+projection tests (SURVEY §7.2 stage 7 acceptance):
2D Taylor-Green analytic decay, divergence-freeness, laminar channel."""
import numpy as np
import jax.numpy as jnp

from cales_tpu.config import Config
from cales_tpu.grid import make_grid_from_config
from cales_tpu.initflow import initflow
from cales_tpu.timeloop import Simulation


def make_sim(cfg):
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid)
    u, v, w, p = initflow(cfg, grid)
    state = sim.initial_state(u, v, w, p)
    return sim, grid, state


def test_taylor_green_decay():
    """'tgw' has the exact solution u = cos(x) sin(y) exp(-2 nu t) on a
    (2pi)^2-periodic box; validates momentum + projection + time scheme."""
    n = 32
    visc_i = 100.0
    cfg = Config(ng=(n, n, 4), l=(2 * np.pi, 2 * np.pi, 1.0), visci=visc_i,
                 inivel='tgw', dtype='float64',
                 cbcvel=((('P',) * 3,) * 3, (('P',) * 3,) * 3),
                 cbcpre=(('P', 'P', 'P'), ('P', 'P', 'P')),
                 cbcsgs=(('P', 'P', 'P'), ('P', 'P', 'P')))
    sim, grid, state = make_sim(cfg)
    nu = cfg.visc
    dt = 1e-3
    nsteps = 200
    for _ in range(nsteps):
        state, _ = sim.step(state, dt)
    t = nsteps * dt
    nx, ny = n, n
    xf = (np.arange(nx) + 1.0) * cfg.dl[0]
    yc = (np.arange(ny) + 0.5) * cfg.dl[1]
    u_exact = np.cos(xf)[None, None, :] * np.sin(yc)[None, :, None] \
        * np.exp(-2.0 * nu * t) * np.ones((4, 1, 1))
    u_num = np.asarray(state.u)
    err = np.abs(u_num - u_exact).max()
    # 2nd-order space + RK3 time: expect ~h^2 ~ 0.04^2-level errors
    assert err < 5e-3, f"TGV decay error too large: {err}"
    # energy must decay monotonically at the analytic rate (2% tolerance)
    e_num = (u_num ** 2).mean()
    e_exact = (u_exact ** 2).mean()
    assert abs(e_num / e_exact - 1.0) < 2e-2

    dt_cfl, divtot, divmax = sim.check(state)
    assert divmax < 1e-10
    assert dt_cfl > 0


def test_divergence_free_channel():
    """Channel (walls in z, stretched grid) stays divergence-free from a
    noisy start; the reference aborts when divmax > sqrt(eps)
    (main.f90:536-543)."""
    cfg = Config(ng=(16, 12, 16), l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=1000.0, inivel='log', is_wallturb=True, dtype='float64',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0))
    sim, grid, state = make_sim(cfg)
    dt_cfl, _, _ = sim.check(state)
    dt = sim.pick_dt(dt_cfl)
    for _ in range(10):
        state, dpdl = sim.step(state, dt)
    _, divtot, divmax = sim.check(state)
    assert divmax < 1e-10, f"divergence blew up: {divmax}"
    assert np.isfinite(np.asarray(state.u)).all()
    # bulk forcing keeps mean velocity at velf
    wz = grid.dzf[1:17] / (2.0 * 16 * 12)
    ub = float((np.asarray(state.u) * wz[:, None, None]).sum())
    np.testing.assert_allclose(ub, 1.0, rtol=1e-12)


def test_laminar_poiseuille_steady():
    """Pressure-driven laminar channel must converge to the parabolic
    profile (the reference's 'pdc' case)."""
    nz = 24
    cfg = Config(ng=(4, 4, nz), l=(1.0, 1.0, 1.0), visci=10.0, inivel='poi',
                 dtype='float64', is_forced=(True, False, False),
                 velf=(1.0, 0.0, 0.0), dtmax=0.05)
    sim, grid, state = make_sim(cfg)
    dt_cfl, _, _ = sim.check(state)
    dt = sim.pick_dt(dt_cfl)
    for _ in range(400):
        state, _ = sim.step(state, dt)
    zc = grid.zc[1:nz + 1]
    u_exact = 6.0 * zc * (1.0 - zc)  # ubulk = 1
    u_prof = np.asarray(state.u).mean(axis=(1, 2))
    err = np.abs(u_prof - u_exact).max() / u_exact.max()
    assert err < 2e-3, f"Poiseuille profile error {err}"


def test_impdiff_1d_matches_explicit():
    """z-implicit diffusion must reproduce the explicit solution on a case
    where both are stable (laminar channel, small dt)."""
    base = dict(ng=(8, 4, 16), l=(1.0, 1.0, 1.0), visci=50.0, inivel='poi',
                dtype='float64', is_forced=(True, False, False),
                velf=(1.0, 0.0, 0.0))
    cfg_e = Config(**base)
    cfg_i = Config(**base, impdiff_1d=True)
    dt = 2e-4
    outs = []
    for cfg in (cfg_e, cfg_i):
        sim, grid, state = make_sim(cfg)
        for _ in range(50):
            state, _ = sim.step(state, dt)
        outs.append(np.asarray(state.u))
    err = np.abs(outs[0] - outs[1]).max()
    assert err < 1e-6, f"implicit vs explicit mismatch {err}"


def test_impdiff_3d_matches_explicit():
    cfg_e = Config(ng=(8, 8, 12), l=(1.0, 1.0, 1.0), visci=50.0, inivel='poi',
                   dtype='float64', is_forced=(True, False, False),
                   velf=(1.0, 0.0, 0.0))
    cfg_i = cfg_e.replace(impdiff=True)
    dt = 2e-4
    outs = []
    for cfg in (cfg_e, cfg_i):
        sim, grid, state = make_sim(cfg)
        for _ in range(50):
            state, _ = sim.step(state, dt)
        outs.append(np.asarray(state.u))
    err = np.abs(outs[0] - outs[1]).max()
    assert err < 1e-6, f"implicit vs explicit mismatch {err}"


def test_scalar_transport():
    """Opt-in passive scalar: a constant field stays constant (conservation),
    and a pure-diffusion sine decays at exp(-alpha k^2 t) (scal.f90:14-51)."""
    n = 32
    cfg = Config(ng=(n, 4, 4), l=(2 * np.pi, 1.0, 1.0), visci=10.0,
                 inivel='zer', dtype='float64', scalar=True, pr=1.0,
                 iniscal='uni',
                 cbcvel=((('P',) * 3,) * 3, (('P',) * 3,) * 3),
                 cbcpre=(('P',) * 3, ('P',) * 3),
                 cbcsgs=(('P',) * 3, ('P',) * 3),
                 cbcscal=(('P', 'P', 'P'), ('P', 'P', 'P')))
    sim, grid, state = make_sim(cfg)
    dt = 1e-3
    # constant scalar stays exactly 1
    for _ in range(5):
        state, _ = sim.step(state, dt)
    np.testing.assert_allclose(np.asarray(state.s), 1.0, atol=1e-13)
    # sine decay under pure diffusion (u = 0)
    x = (np.arange(n) + 0.5) * cfg.dl[0]
    s0 = np.broadcast_to(np.sin(x)[None, None, :], (4, 4, n)).copy()
    state = state._replace(s=jnp.asarray(s0))
    nsteps = 100
    for _ in range(nsteps):
        state, _ = sim.step(state, dt)
    alpha = cfg.visc / cfg.pr
    # discrete diffusion eigenvalue for wavenumber 1: 2(1-cos(dx))/dx^2
    dx = cfg.dl[0]
    keff = 2.0 * (1.0 - np.cos(dx)) / dx ** 2
    expect = s0 * np.exp(-alpha * keff * nsteps * dt)
    err = np.abs(np.asarray(state.s) - expect).max()
    assert err < 5e-6, f"scalar diffusion decay error {err}"


def test_wm_fast_bcs_match_full_pad():
    """The wall-model fast path (_wm_bcs_fast: sliced x/y- or x/z-filled
    rows) must reproduce the full-field pad_velocity route bit-for-bit —
    the ghost fill of a wall-parallel row reads only that row.  Covers
    z-wall (channel) and y+z-wall (duct) wall models on a perturbed field."""
    import jax
    from cales_tpu import models
    rng = np.random.default_rng(3)
    channel = models.channel_wmles(ng=(16, 12, 12), visci=50000.0,
                                   dtype='float64')
    duct = channel.replace(
        l=(channel.l[0], 2.0, 2.0),
        cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
        cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
        cbcsgs=(('P', 'N', 'N'), ('P', 'N', 'N')),
        lwm=((0, 1, 1), (0, 1, 1)))
    for cfg in (channel, duct):
        sim, grid, state = make_sim(cfg)
        assert sim._wm_fast
        u, v, w = (jnp.asarray(np.asarray(f) + 0.1 * rng.standard_normal(
            f.shape)) for f in (state.u, state.v, state.w))
        fast = jax.jit(sim._wm_bcs_fast)(u, v, w)
        full = jax.jit(sim._wm_bcs_full)(u, v, w)
        leaves_f = jax.tree_util.tree_leaves(fast)
        leaves_p = jax.tree_util.tree_leaves(full)
        assert len(leaves_f) == len(leaves_p)
        for a, b in zip(leaves_f, leaves_p):
            # static faces may stay scalar on one route, a plane on the other
            a, b = np.broadcast_arrays(np.asarray(a), np.asarray(b))
            assert np.array_equal(a, b)
