#!/usr/bin/env python3
"""Wall-modeled channel LES validation (the BASELINE.json Re_tau = 5200
case; reference: examples/les/_manuscript_turbulent_channel_wall_model).

Runs the log-law wall-modeled channel (both z walls, hwm matching height,
static Smagorinsky, bulk-forced) and reports the friction Reynolds number
from the mean-momentum balance: with bulk forcing, <dpdl_x> = u_tau^2 / h,
so Re_tau = sqrt(<-dpdl_x> * h) / nu averaged over the statistically steady
window.  Acceptance: within the reference's quoted <=5% friction accuracy
(sgs.f90:28-30); round-1 measured +1.0%.

Usage: python validation/wmles_channel.py [--steps 3000] [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=3000)
    ap.add_argument('--avg-frac', type=float, default=0.5,
                    help='trailing fraction of the run used for the average')
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')
        jax.config.update('jax_enable_x64', True)
    from cales_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from cales_tpu.config import Config
    from cales_tpu.grid import make_grid_from_config
    from cales_tpu.initflow import initflow
    from cales_tpu.timeloop import Simulation

    re_tau_target = 5200.0
    visci = 125_000.0           # Re_b = 2 h u_b / nu with h = 1, u_b = 1
    cfg = Config(ng=(192, 72, 48), l=(12.8, 4.8, 2.0), gtype=6, gr=0.0,
                 visci=visci, inivel='poi', is_wallturb=True,
                 dtype='float64' if args.cpu else 'float32',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='smag', lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1,
                 cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'),
                          ('D', 'D', 'D')),) * 2,
                 cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
                 # sgs BC at wall-modeled walls MUST be 'D' (value 0): the
                 # antisymmetric ghost zeroes visct at the wall face so the
                 # wall diffusive flux is exactly visc*bc = tauw.  A symmetric
                 # 'N' ghost leaves visct(wall) ~ visct(1), amplifying the
                 # imposed stress by (visc+visct)/visc -> runaway coupling
                 # (reference: examples/les/..._wall_model cbcsgs 'D','D').
                 cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid)
    state = sim.initial_state(*initflow(cfg, grid))
    dt = sim.pick_dt(sim.check(state)[0])

    dpdl_acc = 0.0
    nacc = 0
    navg0 = int(args.steps * (1.0 - args.avg_frac))
    t0 = time.perf_counter()
    for it in range(args.steps):
        state, dpdl = sim.step(state, dt)
        if it >= navg0:
            dpdl_acc += float(dpdl[0])
            nacc += 1
        icheck = 10 if it < 1500 else 50
        if (it + 1) % icheck == 0:
            # adaptive dt like the driver's icheck loop — every 10 steps
            # through the transition (the vortex-pair trigger's spike can
            # outrun a 50-step cadence at f32), then every 50
            dt = sim.pick_dt(sim.check(state)[0])
        if (it + 1) % 500 == 0:
            print(f'step {it + 1}/{args.steps}  t={float(state.time):.2f}  '
                  f'dt={dt:.2e}  wall={time.perf_counter() - t0:.0f}s',
                  flush=True)
    dpdl_mean = dpdl_acc / max(nacc, 1)
    h = cfg.l[2] / 2.0
    u_tau = np.sqrt(abs(dpdl_mean) * h)
    re_tau = u_tau * h * visci
    err = (re_tau - re_tau_target) / re_tau_target * 100.0
    print(f'<dpdl_x> = {dpdl_mean:.6e}  u_tau = {u_tau:.5f}  '
          f'Re_tau = {re_tau:.0f}  ({err:+.1f}% vs {re_tau_target:.0f})')


if __name__ == '__main__':
    main()
