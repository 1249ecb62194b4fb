#!/usr/bin/env python3
"""Square-duct validation (the BASELINE.json config-#4 class; reference:
examples/dns/_manuscript_turbulent_duct).

Runs the Gavrilakis (1992) square duct — Re_b = 4410 on bulk velocity and
duct width — at reduced resolution with the dynamic-Smagorinsky model
(dsmag_avg='duct'), and reports the mean friction
from the streamwise force balance: with bulk forcing on a square cross
section (side W, area W^2, perimeter 4W),

    <tau_w> = <-dpdl_x> * W / 4,   u_tau = sqrt(<tau_w>),
    Re_tau  = u_tau (W/2) / nu.

Acceptance: Re_tau within ~8% of the Gavrilakis DNS value (~150 based on
the duct half-width; u_tau/U_b = 0.0680 mean over the perimeter), i.e. the
same friction-accuracy class the reference quotes for the dynamic model
(sgs.f90:28-30).

Usage: python validation/duct.py [--steps 6000] [--ng 256x64x64] [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RE_TAU_REF = 150.0   # Gavrilakis (1992), JFM 244: Re_tau = u_tau (W/2)/nu


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=6000)
    ap.add_argument('--ng', default='256x64x64')  # nx%128==0 -> kernel path
    ap.add_argument('--avg-frac', type=float, default=0.4)
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')
        jax.config.update('jax_enable_x64', True)
    from cales_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    from cales_tpu.config import Config
    from cales_tpu.grid import make_grid_from_config
    from cales_tpu.initflow import initflow
    from cales_tpu.timeloop import Simulation

    ng = tuple(int(v) for v in args.ng.split('x'))
    visci = 4410.0                # Re_b (bulk, width) = Gavrilakis
    cfg = Config(ng=ng, l=(10.0, 1.0, 1.0), gtype=1, gr=0.0, visci=visci,
                 inivel='poi', is_wallturb=True,
                 dtype='float64' if args.cpu else 'float32',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='dsmag', dsmag_avg='duct',
                 cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'),
                          ('D', 'D', 'D')),) * 2,
                 cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
                 cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')))
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid)
    print(f'execution path: {sim.exec_path()}', flush=True)
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
        if (it + 1) % 50 == 0:
            dt = sim.pick_dt(sim.check(state)[0])
        if (it + 1) % 500 == 0:
            print(f'step {it + 1}/{args.steps}  t={float(state.time):.2f}  '
                  f'dt={dt:.2e}  wall={time.perf_counter() - t0:.0f}s',
                  flush=True)
    dpdl_mean = dpdl_acc / max(nacc, 1)
    W = cfg.l[1]
    nu = 1.0 / visci
    tau_w = abs(dpdl_mean) * W / 4.0
    u_tau = np.sqrt(tau_w)
    re_tau = u_tau * (W / 2.0) / nu
    err = (re_tau - RE_TAU_REF) / RE_TAU_REF * 100.0
    print(f'<dpdl_x> = {dpdl_mean:.6e}  u_tau/U_b = {u_tau:.5f}  '
          f'Re_tau = {re_tau:.1f}  ({err:+.1f}% vs {RE_TAU_REF:.0f} '
          f'[Gavrilakis 1992])')


if __name__ == '__main__':
    main()
