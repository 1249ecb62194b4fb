#!/usr/bin/env python3
"""Dynamic-Smagorinsky channel validation at the reference's own accuracy
bar: "<=5% errors in the friction coefficient ... for Retau = 395, 550 and
1000" (/root/reference/src/sgs.f90:28-30), on the manuscript channel case
(/root/reference/examples/les/_manuscript_turbulent_channel/input.nml:
visci = 10000, l = (12.8, 4.8, 2), gtype 1) with sgstype='dsmag' and
plane averaging over the homogeneous x,y directions (the reference's
compile-time `#define _CHANNEL`, sgs.f90:359-370).

Re_b = U_b h / nu = 10000 corresponds to the Lee & Moser (2015) DNS at
Re_tau = 543.5.  With bulk forcing the mean streamwise momentum balance
gives <-dpdl_x> = u_tau^2 / h, so

    Re_tau = sqrt(<-dpdl_x> h) * h / nu,
    cf     = 2 (u_tau / U_b)^2,   err_cf = (Re_tau/543.5)^2 - 1.

Acceptance: |err_cf| <= 5%.

Implicit z diffusion (impdiff_1d, the reference's -D_IMPDIFF_1D build,
configs/flags.mk.example:97-98) is ON by default: the manuscript grid
clusters to dz+ < 1 and the explicit diffusive dt limit would cost ~8x
more steps for a scheme-equivalent friction result.

Usage: python validation/dsmag_channel.py [--steps 20000] [--ng 256x128x128]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RE_TAU_REF = 543.5   # Lee & Moser (2015), Re_b = U_b h / nu = 10000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=20000)
    ap.add_argument('--ng', default='256x128x128')  # nx%128==0 -> kernel path
    ap.add_argument('--avg-frac', type=float, default=0.4,
                    help='trailing fraction of the run used for the average')
    ap.add_argument('--explicit', action='store_true',
                    help='explicit z diffusion (no CN); ~8x more steps')
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--visci', type=float, default=10_000.0,
                    help='bulk Reynolds number U_b h / nu (10000 -> '
                         'Re_tau 543.5; 20000 -> Re_tau 1000.5, both '
                         'Lee & Moser 2015)')
    ap.add_argument('--retau-ref', type=float, default=None,
                    help='DNS reference Re_tau (default: matched to '
                         '--visci from the Lee & Moser 2015 cases)')
    args = ap.parse_args()
    retau_ref = args.retau_ref
    if retau_ref is None:
        lm2015 = {2857.0: 182.088, 10_000.0: 543.5, 20_000.0: 1000.512}
        if args.visci not in lm2015:
            ap.error('--retau-ref required for a non-tabulated --visci')
        retau_ref = lm2015[args.visci]

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
    visci = args.visci            # Re_b = U_b h / nu, h = lz/2 = 1
    cfg = Config(ng=ng, l=(12.8, 4.8, 2.0), gtype=1, gr=5.0, visci=visci,
                 inivel='poi', is_wallturb=True,
                 dtype='float64' if args.cpu else 'float32',
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='dsmag', dsmag_avg='channel',
                 impdiff=not args.explicit, impdiff_1d=not args.explicit,
                 cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'),
                          ('D', 'D', 'D')),) * 2,
                 cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
                 # 'D' value 0 at solid walls (reference manuscript nml):
                 # antisymmetric visct ghost -> zero eddy viscosity at the
                 # wall face
                 cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid)
    print(f'execution path: {sim.exec_path()}', flush=True)
    state = sim.initial_state(*initflow(cfg, grid))
    dt = sim.pick_dt(sim.check(state)[0])

    dpdl_acc = 0.0
    nacc = 0
    navg0 = int(args.steps * (1.0 - args.avg_frac))
    h = cfg.l[2] / 2.0
    nu = 1.0 / visci
    t0 = time.perf_counter()
    for it in range(args.steps):
        state, dpdl = sim.step(state, dt)
        if it >= navg0:
            dpdl_acc += float(dpdl[0])
            nacc += 1
        icheck = 10 if it < 2000 else 50
        if (it + 1) % icheck == 0:
            dt = sim.pick_dt(sim.check(state)[0])
        if (it + 1) % 1000 == 0:
            msg = (f'step {it + 1}/{args.steps}  t={float(state.time):.1f}  '
                   f'dt={dt:.2e}  wall={time.perf_counter() - t0:.0f}s')
            if nacc:
                rt = np.sqrt(abs(dpdl_acc / nacc) * h) * h / nu
                msg += f'  running Re_tau={rt:.1f}'
            print(msg, flush=True)
    dpdl_mean = dpdl_acc / max(nacc, 1)
    u_tau = np.sqrt(abs(dpdl_mean) * h)
    re_tau = u_tau * h / nu
    err_rt = (re_tau - retau_ref) / retau_ref * 100.0
    err_cf = ((re_tau / retau_ref) ** 2 - 1.0) * 100.0
    print(f'<dpdl_x> = {dpdl_mean:.6e}  u_tau/U_b = {u_tau:.5f}  '
          f'Re_tau = {re_tau:.1f}  ({err_rt:+.1f}% vs {retau_ref} '
          f'[Lee & Moser 2015]; cf error {err_cf:+.1f}%, bar <=5% '
          f'per sgs.f90:28-30)')


if __name__ == '__main__':
    main()
