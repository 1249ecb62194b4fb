#!/usr/bin/env python3
"""Lid-driven cavity validation vs Ghia, Ghia & Shin (1982), Re = 1000.

Runs the spanwise-periodic cavity (models.spanwise_cavity: x periodic,
(y, z) walls, z-top lid moving in Y) with a thin span and no perturbation:
the flow is exactly the 2D cavity in the (y, z) plane, so the steady
centerline profiles compare directly against Ghia's 129^2 stream-function
solution (Table I/II):
  * v along the vertical centerline y = 0.5   <-> Ghia's u(y) at x = 0.5
  * w along the horizontal centerline z = 0.5 <-> Ghia's v(x) at y = 0.5
Reference counterpart: /root/reference/examples/dns/lid_driven_cavity/
(the fully-enclosed 3D case, same Re and lid speed).

Usage: PYTHONPATH=. python validation/cavity.py [--n 96] [--tend 60]
CPU f64 by default (~12 min at 96^2); pass --f32 to run float32 on the
default (GPU) backend.
"""
import argparse
import sys
import time

import jax

sys.path.insert(0, '.')


# Ghia, Ghia & Shin (1982), Re=1000: u on the vertical centerline (x=0.5)
GHIA_U = [  # (y, u)
    (1.0000, 1.00000), (0.9766, 0.65928), (0.9688, 0.57492),
    (0.9609, 0.51117), (0.9531, 0.46604), (0.8516, 0.33304),
    (0.7344, 0.18719), (0.6172, 0.05702), (0.5000, -0.06080),
    (0.4531, -0.10648), (0.2813, -0.27805), (0.1719, -0.38289),
    (0.1016, -0.29730), (0.0703, -0.22220), (0.0625, -0.20196),
    (0.0547, -0.18109), (0.0000, 0.00000),
]
# v on the horizontal centerline (y=0.5)
GHIA_V = [  # (x, v)
    (1.0000, 0.00000), (0.9688, -0.21388), (0.9609, -0.27669),
    (0.9531, -0.33714), (0.9453, -0.39188), (0.9063, -0.51550),
    (0.8594, -0.42665), (0.8047, -0.31966), (0.5000, 0.02526),
    (0.2344, 0.32235), (0.2266, 0.33075), (0.1563, 0.37095),
    (0.0938, 0.32627), (0.0781, 0.30353), (0.0703, 0.29012),
    (0.0625, 0.27485), (0.0000, 0.00000),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=96)
    ap.add_argument('--tend', type=float, default=60.0)
    ap.add_argument('--f32', action='store_true',
                    help='float32 on the default (GPU) backend')
    args = ap.parse_args()
    if not args.f32:
        jax.config.update('jax_platforms', 'cpu')
        jax.config.update('jax_enable_x64', True)
    import numpy as np
    from cales_tpu import models
    from cales_tpu.grid import make_grid_from_config
    from cales_tpu.initflow import initflow
    from cales_tpu.timeloop import Simulation

    n = args.n
    cfg = models.spanwise_cavity(
        ng=(8, n, n), visci=1000.0,
        dtype='float32' if args.f32 else 'float64')
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid)
    print('exec path:', sim.exec_path(), flush=True)
    state = sim.initial_state(*initflow(cfg, grid))

    t, it, t0 = 0.0, 0, time.time()
    while t < args.tend:
        dtmax, _, _ = sim.check(state)
        dt = 0.95 * float(dtmax)
        nsteps = min(500, max(1, int((args.tend - t) / dt)))
        state = sim.multi_step(state, dt, nsteps)
        t += dt * nsteps
        it += nsteps
        if it % 2000 < nsteps:
            print(f'  t={t:7.2f} it={it} ({time.time()-t0:.0f}s)',
                  flush=True)

    v = np.asarray(state.v).mean(axis=2)      # span-avg -> (nz, ny), y-face
    w = np.asarray(state.w).mean(axis=2)      # (nz, ny), z-face
    zc = np.asarray(grid.zc[1:n + 1])
    zf = np.asarray(grid.zf[1:n + 1])
    yc = (np.arange(n) + 0.5) / n

    # v at the vertical centerline y=0.5: y-face index n//2 - 1 is exactly
    # at 0.5 for even n
    vline = v[:, n // 2 - 1]
    ghia_y = np.array([p[0] for p in GHIA_U])
    ghia_u = np.array([p[1] for p in GHIA_U])
    v_interp = np.interp(ghia_y, zc, vline)
    # the lid point (y=1) is a BC, skip it in the error norm
    err_v = np.abs(v_interp[1:] - ghia_u[1:])

    # w at the horizontal centerline z=0.5: interp in z at each y
    wline = np.array([np.interp(0.5, zf, w[:, j]) for j in range(n)])
    ghia_x = np.array([p[0] for p in GHIA_V])
    ghia_v = np.array([p[1] for p in GHIA_V])
    w_interp = np.interp(ghia_x, yc, wline)
    err_w = np.abs(w_interp[1:-1] - ghia_v[1:-1])

    print(f'\nRe=1000 cavity vs Ghia et al. (1982), {n}^2, t={t:.1f}:')
    print(f'  centerline v: max err {err_v.max():.4f}, '
          f'rms {np.sqrt((err_v**2).mean()):.4f} '
          f'(v_min {vline.min():.4f} vs Ghia -0.38289)')
    print(f'  centerline w: max err {err_w.max():.4f}, '
          f'rms {np.sqrt((err_w**2).mean()):.4f} '
          f'(w_min {wline.min():.4f} vs Ghia -0.51550)')
    ok = err_v.max() < 0.03 and err_w.max() < 0.03
    print('PASS' if ok else 'FAIL (2nd-order at this resolution should be '
          'within ~0.03 of the 129^2 reference)')
    return 0 if ok else 1


if __name__ == '__main__':
    raise SystemExit(main())
