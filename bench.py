"""Headline benchmark: wall-clock per RK3 substep for a turbulent-channel LES
(static Smagorinsky + van Driest), the reference's production configuration
(BASELINE.md: channel LES Re_tau=550 class).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Methodology: N time steps run inside ONE device program
(Simulation.multi_step, a lax.fori_loop over the full RK3 step), timed from
dispatch to block_until_ready on the result, after a first call of the same
program that compiles it.

Metric: ns per grid cell per RK3 substep (one substep = momentum RHS + RK
update + BC fills + FFT/tridiagonal Poisson solve + projection + SGS,
reference main.f90:417-507).

vs_baseline: the reference publishes no benchmark tables (BASELINE.md); the
constant below is our documented estimate of CaLES-on-A100 for this class of
configuration, 0.25 ns/cell/substep (bandwidth model: ~45 full-field HBM
passes per substep at ~1.55 TB/s effective).  vs_baseline > 1 means faster
than that estimate; superseded by a measured number when one exists.

Multi-device: ``python bench.py --mesh 4x1 [--ng 1024x512x512]`` runs the
same benchmark sharded over a ('gy','gx') device mesh.  Requires gy*gx
attached devices.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

BASELINE_NS_PER_CELL_SUBSTEP = 0.25
NG = (512, 256, 256)
NSTEPS = 10

# Per-config A100 estimates from the same bandwidth model as the 0.25
# headline constant (~45 full-field HBM passes per substep at ~1.55 TB/s
# effective, BASELINE.md), adjusted by what each reference config adds or
# removes relative to the smag-channel case:
#  - triperiodic DNS: no SGS (no visct field, no eddy-stress reads in
#    mom.f90) — about 6 passes fewer -> ~0.22
#  - impdiff_1d channel DNS: no SGS (-6) but 3 wall-normal batched-Thomas
#    Helmholtz solves (~4 passes each, solver_gpu.f90:92-130) -> ~0.28
#  - dsmag duct/cavity: the reference's own "~2x the per-step cost" quote
#    for the dynamic model (sgs.f90:25) -> 0.50
#  - WMLES: wall-model overhead "negligible" (bound.f90:117-118) -> 0.25
_CONFIG_BASELINES = {
    'triperiodic_dns': 0.22,
    'channel_dns_impdiff': 0.28,
    'channel_les_smag': BASELINE_NS_PER_CELL_SUBSTEP,
    'duct_les_dsmag': 0.50,
    'cavity_les_dsmag': 0.50,
    'wmles_channel': BASELINE_NS_PER_CELL_SUBSTEP,
}

# the five BASELINE.json configs (--matrix mode); shapes are the largest
# single-chip-friendly analogues of each class (z = wall-normal)
_CHAN_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('P', 'P', 'P'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'P', 'N'), ('P', 'P', 'N')),
    cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')))
_DUCT_BCS = dict(
    cbcvel=((('P', 'P', 'P'), ('D', 'D', 'D'), ('D', 'D', 'D')),) * 2,
    cbcpre=(('P', 'N', 'N'), ('P', 'N', 'N')),
    cbcsgs=(('P', 'D', 'D'), ('P', 'D', 'D')))
# the reference cavity is fully enclosed (all-D); this matrix entry is the
# spanwise-periodic cavity class with the lid driving V
_CAV_BCS = _DUCT_BCS


def _matrix_configs(ng):
    """name -> Config kwargs for the BASELINE.json benchmark matrix."""
    nx, ny, nz = ng
    chan = dict(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                inivel='log', is_wallturb=True,
                is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                dtype='float32')
    return {
        'triperiodic_dns': dict(
            ng=ng, l=(2 * np.pi,) * 3, gtype=0, gr=0.0, visci=1600.0,
            inivel='tgv', sgstype='none', dtype='float32',
            cbcvel=((('P',) * 3,) * 3,) * 2,
            cbcpre=(('P',) * 3,) * 2, cbcsgs=(('P',) * 3,) * 2),
        # BASELINE.json #2 is "wall-normal tridiag Helmholtz + implicit CN
        # viscous" == the reference's -D_IMPDIFF_1D build (z-only implicit
        # diffusion, configs/flags.mk.example:97-98), the canonical choice
        # for wall-resolved channels with z-stretching
        'channel_dns_impdiff': dict(
            **chan, visci=5640.0, sgstype='none', impdiff=True,
            impdiff_1d=True, **_CHAN_BCS),
        'channel_les_smag': dict(
            **chan, visci=20_000.0, sgstype='smag', **_CHAN_BCS),
        'duct_les_dsmag': dict(
            ng=ng, l=(4 * np.pi, 2.0, 2.0), gtype=1, gr=1.0, visci=10_000.0,
            inivel='duc', is_wallturb=True, is_forced=(True, False, False),
            velf=(1.0, 0.0, 0.0), sgstype='dsmag', dsmag_avg='duct',
            dtype='float32', **_DUCT_BCS),
        # inivel 'tgv' (not 'zer'): a dsmag step from an identically-zero
        # field is 0/0; any smooth field times the same code path
        'cavity_les_dsmag': dict(
            ng=ng, l=(1.0, 1.0, 1.0), gtype=1, gr=0.0, visci=5_000.0,
            inivel='tgv', sgstype='dsmag', dsmag_avg='cavity',
            dtype='float32',
            # spanwise-periodic cavity: the z-top lid drives V (the
            # recirculating (y,z) cavity with periodic span; a lid along
            # the periodic x would decouple from the pressure entirely)
            bcvel=(((0.0,) * 3,) * 3,
                   ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))),
            **_CAV_BCS),
        'wmles_channel': dict(
            **chan, visci=125_000.0, sgstype='smag',
            lwm=((0, 0, 1), (0, 0, 1)), hwm=0.1, **_CHAN_BCS),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--mesh', default=None,
                    help="device mesh as GYxGX (e.g. 4x1); default one device")
    ap.add_argument('--ng', default=None,
                    help="grid as NXxNYxNZ; default 512x256x256 "
                         "(1024x512x512 with --mesh)")
    ap.add_argument('--nsteps', type=int, default=NSTEPS)
    ap.add_argument('--matrix', action='store_true',
                    help="run the six matrix configs and report "
                         "ns/cell/substep + Poisson fraction per config")
    ap.add_argument('--only', default=None,
                    help="with --matrix: comma-separated config names to run")
    ap.add_argument('--no-solve-ablation', action='store_true',
                    help="with --matrix: skip the solve-ablated run (no "
                         "Poisson fraction)")
    args = ap.parse_args(argv)

    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cales_tpu.config import Config
    from cales_tpu.grid import make_grid_from_config
    from cales_tpu.initflow import initflow
    from cales_tpu.runtime import enable_compile_cache
    from cales_tpu.timeloop import Simulation

    enable_compile_cache()
    mesh = None
    if args.mesh:
        from cales_tpu.parallel.mesh import make_mesh
        dims = tuple(int(v) for v in args.mesh.split('x'))
        mesh = make_mesh(dims)
    ng = NG
    if args.ng:
        ng = tuple(int(v) for v in args.ng.split('x'))
    elif mesh is not None:
        ng = (1024, 512, 512)  # the sharded class: 8x the one-device grid

    dt = 1e-4
    nsteps = args.nsteps

    def measure(cfg, ablate_solve=False):
        """ns/cell/RK3-substep for one Config."""
        grid = make_grid_from_config(cfg)
        sim = Simulation(cfg, grid, mesh=mesh)
        sim.ablate_solve = ablate_solve
        u, v, w, p = initflow(cfg, grid)
        state = sim.initial_state(u, v, w, p)
        if mesh is not None:
            from cales_tpu.parallel.mesh import field_sharding
            sh = field_sharding(mesh)
            state = state._replace(
                u=jax.device_put(state.u, sh), v=jax.device_put(state.v, sh),
                w=jax.device_put(state.w, sh), p=jax.device_put(state.p, sh),
                visct=jax.device_put(state.visct, sh))

        def timed_advance(st, n):
            # multi_step donates its input state; use the returned state
            t0 = time.perf_counter()
            out = sim.multi_step(st, dt, n)
            jax.block_until_ready(out.u)
            return out, time.perf_counter() - t0

        state, _ = timed_advance(state, nsteps)     # compiles
        state, t_n = timed_advance(state, nsteps)
        assert np.isfinite(float(state.u[0, 0, 0]))
        ncell = cfg.ng[0] * cfg.ng[1] * cfg.ng[2]
        return t_n / nsteps / 3.0 / ncell * 1e9, sim.exec_path()

    tag = f'{ng[0]}x{ng[1]}x{ng[2]} f32'
    if mesh is not None:
        tag += f', mesh {args.mesh}'

    if args.matrix:
        # per-config ns/cell/RK3-substep + Poisson-solve fraction (measured
        # by ablating the solve)
        results = {}
        only = set(args.only.split(',')) if args.only else None
        for name, kw in _matrix_configs(ng).items():
            if only is not None and name not in only:
                continue
            cfg = Config(**kw)
            ns_full, path = measure(cfg)
            row = {'ns_per_cell_substep': ns_full,
                   'vs_baseline': _CONFIG_BASELINES[name] / ns_full,
                   'baseline_ns': _CONFIG_BASELINES[name],
                   'exec_path': path}
            if not args.no_solve_ablation:
                ns_nosolve, _ = measure(cfg, ablate_solve=True)
                row['poisson_fraction'] = max(0.0, 1.0 - ns_nosolve / ns_full)
            results[name] = row
            print(f'# {name}: {ns_full:.4f} ns/cell/substep, {path}',
                  flush=True)
        print(json.dumps({'grid': tag, 'nsteps': nsteps,
                          'configs': results}))
        return

    # headline config (BASELINE config #3 class)
    cfg = Config(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                 visci=20_000.0, inivel='log', is_wallturb=True,
                 is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                 sgstype='smag', dtype='float32')
    ns_per_cell_substep, path = measure(cfg)
    out = {
        "metric": f"channel LES (smag) ns/cell/RK3-substep, {tag}",
        "value": ns_per_cell_substep,
        "unit": "ns/cell/substep",
        "vs_baseline": BASELINE_NS_PER_CELL_SUBSTEP / ns_per_cell_substep,
        "exec_path": path,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
