"""CLI entry point: ``python -m cales_tpu [input.nml] [--datadir DIR] ...``

The counterpart of running the reference executable in a case directory with
its ``input.nml`` (main.f90:135-144)."""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='cales_tpu',
        description='JAX incompressible DNS/LES solver (CaLES-class)')
    ap.add_argument('input', nargs='?', default='input.nml',
                    help='namelist input file (reference-compatible)')
    ap.add_argument('--datadir', default='data', help='output directory')
    ap.add_argument('--dtype', default=None, choices=['float32', 'float64'],
                    help='override compute precision')
    ap.add_argument('--max-steps', type=int, default=None,
                    help='cap the number of steps (debug)')
    ap.add_argument('--cpu', action='store_true',
                    help='force the CPU backend')
    ap.add_argument('--mesh', default=None,
                    help='device mesh as GYxGX, e.g. 4x1')
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')

    from .nml import config_from_nml
    from .driver import run
    from .runtime import enable_compile_cache

    overrides = {}
    if args.dtype:
        overrides['dtype'] = args.dtype
    cfg = config_from_nml(args.input, **overrides)
    if cfg.dtype == 'float64':
        # the host-side logs and checkpoints handle the float64 state
        # (the Simulation itself traces in its own precision either way)
        jax.config.update('jax_enable_x64', True)
    enable_compile_cache()

    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh
        gy, gx = (int(t) for t in args.mesh.lower().split('x'))
        mesh = make_mesh((gy, gx))

    run(cfg, datadir=args.datadir, mesh=mesh, max_steps=args.max_steps)
    return 0


if __name__ == '__main__':
    sys.exit(main())
