#!/usr/bin/env python3
"""Estimate the per-device memory footprint of a run before launching it.

Counterpart of /root/reference/utils/other_utilities/
estimate_device_memory_footprint/ (which sums the reference's allocation
list).  This version models OUR runtime: the jitted step donates the state
(u, v, w, p, visct [, s] + 3 RK rhs carries + vlo wall planes) and the
Poisson solve adds transform temporaries; on multi-device meshes the
all-to-all stages add one field-sized staging buffer per direction.  Check
the estimate against the compiled step's memory_analysis(), which
chip_smoke.py prints for the 512x256x256 LES.

Usage: python utils/estimate_memory_footprint.py --ng 1024x512x512 \
    --mesh 4 [--dtype float32] [--scalar] [--impdiff]
"""
import argparse


def estimate_footprint_bytes(ng, nchips=1, itemsize=4, scalar=False,
                             impdiff=False, z_periodic=False):
    """Bytes of live device memory per device for one production step."""
    n = ng[0] * ng[1] * ng[2] / nchips
    nfields = 5 + (1 if scalar else 0)          # u v w p visct (+s)
    ncarry = 3 + (1 if scalar else 0)           # rhs_old RK carries
    state = (nfields + ncarry) * n * itemsize
    # solver + XLA fusion temporaries (~8 fields)
    solve = 8 * n * itemsize
    if z_periodic:
        solve += 1 * n * itemsize               # rank-1 two-RHS Thomas
    if impdiff:
        solve += 1 * n * itemsize               # CN Helmholtz RHS
    temps = 0.0
    comm = (2 * n * itemsize) if nchips > 1 else 0   # all-to-all staging
    return state + solve + temps + comm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--ng', default='512x256x256')
    ap.add_argument('--mesh', type=int, default=1, help='number of devices')
    ap.add_argument('--dtype', default='float32',
                    choices=['float32', 'float64'])
    ap.add_argument('--scalar', action='store_true')
    ap.add_argument('--impdiff', action='store_true')
    ap.add_argument('--z-periodic', action='store_true')
    ap.add_argument('--mem-gib', type=float, default=80.0,
                    help='device memory per device in GiB (default: an '
                         '80 GB H100)')
    args = ap.parse_args()

    ng = tuple(int(v) for v in args.ng.split('x'))
    itemsize = 4 if args.dtype == 'float32' else 8
    b = estimate_footprint_bytes(ng, args.mesh, itemsize, args.scalar,
                                 args.impdiff, args.z_periodic)
    gib = b / 1024.0 ** 3
    cells = ng[0] * ng[1] * ng[2] / args.mesh
    print(f'{args.ng} on {args.mesh} device(s), {args.dtype}: '
          f'~{gib:.2f} GiB/device live ({b / cells:.1f} B/cell), '
          f'{gib / args.mem_gib * 100:.0f}% of {args.mem_gib:.0f} GiB')
    if gib > 0.85 * args.mem_gib:
        print('WARNING: above ~85% of device memory — expect allocation '
              'failures; shard over more devices or drop to float32')


if __name__ == '__main__':
    main()
