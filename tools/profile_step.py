#!/usr/bin/env python3
"""Capture + summarize a device profile of N time steps (development tool).

Usage: python tools/profile_step.py [--ng 256 128 128] [--steps 3] [--sgs smag]
Writes the raw trace under profile_trace/ and prints the per-op
device-time summary.
"""
import argparse, collections, glob, gzip, json, re, sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--ng', type=int, nargs=3, default=[256, 128, 128])
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--sgs', default='smag')
    ap.add_argument('--flavor', default='channel',
                    choices=['channel', 'matrix'],
                    help="'matrix': --sgs selects a bench.py matrix config "
                         "name instead (e.g. duct_les_dsmag)")
    ap.add_argument('--out', default='profile_trace')
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from cales_tpu.config import Config
    from cales_tpu.grid import make_grid_from_config
    from cales_tpu.initflow import initflow
    from cales_tpu.timeloop import Simulation

    if args.flavor == 'matrix':
        import bench
        cfg = Config(**bench._matrix_configs(tuple(args.ng))[args.sgs])
    else:
        cfg = Config(ng=tuple(args.ng), l=(2*np.pi, np.pi, 2.0), gtype=1,
                     gr=1.0, visci=20000.0, inivel='log', is_wallturb=True,
                     is_forced=(True, False, False), velf=(1., 0., 0.),
                     sgstype=args.sgs, dtype='float32')
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid)
    state = sim.initial_state(*initflow(cfg, grid))
    dt = 1e-4
    s = sim.multi_step(state, dt, args.steps)
    jax.block_until_ready(s.u)
    jax.profiler.start_trace(args.out)
    s = sim.multi_step(s, dt, args.steps)
    jax.block_until_ready(s.u)
    jax.profiler.stop_trace()
    # instruction name -> op_name metadata (carries the named scopes)
    with sim._x64():
        hlo = sim._multi.lower(s, jnp.asarray(dt, sim.dtype),
                               args.steps).compile().as_text()
    op_names = dict(re.findall(
        r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name="([^"]+)"', hlo, re.M))

    path = sorted(glob.glob(f'{args.out}/plugins/profile/*/*.trace.json.gz'))[-1]
    with gzip.open(path) as f:
        tr = json.load(f)
    # device lanes: the process whose name names the device (GPU streams),
    # else every event (the CPU backend runs ops on host threads)
    pnames = {e['pid']: e.get('args', {}).get('name', '')
              for e in tr['traceEvents'] if e.get('ph') == 'M'
              and e.get('name') == 'process_name'}
    dev = {p for p, n in pnames.items() if '/device:' in n}
    scopes = ('momentum_rhs', 'poisson', 'sgs', 'thomas_z')
    durs, cnt = collections.Counter(), collections.Counter()
    by_scope = collections.Counter()
    spans = []
    for e in tr['traceEvents']:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        if dev and e.get('pid') not in dev:
            continue
        nm = e.get('name', '?')
        hlo_op = e.get('args', {}).get('hlo_op')
        if nm.startswith('while') or (not dev and hlo_op is None):
            continue
        key = re.sub(r'[._]\d+$', '', nm)
        durs[key] += e['dur']
        cnt[key] += 1
        text = ' '.join([nm, op_names.get(hlo_op or nm, '')])
        scope = next((sc for sc in scopes if sc in text), 'other')
        by_scope[scope] += e['dur']
        spans.append((e['ts'], e['ts'] + e['dur']))
    tot = sum(durs.values())
    busy = 0.0
    end = -1.0
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    window = (max(t1 for _, t1 in spans) - min(t0 for t0, _ in spans)
              if spans else 0.0)
    print(f'device kernel time: {tot/1e3:.2f} ms / {args.steps} steps; '
          f'busy {busy/1e3:.2f} ms of a {window/1e3:.2f} ms window')
    for sc, d in by_scope.most_common():
        print(f'  scope {sc:13s} {d/1e3:9.3f} ms ({d / max(tot, 1):.1%})')
    for name, d in durs.most_common(20):
        print(f'{d/1e3:9.3f} ms x{cnt[name]:4d}  {name[:90]}')


if __name__ == '__main__':
    main()
