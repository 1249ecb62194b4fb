"""Smoke run of the solver on NVIDIA GPUs, through the entry points a user
calls, at production sizes.

    python chip_smoke.py           one card: phases 1-4 below
    python chip_smoke.py --multi   four cards: the sharded comparisons only

Phases (one card):
  1. CLI run of examples/turbulent_channel/input.nml (512x256x144 DNS) for
     20 steps through ``python -m cales_tpu``'s main(); the checkpoint it
     writes must read back.
  2. Channel LES (static Smagorinsky) at 512x256x256 float32, 10 steps of
     Simulation.multi_step, against the same run in float64.
  3. Every configuration class in float64 at 64x32x32 for 3 steps, the GPU
     run against the same program on the host CPU in this process.
  4. The z stage of the Poisson solve: each z solver alone at the spectral
     shape of phase 2 and in the phase-2 step.

Every phase prints one JSON line with the card (nvidia-smi name and power
limit), its wall times and its errors beside their bounds.  A failed phase
fails the script: it exits non-zero and does not print the final line.  The
last line is the device record
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
The script refuses to run (non-zero exit, no result) where JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CLI_DECK = REPO / 'examples' / 'turbulent_channel' / 'input.nml'
LES_NG = (512, 256, 256)       # headline LES (bench.py), nx, ny, nz
CLASS_NG = (64, 32, 32)
MULTI_NG = ((512, 256, 256), (1024, 512, 512))

# f32 vs f64 after 10 steps of the phase-2 LES, relative to max|u64|: a
# float32 step carries ~1e-7 round-off per operation, and 30 substeps of a
# projection method on a 33.5M-cell grid amplify it to ~1e-5 at most
F32_VS_F64_BOUND = 1e-4
# post-projection max divergence of the float32 LES: the reference aborts at
# 10*sqrt(eps) = 3.5e-3 (main.f90:536-543); a healthy f32 projection leaves
# round-off of eps * max|u| * max(1/dz) = 1.2e-7 * 1.2 * 230 ~ 3e-5
F32_DIV_BOUND = 1e-4
# float64 GPU vs CPU, and sharded vs one device: the decomposition-invariance
# budget (reduction reassociation only)
F64_BOUND = 1e-10
# each z solver in float64 against tridiag.thomas in float64
ZSOLVE_F64_BOUND = 1e-10


def card():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel(a, b):
    # the float64 reference promotes a float32 (or complex64) result
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
def les_config(ng, dtype, **kw):
    """The headline channel LES (bench.py's configuration)."""
    from cales_tpu.config import Config
    return Config(ng=ng, l=(2 * np.pi, np.pi, 2.0), gtype=1, gr=1.0,
                  visci=20_000.0, inivel='log', is_wallturb=True,
                  is_forced=(True, False, False), velf=(1.0, 0.0, 0.0),
                  sgstype='smag', dtype=dtype,
                  cbcsgs=(('P', 'P', 'D'), ('P', 'P', 'D')), **kw)


def build(cfg, mesh=None, fields=None):
    from cales_tpu.grid import make_grid_from_config
    from cales_tpu.initflow import initflow
    from cales_tpu.timeloop import Simulation
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid, mesh=mesh)
    if fields is None:
        fields = initflow(cfg, grid)
    state = sim.initial_state(*fields)
    if mesh is not None:
        import jax
        from cales_tpu.parallel.mesh import field_sharding
        sh = field_sharding(mesh)
        state = state._replace(**{k: jax.device_put(getattr(state, k), sh)
                                  for k in ('u', 'v', 'w', 'p', 'visct')})
    return sim, state


def timed_steps(sim, state, dt, n):
    """multi_step(n) with its wall time (state is donated)."""
    import jax
    t0 = time.perf_counter()
    state = sim.multi_step(state, dt, n)
    jax.block_until_ready(state.u)
    return state, time.perf_counter() - t0


# ---------------------------------------------------------------------------
def phase_cli(dev):
    import jax
    from cales_tpu.__main__ import main
    from cales_tpu.io.checkpoint import load_checkpoint
    from cales_tpu.nml import config_from_nml
    deck = CLI_DECK
    cfg = config_from_nml(str(deck))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = main([str(deck), '--max-steps', '20', '--datadir', tmp])
        wall = time.perf_counter() - t0
        check(rc == 0, f'CLI returned {rc}')
        u, v, w, p, t, istep = load_checkpoint(Path(tmp) / 'fld.bin', cfg.ng,
                                               cfg.np_dtype)
        finite = all(np.isfinite(a).all() for a in (u, v, w, p))
        check(istep == 20 and finite,
              f'checkpoint: istep={istep}, finite={finite}')
        ub = float(np.mean(u))
    emit(phase=1, name='cli_turbulent_channel', card=dev, ng=list(cfg.ng),
         dtype=cfg.dtype, steps=20, wall_s=wall, checkpoint_istep=istep,
         checkpoint_time=t, u_mean=ub, ok=True)
    jax.clear_caches()


def phase_les(dev):
    import jax
    ng = LES_NG
    nst = 10
    dt = 2e-4
    out = {}
    for dtype in ('float32', 'float64'):
        t0 = time.perf_counter()
        sim, st0 = build(les_config(ng, dtype))
        jax.block_until_ready(st0.u)
        setup = time.perf_counter() - t0
        st1, first = timed_steps(sim, st0, dt, nst)       # compiles
        u_ref = np.asarray(st1.u)
        st2, wall = timed_steps(sim, st1, dt, nst)
        # the memory analysis of the compiled program (the persistent
        # compile cache makes this lowering a cache hit)
        with sim._x64():
            ma = sim._multi.lower(st2, jax.numpy.asarray(dt, sim.dtype),
                                  nst).compile().memory_analysis()
        _, _, divmax = sim.check(st2)
        out[dtype] = u_ref
        emit(phase=2, name=f'les_{dtype}', card=dev, ng=list(ng), steps=nst,
             exec_path=sim.exec_path(), setup_s=setup, first_call_s=first,
             step_ms=wall / nst * 1e3,
             ns_per_cell_substep=wall / nst / 3 / np.prod(ng) * 1e9,
             divmax=divmax,
             memory=dict(argument=ma.argument_size_in_bytes,
                         output=ma.output_size_in_bytes,
                         temp=ma.temp_size_in_bytes,
                         alias=ma.alias_size_in_bytes))
        if dtype == 'float32':
            check(divmax <= F32_DIV_BOUND,
                  f'f32 divergence {divmax} > {F32_DIV_BOUND}')
        del sim, st0, st1, st2
    e = rel(out['float32'], out['float64'])
    emit(phase=2, name='les_f32_vs_f64', card=dev, rel_err_u=e,
         bound=F32_VS_F64_BOUND, ok=e <= F32_VS_F64_BOUND)
    check(e <= F32_VS_F64_BOUND, f'f32 vs f64 {e} > {F32_VS_F64_BOUND}')
    jax.clear_caches()


def class_configs(ng):
    """Every configuration class the repo ships, float64."""
    from cales_tpu import models
    f64 = dict(dtype='float64')
    chan = models.channel_dns(ng=ng, **f64)
    return {
        'triperiodic': models.taylor_green_3d(ng=ng, **f64),
        'channel': chan,
        'channel_impdiff_1d': chan.replace(impdiff_1d=True),
        'channel_les_smag': models.channel_les(ng=ng, **f64),
        'channel_wmles': models.channel_wmles(ng=ng, **f64),
        'duct_les_dsmag': models.square_duct_les(ng=ng, **f64),
        'cavity_les_dsmag': models.spanwise_cavity(ng=ng, sgstype='dsmag',
                                                   **f64),
        'passive_scalar': chan.replace(
            scalar=True, pr=0.71, iniscal='uni', ssource=0.02,
            cbcscal=(('P', 'P', 'D'), ('P', 'P', 'D')),
            bcscal=((0.0, 0.0, 1.0), (0.0, 0.0, 0.5))),
        'x_walled_inflow': models.developing_channel(ng=ng, **f64),
        'closed_box': models.lid_driven_cavity(ng=ng, **f64),
    }


def run_class(cfg, fields, dt, nsteps):
    sim, state = build(cfg, fields=fields)
    for _ in range(nsteps):
        state, _ = sim.step(state, dt)
    out = {k: np.asarray(getattr(state, k)) for k in ('u', 'v', 'w', 'p',
                                                       'visct')}
    if state.s is not None:
        out['s'] = np.asarray(state.s)
    out['p'] = out['p'] - out['p'].mean()      # singular-mode gauge
    return sim, out


def phase_classes(dev):
    import jax
    from cales_tpu.grid import make_grid_from_config
    from cales_tpu.initflow import initflow
    from cales_tpu.runtime import compile_cache_off
    cpu = jax.devices('cpu')[0]
    rng = np.random.default_rng(20261016)
    rows = {}
    for name, cfg in class_configs(CLASS_NG).items():
        grid = make_grid_from_config(cfg)
        # seeded asymmetric perturbation: symmetric start-up flows can
        # cancel a lowering difference exactly
        fields = tuple(np.asarray(f) + 1e-2 * rng.standard_normal(f.shape)
                       for f in initflow(cfg, grid))
        dt = 1e-3
        t0 = time.perf_counter()
        sim_g, g = run_class(cfg, fields, dt, 3)
        tg = time.perf_counter() - t0
        check(sim_g.device.platform == 'gpu', sim_g.exec_path())
        t0 = time.perf_counter()
        # the same configuration on the host: zsolver 'auto' resolves to the
        # eig contractions there, an exact solver like the GPU's sweep, so
        # only the pressure gauge differs (removed in run_class)
        with compile_cache_off(), jax.default_device(cpu):
            sim_c, c = run_class(cfg, fields, dt, 3)
        tc = time.perf_counter() - t0
        check(sim_c.device.platform == 'cpu', sim_c.exec_path())
        errs = {k: rel(g[k], c[k]) for k in g if np.abs(c[k]).max() > 0}
        finite = all(np.isfinite(a).all() for a in g.values())
        worst = max(errs.values())
        rows[name] = dict(max_rel_err=worst, gpu_s=tg, cpu_s=tc,
                          finite=finite, exec_path=sim_g.exec_path())
        check(finite and worst <= F64_BOUND,
              f'{name}: GPU vs CPU {errs}, finite={finite}')
    emit(phase=3, name='classes_gpu_vs_cpu_f64', card=dev, ng=list(CLASS_NG),
         steps=3, bound=F64_BOUND, classes=rows, ok=True)
    jax.clear_caches()


def phase_zsolve(dev):
    """The z stage: each solver alone at the spectral shape of phase 2 and
    in the phase-2 float32 step."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from unittest import mock
    from cales_tpu import poisson
    from cales_tpu.ops.tridiag import thomas
    ng = LES_NG
    cfg = les_config(ng, 'float32')
    sim_e, _ = build(cfg.replace(zsolver='eig'))
    sv_e = sim_e.solver_p
    sv_t = poisson.make_solver(cfg, sim_e.grid, ('PP', 'PP', 'NN'),
                               ('c', 'c', 'c'), zsolver='thomas',
                               platform='gpu')
    solvers = {poisson.z_solver_name(sv): sv
               for sv in (sv_e, sv_t, dataclasses.replace(sv_t, zimpl='scan'))}
    nz = ng[2]
    lamxy = (sv_e.lamy[:, None] + sv_e.lamx[None, :ng[0] // 2 + 1])
    # the singular column is pinned or projected by the solvers; keep the
    # comparison to well-posed columns
    lamxy[0, 0] = lamxy[0, 1]
    rng = np.random.default_rng(1)
    shape = (nz,) + lamxy.shape
    r64 = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    with jax.enable_x64(True):
        ref = np.asarray(jax.jit(lambda r: thomas(
            sv_e.a, sv_e.b, sv_e.c, r, lam=jnp.asarray(lamxy),
            regularize=False))(jnp.asarray(r64)))
    alone = {}
    for dtype, cdt in (('float32', np.complex64), ('float64', np.complex128)):
        with jax.enable_x64(dtype == 'float64'):
            r = jnp.asarray(r64.astype(cdt))
            lam = jnp.asarray(lamxy, dtype)
            for label, sv in solvers.items():
                f = jax.jit(lambda r, sv=sv: poisson._z_stage(sv, r, lam, 0.0,
                                                              None))
                x = f(r).block_until_ready()
                t0 = time.perf_counter()
                for _ in range(20):
                    x = f(r)
                x.block_until_ready()
                ms = (time.perf_counter() - t0) / 20 * 1e3
                alone[f'{label} {dtype}'] = dict(ms=ms, rel_err=rel(x, ref))
    for k, v in alone.items():
        if k.endswith('float64'):
            check(v['rel_err'] <= ZSOLVE_F64_BOUND, f'{k}: {v}')
    emit(phase=4, name='zsolve_alone', card=dev, spectral_shape=list(shape),
         f64_bound=ZSOLVE_F64_BOUND, solvers=alone)

    # in the step: the same LES with each z solver, timed in turns
    dt = 2e-4
    nst = 5
    runs = {}
    for zsolver, impl in (('eig', None), ('thomas', 'sweep'),
                          ('thomas', 'scan')):
        with mock.patch.object(poisson, 'thomas_impl',
                               lambda *a, impl=impl: impl):
            sim, st = build(cfg.replace(zsolver=zsolver))
        st, _ = timed_steps(sim, st, dt, nst)      # compiles
        runs[poisson.z_solver_name(sim.solver_p)] = [sim, st, []]
    for _ in range(3):
        for label, run in runs.items():
            run[1], wall = timed_steps(run[0], run[1], dt, nst)
            run[2].append(wall / nst * 1e3)
    step = {}
    for label, (sim, st, ms) in runs.items():
        _, _, divmax = sim.check(st)
        step[label] = dict(step_ms=sorted(ms)[len(ms) // 2], runs_ms=ms,
                           divmax=divmax)
        check(divmax <= F32_DIV_BOUND, f'{label}: divergence {divmax}')
    emit(phase=4, name='zsolve_in_step', card=dev, ng=list(ng),
         steps_per_window=nst, solvers=step)
    jax.clear_caches()


# ---------------------------------------------------------------------------
def phase_multi(dev, devices):
    import jax
    from cales_tpu.parallel.mesh import make_mesh
    ng = MULTI_NG[0]
    dt = 2e-4
    # the decomposition-invariance check runs one algorithm on both sides:
    # a mesh resolves zsolver 'auto' to the eig contractions
    cfg64 = les_config(ng, 'float64', zsolver='eig')
    sim1, st1 = build(cfg64)
    for _ in range(2):
        st1, _ = sim1.step(st1, dt)
    ref = {k: np.asarray(getattr(st1, k)) for k in ('u', 'v', 'w', 'visct')}
    ref['p'] = np.asarray(st1.p) - np.asarray(st1.p).mean()
    del sim1, st1
    for dims in ((4, 1), (2, 2)):
        mesh = make_mesh(dims, devices)
        t0 = time.perf_counter()
        sim, st = build(cfg64, mesh=mesh)
        for _ in range(2):
            st, _ = sim.step(st, dt)
        jax.block_until_ready(st.u)
        wall = time.perf_counter() - t0
        got = {k: np.asarray(getattr(st, k)) for k in ref if k != 'p'}
        got['p'] = np.asarray(st.p) - np.asarray(st.p).mean()
        errs = {k: rel(got[k], ref[k]) for k in ref}
        worst = max(errs.values())
        emit(phase='multi', name=f'mesh_{dims[0]}x{dims[1]}_f64_vs_single',
             card=dev, ng=list(ng), steps=2, wall_s=wall, rel_errs=errs,
             bound=F64_BOUND, exec_path=sim.exec_path(),
             ok=worst <= F64_BOUND)
        check(worst <= F64_BOUND, f'mesh {dims}: {errs}')
        del sim, st
    ng = MULTI_NG[1]
    mesh = make_mesh((4, 1), devices)
    sim, st = build(les_config(ng, 'float32'), mesh=mesh)
    st, first = timed_steps(sim, st, dt, 5)
    st, wall = timed_steps(sim, st, dt, 5)
    _, _, divmax = sim.check(st)
    finite = bool(np.isfinite(np.asarray(st.u)).all())
    emit(phase='multi', name='les_1024x512x512_f32_mesh_4x1', card=dev,
         ng=list(ng), steps=5, first_call_s=first, step_ms=wall / 5 * 1e3,
         ns_per_cell_substep=wall / 5 / 3 / np.prod(ng) * 1e9,
         divmax=divmax, div_bound=F32_DIV_BOUND, finite=finite,
         exec_path=sim.exec_path())
    check(finite and divmax <= F32_DIV_BOUND, f'1024-class: div {divmax}')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--multi', action='store_true',
                    help='four-card path: mesh comparisons only')
    args = ap.parse_args(argv)

    import jax
    if jax.devices()[0].platform != 'gpu':
        print(f'chip_smoke: no GPU (JAX found {jax.devices()[0].platform})',
              file=sys.stderr)
        return 2
    jax.config.update('jax_enable_x64', True)
    from cales_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    dev = card()
    devices = jax.devices()
    if args.multi:
        if len(devices) < 4:
            print(f'chip_smoke --multi: needs 4 GPUs, found {len(devices)}',
                  file=sys.stderr)
            return 2
        phase_multi(dev, devices[:4])
    else:
        phase_cli(dev)
        phase_les(dev)
        phase_classes(dev)
        phase_zsolve(dev)
    print(dev, flush=True)      # nvidia-smi's name, power.limit line
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
