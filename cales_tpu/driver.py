"""Simulation driver: the counterpart of the reference executable
(/root/reference/src/main.f90:28-632).

Orchestrates: config validation -> grid -> solver setup -> initial condition
or restart -> time loop with stopping criteria (nstep / time_max / tw_max),
cadenced stability+divergence checks with hard aborts (main.f90:523-544),
scalar logs (time.out, forcing.out), profile outputs, checkpoint rotation
with alias symlinks (main.f90:590-611), and per-step wall-time reporting
(main.f90:613-618).
"""
from __future__ import annotations

import math
import time as _time
from functools import reduce
from pathlib import Path

import numpy as np

import jax

from .config import Config, validate
from .grid import make_grid_from_config
from .initflow import initflow
from .timeloop import Simulation
from .io import checkpoint as ckpt
from .io import output as out


class SimulationAborted(RuntimeError):
    pass


def run(cfg: Config, datadir='data', mesh=None, verbose=True,
        max_steps=None, hooks=None):
    """Run a full simulation.  Returns (sim, state).

    hooks: optional dict of callables fired at output cadences:
      {'out1d': fn(sim, state, istep), 'out2d': ..., 'out3d': ...}
    replacing the reference's user-editable out?d.h90 include files
    (main.f90:380-394,575-589)."""
    validate(cfg)
    datadir = Path(datadir)
    datadir.mkdir(parents=True, exist_ok=True)
    grid = make_grid_from_config(cfg)
    # hwm band validity for every wall-modeled direction is enforced in
    # wallmodel.find_index_wm (sanity.f90:233-241), called by Simulation

    if mesh is None and cfg.dims[0] * cfg.dims[1] > 1:
        # namelist-driven decomposition (initmpi.f90:56-73): dims = (gy, gx)
        import jax as _jax
        from .parallel.mesh import make_mesh
        if len(_jax.devices()) >= cfg.dims[0] * cfg.dims[1]:
            mesh = make_mesh(cfg.dims)
        else:
            log(verbose, f'WARNING: dims={cfg.dims} needs more devices than '
                         f'available; running single-device')
    sim = Simulation(cfg, grid, mesh=mesh)
    # the reference prints its decomposition/backends at startup
    # (initmpi.f90:104-139): device, transforms, z solver, precision
    log(verbose, f'*** Execution path: {sim.exec_path()} ***')
    out.write_grid_files(datadir, cfg, grid)

    if cfg.restart:
        if mesh is not None:
            # per-shard reads (the MPI-IO subarray analogue, io/sharded.py)
            from .io import sharded as shio
            from .parallel.mesh import field_sharding
            u, v, w, p, t0, istep0 = shio.load_checkpoint_sharded(
                datadir / 'fld.bin', cfg.ng, cfg.np_dtype,
                field_sharding(mesh))
        else:
            u, v, w, p, t0, istep0 = ckpt.load_checkpoint(
                datadir / 'fld.bin', cfg.ng, cfg.np_dtype)
        state = sim.initial_state(u, v, w, p)
        if cfg.scalar:
            # scalar state lives in a sidecar (fld.bin stays
            # reference-compatible); restarting without it would silently
            # reset s to the initial profile
            spath = datadir / 'scal.bin'
            if not spath.exists():
                raise FileNotFoundError(
                    'restart with scalar=True requires data/scal.bin '
                    '(scalar sidecar checkpoint)')
            s, _, _ = ckpt.load_scalar(spath, cfg.ng, cfg.np_dtype)
            state = state._replace(s=jax.numpy.asarray(s, dtype=cfg.np_dtype))
        state = state._replace(time=state.time + t0,
                               istep=state.istep + istep0)
        log(verbose, f'*** Checkpoint loaded at time = {t0}, step = {istep0} ***')
    else:
        u, v, w, p = initflow(cfg, grid)
        state = sim.initial_state(u, v, w, p)
        log(verbose, '*** Initial condition successfully set ***')

    dt_cfl, divtot, divmax = sim.check(state)
    dt = sim.pick_dt(dt_cfl)
    log(verbose, f'dt_cfl = {dt_cfl:.6e}, dt = {dt:.6e}')

    small = math.sqrt(np.finfo(cfg.np_dtype).eps) * 10
    twi = _time.perf_counter()
    savecounter = 0
    kill = False
    is_done = False
    nsteps_done = 0
    hooks = hooks or {}
    averager = None
    if getattr(cfg, 'stats_avg', False):
        from .io.averaging import RunningMean
        averager = RunningMean()

    # advance between host-side events in one device dispatch (multi_step):
    # chunk = gcd of all active cadences, so no cadence is ever skipped
    cadences = [c for c in (cfg.icheck, cfg.iout0d, cfg.iout1d, cfg.iout2d,
                            cfg.iout3d, cfg.isave) if c > 0]
    if cfg.stop_type[0]:
        cadences.append(max(cfg.nstep, 1))
    chunk = max(reduce(math.gcd, cadences) if cadences else 1, 1)
    if max_steps is not None:
        chunk = max(math.gcd(chunk, max_steps), 1)

    while not is_done:
        t_step = _time.perf_counter()
        # time_max stopping: predict remaining steps from dt and fall back to
        # per-step advances for the tail, so production time_max runs keep the
        # multi-step dispatch (the reference loop has no such cliff)
        chunk_now = chunk
        if cfg.stop_type[1] and dt > 0:
            steps_left = max(int(math.ceil((cfg.time_max - float(state.time))
                                           / dt - 1e-9)), 1)
            if steps_left < chunk_now:
                chunk_now = 1
        if chunk_now > 1:
            state = sim.multi_step(state, dt, chunk_now - 1)
            nsteps_done += chunk_now - 1
        state, dpdl = sim.step(state, dt)
        istep = int(state.istep)
        tnow = float(state.time)
        nsteps_done += 1

        # stopping criteria (main.f90:513-522)
        if cfg.stop_type[0] and istep >= cfg.nstep:
            is_done = True
        if cfg.stop_type[1] and tnow >= cfg.time_max:
            is_done = True
        if cfg.stop_type[2] and (_time.perf_counter() - twi) / 3600.0 >= cfg.tw_max:
            is_done = True
        if max_steps is not None and nsteps_done >= max_steps:
            is_done = True

        # stability & divergence checks (main.f90:523-544)
        if cfg.icheck > 0 and istep % max(cfg.icheck, 1) == 0:
            dt_cfl, divtot, divmax = sim.check(state)
            dt = sim.pick_dt(dt_cfl)
            if dt_cfl < small:
                log(verbose, 'ERROR: time step is too small. Aborting...')
                is_done, kill = True, True
            if divmax > small or math.isnan(divtot):
                log(verbose, f'ERROR: maximum divergence too large '
                             f'({divmax:.3e}). Aborting...')
                is_done, kill = True, True

        # scalar logs (main.f90:548-573)
        if cfg.iout0d > 0 and istep % max(cfg.iout0d, 1) == 0:
            out.out0d(datadir / 'time.out', [istep, dt, tnow])
            if any(cfg.is_forced) or any(abs(b) > 0 for b in cfg.bforce):
                from .ops.stencil import bulk_mean
                mv = [0.0, 0.0, 0.0]
                if cfg.is_forced[0] or abs(cfg.bforce[0]) > 0:
                    mv[0] = float(bulk_mean(state.u, sim.gvr_f))
                if cfg.is_forced[1] or abs(cfg.bforce[1]) > 0:
                    mv[1] = float(bulk_mean(state.v, sim.gvr_f))
                if cfg.is_forced[2] or abs(cfg.bforce[2]) > 0:
                    mv[2] = float(bulk_mean(state.w, sim.gvr_c))
                dp = np.asarray(dpdl)
                if not any(cfg.is_forced):
                    dp = -np.asarray(cfg.bforce)
                out.out0d(datadir / 'forcing.out',
                          [tnow, dp[0], dp[1], dp[2], mv[0], mv[1], mv[2]])

        # profile / plane / volume outputs (main.f90:574-589)
        if cfg.iout1d > 0 and istep % max(cfg.iout1d, 1) == 0:
            if 'out1d' in hooks:
                hooks['out1d'](sim, state, istep)
            else:
                # default hook = the reference's out1d.h90: single-point
                # channel statistics (+ budgets); duct cross-section stats
                # when y is also wall-bounded (output.f90:509, 406)
                from .io import stats as st_io
                if cfg.cbc_pre(1) == 'PP':
                    padded = sim.padded_state(state)
                    sp = st_io.single_point_chan(
                        datadir / f'stats_{istep:07d}', cfg, grid,
                        np.asarray(state.u), np.asarray(state.v),
                        np.asarray(state.w), np.asarray(state.p),
                        np.asarray(state.visct), padded=padded)
                    bu = st_io.reystr_budget_chan(
                        datadir / f'stats_{istep:07d}', cfg, grid,
                        np.asarray(state.u), np.asarray(state.v),
                        np.asarray(state.w), np.asarray(state.p),
                        padded=padded)
                    if averager is not None:
                        from .io import averaging as avg_io
                        averager.add('sp', sp)
                        averager.add('budget', bu)
                        averager.tick()
                        avg_io.write_profile(datadir / 'stats_avg_chan.out',
                                             grid, averager.mean('sp'),
                                             averager.n)
                        avg_io.write_profile(
                            datadir / 'stats_avg_chan_reystr_budget.out',
                            grid, averager.mean('budget'), averager.n)
                else:
                    st_io.duct_stats_2d(
                        datadir / f'stats2d_{istep:07d}', cfg, grid,
                        np.asarray(state.u), np.asarray(state.v),
                        np.asarray(state.w))
        if cfg.iout2d > 0 and istep % max(cfg.iout2d, 1) == 0:
            if 'out2d' in hooks:
                hooks['out2d'](sim, state, istep)
            else:
                ny = cfg.ng[1]
                for name, f in (('u', state.u), ('v', state.v),
                                ('w', state.w), ('p', state.p)):
                    fn = datadir / f'{name}_2d_{istep:07d}.bin'
                    out.out2d(fn, np.asarray(f), 1, ny // 2)
                    out.write_log_output(datadir / 'log_visu_2d_slice_1.out',
                                         fn.name, name, (1, ny // 2, 1),
                                         (cfg.ng[0], ny // 2, cfg.ng[2]),
                                         (1, 1, 1), tnow, istep)
        if cfg.iout3d > 0 and istep % max(cfg.iout3d, 1) == 0:
            if 'out3d' in hooks:
                hooks['out3d'](sim, state, istep)
            else:
                nskip = tuple(cfg.nskip_out3d)
                for name, f in (('u', state.u), ('v', state.v),
                                ('w', state.w), ('p', state.p)):
                    fn = datadir / f'{name}_{istep:07d}.bin'
                    out.write_field_bin(fn, np.asarray(f), nskip=nskip)
                    out.write_log_output(datadir / 'log_visu_3d.out', fn.name,
                                         name, (1, 1, 1), cfg.ng, nskip,
                                         tnow, istep)

        # checkpoint (main.f90:590-611)
        if (cfg.isave > 0 and istep % max(cfg.isave, 1) == 0) or \
                (is_done and not kill):
            if cfg.is_overwrite_save:
                filename = 'fld.bin'
            else:
                if cfg.nsaves_max > 0:
                    if savecounter >= cfg.nsaves_max:
                        savecounter = 0
                    savecounter += 1
                    filename = f'fld_{savecounter:04d}.bin'
                    out.out0d(datadir / 'log_checkpoints.out',
                              [istep, tnow, savecounter])
                else:
                    filename = f'fld_{istep:07d}.bin'
            if mesh is not None:
                from .io import sharded as shio
                shio.save_checkpoint_sharded(
                    datadir / filename, (state.u, state.v, state.w, state.p),
                    cfg.ng, tnow, istep)
            else:
                ckpt.save_checkpoint(datadir / filename, np.asarray(state.u),
                                     np.asarray(state.v), np.asarray(state.w),
                                     np.asarray(state.p), tnow, istep)
            if cfg.scalar:
                sname = filename.replace('fld', 'scal')
                ckpt.save_scalar(datadir / sname, np.asarray(state.s),
                                 tnow, istep)
                if not cfg.is_overwrite_save:
                    ckpt.gen_alias(datadir, sname, alias='scal.bin')
            if not cfg.is_overwrite_save:
                ckpt.gen_alias(datadir, filename)
            log(verbose, f'*** Checkpoint saved at time = {tnow}, '
                         f'step = {istep} ***')

        jax.block_until_ready(state.u)
        dt_wall = _time.perf_counter() - t_step
        log(verbose, f'step {istep}  t = {tnow:.6e}  dt = {dt:.3e}  '
                     f'wall = {dt_wall:.3f}s'
                     + (f' ({chunk_now} steps/dispatch)' if chunk_now > 1 else ''))

    if kill:
        raise SimulationAborted('simulation aborted (see log)')
    log(verbose, '*** Fim ***')
    return sim, state


def log(verbose, msg):
    if verbose:
        print(msg, flush=True)
