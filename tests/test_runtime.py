"""Runtime setup shared by the entry points: the compile-cache helper, the
device a Simulation lands on, exec_path(), the precision a Simulation
traces in, and chip_smoke.py's refusal to run without a GPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cales_tpu import models, runtime
from cales_tpu.grid import make_grid_from_config
from cales_tpu.initflow import initflow
from cales_tpu.timeloop import Simulation

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update('jax_compilation_cache_dir', old)


class _FakeDevice:
    platform = 'gpu'
    device_kind = 'fake'


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the helper
    reports it and sets nothing."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '/some/where')
    monkeypatch.setattr(jax, 'devices', lambda *a: [_FakeDevice()])
    assert runtime.enable_compile_cache() == '/some/where'
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_dir):
    """Without the variable a GPU run caches at one fixed path inside the
    checkout, which .gitignore lists."""
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    monkeypatch.setattr(jax, 'devices', lambda *a: [_FakeDevice()])
    path = runtime.enable_compile_cache()
    assert path == str(REPO / '.jax_cache')
    assert jax.config.jax_compilation_cache_dir == path
    assert '.jax_cache/' in (REPO / '.gitignore').read_text().split()


def test_compile_cache_off_on_cpu(monkeypatch, restore_cache_dir):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_off_writes_nothing(tmp_path, restore_cache_dir):
    """Inside compile_cache_off nothing reaches the persistent cache, even
    after the process has used it; on exit the cache is in use again."""
    opts = {'jax_persistent_cache_min_compile_time_secs': 0,
            'jax_persistent_cache_min_entry_size_bytes': 0}
    old = {k: getattr(jax.config, k) for k in opts}
    jax.config.update('jax_compilation_cache_dir', str(tmp_path))
    for k, v in opts.items():
        jax.config.update(k, v)
    x = jnp.arange(3.0)
    try:
        runtime.compilation_cache.reset_cache()
        jax.jit(lambda a: a * 2.0 + 1.0)(x).block_until_ready()
        n_used = len(list(tmp_path.iterdir()))
        assert n_used > 0
        with runtime.compile_cache_off():
            jax.jit(lambda a: a * 3.0 - 1.0)(x).block_until_ready()
            assert len(list(tmp_path.iterdir())) == n_used
        jax.jit(lambda a: a * 5.0 - 2.0)(x).block_until_ready()
        assert len(list(tmp_path.iterdir())) > n_used
    finally:
        for k, v in old.items():
            jax.config.update(k, v)
        runtime.compilation_cache.reset_cache()


def test_default_device_follows_context_and_mesh():
    from cales_tpu.parallel.mesh import make_mesh
    cpus = jax.devices('cpu')
    assert runtime.default_device() == jax.devices()[0]
    with jax.default_device(cpus[1]):
        assert runtime.default_device() == cpus[1]
    mesh = make_mesh((2, 2), cpus[2:6])
    assert runtime.default_device(mesh) == cpus[2]


@pytest.mark.parametrize('name,cfg,expect', [
    ('channel_les', models.channel_les(ng=(16, 8, 8), dtype='float32'),
     ('cpu (cpu)', 'transforms x=fft y=fft', 'z solver eig',
      'matmul precision HIGHEST', 'float32')),
    ('duct_thomas', models.square_duct_les(ng=(16, 8, 8), dtype='float64',
                                           zsolver='thomas'),
     ('transforms x=fft y=mat', 'z solver thomas (scan)', 'float64')),
    ('box_mat', models.lid_driven_cavity(ng=(8, 8, 8), dtype='float64'),
     ('transforms x=mat y=mat',)),
])
def test_exec_path_reports_device_transforms_solver(name, cfg, expect):
    sim = Simulation(cfg, make_grid_from_config(cfg))
    path = sim.exec_path()
    for part in expect:
        assert part in path, (part, path)
    assert 'fallback' not in path.lower()


def test_f32_simulation_under_x64_keeps_f32():
    """With x64 on process-wide (as in these tests and chip_smoke.py), a
    float32 Simulation still traces in float32: multi_step's loop carry
    and every state field keep their dtype."""
    assert jax.config.jax_enable_x64
    cfg = models.channel_les(ng=(16, 8, 8), dtype='float32')
    grid = make_grid_from_config(cfg)
    sim = Simulation(cfg, grid)
    st = sim.initial_state(*initflow(cfg, grid))
    st = sim.multi_step(st, 1e-3, 2)
    st, dpdl = sim.step(st, 1e-3)
    for leaf in jax.tree_util.tree_leaves(st):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            assert leaf.dtype == jnp.float32
    assert dpdl.dtype == jnp.float32
    assert np.isfinite(np.asarray(st.u)).all()


def test_chip_smoke_refuses_without_gpu(capsys):
    """In-process: no GPU -> non-zero return and no result on stdout."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(['--multi']) != 0
    assert capsys.readouterr().out == ''


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    exits non-zero and prints no result."""
    (tmp_path / 'chip_smoke.py').write_text(
        (REPO / 'chip_smoke.py').read_text())
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['JAX_PLATFORMS'] = 'cpu'
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
