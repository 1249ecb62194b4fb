"""Process-level runtime setup shared by the entry points (CLI, bench,
chip_smoke, validation scripts): the device a run lands on and JAX's
persistent compilation cache."""
from __future__ import annotations

import contextlib
import os
from pathlib import Path

import jax
from jax.experimental.compilation_cache import compilation_cache

# fixed in-checkout cache path (listed in .gitignore): the path is part of
# the cache key, so it must not move between runs
CACHE_DIR = Path(__file__).resolve().parent.parent / '.jax_cache'


def default_device(mesh=None):
    """The device a computation lands on: the mesh's first device, else the
    current default device (a ``jax.default_device`` context, or the first
    attached device)."""
    if mesh is not None:
        return mesh.devices.flat[0]
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.devices()[0]
    if isinstance(dev, str):
        return jax.devices(dev)[0]
    return dev


def enable_compile_cache():
    """Turn on the persistent compilation cache for GPU runs.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    is changed here.  Otherwise GPU runs cache under ``CACHE_DIR``.  CPU runs
    stay uncached: XLA:CPU executables are pinned to the host's CPU
    features, and a mismatched entry can load as a corrupt executable.
    Returns the directory in use, or None."""
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    if jax.devices()[0].platform != 'gpu':
        return None
    jax.config.update('jax_compilation_cache_dir', str(CACHE_DIR))
    return str(CACHE_DIR)


@contextlib.contextmanager
def compile_cache_off():
    """Compile without the persistent cache inside the block: for an XLA:CPU
    oracle in a GPU process, whose cache another host may have filled (see
    enable_compile_cache).  JAX decides once per process whether the cache
    is in use, so the decision is reset on entry and on exit."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update('jax_enable_compilation_cache', False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update('jax_enable_compilation_cache', was)
        compilation_cache.reset_cache()
