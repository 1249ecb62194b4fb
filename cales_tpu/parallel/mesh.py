"""Device-mesh domain decomposition.

JAX replacement of the reference's pencil-decomposition runtimes
(2DECOMP&FFT and NVIDIA cuDecomp, SURVEY.md §2.2; initmpi.f90:34-206):

  * the global (nz, ny, nx) field is sharded over a 2D ``Mesh`` with axes
    ('gy', 'gx') covering the y and x directions; z stays local per device —
    the analogue of the reference's default X-pencil layout with the
    tridiagonal direction kept on-device (SURVEY.md §5.7);
  * halo exchanges: XLA's SPMD partitioner emits collective-permutes for the
    shifted-slice/concat patterns of the ghost layer (the cudecompUpdateHalos
    analogue, bound.f90:698-723);
  * the Poisson solver's pencil transposes (solver_gpu.f90:80-158) become
    sharding constraints around each transform stage; GSPMD lowers the
    resharding to all-to-alls (NCCL over NVLink on GPUs);
  * the reference's communication-backend autotuning (param.f90:180-217)
    collapses into the mesh-shape choice — there is a single XLA backend.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(dims, devices=None) -> Mesh:
    """Build the ('gy', 'gx') mesh; dims = (ny_shards, nx_shards), matching
    the reference's `dims` namelist (param.f90:54, initmpi.f90:56-73)."""
    if devices is None:
        devices = jax.devices()
    n = dims[0] * dims[1]
    if len(devices) < n:
        raise ValueError(f'need {n} devices, have {len(devices)}')
    dev = np.asarray(devices[:n]).reshape(dims[0], dims[1])
    return Mesh(dev, axis_names=('gy', 'gx'))


def field_spec() -> P:
    """Base sharding of a (nz, ny, nx) field: z local, y/x split."""
    return P(None, 'gy', 'gx')


def field_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, field_spec())


class ShardingHints:
    """Sharding-constraint hooks used inside the jitted step.  With no mesh
    every hook is the identity, so single-device code paths are unchanged."""

    def __init__(self, mesh: Mesh | None):
        self.mesh = mesh

    def _c(self, x, spec):
        if self.mesh is None:
            return x
        return jax.lax.with_sharding_constraint(x, NamedSharding(self.mesh, spec))

    def field(self, x):
        """canonical layout: (z, y:gy, x:gx)"""
        return self._c(x, P(None, 'gy', 'gx'))

    def x_local(self, x):
        """x-transform stage: x gathered, z takes gx (TransposeXtoY analogue)"""
        return self._c(x, P('gx', 'gy', None))

    def y_local(self, x):
        """y-transform stage: y gathered, x takes gy"""
        return self._c(x, P('gx', None, 'gy'))

    def z_local(self, x):
        """tridiagonal stage: z gathered, (ky, kx) split"""
        return self._c(x, P(None, 'gy', 'gx'))
