"""Per-shard checkpoint I/O for sharded arrays.

JAX counterpart of the reference's MPI-IO collective subarray writes
(io_field with MPI_TYPE_CREATE_SUBARRAY, load.f90:155-187): every process
writes/reads only its addressable shards of a sharded ``jax.Array``, placed
at the right (strided) offsets of the SAME ``fld.bin``-format file via a
memory map — O(shard) host memory instead of a full-field gather, and
byte-identical output to the gathered writer.  On a multi-host mesh over a
shared filesystem each host covers exactly its addressable shards (the
MPI-IO analogue); single-host meshes cover all shards.

File layout is unchanged from io/checkpoint.py: u, v, w, p in global
Fortran order (x fastest == our (z, y, x) C-order), then the (time, istep)
footer written by process 0.
"""
from __future__ import annotations

import numpy as np


def _multihost_barrier(tag: str):
    """Cross-host barrier around shared-FS file creation/footer writes.

    In a multi-host run (jax.distributed initialized) a non-zero process may
    open the checkpoint before process 0 has created/sized it, or process 0's
    truncate may discard bytes another host already wrote; both sides of the
    critical sections below are fenced.  Single-process runs are a no-op."""
    import jax
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)


def _field_offsets(ng, dtype):
    nx, ny, nz = ng
    n = nx * ny * nz
    itemsize = np.dtype(dtype).itemsize
    return n, itemsize


def save_checkpoint_sharded(path, fields, ng, time: float, istep: int):
    """fields: (u, v, w, p) sharded jax.Arrays (or numpy); ng=(nx,ny,nz).

    Each addressable shard is written at its global byte offsets through a
    memmap view; the footer goes in last (process 0 in a multi-host run —
    here, whoever calls)."""
    import jax

    nx, ny, nz = ng
    n, itemsize = _field_offsets(ng, fields[0].dtype)
    dtype = np.dtype(fields[0].dtype)
    nbytes = (4 * n + 2) * itemsize

    is_proc0 = jax.process_index() == 0
    # create/size the file once; barrier so no host memmaps a missing file
    # and proc 0's truncate cannot discard already-written shard bytes
    if is_proc0:
        with open(path, 'wb') as f:
            f.truncate(nbytes)
    _multihost_barrier(f'ckpt-create:{path}')
    mm = np.memmap(path, dtype=dtype, mode='r+', shape=(4 * n + 2,))
    for m, arr in enumerate(fields):
        view = mm[m * n:(m + 1) * n].reshape(nz, ny, nx)
        if hasattr(arr, 'addressable_shards'):
            for sh in arr.addressable_shards:
                view[sh.index] = np.asarray(sh.data)
        else:
            view[...] = np.asarray(arr)
    if is_proc0:
        mm[4 * n] = dtype.type(time)
        mm[4 * n + 1] = dtype.type(float(istep))
    mm.flush()
    del mm
    # all shards durable before any host reports the checkpoint complete
    _multihost_barrier(f'ckpt-flush:{path}')


def load_checkpoint_sharded(path, ng, dtype, sharding):
    """Read fld.bin into sharded device arrays: each device gets only its
    shard slice off the memmap (no full-field host materialization).
    Returns (u, v, w, p, time, istep)."""
    import os
    import jax

    nx, ny, nz = ng
    n, itemsize = _field_offsets(ng, dtype)
    expected = (4 * n + 2) * itemsize
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            f'checkpoint size mismatch: {actual} bytes, expected {expected} '
            f'for ng={ng} dtype={dtype} (load.f90:44-52 parity check)')
    mm = np.memmap(path, dtype=np.dtype(dtype), mode='r', shape=(4 * n + 2,))
    out = []
    shape = (nz, ny, nx)
    for m in range(4):
        view = mm[m * n:(m + 1) * n].reshape(shape)
        arr = jax.make_array_from_callback(
            shape, sharding, lambda idx, v=view: np.array(v[idx]))
        out.append(arr)
    time = float(mm[4 * n])
    istep = int(round(float(mm[4 * n + 1])))
    del mm
    return (*out, time, istep)
