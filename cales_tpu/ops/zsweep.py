"""Batched tridiagonal z-sweep as one Pallas kernel for NVIDIA GPUs (Triton).

The counterpart of the reference's ``gaussel_gpu`` (solver_gpu.f90:166-231):
one lane per (x, y) column and a sequential loop over z inside the program,
with the periodic rank-1 variant of ``gaussel_periodic`` (solver_gpu.f90:
233-371).  The plain-JAX reference is ``ops/tridiag.thomas`` /
``thomas_periodic``.

Layout: the (n, ny, nx) right-hand side is viewed as (n, ny*nx) (a free
reshape); each program owns ``block`` contiguous columns, so every row load
and store is coalesced along x, and the ragged last block is masked.  The
forward sweep writes the modified RHS into the output and ``c'`` into a
second device buffer; the backward sweep reads both back.

The coefficients a, b, c and the diagonal shift ``lam`` are real, so a
complex spectral RHS is solved as its real and imaginary planes inside one
program, sharing the pivots.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# columns per program (a power of two, as Triton requires) and warps: every
# block of 32-256 columns with 1-4 warps ran within 0.76-0.89 ms at the
# (256, 256, 257) complex64 shape on an H100 (PERF.md)
BLOCK = 64
NUM_WARPS = 2


def _kernel(a_ref, b_ref, c_ref, lam_ref, *refs, n, nrhs, ncol, block,
            pin_tol, periodic):
    rhs_refs = refs[:nrhs]
    out_refs = refs[nrhs:2 * nrhs]
    cp_ref = refs[2 * nrhs]
    q_ref = refs[2 * nrhs + 1] if periodic else None

    cols = pl.program_id(0) * block + jnp.arange(block)
    mask = cols < ncol

    def ld(ref, k):
        return plgpu.load(ref.at[k, :], mask=mask, other=0.0)

    def st(ref, k, val):
        plgpu.store(ref.at[k, :], val, mask=mask)

    lam = plgpu.load(lam_ref, mask=mask, other=0.0)
    singular = jnp.abs(lam) <= pin_tol if pin_tol is not None else None
    m = n - 1 if periodic else n          # rows of the (reduced) sweep

    # forward sweep, row 0 peeled: on a pinned (singular) column of a
    # non-periodic system the first pivot is zeroed, which fixes x[0] = 0
    piv = 1.0 / (b_ref[0] + lam)
    if singular is not None and not periodic:
        piv = jnp.where(singular, 0.0, piv)
    cp = c_ref[0] * piv
    st(cp_ref, 0, cp)
    ps = []
    for r_ref, o_ref in zip(rhs_refs, out_refs):
        p = ld(r_ref, 0) * piv
        st(o_ref, 0, p)
        ps.append(p)
    if periodic:
        # correction RHS e: e[0] = -a[0], e[m-1] = -c[m-1] (solver.f90:127-129)
        q = -a_ref[0] * piv
        st(q_ref, 0, q)
        ps.append(q)

    def fwd(k, carry):
        cp_prev, p_prev = carry
        ak = a_ref[k]
        piv = 1.0 / (b_ref[k] + lam - ak * cp_prev)
        cp = c_ref[k] * piv
        st(cp_ref, k, cp)
        p_new = []
        for r_ref, o_ref, pp in zip(rhs_refs, out_refs, p_prev):
            p = (ld(r_ref, k) - ak * pp) * piv
            st(o_ref, k, p)
            p_new.append(p)
        if periodic:
            e = jnp.where(k == m - 1, -c_ref[m - 1], 0.0)
            q = (e - ak * p_prev[-1]) * piv
            st(q_ref, k, q)
            p_new.append(q)
        return cp, tuple(p_new)

    _, last = jax.lax.fori_loop(1, m, fwd, (cp, tuple(ps)))
    bufs = tuple(out_refs) + ((q_ref,) if periodic else ())

    def bwd(t, x_next):
        k = m - 2 - t
        cp = ld(cp_ref, k)
        x_new = []
        for ref, xn in zip(bufs, x_next):
            x = ld(ref, k) - cp * xn
            st(ref, k, x)
            x_new.append(x)
        return tuple(x_new)

    jax.lax.fori_loop(0, m - 1, bwd, last)
    if not periodic:
        return

    # rank-1 closure for the last row (solver.f90:139-151)
    am, bm, cm = a_ref[m], b_ref[m], c_ref[m]
    q0, qm = ld(q_ref, 0), ld(q_ref, m - 1)
    den = (bm + lam) + cm * q0 + am * qm
    xns = []
    for r_ref, o_ref in zip(rhs_refs, out_refs):
        xn = (ld(r_ref, m) - cm * ld(o_ref, 0) - am * ld(o_ref, m - 1)) / den
        if singular is not None:
            xn = jnp.where(singular, 0.0, xn)
        st(o_ref, m, xn)
        xns.append(xn)

    @pl.loop(0, m)
    def _combine(k):
        qk = ld(q_ref, k)
        for o_ref, xn in zip(out_refs, xns):
            st(o_ref, k, ld(o_ref, k) + qk * xn)


def thomas_z(rhs, a, b, c, lam=None, *, pin_tol=None, periodic=False,
             interpret=False, block=BLOCK):
    """Solve tridiag(a, b + lam, c) x = rhs along axis 0 in one kernel.

    rhs: (n, ...) real or complex; a, b, c: (n,) real (host or traced);
    lam: real, broadcastable to rhs.shape[1:], or None.
    periodic: the cyclic system of ``tridiag.thomas_periodic`` (corner
    entries a[0], c[n-1]).
    pin_tol: columns with |lam| <= pin_tol carry the exactly singular
    Poisson mode; their gauge is fixed by pinning x[0] = 0 (non-periodic)
    or x[n-1] = 0 (periodic) instead of regularizing the pivots.  The
    result on such a column differs from ``tridiag.thomas(regularize=True)``
    by a constant along z.
    interpret: Pallas interpret mode (how the tests run it on the CPU).
    block: columns per program, a power of two.
    """
    n = rhs.shape[0]
    if n < (3 if periodic else 2):
        raise ValueError(f'z-sweep needs at least {3 if periodic else 2} rows')
    cplx = jnp.iscomplexobj(rhs)
    rdt = rhs.real.dtype if cplx else rhs.dtype
    ncol = int(np.prod(rhs.shape[1:]))
    planes = (rhs.real, rhs.imag) if cplx else (rhs,)
    planes = tuple(p.reshape(n, ncol) for p in planes)
    if lam is None:
        lam = jnp.zeros((ncol,), rdt)
    else:
        lam = jnp.broadcast_to(jnp.asarray(lam, rdt), rhs.shape[1:])
        lam = lam.reshape(ncol)
    coef = tuple(jnp.asarray(v, rdt) for v in (a, b, c))
    nrhs = len(planes)
    nbuf = nrhs + 1 + periodic
    kernel = functools.partial(
        _kernel, n=n, nrhs=nrhs, ncol=ncol, block=block,
        pin_tol=None if pin_tol is None else float(pin_tol),
        periodic=periodic)
    vec = pl.BlockSpec((n,), lambda i: (0,))
    col = pl.BlockSpec((n, block), lambda i: (0, i))
    outs = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(ncol, block),),
        in_specs=[vec, vec, vec, pl.BlockSpec((block,), lambda i: (i,))]
        + [col] * nrhs,
        out_specs=[col] * nbuf,
        out_shape=[jax.ShapeDtypeStruct((n, ncol), rdt)] * nbuf,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        backend='triton',
        interpret=interpret,
        name='thomas_z',
    )(*coef, lam, *planes)
    x = jax.lax.complex(outs[0], outs[1]) if cplx else outs[0]
    return x.reshape(rhs.shape)
