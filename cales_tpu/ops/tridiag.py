"""Batched tridiagonal solvers along the leading (z) axis.

JAX counterpart of the reference Thomas kernels
(/root/reference/src/solver.f90:82-179 ``gaussel``/``dgtsv_homebrewed`` and
solver.f90:109-151 ``gaussel_periodic``).

The solve axis is axis 0 of a (nz, ...) array so each scan step touches a
contiguous (ny, nx) plane.  ops/zsweep.py is the GPU kernel of the same
sweep; these scans are its reference and the implementation elsewhere.
The diagonal is ``b[k] + lam`` with ``lam`` broadcast over the batch (the modified-wavenumber
shift of the eigenfunction method).  RHS may be complex (a, b, c, lam real).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _eps_for(dtype) -> float:
    d = np.dtype(dtype)
    if d in (np.dtype(np.complex64), np.dtype(np.float32)):
        return float(np.finfo(np.float32).eps)
    return float(np.finfo(np.float64).eps)


def thomas(a, b, c, rhs, lam=None, regularize=True):
    """Solve tridiag(a, b + lam, c) x = rhs along axis 0.

    a, b, c: (n,) real; rhs: (n, ...) real or complex; lam: broadcastable to
    rhs[0].shape (or None).  Mirrors dgtsv_homebrewed (solver.f90:153-179).
    regularize=True adds eps to the pivots — needed only for the exactly
    singular Poisson zero mode (solver.f90:165-169); pass False for
    well-conditioned Helmholtz solves where the eps is pure bias.
    """
    n = rhs.shape[0]
    eps = _eps_for(rhs.dtype) if regularize else 0.0
    a = jnp.asarray(a, dtype=rhs.real.dtype if jnp.iscomplexobj(rhs) else rhs.dtype)
    b = jnp.asarray(b, dtype=a.dtype)
    c = jnp.asarray(c, dtype=a.dtype)
    if lam is None:
        lam = jnp.zeros((), dtype=a.dtype)
    else:
        lam = jnp.asarray(lam, dtype=a.dtype)

    def fwd_step(carry, xs):
        d_prev, p_prev = carry
        a_k, b_k, c_k, r_k = xs
        z = 1.0 / (b_k + lam - a_k * d_prev + eps)
        d_k = c_k * z
        p_k = (r_k - a_k * p_prev) * z
        return (d_k, p_k), (d_k, p_k)

    zeros_d = jnp.zeros_like(lam + jnp.zeros(rhs.shape[1:], dtype=a.dtype))
    zeros_p = jnp.zeros(rhs.shape[1:], dtype=rhs.dtype)
    (_, _), (d, p) = jax.lax.scan(fwd_step, (zeros_d, zeros_p), (a, b, c, rhs))

    def bwd_step(p_next, xs):
        d_k, p_k = xs
        p_new = p_k - d_k * p_next
        return p_new, p_new

    _, x_rev = jax.lax.scan(bwd_step, p[-1], (d[:-1][::-1], p[:-1][::-1]))
    return jnp.concatenate([x_rev[::-1], p[-1:][...]], axis=0)


def thomas_periodic(a, b, c, rhs, lam=None, regularize=True):
    """Periodic tridiagonal solve along axis 0 (rank-1 corrected two-solve),
    mirroring gaussel_periodic (solver.f90:109-151)."""
    n = rhs.shape[0]
    eps = _eps_for(rhs.dtype) if regularize else 0.0
    rdtype = rhs.real.dtype if jnp.iscomplexobj(rhs) else rhs.dtype
    a_ = jnp.asarray(a, dtype=rdtype)
    b_ = jnp.asarray(b, dtype=rdtype)
    c_ = jnp.asarray(c, dtype=rdtype)
    if lam is None:
        lam_ = jnp.zeros((), dtype=rdtype)
    else:
        lam_ = jnp.asarray(lam, dtype=rdtype)

    # correction RHS: p2(1) = -a(1), p2(n-1) = -c(n-1)  (solver.f90:127-129)
    e = jnp.zeros((n - 1,) + rhs.shape[1:], dtype=rhs.dtype)
    e = e.at[0].set(-a_[0])
    e = e.at[n - 2].set(-c_[n - 2])

    stacked = jnp.stack([rhs[: n - 1], e], axis=1)     # (n-1, 2, ...)
    lam_b = lam_[None] if lam_.ndim else lam_          # broadcast over the 2-stack
    sol = thomas(a_[: n - 1], b_[: n - 1], c_[: n - 1], stacked, lam=lam_b,
                 regularize=regularize)
    p1 = sol[:, 0]
    p2 = sol[:, 1]

    denom = (b_[n - 1] + lam_) + c_[n - 1] * p2[0] + a_[n - 1] * p2[n - 2] + eps
    pn = (rhs[n - 1] - c_[n - 1] * p1[0] - a_[n - 1] * p1[n - 2]) / denom
    body = p1 + p2 * pn[None]
    return jnp.concatenate([body, pn[None]], axis=0)
