"""Passive-scalar transport.

Port of /root/reference/src/scal.f90 (advection-diffusion RHS, 14-51) and
rk.f90:123-195 (rk_scal: low-storage RK3 update with bulk forcing).  Like the
reference, this machinery is provided as a library component; the main driver
does not advance a scalar by default (SURVEY.md §2.1 "Scalar RHS").
"""
from __future__ import annotations

from typing import NamedTuple, Any

import jax.numpy as jnp

from .config import RK_COEFF
from .ops.stencil import _sh, _zb, bulk_mean, scalar_rhs_core


def scalar_rhs(up, vp, wp, sp, alpha, dxi, dyi, dzci, dzfi):
    """Advection-diffusion RHS for a cell-centered scalar (scal.f90:14-51).
    alpha: molecular diffusivity.  All inputs padded.  The discretization
    lives in stencil.scalar_rhs_core."""
    nz = up.shape[0] - 2
    metrics = {
        'dzci_c': _zb(dzci, 1, nz + 1),
        'dzci_m': _zb(dzci, 0, nz),
        'dzfi_c': _zb(dzfi, 1, nz + 1),
    }

    def V(P, k=0, j=0, i=0):
        return _sh(P, k, j, i)

    return scalar_rhs_core(V, metrics.__getitem__, up, vp, wp, sp,
                           alpha, dxi, dyi)


class ScalarState(NamedTuple):
    s: Any            # interior (nz, ny, nx)
    dsdtrk_old: Any   # previous-substep RHS


def rk_scal(sstate: ScalarState, up, vp, wp, sp, alpha, dt, irk,
            dxi, dyi, dzci, dzfi, ssource=0.0,
            is_forced=False, scalf=0.0, gvr_f=None):
    """One RK3 substep for the scalar (rk.f90:123-195).  sp is the padded
    scalar consistent with sstate.s.  Returns (new state, forcing f)."""
    f1 = RK_COEFF[irk][0] * dt
    f2 = RK_COEFF[irk][1] * dt
    f12 = f1 + f2
    dsdt = scalar_rhs(up, vp, wp, sp, alpha, dxi, dyi, dzci, dzfi)
    s = sstate.s + f1 * dsdt + f2 * sstate.dsdtrk_old + f12 * ssource
    f = jnp.zeros((), s.dtype)
    if is_forced:
        f = scalf - bulk_mean(s, gvr_f)
        s = s + f
    return ScalarState(s=s, dsdtrk_old=dsdt), f
