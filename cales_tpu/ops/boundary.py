"""Functional ghost-cell layer.

JAX counterpart of the reference halo/BC machinery
(/root/reference/src/bound.f90): fields are stored interior-only with shape
(nz, ny, nx); each operation that needs neighbors consumes a *padded* view
(nz+2, ny+2, nx+2) materialized here according to the BC semantics of
``set_bc`` (bound.f90:202-399).

Implementation note: each padded field is assembled with one
``concatenate`` per axis from the interior and functionally-computed ghost
faces; concatenates fuse into their consumers, unlike chains of
``.at[face].set`` updates which lower to full-array dynamic-update-slices.
Axes are processed in x, y, z order with each ghost plane spanning the
already-attached earlier-axis ghosts, reproducing the corner semantics of
the reference's sequential halo+set_bc sweep.  Periodic wraps become
collective-permutes when sharded (the updthalo/cudecompUpdateHalos analogue,
bound.f90:619-723).  N.B. trace-time constants must stay scalar/1D: inlined
multi-MB literals blow up compile time.

Staggered conventions (padded python index p == Fortran index p of the
reference's 0:n+1 arrays):
  * cell-centered fields: ghosts at 0 and n+1;
  * a velocity's normal direction is face-staggered: the interior includes
    the upper wall face (Fortran n); the lower wall face (Fortran 0) sits in
    the ghost slot.  For non-periodic normal BCs its value is part of the
    solver state (the ``vlo`` planes) so the corrector's update of wall-face
    velocity persists exactly as in the reference (correc.f90:45-67 +
    impose_norm_bc, bound.f90:54-100).

BC values are 2D planes with padded transverse shapes like the reference's
``type(bound)`` arrays (typedef.f90:9-13, main.f90:176-208):
  x-faces: (nz+2, ny+2);  y-faces: (nz+2, nx+2);  z-faces: (ny+2, nx+2).
"""
from __future__ import annotations

import jax.numpy as jnp

AX = {'x': 2, 'y': 1, 'z': 0}  # logical direction -> array axis of (z, y, x)


def bc_plane_shapes(ng):
    nx, ny, nz = ng
    return {'x': (nz + 2, ny + 2), 'y': (nz + 2, nx + 2), 'z': (ny + 2, nx + 2)}


def make_bc_values(ng, vals, dtype):
    """Per-face BC values from namelist scalars (initbc, bound.f90:764-795).

    Scalars are kept as python scalars (broadcast at use): materializing
    them as full planes at trace time would inline megabytes of literal
    constants into the HLO and blow up compile time.  The wall model
    promotes the faces it owns to full traced planes
    (wallmodel.update_wallmodel_bcs).

    A 2-D array entry (round 5) is a USER-SUPPLIED plane-valued BC — an
    inflow profile, a nonuniform moving lid, wall transpiration (the
    reference holds every BC as a plane internally, bound.f90:764-795) —
    kept as a padded (t1+2, t2+2) device plane; the ghost fills crop it
    (crop_plane, ensure_plane).  One static plane is ~0.5 MB at the
    512-class — far below the inlined-literal compile hazard (full 3-D
    fields)."""
    shapes = bc_plane_shapes(ng)
    axes = ('x', 'y', 'z')
    out = []
    for idir in range(3):
        pair = []
        for ib in range(2):
            v = vals[idir][ib]
            if hasattr(v, 'ndim') and getattr(v, 'ndim', 0) == 2:
                want = shapes[axes[idir]]
                if tuple(v.shape) != want:
                    raise ValueError(
                        f'plane-valued BC for direction {axes[idir]} must '
                        f'have padded shape {want}, got {tuple(v.shape)}')
                pair.append(jnp.asarray(v, dtype))
            else:
                pair.append(float(v))
        out.append(tuple(pair))
    return tuple(out)


def ensure_plane(val, shape, dtype):
    """Promote a scalar BC value to a full plane (used by the wall model)."""
    if hasattr(val, 'ndim') and getattr(val, 'ndim', 0) == 2:
        return val
    return jnp.full(shape, val, dtype=dtype)


def _fi(axis, i):
    idx = [slice(None)] * 3
    idx[axis] = i
    return tuple(idx)


def _body(q, axis, lo_i, hi_i):
    """static slice q[lo_i:hi_i] along axis"""
    idx = [slice(None)] * 3
    idx[axis] = slice(lo_i, hi_i)
    return q[tuple(idx)]


def _ex(plane, axis):
    return jnp.expand_dims(plane, axis)


def crop_plane(plane, q_shape, axis):
    """Crop a full padded-transverse plane to the ghost-plane shape of a
    (possibly partially padded) array: axes are processed x, y, z, so
    later-axis extents may still be unpadded when earlier faces attach."""
    dims = [d for d in range(3) if d != axis]
    sl = []
    for d_plane, d_arr in enumerate(dims):
        cur, full = q_shape[d_arr], plane.shape[d_plane]
        if cur == full:
            sl.append(slice(None))
        elif cur == full - 2:
            sl.append(slice(1, -1))
        else:
            raise ValueError(f'BC plane shape {plane.shape} vs field {q_shape}')
    return plane[tuple(sl)]


def _bc_plane(val, like, axis, dtype):
    """broadcast/crop a scalar/2D BC value to the ghost-plane shape of
    `like`."""
    if hasattr(val, 'ndim') and getattr(val, 'ndim', 0) == 2:
        return crop_plane(val, like.shape, axis).astype(dtype)
    shape = list(like.shape)
    del shape[axis]
    return jnp.full(shape, val, dtype=dtype)


def _set_centered(q, axis, letters, bcvals, dr):
    """Attach both ghost faces along `axis` for a cell-centered variable
    (set_bc centered=.true., bound.f90:232-352)."""
    first = q[_fi(axis, 0)]
    last = q[_fi(axis, -1)]
    if letters[0] == 'P':
        lo, hi = last, first
    else:
        b0 = _bc_plane(bcvals[0], q, axis, q.dtype)
        b1 = _bc_plane(bcvals[1], q, axis, q.dtype)
        lo = 2.0 * b0 - first if letters[0] == 'D' else -dr[0] * b0 + first
        hi = 2.0 * b1 - last if letters[1] == 'D' else dr[1] * b1 + last
    return jnp.concatenate([_ex(lo, axis), q, _ex(hi, axis)], axis=axis)


def _set_face(q, axis, letters, bcvals, dr, lo_keep=None, keep=False):
    """Attach the ghost faces + rewrite the wall-face entry along `axis` for
    the face-staggered normal component (set_bc centered=.false.,
    bound.f90:283-318 'D', 354-396 'N').

    keep=True (the corrector path, impose_norm_bc=.false.): the lower wall
    face comes from `lo_keep`, the interior wall-face entry is left at its
    corrected value."""
    first = q[_fi(axis, 0)]
    second_last = q[_fi(axis, -2)]
    last = q[_fi(axis, -1)]
    if letters[0] == 'P':
        return jnp.concatenate([_ex(last, axis), q, _ex(first, axis)],
                               axis=axis)
    if keep:
        hi = second_last if letters[1] == 'D' else last
        lo = crop_plane(lo_keep, q.shape, axis).astype(q.dtype)
        return jnp.concatenate([_ex(lo, axis), q, _ex(hi, axis)],
                               axis=axis)
    b0 = _bc_plane(bcvals[0], q, axis, q.dtype)
    b1 = _bc_plane(bcvals[1], q, axis, q.dtype)
    lo = b0 if letters[0] == 'D' else -dr[0] * b0 + first
    trunk = _body(q, axis, 0, -1)
    if letters[1] == 'D':
        # u(n) = bc; u(n+1) = u(n-1) (unused)   bound.f90:292-293
        newlast, hi = b1, second_last
    else:
        # u(n+1) = old u(n) (unused); u(n) = dr*bc + u(n-1)  bound.f90:365-366
        newlast, hi = dr[1] * b1 + second_last, last
    return jnp.concatenate([_ex(lo, axis), trunk, _ex(newlast, axis),
                            _ex(hi, axis)], axis=axis)


def pad_scalar(p, cbc, bcvals, dl, dzc):
    """Ghost fill for a cell-centered scalar (boundp, bound.f90:156-200)."""
    nz = p.shape[0]
    q = p
    drs = {'x': (dl[0], dl[0]), 'y': (dl[1], dl[1]),
           'z': (float(dzc[0]), float(dzc[nz]))}
    for key, idir in (('x', 0), ('y', 1), ('z', 2)):
        q = _set_centered(q, AX[key], cbc[idir], bcvals[idir], drs[key])
    return q


def pad_velocity(u, v, w, cbcvel, bcu, bcv, bcw, dl, dzc, dzf,
                 vlo=None, is_correc=False):
    """Ghost fill for the staggered velocity (bounduvw, bound.f90:18-154).

    cbcvel[ibound][idir][ivel]; bcu/bcv/bcw: per-direction plane pairs
    (Neumann values possibly wall-model-updated).  vlo: (u_lo, v_lo, w_lo)
    lower-wall normal-face planes from the state; consumed when is_correc
    (impose_norm_bc=.false., bound.f90:54-56).

    Returns (up, vp, wp, vlo_new) with vlo_new the planes actually placed in
    the ghost layer (full padded transverse shape), to be stored back.
    """
    nz = u.shape[0]
    dr_par = {'x': (dl[0], dl[0]), 'y': (dl[1], dl[1]),
              'z': (float(dzc[0]), float(dzc[nz]))}
    dr_nrm = {'x': (dl[0], dl[0]), 'y': (dl[1], dl[1]),
              'z': (float(dzf[0]), float(dzf[nz]))}

    fields = {'u': u, 'v': v, 'w': w}
    bcs = {'u': bcu, 'v': bcv, 'w': bcw}
    face_of = {'u': 'x', 'v': 'y', 'w': 'z'}
    vlo_in = {'u': None, 'v': None, 'w': None}
    if vlo is not None:
        vlo_in = {'u': vlo[0], 'v': vlo[1], 'w': vlo[2]}

    out = {}
    for name, ivel in (('u', 0), ('v', 1), ('w', 2)):
        q = fields[name]
        for key, idir in (('x', 0), ('y', 1), ('z', 2)):
            axis = AX[key]
            lts = (cbcvel[0][idir][ivel], cbcvel[1][idir][ivel])
            bv = bcs[name][idir]
            if key == face_of[name]:
                keep = is_correc and lts[0] != 'P' and vlo_in[name] is not None
                q = _set_face(q, axis, lts, bv, dr_nrm[key],
                              lo_keep=vlo_in[name] if keep else None, keep=keep)
            else:
                q = _set_centered(q, axis, lts, bv, dr_par[key])
        out[name] = q

    vlo_new = (out['u'][:, :, 0], out['v'][:, 0, :], out['w'][0, :, :])
    return out['u'], out['v'], out['w'], vlo_new
