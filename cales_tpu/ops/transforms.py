"""1D transforms that diagonalize the second-difference operator per BC pair.

JAX counterpart of the reference FFT layer
(/root/reference/src/fft.f90:192-245 ``find_fft``,
/root/reference/src/initsolver.f90:66-125 ``eigenvalues``).

Design: periodic directions use native XLA FFTs (``jnp.fft.rfft/fft``, cuFFT
on the GPU); all non-periodic kinds (DCT/DST families) are applied as
**precomputed operator matrices** (a single batched matmul along the axis).
This is exact and removes the Makhoul pre/post-processing choreography the
reference needs for cuFFT (fft.f90:273-493).  The matrices are built once per
solver in float64 and cast to the compute dtype.

Every (transform, eigenvalues) pair here is defined by the requirement that it
*exactly* diagonalizes the 1D second-difference operator assembled from the
reference's ghost-cell semantics (bound.f90:202-399 ``set_bc``) and boundary
row folding (initsolver.f90:127-169 ``tridmatrix``):

  cell-centered ('c'), points at (i-1/2)h, i=1..n:
    PP: DFT,           lam_j = -2(1-cos(2 pi j/n))            (j=0..n-1)
    NN: DCT-II,        lam_k = -2(1-cos(pi k/n))              (k=0..n-1)
    DD: DST-II,        lam_k = -2(1-cos(pi (k+1)/n))          (k=0..n-1)
    ND: DCT-IV,        lam_k = -2(1-cos((2k+1) pi/(2n)))      (k=0..n-1)
    DN: DST-IV,        lam_k = -2(1-cos((2k+1) pi/(2n)))      (k=0..n-1)
  face-centered ('f'), points at i*h, i=1..n (wall faces at 0 and n):
    PP: DFT as above
    NN: DCT-II,        lam_k = -2(1-cos(pi k/n))
        (the reference maps this to FFTW REDFT00/DCT-I, fft.f90:228-229, but
         the operator row structure from tridmatrix('f','N') is the mirror
         operator, whose exact eigenbasis is the DCT-II basis; the reference's
         eigenvalues initsolver.f90:104-107 agree with ours.)
    DD: DST-I on n-1 points (wall face n excluded; fft.f90:69 ``ix=1``),
        lam_k = -2(1-cos(pi (k+1)/n)), k=0..n-2; last point passes through.
    ND: mixed basis cos(theta(i-1/2)), theta=(2k+1)pi/(2n-1), on n-1 points
        (face n is a Dirichlet wall); lam_k = -2(1-cos theta).
    DN: basis sin(theta i), theta=(2k+1)pi/(2n+1), on n points;
        lam_k = -2(1-cos theta).

All matrix pairs satisfy bwd(fwd(x)) == x exactly (bwd = inverse), so the
global normalization of the reference (fft.f90:62-142 ``normfft``) is 1 here.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class Transform1D:
    kind: str          # 'fft' | 'mat' | 'none'
    n: int             # array length along the axis
    nsolve: int        # number of transformed/solved points (n or n-1)
    lam: np.ndarray    # (nsolve,) eigenvalues for unit spacing, float64
    fwd_mat: np.ndarray | None = None   # (nsolve, nsolve)
    bwd_mat: np.ndarray | None = None   # (nsolve, nsolve)

    @property
    def lam_rfft(self) -> np.ndarray:
        """Eigenvalues for the rfft half-spectrum (PP only)."""
        assert self.kind == 'fft'
        return self.lam[: self.n // 2 + 1]


def _basis_matrix(n: int, func) -> np.ndarray:
    """Rows = basis vectors evaluated at point indices (forward = analysis)."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    return func(k, i)


def make_transform(bc: str, c_or_f: str, n: int,
                   pp_mat: bool = False) -> Transform1D:
    """Build the transform pair + eigenvalues for one direction.

    bc is the two-letter BC pair ('PP','NN','DD','ND','DN'); c_or_f is 'c'
    (cell-centered) or 'f' (face-centered) staggering of the solved variable.

    pp_mat: apply the periodic transform as a real half-complex DFT operator
    matrix instead of ``jnp.fft.rfft``.  The circulant second-difference
    operator is diagonalized by the real cos/sin pairs (rows ordered
    [cos k=0..n/2, sin k=1..ceil(n/2)-1]), so the whole Poisson solve stays
    real-valued.  Eigenvalues are returned in matrix row order.
    """
    pi = np.pi
    if bc == 'PP':
        if not pp_mat:
            j = np.arange(n, dtype=np.float64)
            lam = -2.0 * (1.0 - np.cos(2.0 * pi * j / n))
            return Transform1D(kind='fft', n=n, nsolve=n, lam=lam)
        i = np.arange(n, dtype=np.float64)
        kc = np.arange(0, n // 2 + 1, dtype=np.float64)         # cos rows
        ks = np.arange(1, (n - 1) // 2 + 1, dtype=np.float64)   # sin rows
        T = np.vstack([np.cos(2.0 * pi * np.outer(kc, i) / n),
                       np.sin(2.0 * pi * np.outer(ks, i) / n)])
        lam = -2.0 * (1.0 - np.cos(2.0 * pi * np.concatenate([kc, ks]) / n))
        return Transform1D(kind='mat', n=n, nsolve=n, lam=lam,
                           fwd_mat=T, bwd_mat=np.linalg.inv(T))

    if c_or_f == 'c':
        if bc == 'NN':     # DCT-II
            T = _basis_matrix(n, lambda k, i: np.cos(pi * k * (2 * i + 1) / (2 * n)))
            lam = -2.0 * (1.0 - np.cos(pi * np.arange(n) / n))
        elif bc == 'DD':   # DST-II
            T = _basis_matrix(n, lambda k, i: np.sin(pi * (k + 1) * (2 * i + 1) / (2 * n)))
            lam = -2.0 * (1.0 - np.cos(pi * (np.arange(n) + 1.0) / n))
        elif bc == 'ND':   # DCT-IV
            T = _basis_matrix(n, lambda k, i: np.cos(pi * (2 * k + 1) * (2 * i + 1) / (4 * n)))
            lam = -2.0 * (1.0 - np.cos((2 * np.arange(n) + 1.0) * pi / (2 * n)))
        elif bc == 'DN':   # DST-IV
            T = _basis_matrix(n, lambda k, i: np.sin(pi * (2 * k + 1) * (2 * i + 1) / (4 * n)))
            lam = -2.0 * (1.0 - np.cos((2 * np.arange(n) + 1.0) * pi / (2 * n)))
        else:
            raise ValueError(f'unsupported BC pair {bc!r}')
        nsolve = n
    else:  # 'f'
        if bc == 'NN':     # mirror operator -> DCT-II basis
            T = _basis_matrix(n, lambda k, i: np.cos(pi * k * (2 * i + 1) / (2 * n)))
            lam = -2.0 * (1.0 - np.cos(pi * np.arange(n) / n))
            nsolve = n
        elif bc == 'DD':   # DST-I on n-1 interior faces
            m = n - 1
            T = _basis_matrix(m, lambda k, i: np.sin(pi * (k + 1) * (i + 1) / n))
            lam = -2.0 * (1.0 - np.cos(pi * (np.arange(m) + 1.0) / n))
            nsolve = m
        elif bc == 'ND':   # n-1 points, mirror low / Dirichlet node at i=n
            m = n - 1
            theta = (2 * np.arange(m) + 1.0) * pi / (2 * n - 1)
            T = _basis_matrix(m, lambda k, i: np.cos(
                (2 * k + 1) * pi / (2 * n - 1) * (i + 0.5)))
            lam = -2.0 * (1.0 - np.cos(theta))
            nsolve = m
        elif bc == 'DN':   # n points, Dirichlet node at i=0 / mirror high
            theta = (2 * np.arange(n) + 1.0) * pi / (2 * n + 1)
            T = _basis_matrix(n, lambda k, i: np.sin(
                (2 * k + 1) * pi / (2 * n + 1) * (i + 1.0)))
            lam = -2.0 * (1.0 - np.cos(theta))
            nsolve = n
        else:
            raise ValueError(f'unsupported BC pair {bc!r}')

    Tinv = np.linalg.inv(T)
    return Transform1D(kind='mat', n=n, nsolve=nsolve, lam=lam,
                       fwd_mat=T, bwd_mat=Tinv)


# ---------------------------------------------------------------------------
# application along an axis of a (z, y, x) array
# ---------------------------------------------------------------------------

# Precision of the float32 operator contractions (DCT/DST matrices, the z
# eigenbasis): HIGHEST, true float32 products.  On an H100 the default and
# HIGH run one TF32 pass (10-bit mantissa): the z eigen-solve lost three
# digits (4.0e-4 vs 2.3e-7 relative) and the channel-LES step drifted 7.6x
# further from float64 after 30 steps, for a 5.5% faster step; the 3-pass
# TF32 algorithm was no faster than HIGHEST (PERF.md).
F32_PRECISION = jax.lax.Precision.HIGHEST


def precision(dtype):
    """Dot precision for operator contractions on arrays of `dtype`:
    float64 always runs at full precision."""
    if np.dtype(dtype) in (np.dtype(np.float32), np.dtype(np.complex64)):
        return F32_PRECISION
    return jax.lax.Precision.HIGHEST


def precision_name(dtype) -> str:
    p = precision(dtype)
    return getattr(p, 'name', str(p))


def _real_parts(arr, apply):
    # real operators act on the real and imaginary planes separately: a
    # complex x real contraction would run as a complex product at twice
    # the flops
    if jnp.iscomplexobj(arr):
        return jax.lax.complex(apply(arr.real), apply(arr.imag))
    return apply(arr)


def contract_leading(mat, arr):
    """mat (k_out, k_in) applied along axis 0 of `arr`: one (k, k) x
    (k, rest) matrix product with no transpose."""
    rdt = arr.real.dtype if jnp.iscomplexobj(arr) else arr.dtype
    m = jnp.asarray(mat, dtype=rdt)
    prec = precision(rdt)
    return _real_parts(arr, lambda a: jnp.tensordot(m, a, axes=(1, 0),
                                                    precision=prec))


def _matmul_axis(arr, mat, axis):
    """Contract `mat` (k_out, k_in) with `arr` along `axis`."""
    rdt = arr.real.dtype if jnp.iscomplexobj(arr) else arr.dtype
    m = jnp.asarray(mat, dtype=rdt)
    prec = precision(rdt)

    def apply(real_arr):
        # moveaxis + minor-dim matmul keeps default layouts for the FFT
        # thunks around it
        moved = jnp.moveaxis(real_arr, axis, -1)
        out = jnp.matmul(moved, m.T, precision=prec)
        return jnp.moveaxis(out, -1, axis)

    return _real_parts(arr, apply)


def fwd(tr: Transform1D, arr, axis: int):
    """Forward transform along `axis`.  For PP: rfft on real input, fft on
    complex input.  Returns the transformed array."""
    if tr.kind == 'fft':
        if jnp.iscomplexobj(arr):
            return jnp.fft.fft(arr, axis=axis)
        return jnp.fft.rfft(arr, axis=axis)
    return _matmul_axis(arr, tr.fwd_mat, axis)


def bwd(tr: Transform1D, arr, axis: int, n: int, real_out: bool):
    """Backward transform along `axis`; `n` is the output length for FFTs."""
    if tr.kind == 'fft':
        if real_out:
            return jnp.fft.irfft(arr, n=n, axis=axis)
        return jnp.fft.ifft(arr, axis=axis)
    return _matmul_axis(arr, tr.bwd_mat, axis)
