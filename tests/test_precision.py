"""Precision of the solver's float32 path: each configuration class run in
float32 against the same run in float64 (guards the operator-contraction
precision and the float32 tracing of a Simulation), the contraction helpers,
and the transform choice of ptransform='auto'."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cales_tpu import models
from cales_tpu.config import Config
from cales_tpu.grid import make_grid, make_grid_from_config
from cales_tpu.initflow import initflow
from cales_tpu.ops import transforms as tr
from cales_tpu.poisson import make_solver
from cales_tpu.timeloop import Simulation

NG = (16, 12, 12)
_chan = models.channel_dns(ng=NG, visci=2000.0)

CLASSES = {
    'channel_les_smag': models.channel_les(ng=NG, visci=5000.0),
    'channel_wmles': models.channel_wmles(ng=NG, visci=50000.0),
    'passive_scalar': _chan.replace(
        scalar=True, pr=0.71, iniscal='uni', ssource=0.02,
        cbcscal=(('P', 'P', 'D'), ('P', 'P', 'D')),
        bcscal=((0.0, 0.0, 1.0), (0.0, 0.0, 0.5))),
    'duct_les_dsmag': models.square_duct_les(ng=NG, visci=2000.0),
    'channel_impdiff_1d': _chan.replace(impdiff_1d=True),
    'x_walled_inflow': models.developing_channel(ng=NG, visci=200.0),
}
# float32 round-off (6e-8) grown over 3 RK3 steps on these grids reaches
# 4e-6 of the field maximum for velocity and scalar; the dynamic model's
# ratio of plane averages amplifies it to 1e-5 in visct.  Bounds keep a
# factor 5-10; a contraction silently run at reduced precision (bf16, or a
# single TF32 pass: ~4e-4 in the z stage) does not fit under them
F32_TOL = {'visct': 1e-4}
F32_TOL_FIELDS = 2e-5


def _run(cfg, fields, nsteps=3, dt=2e-3):
    sim = Simulation(cfg, make_grid_from_config(cfg))
    st = sim.initial_state(*fields)
    st = sim.multi_step(st, dt, nsteps)
    out = {k: np.asarray(getattr(st, k), np.float64)
           for k in ('u', 'v', 'w', 'visct')}
    if st.s is not None:
        out['s'] = np.asarray(st.s, np.float64)
    assert all(a.dtype == np.float64 for a in out.values())
    return sim, st, out


@pytest.mark.parametrize('name', sorted(CLASSES))
def test_f32_matches_f64(name):
    cfg64 = CLASSES[name].replace(dtype='float64')
    cfg32 = cfg64.replace(dtype='float32')
    grid = make_grid_from_config(cfg64)
    rng = np.random.default_rng(11)
    fields = tuple(np.asarray(f) + 1e-2 * rng.standard_normal(f.shape)
                   for f in initflow(cfg64, grid))
    _, _, ref = _run(cfg64, fields)
    sim32, st32, got = _run(cfg32, fields)
    assert st32.u.dtype == jnp.float32
    for k in ref:
        scale = np.abs(ref[k]).max()
        if scale == 0:
            continue
        err = np.abs(got[k] - ref[k]).max() / scale
        assert err < F32_TOL.get(k, F32_TOL_FIELDS), (name, k, err)
    _, _, divmax = sim32.check(st32)
    assert divmax < 1e-3, divmax


def test_precision_choice():
    """float32 operator contractions name an explicit precision; float64
    always runs at full precision."""
    assert tr.precision(np.float64) == jax.lax.Precision.HIGHEST
    assert tr.precision(np.complex128) == jax.lax.Precision.HIGHEST
    assert tr.precision(np.float32) == tr.F32_PRECISION
    assert tr.precision(np.complex64) == tr.F32_PRECISION
    assert tr.precision_name(np.float32) == 'HIGHEST'


def test_contract_leading_real_and_complex():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((6, 6))
    x = rng.standard_normal((6, 3, 5)) + 1j * rng.standard_normal((6, 3, 5))
    want = np.tensordot(m, x, axes=(1, 0))
    got = np.asarray(tr.contract_leading(m, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-13)
    got_r = np.asarray(tr.contract_leading(m, jnp.asarray(x.real)))
    np.testing.assert_allclose(got_r, want.real, atol=1e-13)


@pytest.mark.parametrize('ptransform,kind', [('auto', 'fft'), ('fft', 'fft'),
                                             ('mat', 'mat')])
def test_periodic_transform_choice(ptransform, kind):
    """'auto' is the FFT on every platform; the dense DFT operator only when
    asked for."""
    cfg = Config(ng=(8, 6, 4), l=(1.0, 1.0, 1.0), ptransform=ptransform)
    sv = make_solver(cfg, make_grid(0, 4, 0.0, 1.0), ('PP', 'PP', 'NN'),
                     ('c', 'c', 'c'))
    assert sv.trx.kind == kind and sv.try_.kind == kind
