"""The acoustic XLA engine (`propagate_acoustic`, boundary-saving
custom_vjp) against the plain-AD reference (`propagate_acoustic_ad`) in
float64, forward and gradient, over the acquisition layouts of
tests/layouts.py that differ for pressure/velocity recording."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sep2023_tpu import acoustic
from sep2023_tpu.acoustic import (AcGeom, propagate_acoustic,
                                  propagate_acoustic_ad)
from sep2023_tpu.ops import misfit as mf

from layouts import AC_LAYOUTS, build, model, src_zx, stf


def _case(name):
    lay = build(name)
    sz, sx = src_zx()
    geoms = AcGeom(src_z=sz, src_x=sx,
                   rec_z=jnp.asarray(lay.rec_z, jnp.int32),
                   rec_x=jnp.asarray(lay.rec_x, jnp.int32))
    if lay.per_trace:
        fn = mf.make_preprocessed_l2(channels=("pr",), dt=lay.cfg.dt,
                                     per_trace=True)
    else:
        fn = lambda o, s: mf.l2_misfit(o, s, channels=acoustic.AC_CHANNELS)
    med = model(lay.cfg)
    return (lay.cfg, geoms, fn, tuple(jnp.asarray(a) for a in lay.aux),
            med.rho * med.vp ** 2, med.rho)


def _run(fn, cfg, lam, rho, s, geoms):
    return jax.vmap(lambda si, gi: fn(cfg, lam, rho, si, gi))(s, geoms)


@pytest.mark.parametrize("layout", AC_LAYOUTS)
def test_acoustic_forward_matches_plain_ad(layout):
    """Seismograms through the custom_vjp's primal equal plain AD; the last
    sample equals a numpy gather of the final (p, vx, vz) state; the
    layout's misfit has the same value on both engines."""
    cfg, geoms, fn, aux, lam, rho = _case(layout)
    s = stf(cfg)
    out, _ = jax.vjp(lambda l: _run(propagate_acoustic, cfg, l, rho, s,
                                    geoms), lam)
    ref = np.asarray(_run(propagate_acoustic_ad, cfg, lam, rho, s, geoms))
    out = np.asarray(out)
    assert out.shape == (2, 3, geoms.rec_z.shape[1], cfg.nt)
    for c in range(3):
        scale = np.abs(ref[:, c]).max()
        assert scale > 0, f"channel {c} records nothing"
        assert np.abs(out[:, c] - ref[:, c]).max() / scale < 1e-13

    for i in range(2):
        g = jax.tree.map(lambda a: a[i], geoms)
        data, final, _ = acoustic._forward(cfg, lam, rho, s[i], g,
                                           save_bnd=True)
        rz, rx = np.asarray(g.rec_z), np.asarray(g.rec_x)
        want = np.stack([np.asarray(f)[rz, rx]
                         for f in (final.f.p, final.f.vx, final.f.vz)])
        np.testing.assert_allclose(np.asarray(data)[..., -1], want,
                                   rtol=1e-12, atol=1e-12 * np.abs(want).max())

    obs = _run(propagate_acoustic_ad, cfg, lam * 1.04, rho, s, geoms)
    v = jnp.sum(jax.vmap(fn)(obs, jnp.asarray(out), *aux))
    v_ad = jnp.sum(jax.vmap(fn)(obs, ref, *aux))
    assert float(v_ad) > 0
    assert abs(float(v) - float(v_ad)) <= 1e-12 * float(v_ad)


@pytest.mark.parametrize("layout", AC_LAYOUTS)
def test_acoustic_gradient_matches_plain_ad(layout):
    """(lam, rho, stf) gradients through the boundary-saving adjoint equal
    plain AD: model gradients on the reconstruction region
    [npml+2, n-3-npml] (ac_pressure.cu:56-65) shrunk by 2 more cells,
    stf everywhere."""
    cfg, geoms, fn, aux, lam, rho = _case(layout)
    s = stf(cfg)
    obs = _run(propagate_acoustic_ad, cfg, lam.at[20:30, 18:40].multiply(
        1.05), rho, s, geoms)
    w = jnp.asarray([1.0, 0.7])

    def loss(prop, lam_, rho_, s_):
        syn = _run(prop, cfg, lam_, rho_, s_, geoms)
        return jnp.sum(w * jax.vmap(fn)(obs, syn, *aux))

    g = jax.jit(jax.grad(lambda *a: loss(propagate_acoustic, *a),
                         argnums=(0, 1, 2)))(lam, rho, s)
    g_ad = jax.jit(jax.grad(lambda *a: loss(propagate_acoustic_ad, *a),
                            argnums=(0, 1, 2)))(lam, rho, s)
    sl = (slice(cfg.npml + 4, cfg.nz - cfg.npml - 4),
          slice(cfg.npml + 4, cfg.nx - cfg.npml - 4))
    for name, a, b in zip(("lam", "rho", "stf"), g, g_ad):
        a, b = np.asarray(a), np.asarray(b)
        if name != "stf":
            a, b = a[sl], b[sl]
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() / scale < 1e-9, name
