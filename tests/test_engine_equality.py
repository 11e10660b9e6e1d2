"""The elastic XLA engine (`propagate`, boundary-saving custom_vjp) against
the plain-AD reference (`propagate_ad`) in float64, forward and gradient,
over the acquisition layouts users record with (tests/layouts.py): single
row, multi-row fiber, curved spline fiber with weighted DAS, borehole
column with the exx and ezz channels, ragged spreads, src_rxz != 1 and
per-trace windows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sep2023_tpu as st
from sep2023_tpu import parallel, propagator
from sep2023_tpu.ops import misfit as mf
from sep2023_tpu.propagator import propagate_ad

from layouts import LAYOUTS, build, model, src_zx, stf


def _case(name):
    lay = build(name)
    cfg = lay.cfg
    sz, sx = src_zx()
    geoms = st.ShotGeom(
        src_z=sz, src_x=sx, rxz=jnp.asarray(lay.rxz),
        rec_z=jnp.asarray(lay.rec_z, jnp.int32),
        rec_x=jnp.asarray(lay.rec_x, jnp.int32),
        das_w=None if lay.das_w is None else jnp.asarray(lay.das_w))
    if lay.per_trace:
        fn = mf.make_preprocessed_l2(channels=("ett",), dt=cfg.dt,
                                     per_trace=True)
    else:
        fn = lambda o, s: mf.l2_misfit(o, s, channels=st.CHANNELS)
    aux = tuple(jnp.asarray(a) for a in lay.aux)
    return cfg, geoms, fn, aux


def _run(fn, cfg, lam, mu, rho, s, geoms):
    return jax.vmap(lambda si, gi: fn(cfg, lam, mu, rho, si, gi))(s, geoms)


def _record_np(f, rz, rx, w, cfg):
    """The four recorded channels (utilities.cu:593-703) gathered in numpy
    from one wavefield state."""
    vx, vz = np.asarray(f.vx), np.asarray(f.vz)
    pr = np.asarray(f.szz)[rz, rx] + np.asarray(f.sxx)[rz, rx]
    if cfg.das_channel == "ezz":
        ett = vz[rz, rx] - vz[rz - 1, rx]
    elif cfg.das_channel == "weighted":
        exx = (vx[rz, rx] - vx[rz, rx - 1]) / cfg.dx
        ezz = (vz[rz, rx] - vz[rz - 1, rx]) / cfg.dz
        exz = 0.5 * ((vx[rz + 1, rx] - vx[rz, rx]) / cfg.dz
                     + (vz[rz, rx + 1] - vz[rz, rx]) / cfg.dx)
        ett = w[:, 0] * exx + w[:, 1] * exz + w[:, 2] * ezz
    else:
        ett = vx[rz, rx] - vx[rz, rx - 1]
    return np.stack([pr, vx[rz, rx], vz[rz, rx], ett])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_matches_plain_ad(layout):
    """Seismograms through the custom_vjp's primal (strip saving on) equal
    plain AD; the last sample equals a numpy gather of the final state; and
    the layout's misfit has the same value on both engines."""
    cfg, geoms, fn, aux = _case(layout)
    med, s = model(cfg), stf(cfg)
    lam, mu, rho = med.to_lame()
    out, _ = jax.vjp(lambda l: _run(st.propagate, cfg, l, mu, rho, s, geoms),
                     lam)
    ref = np.asarray(_run(propagate_ad, cfg, lam, mu, rho, s, geoms))
    out = np.asarray(out)
    assert out.shape == (2, 4, geoms.rec_z.shape[1], cfg.nt)
    for c in range(4):
        scale = np.abs(ref[:, c]).max()
        assert scale > 0, f"channel {c} records nothing"
        assert np.abs(out[:, c] - ref[:, c]).max() / scale < 1e-13

    for i in range(2):
        g = jax.tree.map(lambda a: a[i], geoms)
        data, final, _ = propagator._forward(cfg, lam, mu, rho, s[i], g,
                                             save_bnd=True)
        w = None if g.das_w is None else np.asarray(g.das_w)
        want = _record_np(final.f, np.asarray(g.rec_z), np.asarray(g.rec_x),
                          w, cfg)
        np.testing.assert_allclose(np.asarray(data)[..., -1], want,
                                   rtol=1e-12, atol=1e-12 * np.abs(want).max())

    obs = _run(propagate_ad, cfg, lam * 1.04, mu, rho, s, geoms)
    w = jnp.ones((2,))
    v = parallel.make_local_misfit(cfg, misfit_fn=fn)(
        lam, mu, rho, s, geoms, obs, w, *aux)
    v_ad = jnp.sum(jax.vmap(fn)(obs, ref, *aux))
    assert float(v_ad) > 0
    assert abs(float(v) - float(v_ad)) <= 1e-12 * float(v_ad)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gradient_matches_plain_ad(layout):
    """(lam, mu, rho, stf) gradients of the layout's misfit through the
    boundary-saving adjoint equal plain AD: model gradients on the
    interior shrunk by the 2-cell reach of the material-averaging chain
    rules, stf everywhere."""
    cfg, geoms, fn, aux = _case(layout)
    med, s = model(cfg), stf(cfg)
    lam, mu, rho = med.to_lame()
    obs = _run(propagate_ad, cfg, lam.at[20:30, 18:40].multiply(1.05), mu,
               rho, s, geoms)
    w = jnp.asarray([1.0, 0.7])
    loss = parallel.make_local_misfit(cfg, misfit_fn=fn)

    def loss_ad(lam_, mu_, rho_, s_):
        syn = _run(propagate_ad, cfg, lam_, mu_, rho_, s_, geoms)
        return jnp.sum(w * jax.vmap(fn)(obs, syn, *aux))

    g = jax.jit(jax.grad(lambda l, m, r, s_: loss(l, m, r, s_, geoms, obs,
                                                  w, *aux),
                         argnums=(0, 1, 2, 3)))(lam, mu, rho, s)
    g_ad = jax.jit(jax.grad(loss_ad, argnums=(0, 1, 2, 3)))(lam, mu, rho, s)
    sl = (slice(cfg.npml + 2, cfg.nz - cfg.npml - 2),
          slice(cfg.npml + 2, cfg.nx - cfg.npml - 2))
    for name, a, b in zip(("lam", "mu", "rho", "stf"), g, g_ad):
        a, b = np.asarray(a), np.asarray(b)
        if name != "stf":
            a, b = a[sl], b[sl]
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() / scale < 1e-9, name
