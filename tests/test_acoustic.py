"""Acoustic propagator: forward sanity + boundary-saving adjoint vs plain AD."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sep2023_tpu as st
from sep2023_tpu.acoustic import (AcGeom, propagate_acoustic,
                                  propagate_acoustic_ad)


@pytest.fixture(scope="module")
def setup():
    cfg = st.SimConfig(nz=60, nx=70, dz=20.0, dx=20.0, nt=120, dt=0.002,
                       f0=10.0, npml=12)
    key = jax.random.PRNGKey(3)
    vp = 3000.0 + 100.0 * jax.random.normal(key, cfg.grid.shape)
    rho = jnp.full(cfg.grid.shape, 2500.0)
    lam = rho * vp ** 2
    stf = jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt))
    geom = AcGeom(src_z=jnp.int32(18), src_x=jnp.int32(30),
                  rec_z=jnp.full(16, 40, jnp.int32),
                  rec_x=jnp.arange(22, 38, dtype=jnp.int32))
    return cfg, lam, rho, stf, geom


def test_forward_finite_and_absorbing(setup):
    cfg, lam, rho, stf, geom = setup
    # absorption check needs the wave to traverse and exit: run longer
    cfg_long = st.SimConfig(nz=cfg.nz, nx=cfg.nx, dz=cfg.dz, dx=cfg.dx,
                            nt=500, dt=cfg.dt, f0=cfg.f0, npml=cfg.npml)
    stf_long = jnp.asarray(st.ricker(cfg.f0, cfg_long.nt, cfg.dt))
    data = np.asarray(propagate_acoustic(cfg_long, lam, rho, stf_long, geom))
    assert data.shape == (3, 16, cfg_long.nt)
    assert np.isfinite(data).all()
    p = np.abs(data[0, 0])
    assert p[-10:].max() < 0.05 * p.max()


def test_acoustic_adjoint_matches_ad(setup):
    cfg, lam, rho, stf, geom = setup
    obs = propagate_acoustic_ad(cfg, lam * 1.03, rho, stf, geom)

    def loss(fn, lam_, rho_, stf_):
        r = obs - fn(cfg, lam_, rho_, stf_, geom)
        r = r.at[..., 0].set(0.0)
        return 0.5 * jnp.sum(r * r)

    g_cv = jax.jit(jax.grad(lambda *a: loss(propagate_acoustic, *a),
                            argnums=(0, 1, 2)))(lam, rho, stf)
    g_ad = jax.jit(jax.grad(lambda *a: loss(propagate_acoustic_ad, *a),
                            argnums=(0, 1, 2)))(lam, rho, stf)
    s = 4
    sl = (slice(cfg.npml + s, cfg.nz - cfg.npml - s),
          slice(cfg.npml + s, cfg.nx - cfg.npml - s))
    for name, a, b in zip(("lam", "rho", "stf"), g_cv, g_ad):
        if name != "stf":
            a, b = a[sl], b[sl]
        scale = np.abs(np.asarray(b)).max() + 1e-30
        rel = np.abs(np.asarray(a - b)).max() / scale
        assert rel < 1e-6, f"{name}: rel err {rel}"


def _two_shot_row(nt, vp_box, rec_z, rec_x, src_x):
    npml = 10
    cfg = st.SimConfig(nz=40 + 2 * npml, nx=56 + 2 * npml, dz=20.0, dx=20.0,
                       nt=nt, dt=0.002, f0=10.0, npml=npml)
    (z0, z1), (x0, x1) = vp_box
    vp = jnp.full(cfg.grid.shape, 3000.0).at[z0:z1, x0:x1].add(250.0)
    rho = jnp.full(cfg.grid.shape, 2200.0)
    lam = rho * vp ** 2
    S, R = len(src_x), len(rec_x)
    stf = jnp.broadcast_to(jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt)),
                           (S, cfg.nt))
    geoms = AcGeom(src_z=jnp.full((S,), 2 + npml, jnp.int32),
                   src_x=jnp.asarray(np.asarray(src_x) + npml, jnp.int32),
                   rec_z=jnp.broadcast_to(
                       jnp.asarray(np.asarray(rec_z) + npml, jnp.int32),
                       (S, R)),
                   rec_x=jnp.broadcast_to(
                       jnp.asarray(np.asarray(rec_x) + npml, jnp.int32),
                       (S, R)))
    return cfg, lam, rho, stf, geoms


def test_acoustic_pallas_matches_xla():
    """The XLA acoustic engine's 2-shot row-survey forward, taken through
    the boundary-saving custom_vjp's primal (strip saving on), matches the
    plain-AD reference propagate_acoustic_ad."""
    cfg, lam, rho, stf, geoms = _two_shot_row(
        150, ((26, 32), (30, 44)), np.full(24, 32), np.arange(16, 40),
        [14, 40])

    def run(fn):
        return jax.vmap(lambda s, g: fn(cfg, lam, rho, s, g))(stf, geoms)

    out, _ = jax.vjp(lambda lam_: jax.vmap(
        lambda s, g: propagate_acoustic(cfg, lam_, rho, s, g))(stf, geoms),
        lam)
    ref = np.asarray(run(propagate_acoustic_ad))
    out = np.asarray(out)
    assert out.shape == ref.shape == (2, 3, 24, cfg.nt)
    for c in range(3):
        scale = np.abs(ref[:, c]).max()
        assert scale > 0
        rel = np.abs(out[:, c] - ref[:, c]).max() / scale
        assert rel < 1e-12, (c, rel)


def test_rtm_image_time_locality():
    """The time-derivative imaging condition (image_vel_time.cu) must focus
    energy at a velocity anomaly and carry a consistent sign there."""
    import jax.numpy as jnp

    from sep2023_tpu.imaging import rtm_image_time

    npml = 10
    cfg = st.SimConfig(nz=50 + 2 * npml, nx=60 + 2 * npml, dz=20.0, dx=20.0,
                       nt=300, dt=0.002, f0=10.0, npml=npml)
    vp_bg = jnp.full(cfg.grid.shape, 3000.0)
    az, ax = 42, 40  # anomaly center (padded indices)
    vp_tr = vp_bg.at[az - 3:az + 3, ax - 6:ax + 6].add(300.0)
    rho = jnp.full(cfg.grid.shape, 2200.0)
    geom = AcGeom(src_z=jnp.int32(npml + 2), src_x=jnp.int32(40),
                  rec_z=jnp.full(40, npml + 3, jnp.int32),
                  rec_x=jnp.arange(15, 55, dtype=jnp.int32))
    stf = jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt))

    obs = propagate_acoustic(cfg, rho * vp_tr ** 2, rho, stf, geom)
    syn = propagate_acoustic(cfg, rho * vp_bg ** 2, rho, stf, geom)
    residual = obs - syn

    img = np.asarray(rtm_image_time(cfg, vp_bg, rho, stf, geom, residual))
    assert img.shape == cfg.grid.shape
    assert np.isfinite(img).all() and np.abs(img).max() > 0

    # locality: mean |image| within the anomaly box dominates the far field
    box = np.zeros(cfg.grid.shape, bool)
    box[az - 5:az + 5, ax - 8:ax + 8] = True
    interior = np.zeros(cfg.grid.shape, bool)
    interior[npml + 8:-npml - 1, npml + 1:-npml - 1] = True  # below receivers
    near = np.abs(img[box & interior]).mean()
    far = np.abs(img[interior & ~box]).mean()
    assert near > 5.0 * far

    # sign: a positive velocity anomaly imaged with residual = obs - syn
    # gives a coherent single-signed peak at the anomaly
    peak = img[az - 3:az + 3, ax - 6:ax + 6]
    dominant = np.sign(peak.ravel()[np.abs(peak).argmax()])
    assert np.sign(peak.sum()) == dominant != 0


def test_acoustic_pallas_gradient_matches_xla():
    """The XLA acoustic engine's boundary-saving backward (the counterpart
    of ac_*_adj.cu) matches plain AD through propagate_acoustic_ad in lam,
    rho and stf on a 2-shot row survey."""
    cfg, lam0, rho0, stf, geoms = _two_shot_row(
        141, ((28, 34), (36, 48)), np.full(20, 34), np.arange(14, 34),
        [12, 36])
    obs = jax.vmap(lambda s, g: propagate_acoustic_ad(
        cfg, lam0 * 1.03, rho0, s, g))(stf, geoms)

    def loss(fn, l, r, s):
        d = obs - jax.vmap(lambda s1, g: fn(cfg, l, r, s1, g))(s, geoms)
        return 0.5 * jnp.sum(d * d)

    gp = jax.grad(lambda *a: loss(propagate_acoustic, *a),
                  argnums=(0, 1, 2))(lam0, rho0, stf)
    gx = jax.grad(lambda *a: loss(propagate_acoustic_ad, *a),
                  argnums=(0, 1, 2))(lam0, rho0, stf)
    npml = cfg.npml
    sl = (slice(npml + 4, cfg.nz - npml - 4),
          slice(npml + 4, cfg.nx - npml - 4))
    for name, a, b in zip(("lam", "rho", "stf"), gp, gx):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape == cfg.grid.shape:
            a, b = a[sl], b[sl]
        rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-30)
        assert rel < 1e-8, (name, rel)
