"""DAS operators: fiber geometry, sensitivity weights, gauge-length
quadrature convergence (the reference's Fig-2-3 experiment), and the
differentiable weighted recording channel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sep2023_tpu as st
from sep2023_tpu import das


def test_straight_fiber_weights():
    cable = das.straight_fiber(10.0, direction=(1, 0, 0))
    assert cable.shape == (21, 9)
    # x-aligned fiber: only TxTx = 1
    assert np.allclose(cable[:, 3], 1.0)
    assert np.allclose(cable[:, 4:], 0.0, atol=1e-12)
    # arc length spacing uniform
    d = np.linalg.norm(np.diff(cable[:, :3], axis=0), axis=1)
    assert np.allclose(d, d[0], rtol=1e-6)


def test_sensitivity_weights_sum():
    """w1 + w4 + w6 = |T|^2 = 1 for any tangent (TxTx + TyTy + TzTz)."""
    cable = das.arc_fiber(10.0, 1.0 / np.pi)
    w = cable[:, 3:]
    assert np.allclose(w[:, 0] + w[:, 3] + w[:, 5], 1.0, atol=1e-10)


def test_quadrature_convergence():
    """Higher quadrature order converges to the 21-point response; curvier
    fibers need more points (the reference's quadrature study,
    Fig-2-3-Analytical-DAS-Waveform.ipynb cell 12)."""
    vp, vs, rho, f0, M0 = 3000.0, 1500.0, 2500.0, 25.0, 1e15
    GL = 20.0
    M = np.eye(3)
    cable = das.arc_fiber(GL, 2.0 / np.pi, center=(120.0, 140.0, 100.0))
    src = (0.0, 0.0, 0.0)
    kw = dict(tmin=0.0, tmax=0.35, dt=0.002, f0=f0, M0=M0, M=M)
    full = das.das_response(vp, vs, rho, GL, cable, 21, src, **kw)
    scale = np.abs(full).max()
    errs = {}
    for nq in (1, 3, 7):
        r = das.das_response(vp, vs, rho, GL, cable, nq, src, **kw)
        errs[nq] = np.abs(r - full).max() / scale
    assert errs[7] < errs[1]
    assert errs[7] < 0.05


def test_straight_fiber_matches_point_strain():
    """For a straight x-fiber the gauge response converges to Exx as GL -> 0."""
    vp, vs, rho, f0, M0 = 3000.0, 1500.0, 2500.0, 25.0, 1e15
    M = np.eye(3)
    center = (150.0, 120.0, 90.0)
    kw = dict(tmin=0.0, tmax=0.3, dt=0.002, f0=f0, M0=M0, M=M)
    from sep2023_tpu import analytic as an
    cable = das.straight_fiber(2.0, direction=(1, 0, 0), center=center)
    resp = das.das_response(vp, vs, rho, 2.0, cable, 21, (0, 0, 0), **kw)
    sol = an.solution(vp, vs, rho, *center, kw["tmin"], kw["tmax"], kw["dt"],
                      f0, M0, M, dim="3D", comp="strain")
    scale = np.abs(sol["Exx"]).max()
    assert np.abs(resp - sol["Exx"]).max() / scale < 0.02


def test_weighted_das_channel_differentiable():
    """The propagator's 'weighted' DAS channel reduces to exx/dx for an
    x-aligned fiber and is differentiable."""
    cfg_w = st.SimConfig(nz=60, nx=70, dz=20.0, dx=20.0, nt=80, dt=0.002,
                         f0=10.0, npml=12, das_channel="weighted")
    cfg_e = st.SimConfig(nz=60, nx=70, dz=20.0, dx=20.0, nt=80, dt=0.002,
                         f0=10.0, npml=12, das_channel="exx")
    vp = jnp.full(cfg_w.grid.shape, 3000.0)
    med = st.Medium(vp, vp / jnp.sqrt(3.0), jnp.full_like(vp, 2500.0))
    stf = jnp.asarray(st.ricker(cfg_w.f0, cfg_w.nt, cfg_w.dt))
    R = 10
    das_w = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (R, 1))
    geom_w = st.ShotGeom(src_z=jnp.int32(20), src_x=jnp.int32(30),
                         rxz=jnp.float64(1.0),
                         rec_z=jnp.full(R, 40, jnp.int32),
                         rec_x=jnp.arange(20, 30, dtype=jnp.int32),
                         das_w=das_w)
    geom_e = geom_w._replace(das_w=None)
    d_w = st.propagate(cfg_w, med.lam, med.mu, med.rho, stf, geom_w)
    d_e = st.propagate(cfg_e, med.lam, med.mu, med.rho, stf, geom_e)
    # weighted(1,0,0) == exx / dx
    assert np.allclose(np.asarray(d_w[3]), np.asarray(d_e[3]) / cfg_w.dx,
                       rtol=1e-10)

    def loss(lam):
        d = st.propagate(cfg_w, lam, med.mu, med.rho, stf, geom_w)
        return jnp.sum(d[3] ** 2)

    g = jax.grad(loss)(med.lam)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0


def test_numerical_strain_channels_match_analytic():
    """The weighted DAS channels (exx/ezz/exz strain rates from velocity
    differences) must reproduce the analytic 2D strain waveforms — the
    quantitative version of the reference's visual check
    (000-Solver-Benchmark.ipynb cell 13, including its -1 sign convention)."""
    from sep2023_tpu import analytic as an

    npml = 24
    cfg = st.SimConfig(nz=140 + 2 * npml, nx=200 + 2 * npml, dz=10.0,
                       dx=10.0, nt=600, dt=0.001, f0=10.0, npml=npml,
                       das_channel="weighted")
    vp = jnp.full(cfg.grid.shape, 4000.0)
    med = st.Medium(vp, vp / jnp.sqrt(3.0), jnp.full(cfg.grid.shape, 2500.0))
    src_z, src_x = npml + 30, npml + 50
    rec_z, rec_x = npml + 100, npml + 130  # 700 m down, 800 m across

    # three co-located channels with pure exx / exz / ezz sensitivity
    stf = jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt, amp=1.0))
    geom = st.ShotGeom(
        src_z=jnp.int32(src_z), src_x=jnp.int32(src_x), rxz=jnp.float64(1.0),
        rec_z=jnp.full(3, rec_z, jnp.int32),
        rec_x=jnp.full(3, rec_x, jnp.int32),
        das_w=jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                           [0.0, 0.0, 1.0]]))
    data = np.asarray(st.propagate(cfg, med.lam, med.mu, med.rho, stf, geom))

    t = np.arange(cfg.nt) * cfg.dt
    sol = an.solution(4000.0, 4000.0 / np.sqrt(3.0), 2500.0,
                      (rec_x - src_x) * cfg.dx, 0.0, (rec_z - src_z) * cfg.dz,
                      0.0, t[-1], cfg.dt, cfg.f0, 1e16, np.eye(3),
                      dim="2D", comp="strain")

    def corr(a, b):
        a = (a - a.mean()) / (a.std() + 1e-30)
        b = (b - b.mean()) / (b.std() + 1e-30)
        return float(np.mean(a * b))

    n = min(cfg.nt, len(sol["Exx"]))
    for ch, name in ((0, "Exx"), (1, "Exz"), (2, "Ezz")):
        c = corr(data[3, ch, :n], -sol[name][:n])
        assert c > 0.96, (name, c)


def test_gauge_matrix():
    A = das.gauge_matrix(2, 21, 10.0)
    assert A.shape == (2, 42)
    # rows sum to 1 (average of a constant strain field is itself)
    assert np.allclose(A.sum(axis=1), 1.0)


def test_cable_to_receivers_45deg():
    """A 45-degree straight fiber maps to (exx, exz, ezz) weights
    (0.5, 1.0, 0.5) — T=(1,1)/sqrt(2) projected through the 6-weight set."""
    cable = das.straight_fiber(200.0, direction=(1, 1, 0),
                               center=(500.0, 500.0, 0.0))
    rec_z, rec_x, w = das.cable_to_receivers(cable, 10.0, 10.0)
    assert np.allclose(w, [0.5, 1.0, 0.5], atol=1e-10)
    # diagonal geometry on the grid
    assert np.all(np.abs((rec_x - rec_x[0]) - (rec_z - rec_z[0])) <= 1)


def test_curved_fiber_gauge_fwi_gradient():
    """End-to-end DAS FWI machinery with a curved fiber: directional
    weighted channels -> gauge-length averaging -> L2 misfit -> model
    gradient.  The whole chain must be differentiable and the gradient
    must be nonzero and finite."""
    npml = 10
    cfg = st.SimConfig(nz=50 + 2 * npml, nx=70 + 2 * npml, dz=10.0, dx=10.0,
                       nt=160, dt=0.001, f0=15.0, npml=npml,
                       das_channel="weighted")
    vp = jnp.full(cfg.grid.shape, 3000.0)
    med = st.Medium(vp, vp / jnp.sqrt(3.0), jnp.full(cfg.grid.shape, 2500.0))

    # one gauge channel: a 21-point arc fiber buried at ~300 m depth
    cable = das.arc_fiber(100.0, 2.0 / np.pi, center=(350.0, 300.0, 0.0))
    rec_z, rec_x, das_w = das.cable_to_receivers(cable, cfg.dx, cfg.dz)
    A = das.gauge_matrix(1, das.N_CABLE_PTS, 100.0)

    stf = jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt))
    geom = st.ShotGeom(src_z=jnp.int32(npml + 3), src_x=jnp.int32(npml + 12),
                       rxz=jnp.float64(1.0),
                       rec_z=jnp.asarray(rec_z + npml, jnp.int32),
                       rec_x=jnp.asarray(rec_x + npml, jnp.int32),
                       das_w=jnp.asarray(das_w))

    lam_t = med.lam.at[npml + 25:npml + 35, npml + 20:npml + 50].mul(1.08)
    obs = st.propagate(cfg, lam_t, med.mu, med.rho, stf, geom)
    obs_g = das.apply_gauge(obs[3], A)

    def loss(lam):
        syn = st.propagate(cfg, lam, med.mu, med.rho, stf, geom)
        r = obs_g - das.apply_gauge(syn[3], A)
        return 0.5 * jnp.sum(r * r)

    v, g = jax.value_and_grad(loss)(med.lam)
    assert float(v) > 0
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g[npml + 2:cfg.nz - npml, npml + 2:cfg.nx - npml]).max() > 0


def test_spline_fiber_geometry():
    """spline_fiber (the Overthrust generator, DAS_Geometry_Overthrust.m:
    28-50): passes through the end control points, resamples to equal arc
    length, and carries normalized tangential-projection weights."""
    cp = np.array([[0.0, 100.0, 0.0], [40.0, 80.0, 0.0],
                   [80.0, 110.0, 0.0], [120.0, 90.0, 0.0]])
    cable = das.spline_fiber(cp)
    assert cable.shape == (das.N_CABLE_PTS, 9)
    np.testing.assert_allclose(cable[0, :3], cp[0], atol=1e-6)
    np.testing.assert_allclose(cable[-1, :3], cp[-1], atol=1e-6)
    seg = np.linalg.norm(np.diff(cable[:, :3], axis=0), axis=1)
    assert seg.std() / seg.mean() < 0.05  # equal arc-length spacing
    # weights: w1 = Tx^2, w4 = Ty^2, w6 = Tz^2 sum to |T|^2 = 1
    np.testing.assert_allclose(cable[:, 3] + cable[:, 6] + cable[:, 8],
                               1.0, atol=1e-9)
    # in-plane cable: no z-weights
    np.testing.assert_allclose(cable[:, 5], 0.0, atol=1e-12)
    np.testing.assert_allclose(cable[:, 7], 0.0, atol=1e-12)


def test_spline_fiber_overthrust_fwi_plan():
    """End-to-end Overthrust-style acquisition (DAS_Geometry_Overthrust.m
    flow): a spline cable draped over models.overthrust_vp, recorded with
    directional weights on a genuinely multi-row fiber — the XLA engine's
    2-shot forward and its boundary-saving lam-gradient match the plain-AD
    reference."""
    import jax

    import sep2023_tpu as st
    from sep2023_tpu import models
    from sep2023_tpu.propagator import propagate_ad

    npml = 10
    cfg = st.SimConfig(nz=40 + 2 * npml, nx=56 + 2 * npml, dz=10.0, dx=10.0,
                       nt=120, dt=0.001, f0=15.0, npml=npml,
                       das_channel="weighted")
    vp = models.overthrust_vp(40, 56, v_top=2200.0, v_step=250.0)
    vp_pad = jnp.asarray(st.medium.pad_model_np(vp, npml))
    med = st.Medium(vp_pad, vp_pad / jnp.sqrt(3.0),
                    jnp.full(cfg.grid.shape, 2300.0))
    cfg.check_stability(float(vp.max()))

    # undulating cable through control points over the structure
    cp = np.array([[140.0, 180.0, 0.0], [220.0, 150.0, 0.0],
                   [300.0, 200.0, 0.0], [380.0, 170.0, 0.0]])
    cable = das.spline_fiber(cp)
    rec_z, rec_x, das_w = das.cable_to_receivers(cable, cfg.dx, cfg.dz)
    assert len(np.unique(rec_z)) > 2  # genuinely multi-row

    stf = jnp.broadcast_to(jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt)),
                           (2, cfg.nt))
    geom = st.ShotGeom(
        src_z=jnp.asarray([2 + npml, 2 + npml], jnp.int32),
        src_x=jnp.asarray([14 + npml, 40 + npml], jnp.int32),
        rxz=jnp.ones((2,)),
        rec_z=jnp.broadcast_to(jnp.asarray(rec_z + npml, jnp.int32),
                               (2, len(rec_z))),
        rec_x=jnp.broadcast_to(jnp.asarray(rec_x + npml, jnp.int32),
                               (2, len(rec_x))),
        das_w=jnp.broadcast_to(jnp.asarray(das_w), (2, *das_w.shape)))

    def run(fn, lam):
        return jax.vmap(lambda s, g: fn(cfg, lam, med.mu, med.rho, s, g))(
            stf, geom)

    out, pull = jax.vjp(lambda lam: run(st.propagate, lam), med.lam)
    ref, pull_ad = jax.vjp(lambda lam: run(propagate_ad, lam), med.lam)
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == (2, 4, len(rec_z), cfg.nt)
    for c in range(4):
        scale = np.abs(ref[:, c]).max()
        assert scale > 0
        assert np.abs(out[:, c] - ref[:, c]).max() / scale < 1e-12, c
    ct = jnp.asarray(np.random.default_rng(0).normal(size=out.shape))
    ct = ct.at[:, :3].set(0.0)   # the fiber channel drives the adjoint
    (g,), (g_ad,) = pull(ct), pull_ad(ct)
    sl = (slice(npml + 2, cfg.nz - npml - 2),
          slice(npml + 2, cfg.nx - npml - 2))
    g, g_ad = np.asarray(g)[sl], np.asarray(g_ad)[sl]
    assert np.abs(g - g_ad).max() / np.abs(g_ad).max() < 1e-8


def test_resample_arclength_spline_vs_analytic_circle():
    """Spline-parametric resampling (interparc.m 'spline' mode): on a
    quarter circle known analytically, the spline arc length must beat the
    chordal estimate by orders of magnitude and the resampled points must
    be equally spaced in TRUE arc length and lie on the circle."""
    R, theta = 100.0, np.pi / 2
    t = np.linspace(0.0, theta, 13)   # coarse knots
    knots = np.stack([R * np.cos(t), R * np.sin(t), 0 * t], axis=1)
    L_true = R * theta
    chord = np.linalg.norm(np.diff(knots, axis=0), axis=1).sum()
    _, _, L_spline = das._arc_spline(knots)
    assert abs(L_spline - L_true) < 0.02 * abs(chord - L_true)
    assert abs(L_spline - L_true) / L_true < 1e-5

    pts = das.resample_arclength(knots, 41)
    r = np.linalg.norm(pts[:, :2], axis=1)
    np.testing.assert_allclose(r, R, rtol=1e-5)        # on the circle
    ang = np.arctan2(pts[:, 1], pts[:, 0])
    darc = R * np.diff(ang)
    np.testing.assert_allclose(darc, L_true / 40, rtol=1e-4)  # equal TRUE arc
    # the old chordal variant stays available and is measurably worse
    pts_lin = das.resample_arclength(knots, 41, method="linear")
    r_lin = np.linalg.norm(pts_lin[:, :2], axis=1)
    assert np.abs(r_lin - R).max() > 10 * np.abs(r - R).max()


def test_segment_cable_overthrust():
    """segment_cable (segment.m + DAS_Geometry_Overthrust.m:60-66): the
    Overthrust spline fiber cut into gauge channels whose groups compose
    with gauge_matrix."""
    # the examples/overthrust_das.py cable, meters
    cp = np.array([[150.0, 420.0, 0.0], [350.0, 330.0, 0.0],
                   [550.0, 430.0, 0.0], [750.0, 360.0, 0.0],
                   [900.0, 420.0, 0.0]])
    GL = 50.0
    cable, nodes, err = das.segment_cable(cp, GL)
    _, _, L = das._arc_spline(cp)
    n_nodes = int(round(L / GL)) + 1
    n_chan = n_nodes - 2
    assert nodes.shape == (n_nodes, 3)
    assert cable.shape == (n_chan * das.N_CABLE_PTS, 9)
    assert err < 0.02 * GL   # segment.m's mean-spacing error figure

    # every channel's 21 points span one gauge length in arc
    pts = cable[:, :3].reshape(n_chan, das.N_CABLE_PTS, 3)
    for c in range(n_chan):
        span = np.linalg.norm(np.diff(pts[c], axis=0), axis=1).sum()
        assert abs(span - GL) < 0.01 * GL, c
    # channel centers = the interior segment.m nodes
    np.testing.assert_allclose(pts[:, das.N_CABLE_PTS // 2, :],
                               nodes[1:-1], atol=1e-6)
    # exact spline tangents: normalized projection weights everywhere
    w = cable[:, 3:]
    np.testing.assert_allclose(w[:, 0] + w[:, 3] + w[:, 5], 1.0, atol=1e-9)
    # composes with the gauge averaging map
    A = das.gauge_matrix(n_chan)
    ett = np.random.default_rng(0).normal(
        size=(n_chan * das.N_CABLE_PTS, 8))
    avg = np.asarray(das.apply_gauge(jnp.asarray(ett), A))
    assert avg.shape == (n_chan, 8)
    # trapezoid average of a constant field is that constant
    const = np.asarray(das.apply_gauge(jnp.ones((n_chan * 21, 4)), A))
    np.testing.assert_allclose(const, 1.0, rtol=1e-6)


def test_segment_cable_too_short_raises():
    cp = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0],
                   [3.0, 0.0, 0.0]])
    with pytest.raises(ValueError):
        das.segment_cable(cp, 100.0)
