"""Config/survey JSON round trips (reference para/survey schema) and
wavelets."""
import numpy as np

import sep2023_tpu as st
from sep2023_tpu.config import (SimConfig, Survey, sim_config_from_json,
                                sim_config_to_json)


def test_para_json_roundtrip(tmp_path):
    cfg = SimConfig(nz=165, nx=265, dz=20.0, dx=20.0, nt=1501, dt=0.002,
                    f0=10.0, npml=32)
    p = str(tmp_path / "para_file.json")
    sim_config_to_json(cfg, p, "survey_file.json", str(tmp_path / "Data"))
    cfg2 = sim_config_from_json(p)
    assert cfg2 == cfg


def test_survey_json_roundtrip(tmp_path):
    sv = Survey(src_z=np.array([1, 1]), src_x=np.array([10, 20]),
                rec_z=np.full(5, 95), rec_x=np.arange(10, 15),
                src_rxz=np.array([1.0, 3.0]),
                trace_weights=np.ones((2, 5)),
                src_weights=np.array([1.0, 0.5]))
    p = str(tmp_path / "survey_file.json")
    sv.to_json(p)
    sv2 = Survey.from_json(p)
    assert np.array_equal(sv2.src_x, sv.src_x)
    assert np.array_equal(sv2.rec_x, sv.rec_x)
    assert np.allclose(sv2.src_rxz, [1.0, 3.0])
    assert np.allclose(sv2.trace_weights, 1.0)
    assert np.allclose(sv2.src_weights, [1.0, 0.5])


def test_wavelets():
    for fn in (st.ricker, st.ricker_integrated, st.klauder):
        w = fn(10.0, 500, 0.002)
        assert w.shape == (500,)
        assert np.isfinite(w).all()
        assert np.abs(w).max() > 0
    # integrated ricker is the cumulative sum * dt of ricker
    r = st.ricker(10.0, 500, 0.002)
    ri = st.ricker_integrated(10.0, 500, 0.002)
    assert np.allclose(ri, np.cumsum(r) * 0.002)


def test_courant():
    cfg = SimConfig(nz=100, nx=100, dz=20.0, dx=20.0, nt=100, dt=0.002,
                    f0=10.0)
    cfg.check_stability(3000.0)  # fine
    import pytest
    with pytest.raises(ValueError):
        cfg.check_stability(9000.0)


def test_negative_lambda_warning():
    """medium.check_lambda warns on vp^2 < 2*vs^2 (the reference's device
    model build prints the same warning, Model.cu:37-40)."""
    import warnings

    import jax.numpy as jnp
    import pytest

    from sep2023_tpu import medium

    ok = jnp.ones((4, 4))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert medium.check_lambda(ok) == 1.0
    with pytest.warns(RuntimeWarning, match="negative Lame"):
        assert medium.check_lambda(ok.at[2, 2].set(-1.0)) == -1.0


def test_borehole_column_receivers():
    """Crosswell geometry: receivers down a vertical column with the ezz
    (vertical fiber) DAS channel and an anisotropic source ratio — the
    borehole configuration behind src_rxz (utilities.cu:537) and
    recording_ezz."""
    import jax
    import jax.numpy as jnp
    cfg = SimConfig(nz=70, nx=80, dz=10.0, dx=10.0, nt=200, dt=0.001,
                    f0=15.0, npml=12, das_channel="ezz")
    vp = jnp.full(cfg.grid.shape, 3000.0)
    med = st.Medium(vp, vp / jnp.sqrt(3.0), jnp.full_like(vp, 2500.0))
    stf = jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt))
    geom = st.ShotGeom(src_z=jnp.int32(30), src_x=jnp.int32(20),
                       rxz=jnp.float64(3.0),
                       rec_z=jnp.arange(20, 50, dtype=jnp.int32),
                       rec_x=jnp.full(30, 60, jnp.int32))
    d = np.asarray(st.propagate(cfg, med.lam, med.mu, med.rho, stf, geom))
    assert np.isfinite(d).all()
    # direct P reaches the fiber first at the source depth: first-break
    # (20% of per-trace max) is earliest near the middle receiver
    a = np.abs(d[2])  # vz channel (robust first break; ett is nodal there)
    thresh = 0.2 * a.max(axis=1, keepdims=True)
    first = (a > thresh).argmax(axis=1)
    mid = 10  # receiver at source depth (z=30 is index 10)
    assert first[mid] < first[0] and first[mid] < first[-1]
    # gradient flows through the borehole recording too
    g = jax.grad(lambda l: jnp.sum(st.propagate(
        cfg, l, med.mu, med.rho, stf, geom)[3] ** 2))(med.lam)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0


def test_ezz_channel():
    """das_channel='ezz' records vertical-fiber strain (recording_ezz,
    utilities.cu:620-641)."""
    import jax.numpy as jnp
    cfg = SimConfig(nz=60, nx=70, dz=20.0, dx=20.0, nt=80, dt=0.002,
                    f0=10.0, npml=12, das_channel="ezz")
    vp = jnp.full(cfg.grid.shape, 3000.0)
    med = st.Medium(vp, vp / jnp.sqrt(3.0), jnp.full_like(vp, 2500.0))
    stf = jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt))
    geom = st.ShotGeom(src_z=jnp.int32(20), src_x=jnp.int32(30),
                       rxz=jnp.float64(1.0),
                       rec_z=jnp.full(4, 30, jnp.int32),
                       rec_x=jnp.arange(26, 30, dtype=jnp.int32))
    d = np.asarray(st.propagate(cfg, med.lam, med.mu, med.rho, stf, geom))
    assert np.isfinite(d).all()
    assert np.abs(d[3]).max() > 0
