"""Checks that need an NVIDIA GPU; they skip elsewhere.  On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sep2023_tpu as st
from sep2023_tpu import das, parallel
from sep2023_tpu.propagator import propagate_ad

pytestmark = pytest.mark.gpu


def test_gpu_engine_matches_plain_ad_float32(gpu_device):
    """The compiled boundary-saving gradient against plain AD on the card,
    float32, 2 shots of a 44x52 grid: the bounds chip_smoke.py holds the
    reference workload to."""
    f32 = jnp.float32
    cfg = st.SimConfig(nz=44, nx=52, dz=20.0, dx=20.0, nt=200, dt=0.002,
                       f0=10.0, npml=8)
    key = jax.random.PRNGKey(0)
    vp = 3000.0 + 80.0 * jax.random.normal(key, cfg.grid.shape, f32)
    lam, mu, rho = st.Medium(vp, vp / jnp.sqrt(f32(3.0)),
                             jnp.full_like(vp, 2500.0)).to_lame()
    survey = st.Survey(src_z=np.full(2, 4), src_x=np.array([10, 26]),
                       rec_z=np.full(12, 24), rec_x=np.arange(8, 32, 2))
    geoms = parallel.survey_to_geoms(survey, cfg.npml, dtype=f32)
    stf = jnp.broadcast_to(jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt),
                                       f32), (2, cfg.nt))
    obs = jax.vmap(lambda s, g: propagate_ad(cfg, lam * 1.05, mu, rho, s,
                                             g))(stf, geoms)

    def loss(fn, lam_):
        syn = jax.vmap(lambda s, g: fn(cfg, lam_, mu, rho, s, g))(stf, geoms)
        r = (obs - syn).at[..., 0].set(0.0)
        return 0.5 * jnp.sum(r * r)

    g = jax.jit(jax.grad(lambda l: loss(st.propagate, l)))(lam)
    g_ad = jax.jit(jax.grad(lambda l: loss(propagate_ad, l)))(lam)
    assert g.devices() == {gpu_device}
    sl = (slice(cfg.npml + 2, cfg.nz - cfg.npml - 2),
          slice(cfg.npml + 2, cfg.nx - cfg.npml - 2))
    g, g_ad = np.asarray(g)[sl], np.asarray(g_ad)[sl]
    assert np.abs(g - g_ad).max() / np.abs(g_ad).max() < 1e-4


def test_gpu_gauge_einsum_full_precision(gpu_device):
    """das.apply_gauge in float32 on the card stays at float32 accuracy
    (a TF32 contraction would be off by ~1e-3)."""
    rng = np.random.default_rng(0)
    A = das.gauge_matrix(8, das.N_CABLE_PTS, 10.0)
    x = rng.normal(size=(4, A.shape[1], 512))
    got = np.asarray(das.apply_gauge(jnp.asarray(x, jnp.float32), A))
    want = np.einsum("cp,...pt->...ct", A, x)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_gpu_memory_budget_from_bytes_limit(gpu_device):
    """hbm_budget_bytes takes 3/8 of the card's reported bytes_limit, and
    the Marmousi chunk follows from it."""
    limit = gpu_device.memory_stats()["bytes_limit"]
    budget = parallel.hbm_budget_bytes()
    assert budget == max(1 << 30, limit * 3 // 8)
    cfg = st.SimConfig(nz=814, nx=2064, dz=10.0, dx=10.0, nt=2001,
                       dt=0.001, f0=10.0, npml=32)
    chunk = parallel.auto_shot_chunk(cfg, 24)
    per = parallel.strip_bytes_per_shot(cfg)
    assert chunk == 0 or chunk * per <= budget < (chunk + 1) * per
