"""Shot chunking x shot sharding on the 8-device CPU mesh: every
(chunk, devices) pair gives the unchunked single-device misfit, model and
stf gradients (parallel._chunked_sum's gradient accumulator, ragged tails
included) and the same forward data (parallel.make_forward)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sep2023_tpu as st
from sep2023_tpu import parallel as par
from sep2023_tpu.config import Survey
from sep2023_tpu.propagator import propagate_ad

CHUNKS = (1, 2, 3)          # 8 shots: chunk 3 leaves a ragged tail
DEVICES = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def problem():
    cfg = st.SimConfig(nz=44, nx=52, dz=20.0, dx=20.0, nt=60, dt=0.002,
                       f0=10.0, npml=8)
    key = jax.random.PRNGKey(5)
    vp = 3000.0 + 80.0 * jax.random.normal(key, cfg.grid.shape)
    lam, mu, rho = st.Medium(vp, vp / jnp.sqrt(3.0),
                             jnp.full_like(vp, 2500.0)).to_lame()
    survey = Survey(src_z=np.full(8, 4), src_x=np.arange(4, 36, 4),
                    rec_z=np.full(12, 14), rec_x=np.arange(8, 32, 2))
    geoms = par.survey_to_geoms(survey, cfg.npml, dtype=lam.dtype)
    stf = jnp.broadcast_to(jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt,
                                                 delay_cycles=0.4)),
                           (8, cfg.nt))
    obs = jax.vmap(lambda s, g: propagate_ad(cfg, lam * 1.05, mu, rho, s,
                                             g))(stf, geoms)
    w = jnp.linspace(0.5, 1.5, 8)
    args = (lam, mu, rho, stf, geoms, obs, w)
    ref = jax.jit(jax.value_and_grad(par.make_local_misfit(cfg),
                                     argnums=(0, 1, 2, 3)))(*args)
    return cfg, survey, args, ref


def _loss(cfg, chunk, n_dev):
    if n_dev == 1:
        return par.make_local_misfit(cfg, shot_chunk=chunk)
    return par.make_sharded_misfit(cfg, par.shot_mesh(n_dev),
                                   shot_chunk=chunk)


@pytest.mark.parametrize("n_dev", DEVICES)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_sharded_gradient_matches_unchunked(problem, chunk, n_dev):
    cfg, _, args, (v_ref, g_ref) = problem
    v, g = jax.jit(jax.value_and_grad(_loss(cfg, chunk, n_dev),
                                      argnums=(0, 1, 2, 3)))(*args)
    assert float(v_ref) > 0
    assert np.isclose(float(v), float(v_ref), rtol=1e-12)
    for name, a, b in zip(("lam", "mu", "rho", "stf"), g, g_ref):
        a, b = np.asarray(a), np.asarray(b)
        # the psum and the chunk accumulator sum shots in another order
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-10, name


@pytest.mark.parametrize("n_dev", DEVICES)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_sharded_forward_matches_vmap(problem, chunk, n_dev):
    cfg, survey, (lam, mu, rho, stf, geoms, obs, w), _ = problem
    mesh = None if n_dev == 1 else par.shot_mesh(n_dev)
    fwd = jax.jit(par.make_forward(cfg, survey, mesh=mesh, shot_chunk=chunk,
                                   dtype=lam.dtype))
    got = np.asarray(fwd(lam, mu, rho, stf))
    want = np.asarray(jax.vmap(lambda s, g: st.propagate(
        cfg, lam, mu, rho, s, g))(stf, geoms))
    assert got.shape == want.shape == (8, 4, 12, cfg.nt)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-13 * np.abs(want).max())
