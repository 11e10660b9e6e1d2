"""Per-shot ragged receiver spreads (Src_Rec.cu:87-116: nrec / z_rec / x_rec
parsed per shot): survey JSON round trip, loss equality against per-shot
single runs, plain-AD gradients and the sharded path."""
import json

import jax
import jax.numpy as jnp
import numpy as np

import sep2023_tpu as st
from sep2023_tpu import io as sio
from sep2023_tpu import parallel
from sep2023_tpu.config import Survey
from sep2023_tpu.ops import misfit as mf
from sep2023_tpu.propagator import propagate_ad


def _ragged_survey():
    return Survey(
        src_z=np.array([2, 2]), src_x=np.array([14, 40]),
        rec_z=np.array([[30] * 12 + [30] * 4, [32] * 16]),
        rec_x=np.array([list(range(14, 26)) + [25] * 4,
                        list(range(18, 34))]),
        rec_live=np.array([[1.0] * 12 + [0.0] * 4, [1.0] * 16]))


def test_survey_json_ragged_round_trip(tmp_path):
    """A survey file with heterogeneous spreads must load per shot — not
    silently adopt shot 0's spread — and round-trip."""
    fn = tmp_path / "survey.json"
    d = {"nShots": 2,
         "shot0": {"z_src": 2, "x_src": 14, "nrec": 3,
                   "z_rec": [30, 30, 30], "x_rec": [10, 11, 12],
                   "weights": [1.0, 2.0, 3.0]},
         "shot1": {"z_src": 2, "x_src": 40, "nrec": 5,
                   "z_rec": [32, 32, 32, 32, 32],
                   "x_rec": [20, 21, 22, 23, 24],
                   "weights": [1.0, 1.0, 1.0, 1.0, 1.0]}}
    fn.write_text(json.dumps(d))
    s = Survey.from_json(str(fn))
    assert s.ragged and s.n_rec == 5
    np.testing.assert_array_equal(s.rec_x[1], [20, 21, 22, 23, 24])
    # shot 0 padded by replicating its last receiver, live mask 0 there
    np.testing.assert_array_equal(s.rec_x[0], [10, 11, 12, 12, 12])
    np.testing.assert_array_equal(s.rec_live, [[1, 1, 1, 0, 0],
                                               [1, 1, 1, 1, 1]])
    # the live mask folds into the trace weights
    w = s.live_trace_weights()
    np.testing.assert_allclose(w[0], [1.0, 2.0, 3.0, 0.0, 0.0])
    # round trip strips the padding again
    out = tmp_path / "rt.json"
    s.to_json(str(out))
    d2 = json.loads(out.read_text())
    assert d2["shot0"]["nrec"] == 3 and d2["shot1"]["nrec"] == 5
    assert d2["shot0"]["x_rec"] == [10, 11, 12]

    # identical spreads still collapse to the shared layout
    d["shot1"] = dict(d["shot0"], x_src=40)
    fn.write_text(json.dumps(d))
    s2 = Survey.from_json(str(fn))
    assert not s2.ragged and s2.rec_z.ndim == 1


def _mini_problem():
    npml = 10
    cfg = st.SimConfig(nz=40 + 2 * npml, nx=56 + 2 * npml, dz=20.0, dx=20.0,
                       nt=100, dt=0.002, f0=10.0, npml=npml)
    vp = jnp.full(cfg.grid.shape, 3000.0).at[26:32, 30:44].add(220.0)
    med = st.Medium(vp, vp / jnp.sqrt(3.0), jnp.full(cfg.grid.shape, 2500.0))
    lam, mu, rho = med.lam, med.mu, med.rho
    stf = jnp.broadcast_to(jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt)),
                           (2, cfg.nt))
    return cfg, lam, mu, rho, stf


def _per_shot_reference(cfg, lam, mu, rho, stf, survey, obs_full,
                        propagate=st.propagate):
    """Sum of single-shot losses, each with its OWN (unpadded) spread and
    the same per-trace-conditioned misfit the ragged loss uses."""
    fn = mf.make_preprocessed_l2(channels=("ett",), dt=cfg.dt,
                                 per_trace=True)
    total = 0.0
    for i in range(survey.n_shots):
        rz, rx, n = survey.shot_rec(i)
        geom = st.ShotGeom(
            src_z=jnp.asarray(survey.src_z[i] + cfg.npml, jnp.int32),
            src_x=jnp.asarray(survey.src_x[i] + cfg.npml, jnp.int32),
            rxz=jnp.asarray(survey.src_rxz[i], jnp.float32),
            rec_z=jnp.asarray(rz + cfg.npml, jnp.int32),
            rec_x=jnp.asarray(rx + cfg.npml, jnp.int32))
        syn = propagate(cfg, lam, mu, rho, stf[i], geom)
        total = total + fn(obs_full[i, :, :n], syn,
                           jnp.zeros((n,), jnp.float32),
                           jnp.full((n,), cfg.nt - 1.0, jnp.float32),
                           jnp.ones((n,), jnp.float32))
    return total


def test_ragged_loss_matches_per_shot_runs():
    """XLA ragged loss (padded geoms + live-mask trace weights) equals the
    sum of per-shot single runs with each shot's true spread."""
    cfg, lam, mu, rho, stf = _mini_problem()
    survey = _ragged_survey()
    geoms = parallel.survey_to_geoms(survey, cfg.npml, dtype=jnp.float32)
    fwd = jax.jit(lambda l: jax.vmap(
        lambda s, g: st.propagate(cfg, l, mu, rho, s, g))(stf, geoms))
    obs = fwd(lam * 1.02)

    tw = jnp.asarray(survey.live_trace_weights(), jnp.float32)
    ws = jnp.zeros(tw.shape, jnp.float32)
    we = jnp.full(tw.shape, cfg.nt - 1.0, jnp.float32)
    fn = mf.make_preprocessed_l2(channels=("ett",), dt=cfg.dt,
                                 per_trace=True)
    loss = parallel.make_local_misfit(cfg, misfit_fn=fn)
    w = jnp.ones((2,), jnp.float32)
    got = float(loss(lam, mu, rho, stf, geoms, obs, w, ws, we, tw))

    # reference: per-shot single runs with the true (unpadded) spreads; the
    # ragged obs padding replicates each shot's last receiver, so slicing
    # [:n] recovers each shot's true observed data
    want = float(_per_shot_reference(cfg, lam, mu, rho, stf, survey, obs))
    assert abs(got - want) / abs(want) < 1e-4


def _ragged_case():
    cfg, lam, mu, rho, stf = _mini_problem()
    survey = _ragged_survey()
    geoms = parallel.survey_to_geoms(survey, cfg.npml, dtype=lam.dtype)
    obs = jax.jit(jax.vmap(lambda s, g: st.propagate(
        cfg, lam * 1.02, mu, rho, s, g)))(stf, geoms)
    tw = jnp.asarray(survey.live_trace_weights(), lam.dtype)
    aux = (jnp.zeros(tw.shape, lam.dtype),
           jnp.full(tw.shape, cfg.nt - 1.0, lam.dtype), tw)
    fn = mf.make_preprocessed_l2(channels=("ett",), dt=cfg.dt,
                                 per_trace=True)
    w = jnp.ones((2,), lam.dtype)
    return cfg, lam, mu, rho, stf, survey, geoms, obs, aux, fn, w


def test_ragged_pallas_union_matches_xla():
    """The ragged loss (padded spreads, live mask folded into the trace
    weights): value AND lam-gradient through the boundary-saving adjoint
    match per-shot runs of the plain-AD reference on each shot's own
    spread."""
    cfg, lam, mu, rho, stf, survey, geoms, obs, aux, fn, w = _ragged_case()
    loss_x = parallel.make_local_misfit(cfg, misfit_fn=fn)
    vx, gx = jax.value_and_grad(
        lambda l: loss_x(l, mu, rho, stf, geoms, obs, w, *aux))(lam)
    va, ga = jax.value_and_grad(lambda l: _per_shot_reference(
        cfg, l, mu, rho, stf, survey, obs, propagate=propagate_ad))(lam)
    assert abs(float(vx) - float(va)) / abs(float(va)) < 1e-10
    sl = cfg.grid.interior_slices()
    gx, ga = np.asarray(gx)[sl], np.asarray(ga)[sl]
    assert np.abs(gx - ga).max() / np.abs(ga).max() < 1e-8


def test_ragged_shot_io_round_trip(tmp_path):
    """write/read_shots_survey: per-shot files hold nrec_i traces; reading
    pads back by replicating the last trace."""
    survey = _ragged_survey()
    rng = np.random.default_rng(0)
    data = rng.normal(size=(2, 4, survey.n_rec, 30)).astype(np.float32)
    sio.write_shots_survey(str(tmp_path), data, survey)
    # shot 0's files hold only its 12 live traces
    raw = np.fromfile(tmp_path / "Shot_pr0.bin", np.float32)
    assert raw.size == 12 * 30
    back = sio.read_shots_survey(str(tmp_path), survey, 30)
    np.testing.assert_allclose(back[0, :, :12], data[0, :, :12])
    np.testing.assert_allclose(back[1], data[1])
    # padding replicates the last live trace
    np.testing.assert_allclose(back[0, :, 12:],
                               np.broadcast_to(back[0, :, 11:12],
                                               (4, 4, 30)))


def test_ragged_pallas_sharded_matches_local():
    """The ragged loss under shard_map (the multi-device production path)
    equals the local ragged loss, value and model gradients."""
    cfg, lam, mu, rho, stf, survey, geoms, obs, aux, fn, w = _ragged_case()
    loss_l = parallel.make_local_misfit(cfg, misfit_fn=fn)
    loss_s = parallel.make_sharded_misfit(cfg, parallel.shot_mesh(2),
                                          misfit_fn=fn, n_trace_aux=3)
    args = (lam, mu, rho, stf, geoms, obs, w, *aux)
    vl, gl = jax.value_and_grad(loss_l, argnums=(0, 1, 2))(*args)
    vs, gs = jax.jit(jax.value_and_grad(loss_s, argnums=(0, 1, 2)))(*args)
    assert abs(float(vl) - float(vs)) / abs(float(vl)) < 1e-12
    for a, b in zip(gs, gl):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-10
