"""High-level object API mirroring the reference's newer facade
(`Ops/FWI/propagator.py` ElasticPropagator + `Ops/FWI/survey.py` Model/Survey
dataclasses): construct from physical-grid models + index-based acquisition,
call `apply_forward` / `apply_gradient`.

Unlike the reference (which round-trips through para/survey JSON files and a
CUDA extension), everything here is in-process and jit-compiled; gradients
come back in (vp, vs, rho) space via the chain rule the reference hand-codes
(`propagator.py:210-216` -> imaging.lame_grads_to_velocity).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

import sep2023_tpu as st
from sep2023_tpu import parallel
from sep2023_tpu.config import SimConfig, Survey, ricker


@dataclasses.dataclass
class Model:
    """Physical-grid model container (`survey.py:3-22` of the reference)."""

    nx: int
    nz: int
    dx: float
    dz: float
    nt: int
    dt: float
    nPml: int
    vp: np.ndarray
    vs: np.ndarray
    rho: np.ndarray
    exp_name: str = ""


class ElasticPropagator:
    """Forward modeling + adjoint gradients for one (model, survey) pair."""

    def __init__(self, model: Model, survey: Survey, f0: float = 10.0,
                 dtype=jnp.float32):
        self.model = model
        self.survey = survey
        self.dtype = dtype
        self.cfg = SimConfig(nz=model.nz + 2 * model.nPml,
                             nx=model.nx + 2 * model.nPml,
                             dz=model.dz, dx=model.dx, nt=model.nt,
                             dt=model.dt, f0=f0, npml=model.nPml)
        self.geoms = parallel.survey_to_geoms(survey, model.nPml, dtype=dtype)
        stf = ricker(f0, model.nt, model.dt)
        self.stf = jnp.broadcast_to(jnp.asarray(stf, dtype),
                                    (survey.n_shots, model.nt))
        # jitted once per propagator instance (re-jitting per call would
        # retrace every apply_forward/apply_gradient invocation)
        self._fwd = jax.jit(lambda l, u, r, s, g: jax.vmap(
            lambda si, gi: st.propagate(self.cfg, l, u, r, si, gi))(s, g))
        self._vg = None

    def _padded(self, vp, vs, rho):
        # differentiable replicate-pad (gradient flows back to the physical
        # grid; edge cells also collect the PML-collar contributions, like
        # the reference's crop in propagator.py:198)
        from sep2023_tpu.medium import pad_model
        vp = jnp.asarray(vp, self.dtype)
        vs = jnp.asarray(vs, self.dtype)
        rho = jnp.asarray(rho, self.dtype)
        lam = (vp ** 2 - 2.0 * vs ** 2) * rho
        mu = vs ** 2 * rho
        return (pad_model(lam, self.model.nPml),
                pad_model(mu, self.model.nPml),
                pad_model(rho, self.model.nPml))

    def apply_forward(self, vp=None, vs=None, rho=None) -> np.ndarray:
        """Synthetic seismograms (n_shots, 4, n_rec, nt) for the model (or an
        override), channels (pr, vx, vz, ett)."""
        m = self.model
        lam, mu, rr = self._padded(vp if vp is not None else m.vp,
                                   vs if vs is not None else m.vs,
                                   rho if rho is not None else m.rho)
        return np.asarray(self._fwd(lam, mu, rr, self.stf, self.geoms))

    def apply_gradient(self, model_init: Model, obs: np.ndarray,
                       channels: Sequence[str] = ("ett",),
                       n_devices: int = 0):
        """Misfit + gradients w.r.t. (vp, vs, rho) of `model_init` against
        observed data, plus the per-shot source-wavelet gradient — the
        outputs of the reference's apply_gradient (`propagator.py:141-218`).

        n_devices: shot-shard over a device mesh (0 = all visible devices,
        the reference's ngpu argument `propagator.py:141`); shots are padded
        with zero-weight replicas when the count is ragged.

        Returns dict(misfit, grad_vp, grad_vs, grad_rho, grad_stf); gradients
        are on the PHYSICAL grid (PML collar cropped, `propagator.py:198`).
        """
        m = self.model
        obs = jnp.asarray(obs, self.dtype)
        w = jnp.ones((self.survey.n_shots,), self.dtype)
        stf, geoms = self.stf, self.geoms

        n_dev = min(n_devices or jax.device_count(), jax.device_count(),
                    self.survey.n_shots)
        if n_dev > 1:
            mesh = parallel.shot_mesh(n_dev)
            stf, geoms, obs, w, _ = parallel.pad_shots(stf, geoms, obs, w,
                                                       n_dev)
            loss = parallel.make_sharded_misfit(self.cfg, mesh,
                                                channels=tuple(channels))
        else:
            loss = parallel.make_local_misfit(self.cfg,
                                              channels=tuple(channels))

        vp0 = jnp.asarray(model_init.vp, self.dtype)
        vs0 = jnp.asarray(model_init.vs, self.dtype)
        rho0 = jnp.asarray(model_init.rho, self.dtype)

        # observed data is an argument, not a closure: a closed-over device
        # array would be compiled into the program as a constant
        def f(vp, vs, rho, stf_, obs_):
            lam, mu, rr = self._padded(vp, vs, rho)
            return loss(lam, mu, rr, stf_, geoms, obs_, w)

        val, grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(
            vp0, vs0, rho0, stf, obs)
        g_vp, g_vs, g_rho, g_stf = grads
        return {
            "misfit": float(val),
            "grad_vp": np.asarray(g_vp),
            "grad_vs": np.asarray(g_vs),
            "grad_rho": np.asarray(g_rho),
            "grad_stf": np.asarray(g_stf)[:self.survey.n_shots],
        }
