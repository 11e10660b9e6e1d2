"""Elastic medium containers and staggered-grid material averaging.

Re-expresses (vectorized) what the reference does in:
  - `Model.cu:85-87` + `utilities.cu:109-152` (velInit / aveMuInit / aveBycInit)
  - `fwi_utils.py:11-44` (model padding)
All material fields live on the PADDED (nz, nx) grid; z is axis 0, x is
axis 1 (contiguous).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MatFields(NamedTuple):
    """Precomputed per-cell material fields consumed by the time step.

    lam     : lambda at integer points               (sxx/szz node)
    lp2m    : lambda + 2 mu at integer points
    ave_mu  : harmonic 4-point average of mu         (sxz node, elasticSolver.py:365-368)
    byc_a   : 2 / (rho[z+1,x] + rho[z,x])            (vz node buoyancy, utilities.cu:147)
    byc_b   : 2 / (rho[z,x+1] + rho[z,x])            (vx node buoyancy, utilities.cu:148)
    """

    lam: jax.Array
    lp2m: jax.Array
    ave_mu: jax.Array
    byc_a: jax.Array
    byc_b: jax.Array


def _shift_up(a):  # a[z+1, x] with edge replicate
    return jnp.concatenate([a[1:, :], a[-1:, :]], axis=0)


def _shift_left(a):  # a[z, x+1] with edge replicate
    return jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)


def material_fields(lam, mu, rho) -> MatFields:
    """Differentiable map (lam, mu, rho) -> staggered fields.

    AD through this function reproduces the reference's hand-written
    "gradient spray" chain rules for the harmonic mu average
    (`el_stress.cu:112-123`) and the arithmetic buoyancy average
    (`el_velocity.cu:100-110`) exactly.
    """
    mu_b = _shift_up(mu)        # mu[z+1, x]
    mu_c = _shift_left(mu)      # mu[z, x+1]
    mu_d = _shift_left(mu_b)    # mu[z+1, x+1]
    nonzero = (mu != 0) & (mu_b != 0) & (mu_c != 0) & (mu_d != 0)
    safe = jnp.where(nonzero, mu, 1.0)
    safe_b = jnp.where(nonzero, mu_b, 1.0)
    safe_c = jnp.where(nonzero, mu_c, 1.0)
    safe_d = jnp.where(nonzero, mu_d, 1.0)
    hm = 4.0 / (1.0 / safe + 1.0 / safe_b + 1.0 / safe_c + 1.0 / safe_d)
    ave_mu = jnp.where(nonzero, hm, 0.0)

    byc_a = 2.0 / (_shift_up(rho) + rho)
    byc_b = 2.0 / (_shift_left(rho) + rho)
    return MatFields(lam=lam, lp2m=lam + 2.0 * mu, ave_mu=ave_mu,
                     byc_a=byc_a, byc_b=byc_b)


class Medium(NamedTuple):
    """Velocity-density parameterization on the padded grid."""

    vp: jax.Array
    vs: jax.Array
    rho: jax.Array

    @property
    def lam(self):
        return (self.vp ** 2 - 2.0 * self.vs ** 2) * self.rho

    @property
    def mu(self):
        return self.vs ** 2 * self.rho

    def to_lame(self):
        return self.lam, self.mu, self.rho

    @staticmethod
    def from_lame(lam, mu, rho) -> "Medium":
        vp = jnp.sqrt((lam + 2.0 * mu) / rho)
        vs = jnp.sqrt(mu / rho)
        return Medium(vp=vp, vs=vs, rho=rho)


def check_lambda(lam) -> float:
    """Warn when the first Lamé parameter goes negative anywhere
    (vp² < 2·vs², i.e. negative Poisson ratio past the physical bound):
    the simulation stays defined but it almost always means a bad model or
    head output.  The reference prints the same warning when building its
    device model (`Model.cu:37-40`).  Call with CONCRETE arrays (drivers
    check the true/initial models host-side; a traced check would need
    checkify).  Returns min(lam) for convenience."""
    import warnings

    lam_min = float(jnp.min(lam))
    if lam_min < 0:
        warnings.warn(
            f"negative Lame lambda (min {lam_min:.3e}): vp^2 < 2*vs^2 "
            "somewhere in the model (Model.cu:37-40 prints the same "
            "warning)", RuntimeWarning, stacklevel=2)
    return lam_min


def pad_model(arr, npml: int):
    """Replicate-pad a physical model by the PML collar on all 4 sides
    (nPad-free analogue of `fwi_utils.py:11-27`)."""
    return jnp.pad(arr, ((npml, npml), (npml, npml)), mode="edge")


def resize_and_pad(arr, nz_phys: int, nx_phys: int, npml: int):
    """Bilinear-resize a coarse model to the physical grid then replicate-pad
    (the differentiable path of `fwi_utils.py:31-44`; torch's
    align_corners=False bilinear == jax.image half-pixel 'linear')."""
    r = jax.image.resize(arr, (nz_phys, nx_phys), method="linear")
    return pad_model(r, npml)


def pad_model_np(arr: np.ndarray, npml: int) -> np.ndarray:
    return np.pad(arr, ((npml, npml), (npml, npml)), mode="edge")
