"""Rock-physics forward models: porosity / clay-content / water-saturation
(PCS) -> elastic properties.

JAX re-expression of the reference's two PCS models
(`fwi_utils.py:153-352`, used by the FWI_Rock_Physics_{VRH,gassmann} heads in
`FWI_ops.py:401-619`).  All constants match the reference:

  quartz:      K=37 GPa,  mu=44 GPa, rho=2650 kg/m^3
  clay:        K=21 GPa,  mu=10 GPa, rho=2550
  water:       K=2.25 GPa,           rho=1000
  hydrocarbon: K=0.04 GPa,           rho=100
  consolidation cs = 20 (Gassmann / Dupuy et al. 2016 drained moduli)
"""
from __future__ import annotations

import jax.numpy as jnp

K_QUARTZ = 37.00e9
K_CLAY = 21.00e9
K_WATER = 2.25e9
K_HYDRO = 0.04e9
MU_QUARTZ = 44.00e9
MU_CLAY = 10.00e9
RHO_QUARTZ = 2.65e3
RHO_CLAY = 2.55e3
RHO_WATER = 1.00e3
RHO_HYDRO = 0.10e3
CS_CONSOLIDATION = 20.0


def weighted_average(p1, p2, v1):
    return p1 * v1 + p2 * (1.0 - v1)


def vrh(p1, p2, v1, method: str = "VRH"):
    """Voigt / Reuss / Voigt-Reuss-Hill mixing (fwi_utils.py:225-259)."""
    v2 = 1.0 - v1
    voigt = v1 * p1 + v2 * p2
    reuss = 1.0 / (v1 / p1 + v2 / p2)
    if method == "Voigt":
        return voigt
    if method == "Reuss":
        return reuss
    return 0.5 * (voigt + reuss)


def pcs_to_lame_vrh(phi, cc, sw):
    """VRH-bound PCS model (FWI_ops.py:451-508).  Returns (lam, mu, rho) in
    SI units (the reference divides by 1e6 for its CUDA MEGA convention;
    this engine runs in SI)."""
    kv = ((1 - phi) * (K_CLAY * cc + K_QUARTZ * (1 - cc))
          + phi * (K_WATER * sw + K_HYDRO * (1 - sw)))
    kr = 1.0 / ((1 - phi) * (cc / K_CLAY + (1 - cc) / K_QUARTZ)
                + phi * (sw / K_WATER + (1 - sw) / K_HYDRO))
    k = 0.5 * (kv + kr)
    mu = 0.5 * ((1 - phi) * (MU_CLAY * cc + MU_QUARTZ * (1 - cc)))  # Reuss mu = 0
    rho_f = weighted_average(RHO_WATER, RHO_HYDRO, sw)
    rho_s = weighted_average(RHO_CLAY, RHO_QUARTZ, cc)
    rho = weighted_average(rho_f, rho_s, phi)
    lam = k - 2.0 / 3.0 * mu
    return lam, mu, rho


def drained_moduli(phi, k_s, g_s, cs=CS_CONSOLIDATION):
    """Dupuy et al. (2016) effective drained moduli (fwi_utils.py:278-314)."""
    k_d = k_s * ((1 - phi) / (1 + cs * phi))
    g_d = g_s * ((1 - phi) / (1 + 1.5 * cs * phi))
    return k_d, g_d


def biot_gassmann_ku(phi, k_f, k_s, k_d):
    """Undrained bulk modulus via Biot-Gassmann (fwi_utils.py:261-275)."""
    delta = ((1 - phi) / phi) * (k_f / k_s) * (1 - k_d / (k_s - k_s * phi))
    denom = phi * (1 + delta)
    return (phi * k_d + (1 - (1 + phi) * (k_d / k_s)) * k_f) / denom


def pcs_to_lame_gassmann(phi, cc, sw, method: str = "Voigt"):
    """Gassmann fluid-substitution PCS model (FWI_ops.py:567-619; note the
    reference uses vp^2 = (k_u + 0.75 mu_d)/rho, i.e. a 3/4 rather than 4/3
    coefficient — reproduced as-is for parity).  Returns (lam, mu, rho)."""
    rho_f = weighted_average(RHO_WATER, RHO_HYDRO, sw)
    k_f = weighted_average(K_WATER, K_HYDRO, sw)
    k_s = vrh(K_CLAY, K_QUARTZ, cc, method)
    mu_s = vrh(MU_CLAY, MU_QUARTZ, cc, method)
    rho_s = weighted_average(RHO_CLAY, RHO_QUARTZ, cc)

    k_d, mu_d = drained_moduli(phi, k_s, mu_s)
    k_u = biot_gassmann_ku(phi, k_f, k_s, k_d)
    rho = weighted_average(rho_f, rho_s, phi)
    vp = jnp.sqrt((k_u + 0.75 * mu_d) / rho)
    vs = jnp.sqrt(mu_d / rho)
    lam = rho * (vp ** 2 - 2.0 * vs ** 2)
    mu = rho * vs ** 2
    return lam, mu, rho
