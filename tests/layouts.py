"""Acquisition layouts shared by the engine-equality matrices
(test_engine_equality.py, test_acoustic_equality.py): two shots on a small
heterogeneous float64 model, one per receiver geometry users record with.

Each layout gives padded-grid receiver indices per shot (ragged spreads are
padded by repeating the last receiver, with a zero live weight), the
elastic DAS channel, the per-shot source moment ratio and, for per-trace
conditioned layouts, (win_start, win_end, trace_weight) arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import sep2023_tpu as st
from sep2023_tpu import das

NPML = 8
SRC_X = (10, 30)          # physical columns of the two surface shots
LAYOUTS = ("row", "multirow_fiber", "curved_weighted", "borehole_exx",
           "borehole_ezz", "ragged", "src_rxz", "per_trace_windows")
# the acoustic engine records pressure and particle velocity only, so the
# layouts that differ by DAS channel or source moment collapse
AC_LAYOUTS = ("row", "multirow_fiber", "curved_weighted", "borehole_exx",
              "ragged", "per_trace_windows")


@dataclasses.dataclass
class Layout:
    cfg: st.SimConfig
    rec_z: np.ndarray        # (S, R) padded-grid indices
    rec_x: np.ndarray
    rxz: np.ndarray          # (S,)
    das_w: np.ndarray | None  # (S, R, 3)
    aux: tuple               # () or (win_start, win_end, trace_weight)

    @property
    def per_trace(self):
        return bool(self.aux)


def _cfg(das_channel="exx"):
    return st.SimConfig(nz=36 + 2 * NPML, nx=44 + 2 * NPML, dz=10.0,
                        dx=10.0, nt=100, dt=0.001, f0=20.0, npml=NPML,
                        das_channel=das_channel)


def build(name: str) -> Layout:
    S = len(SRC_X)
    row_x = np.arange(6, 38)
    col_z = np.arange(6, 30)
    das_channel, rxz, das_w, aux = "exx", np.ones(S), None, ()
    if name in ("row", "src_rxz", "per_trace_windows"):
        rz, rx = np.full(row_x.size, 20), row_x
    elif name == "multirow_fiber":
        rz, rx = 18 + row_x % 4, row_x
    elif name == "curved_weighted":
        cp = np.array([[140.0, 180.0, 0.0], [220.0, 150.0, 0.0],
                       [300.0, 200.0, 0.0], [380.0, 170.0, 0.0]])
        rz, rx, w = das.cable_to_receivers(das.spline_fiber(cp), 10.0, 10.0)
        das_channel = "weighted"
        das_w = np.broadcast_to(w, (S, *w.shape))
    elif name in ("borehole_exx", "borehole_ezz"):
        rz, rx = col_z, np.full(col_z.size, 28)
        das_channel = name.split("_")[1]
    elif name == "ragged":
        n0 = 20
        rz = np.stack([np.full(row_x.size, 20), np.full(row_x.size, 22)])
        rx = np.stack([np.concatenate([row_x[:n0],
                                       np.full(row_x.size - n0, row_x[n0 - 1])]),
                       row_x])
        live = np.ones((S, row_x.size))
        live[0, n0:] = 0.0
        aux = (np.zeros((S, row_x.size)),
               np.full((S, row_x.size), 99.0), live)
    else:
        raise ValueError(name)
    if name == "src_rxz":
        rxz = np.array([0.4, 2.5])
    if name == "per_trace_windows":
        R = row_x.size
        rng = np.random.default_rng(1)
        aux = (rng.uniform(0, 20, (S, R)), rng.uniform(50, 99, (S, R)),
               rng.uniform(0.5, 2.0, (S, R)))
    rz = np.broadcast_to(np.asarray(rz) + NPML, (S, np.shape(rz)[-1]))
    rx = np.broadcast_to(np.asarray(rx) + NPML, (S, np.shape(rx)[-1]))
    return Layout(_cfg(das_channel), rz, rx, rxz, das_w, aux)


def model(cfg, seed=0):
    """Heterogeneous (vp, vs, rho) medium on the padded grid."""
    key = jax.random.PRNGKey(seed)
    vp = 3000.0 + 100.0 * jax.random.normal(key, cfg.grid.shape)
    return st.Medium(vp, vp / jnp.sqrt(3.0), jnp.full(cfg.grid.shape, 2400.0))


def stf(cfg):
    # early-onset wavelet so the short record carries energy everywhere
    return jnp.broadcast_to(
        jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt, delay_cycles=0.6)),
        (len(SRC_X), cfg.nt))


def src_zx():
    return (jnp.full((len(SRC_X),), 2 + NPML, jnp.int32),
            jnp.asarray(np.asarray(SRC_X) + NPML, jnp.int32))
