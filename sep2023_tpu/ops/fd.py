"""O(4) staggered-grid finite-difference operators on (nz, nx) fields.

The four shifted first-derivative stencils of the velocity-stress scheme
(c1 = 9/8, c2 = 1/24; see `elasticSolver.py:310-386` and
`el_stress.cu:54-71` / `el_velocity.cu:49-65`):

  dminus_*(f)[i] = c1 (f[i]   - f[i-1]) - c2 (f[i+1] - f[i-2])
  dplus_*(f)[i]  = c1 (f[i+1] - f[i]  ) - c2 (f[i+2] - f[i-1])

Implemented as zero-padded slice arithmetic: XLA fuses these into the
surrounding elementwise update, so each time step compiles to a handful
of fused elementwise loops over the (nz, nx) planes — XLA's counterpart of
the reference's hand-written CUDA stencil kernels.  The 2-cell halo
rows/cols produce garbage values that callers mask out (the reference
equivalently restricts updates to gidz/gidx in [2, n-3]).

Division by the grid spacing happens at the call site.
"""
from __future__ import annotations

import jax.numpy as jnp

from sep2023_tpu.config import C1, C2


def _padz(f):
    return jnp.pad(f, ((2, 2), (0, 0)))


def _padx(f):
    return jnp.pad(f, ((0, 0), (2, 2)))


def dz_minus(f):
    p = _padz(f)
    return C1 * (p[2:-2, :] - p[1:-3, :]) - C2 * (p[3:-1, :] - p[:-4, :])


def dz_plus(f):
    p = _padz(f)
    return C1 * (p[3:-1, :] - p[2:-2, :]) - C2 * (p[4:, :] - p[1:-3, :])


def dx_minus(f):
    p = _padx(f)
    return C1 * (p[:, 2:-2] - p[:, 1:-3]) - C2 * (p[:, 3:-1] - p[:, :-4])


def dx_plus(f):
    p = _padx(f)
    return C1 * (p[:, 3:-1] - p[:, 2:-2]) - C2 * (p[:, 4:] - p[:, 1:-3])


def update_mask(nz: int, nx: int, lo_z: int, hi_z: int, lo_x: int, hi_x: int,
                dtype=jnp.float32):
    """A separable 0/1 mask (as a (nz,1) x (1,nx) broadcast pair) selecting
    rows [lo_z, hi_z] and cols [lo_x, hi_x] inclusive."""
    mz = ((jnp.arange(nz) >= lo_z) & (jnp.arange(nz) <= hi_z)).astype(dtype)
    mx = ((jnp.arange(nx) >= lo_x) & (jnp.arange(nx) <= hi_x)).astype(dtype)
    return mz.reshape(-1, 1), mx.reshape(1, -1)
