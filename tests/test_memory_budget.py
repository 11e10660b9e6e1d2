"""parallel.strip_bytes_per_shot against the residuals the XLA engines
really save for their boundary-saving backward (read off the custom_vjp
forward rule with jax.eval_shape, no compute), at the shapes the CLI and
the examples run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sep2023_tpu as st
from sep2023_tpu import acoustic, parallel, propagator

SHAPES = {  # (nz, nx, nt, dz, dt, npml): padded grids
    "tiny": (44, 52, 60, 20.0, 0.002, 8),
    "reference": (165, 265, 1501, 20.0, 0.002, 32),
    "rock": (265, 385, 4001, 10.0, 0.001, 32),
    "marmousi": (814, 2064, 2001, 10.0, 0.001, 32),
}
CASES = [("reference", False, jnp.float32), ("reference", False, jnp.float64),
         ("rock", False, jnp.float32), ("marmousi", False, jnp.float32),
         ("tiny", True, jnp.float64), ("reference", True, jnp.float32),
         ("marmousi", True, jnp.float32)]


def _saved_strip_bytes(cfg, is_acoustic, dtype):
    plane = jax.ShapeDtypeStruct(cfg.grid.shape, dtype)
    stf = jax.ShapeDtypeStruct((cfg.nt,), dtype)
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    if is_acoustic:
        geom = st.AcGeom(i32(), i32(), i32(7), i32(7))
        _, res = jax.eval_shape(
            lambda l, r, s, g: acoustic._fwd(cfg, l, r, s, g),
            plane, plane, stf, geom)
    else:
        geom = st.ShotGeom(i32(), i32(), jax.ShapeDtypeStruct((), dtype),
                           i32(7), i32(7))
        _, res = jax.eval_shape(
            lambda l, m, r, s, g: propagator._propagate_fwd(cfg, l, m, r, s,
                                                            g),
            plane, plane, plane, stf, geom)
    bnds = res[-1]  # the boundary record is the last residual of both rules
    return sum(a.size * np.dtype(a.dtype).itemsize
               for a in jax.tree.leaves(bnds))


@pytest.mark.parametrize("shape,is_acoustic,dtype", CASES,
                         ids=[f"{s}-{'ac' if a else 'el'}-"
                              f"{np.dtype(d).name}" for s, a, d in CASES])
def test_strip_bytes_match_saved_residuals(shape, is_acoustic, dtype):
    nz, nx, nt, dh, dt, npml = SHAPES[shape]
    cfg = st.SimConfig(nz=nz, nx=nx, dz=dh, dx=dh, nt=nt, dt=dt, f0=10.0,
                       npml=npml)
    itemsize = np.dtype(dtype).itemsize
    with jax.enable_x64(dtype == jnp.float64):
        saved = _saved_strip_bytes(cfg, is_acoustic, dtype)
    assert saved == parallel.strip_bytes_per_shot(
        cfg, acoustic=is_acoustic, itemsize=itemsize)
