"""Overthrust-style spline-fiber DAS FWI demo.

Mirrors the reference's second fiber-geometry flow
(`DAS_Waveform_Modeling/matlab/DAS_Geometry_Overthrust.m:28-50`): a cable
laid as a spline through control points draped over a structured
(overthrust) model, resampled to equal arc length, with Frenet-tangent
directional sensitivity weights — then inverted end-to-end with the
directional 'weighted' strain channel.

Run:  python examples/overthrust_das.py [outdir]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import sep2023_tpu as st
from sep2023_tpu import das, models, optimize, parallel


def main(outdir="scratch/overthrust_das", n_iters=10, nt=501, src_step=10):
    """Defaults are the demo run; smaller nt/n_iters/denser src_step let
    the suite smoke-test the script on CPU.
    Returns the metrics dict it prints."""
    os.makedirs(outdir, exist_ok=True)
    n_iters, nt, src_step = int(n_iters), int(nt), int(src_step)
    npml = 16
    nz, nx, dh = 60, 100, 10.0
    cfg = st.SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=dh, dx=dh,
                       nt=nt, dt=0.001, f0=15.0, npml=npml,
                       das_channel="weighted")

    # --- model: folded + thrusted layers (DAS_Geometry_Overthrust.m's
    # target structure, synthesized since the reference git-ignores its
    # Models/ grids) -----------------------------------------------------
    vp_true = models.overthrust_vp(nz, nx)
    vp_init = models.smooth(vp_true, 10.0)
    pad = lambda m: jnp.asarray(st.medium.pad_model_np(m, npml), jnp.float32)
    rho = pad(models.constant(nz, nx, 2300.0))
    cfg.check_stability(float(vp_true.max()))

    # --- cable: spline through control points over the structure ---------
    cp = np.array([[150.0, 420.0, 0.0], [350.0, 330.0, 0.0],
                   [550.0, 430.0, 0.0], [750.0, 360.0, 0.0],
                   [900.0, 420.0, 0.0]])
    cable = das.spline_fiber(cp)
    rec_z, rec_x, das_w = das.cable_to_receivers(cable, cfg.dx, cfg.dz)
    print(f"cable: {len(rec_z)} channels, depth rows "
          f"{rec_z.min()}..{rec_z.max()}")

    src_x = np.arange(10, nx - 10, src_step)
    S = len(src_x)
    stf = jnp.broadcast_to(
        jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt), jnp.float32),
        (S, cfg.nt))
    bcast = lambda a, dt: jnp.broadcast_to(jnp.asarray(a, dt),
                                           (S, *np.shape(a)))
    geoms = st.ShotGeom(
        src_z=jnp.full((S,), 1 + npml, jnp.int32),
        src_x=jnp.asarray(src_x + npml, jnp.int32),
        rxz=jnp.ones((S,), jnp.float32),
        rec_z=bcast(rec_z + npml, jnp.int32),
        rec_x=bcast(rec_x + npml, jnp.int32),
        das_w=bcast(das_w, jnp.float32))
    w = jnp.ones((S,), jnp.float32)
    data_loss = parallel.make_local_misfit(cfg, channels=("ett",))

    def to_lame(vp_pad):
        vs_pad = vp_pad / jnp.sqrt(3.0)
        return (vp_pad ** 2 - 2 * vs_pad ** 2) * rho, vs_pad ** 2 * rho

    print("generating observed DAS data (true model) ...")
    lam_t, mu_t = to_lame(pad(vp_true))
    obs = jax.jit(jax.vmap(lambda s, g: st.propagate(
        cfg, lam_t, mu_t, rho, s, g)))(stf, geoms)

    # observed data + wavelets threaded as aux arguments (NOT closures:
    # closed-over device arrays become compiled-in constants)
    def loss(params, stf_, obs_):
        vp_pad = jnp.pad(jnp.asarray(params["vp"], jnp.float32), npml,
                         mode="edge")
        lam, mu = to_lame(vp_pad)
        return data_loss(lam, mu, rho, stf_, geoms, obs_, w)

    print("inverting vp from the DAS 'ett' channel ...")
    obj = optimize.ScipyObjective(loss, {"vp": vp_init}, aux=(stf, obs))
    f0 = obj.fun(obj.x0)   # cached — minimize's first evaluation reuses it
    res = optimize.lbfgsb(obj, maxiter=n_iters)
    vp_out = np.asarray(obj.unpack(res.x)["vp"])
    np.savez(os.path.join(outdir, "overthrust_das.npz"),
             vp_true=vp_true, vp_init=vp_init, vp_out=vp_out,
             rec_z=rec_z, rec_x=rec_x, das_w=das_w, cable=cable)
    # report recovery where the transmission geometry illuminates: between
    # the surface sources and the fiber depth, inside the source spread
    zone = (slice(2, int(rec_z.max()) + 2), slice(10, nx - 10))
    zerr0 = float(np.abs(vp_init - vp_true)[zone].mean())
    zerr1 = float(np.abs(vp_out - vp_true)[zone].mean())
    err0 = float(np.abs(vp_init - vp_true).mean())
    err1 = float(np.abs(vp_out - vp_true).mean())
    metrics = {"misfit0": float(f0), "misfit1": float(res.fun),
               "nit": int(res.nit), "zone_err0": zerr0, "zone_err1": zerr1,
               "err0_all": err0, "err1_all": err1}
    print(f"misfit {f0:.4e} -> {res.fun:.4e} after {res.nit} iterations; "
          f"illuminated-zone mean |vp err| {zerr0:.1f} -> {zerr1:.1f} m/s "
          f"(whole model {err0:.1f} -> {err1:.1f})")
    print(f"wrote {outdir}/overthrust_das.npz")
    return metrics


if __name__ == "__main__":
    main(*sys.argv[1:])
