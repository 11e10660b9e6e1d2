"""Curved-fiber DAS FWI demo: invert Vp from gauge-length-averaged strain
measured along buried fiber-optic cables with directional sensitivity — the
use case of the reference paper (Eaid et al. 2020 forward model,
elasticSolver.py:269-276, combined with the TorchFWI inversion engine).

Pipeline: arc-shaped cables -> per-point (exx, exz, ezz) sensitivity
weights -> weighted strain-rate channels -> gauge averaging -> L2 misfit ->
boundary-saving adjoint -> L-BFGS-B.

Run:  python examples/das_fwi.py [outdir]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import sep2023_tpu as st
from sep2023_tpu import das, models, optimize


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/das_fwi"
    os.makedirs(outdir, exist_ok=True)

    npml = 16
    nzp, nxp = 60, 100
    cfg = st.SimConfig(nz=nzp + 2 * npml, nx=nxp + 2 * npml, dz=10.0,
                       dx=10.0, nt=500, dt=0.001, f0=15.0, npml=npml,
                       das_channel="weighted")
    GL = 100.0

    # three buried arc cables, 21 quadrature points each
    cables = [das.arc_fiber(GL, 2.0 / np.pi, center=(cx, 320.0, 0.0))
              for cx in (250.0, 500.0, 750.0)]
    rec_z, rec_x, das_w = [], [], []
    for c in cables:
        z, x, w = das.cable_to_receivers(c, cfg.dx, cfg.dz)
        rec_z.append(z)
        rec_x.append(x)
        das_w.append(w)
    rec_z = np.concatenate(rec_z)
    rec_x = np.concatenate(rec_x)
    das_w = np.concatenate(das_w)
    A = das.gauge_matrix(len(cables), das.N_CABLE_PTS, GL)

    # surface shots
    src_x = np.arange(10, nxp - 10, 15)
    stf = jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt), jnp.float32)
    geoms = st.ShotGeom(
        src_z=jnp.full(len(src_x), npml + 2, jnp.int32),
        src_x=jnp.asarray(src_x + npml, jnp.int32),
        rxz=jnp.ones(len(src_x), jnp.float32),
        rec_z=jnp.broadcast_to(jnp.asarray(rec_z + npml, jnp.int32),
                               (len(src_x), len(rec_z))),
        rec_x=jnp.broadcast_to(jnp.asarray(rec_x + npml, jnp.int32),
                               (len(src_x), len(rec_x))),
        das_w=jnp.broadcast_to(jnp.asarray(das_w, jnp.float32),
                               (len(src_x), *das_w.shape)))
    stf_all = jnp.broadcast_to(stf, (len(src_x), cfg.nt))

    vp_t, vs_t, rho_t = models.anomaly_vp_vs_rho(nzp, nxp)
    vp_i = models.smooth(vp_t, 6.0)
    pad = lambda a: st.pad_model(jnp.asarray(a, jnp.float32), npml)

    def to_lame(vp):
        vp_pad = pad(vp)
        vs_pad = pad(vs_t)
        rho_pad = pad(rho_t)
        return ((vp_pad ** 2 - 2 * vs_pad ** 2) * rho_pad,
                vs_pad ** 2 * rho_pad, rho_pad)

    fwd = jax.jit(lambda lam, mu, rho, s, g: jax.vmap(
        lambda si, gi: st.propagate(cfg, lam, mu, rho, si, gi))(s, g))

    lam_t, mu_t, rr_t = to_lame(vp_t)
    obs = fwd(lam_t, mu_t, rr_t, stf_all, geoms)
    A32 = jnp.asarray(A, jnp.float32)
    obs_g = das.apply_gauge(obs[:, 3], A32)
    print(f"{len(src_x)} shots x {len(cables)} gauge channels "
          f"({len(rec_z)} fiber points)")

    def gauge_l2(obs_g1, syn1):
        r = obs_g1 - das.apply_gauge(syn1[3], A32)
        return 0.5 * jnp.sum(r * r)

    def loss(params, stf_a, obs_gauge):
        lam, mu, rho = to_lame(params["vp"])
        syn = jax.vmap(lambda si, gi: st.propagate(cfg, lam, mu, rho,
                                                   si, gi))(stf_a, geoms)
        per = jax.vmap(gauge_l2)(obs_gauge, syn)
        return jnp.sum(per)

    obj = optimize.ScipyObjective(loss, {"vp": vp_i}, aux=(stf_all, obs_g))
    f0 = obj.fun(obj.x0)
    res = optimize.lbfgsb(obj, maxiter=15)
    vp_inv = np.asarray(obj.unpack(res.x)["vp"])
    print(f"DAS gauge misfit: {f0:.4e} -> {res.fun:.4e} "
          f"({res.nit} iterations)")

    box = vp_t != vp_t[0, 0]
    print(f"anomaly mean update: {vp_inv[box].mean() - vp_t[0, 0]:+.1f} m/s "
          f"(true {vp_t[box].mean() - vp_t[0, 0]:+.1f})")
    np.savez(os.path.join(outdir, "das_fwi.npz"), vp_true=vp_t,
             vp_init=vp_i, vp_inv=vp_inv)
    print("saved", os.path.join(outdir, "das_fwi.npz"))


if __name__ == "__main__":
    main()
