"""Marmousi-scale twin-experiment FWI on the XLA engine.

A 750x2000-cell (7.5 km x 20 km at dz=dx=10 m) overthrust-style model
with three Gaussian vp anomalies — 814x2064 padded — inverted end-to-end on
one GPU: observed data from the true model, L-BFGS-B from the smoothed
anomaly-free background, gradients through the boundary-saving adjoint
(propagator.propagate) with shots chunked so the strips fit device
memory.

This is the reference's twin-experiment design (anomalies on a known
background, Main-001-FWI-Anomaly-Vp-Vs-Den.py:137-154) at Marmousi scale:
the +-250 m/s blobs (sigma ~400 m) sit WITHIN the 6 Hz transmission
resolution (lambda/2 ~ 225 m), so the IN-ANOMALY mean |vp err| drops
visibly within tens of iterations — a model metric that demonstrates
recovery, not just misfit.  (An earlier variant inverted the bare
hard-smoothed overthrust: the data misfit fell 128x but the pointwise
error budget was dominated by sharp layer interfaces ABOVE the 6 Hz
resolution limit, so mean |vp err| moved ~2% — the metric trap CLAUDE.md
documents.  Smooth blobs are what this acquisition can actually see.)

Run:  python examples/marmousi_scale.py [outdir] [n_iters]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import sep2023_tpu as st
from sep2023_tpu import models, optimize, parallel
from sep2023_tpu.config import Survey


def main(outdir="scratch/marmousi_scale", n_iters=30, nz=750, nx=2000,
         nt=2001, n_shots=24, npml=32, smooth_cells=None, shot_chunk=2,
         f0=6.0):
    """Defaults are the Marmousi-scale GPU run; the smaller overrides let
    the same machinery smoke-test on CPU.  Returns the
    metrics dict it prints (misfit + IN-ANOMALY model error, both of
    which must IMPROVE for the demo to count as a recovery; the
    illuminated-zone and whole-model errors are reported alongside)."""
    os.makedirs(outdir, exist_ok=True)
    n_iters, nz, nx, nt, n_shots, npml, shot_chunk = (
        int(v) for v in (n_iters, nz, nx, nt, n_shots, npml, shot_chunk))
    dh = 10.0
    dt = 0.001                    # 2 s window (receivers at 0.6 nz ~ 1.5 s out)
    # f0=6 Hz at full scale; CPU smokes pass a higher f0 so the blobs
    # stay within the lambda/2 resolution on their tiny grids
    cfg = st.SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=dh, dx=dh,
                       nt=nt, dt=dt, f0=float(f0), npml=npml)
    print(f"grid {cfg.nz}x{cfg.nx} padded, nt={nt}; boundary strips "
          f"{parallel.strip_bytes_per_shot(cfg) / 1e9:.2f} GB/shot",
          flush=True)

    vp_bg = models.overthrust_vp(nz, nx, v_top=2600.0, v_step=300.0)
    # truth = background + smooth Gaussian blobs (the recoverable target);
    # init = gently smoothed background WITHOUT the blobs (kinematics near
    # truth -> no cycle skipping; the anomalies carry the signal)
    sig_b = max(5.0, 0.055 * nz)
    vp_t = vp_bg
    for zf, xf, amp in ((0.22, 0.32, 250.0), (0.38, 0.52, -250.0),
                        (0.30, 0.70, 200.0)):
        vp_t = models.gaussian_anomaly(vp_t, zf * nz, xf * nx, sig_b, amp)
    anom_mask = np.abs(vp_t - vp_bg) > 25.0
    if smooth_cells is None:
        smooth_cells = max(6.0, 24.0 * nz / 750.0)
    vp_0 = models.smooth(vp_bg, float(smooth_cells))
    pad = lambda m: jnp.asarray(st.medium.pad_model_np(m, npml), jnp.float32)
    # rho is built from the scalar INSIDE the traced losses (a closed-over
    # device plane would compile in as a constant — CLAUDE.md JAX rules)
    rho_c = 2300.0
    rho = jnp.full(cfg.grid.shape, rho_c, jnp.float32)
    cfg.check_stability(float(vp_t.max()))

    # shots across the top, receivers on a deep row (DAS-style)
    mx = max(4, nx // 50)
    src_x = np.linspace(mx, nx - mx, n_shots).astype(np.int64)
    rec_row = int(0.6 * nz)
    survey = Survey(src_z=np.full(len(src_x), 2), src_x=src_x,
                    rec_z=np.full(nx - 2 * (mx // 2), rec_row),
                    rec_x=np.arange(mx // 2, nx - mx // 2))
    stf = jnp.broadcast_to(
        jnp.asarray(st.ricker(cfg.f0, nt, dt), jnp.float32),
        (len(src_x), nt))
    w = jnp.ones((len(src_x),), jnp.float32)

    # the ILLUMINATED zone: between the surface sources and the receiver
    # line, inside the lateral source spread — where transmission FWI has
    # ray coverage and a recovery claim is physically meaningful
    zone = (slice(4, rec_row), slice(mx, nx - mx))

    def zone_err(vp):
        return float(np.abs(np.asarray(vp) - vp_t)[zone].mean())

    def anom_err(vp):
        return float(np.abs(np.asarray(vp) - vp_t)[anom_mask].mean())

    def to_lame(vp_pad):
        vs_pad = vp_pad / jnp.sqrt(3.0)
        rr = jnp.full(cfg.grid.shape, rho_c, vp_pad.dtype)  # in-trace
        return ((vp_pad ** 2 - 2 * vs_pad ** 2) * rr, vs_pad ** 2 * rr)

    print("generating observed data (production forward builder) ...",
          flush=True)
    t0 = time.time()
    gen = jax.jit(parallel.make_forward(cfg, survey, shot_chunk=shot_chunk))
    lam_t, mu_t = to_lame(pad(vp_t))
    obs = jax.block_until_ready(gen(lam_t, mu_t, rho, stf))
    print(f"  {len(src_x)} shots in {time.time()-t0:.1f}s (incl. compile)",
          flush=True)

    # shot_chunk bounds the boundary-strip residuals (~1.15 GB per
    # in-flight shot at full-scale nt) via the custom-vjp gradient
    # accumulator (parallel._chunked_sum) — the production path
    geoms = parallel.survey_to_geoms(survey, npml)
    data_loss = parallel.make_local_misfit(cfg, shot_chunk=shot_chunk)

    def loss(params, stf_, obs_):
        vp_pad = jnp.pad(jnp.asarray(params["vp"], jnp.float32), npml,
                         mode="edge")
        lam, mu = to_lame(vp_pad)
        rr = jnp.full(cfg.grid.shape, rho_c, jnp.float32)
        return data_loss(lam, mu, rr, stf_, geoms, obs_, w)

    obj = optimize.ScipyObjective(loss, {"vp": vp_0}, aux=(stf, obs))
    err_hist = [anom_err(vp_0)]

    def track(xk):
        err_hist.append(anom_err(obj.unpack(xk)["vp"]))
        print(f"  iter {len(err_hist) - 1}: in-anomaly |vp err| "
              f"{err_hist[-1]:.1f} m/s", flush=True)

    t0 = time.time()
    # (m0, not f0 — don't shadow the frequency parameter)
    m0 = obj.fun(obj.x0)   # cached — minimize's first evaluation reuses it
    res = optimize.lbfgsb(obj, maxiter=int(n_iters), callback=track)
    vp_out = obj.unpack(res.x)["vp"]
    err0_all = float(np.abs(vp_0 - vp_t).mean())
    err1_all = float(np.abs(np.asarray(vp_out) - vp_t).mean())
    np.savez(os.path.join(outdir, "marmousi_scale.npz"),
             vp_true=vp_t, vp_init=vp_0, vp_out=np.asarray(vp_out),
             anom_mask=anom_mask, anom_err_per_iter=np.asarray(err_hist))
    metrics = {"misfit0": float(m0), "misfit1": float(res.fun),
               "nit": int(res.nit), "n_evals": int(obj.n_evals),
               "anom_err0": err_hist[0], "anom_err1": anom_err(vp_out),
               "zone_err0": zone_err(vp_0), "zone_err1": zone_err(vp_out),
               "err0_all": err0_all, "err1_all": err1_all}
    print(f"misfit {m0:.4e} -> {res.fun:.4e} after {res.nit} iterations "
          f"({obj.n_evals} evals, {time.time()-t0:.0f}s); "
          f"in-anomaly mean |vp err| {metrics['anom_err0']:.1f} -> "
          f"{metrics['anom_err1']:.1f} m/s; illuminated-zone "
          f"{metrics['zone_err0']:.1f} -> {metrics['zone_err1']:.1f} "
          f"(whole model {err0_all:.1f} -> {err1_all:.1f})", flush=True)
    return metrics


if __name__ == "__main__":
    main(*sys.argv[1:])
