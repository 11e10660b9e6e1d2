"""Render the framework's key outputs as figures: true/initial/inverted
models, FWI gradient, wavefield snapshots, and shot gathers.

Run:  python examples/make_figures.py [outdir] [--exp /path/to/exp]

Without --exp it runs a quick self-contained twin experiment; with --exp it
plots the artifacts of a previous `python -m sep2023_tpu invert` run.
"""
import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def plot_models(vp_true, vp_init, vp_inv, grad, outdir, dx, dz):
    fig, axes = plt.subplots(2, 2, figsize=(12, 7), constrained_layout=True)
    ext = [0, vp_true.shape[1] * dx / 1000, vp_true.shape[0] * dz / 1000, 0]
    vmin, vmax = vp_true.min(), vp_true.max()
    for ax, (arr, title) in zip(axes.flat, [
            (vp_true, "true Vp"), (vp_init, "initial Vp"),
            (vp_inv, "inverted Vp"), (grad, "first-iteration gradient")]):
        if title.endswith("gradient"):
            v = np.abs(arr).max()
            im = ax.imshow(arr, extent=ext, cmap="seismic", vmin=-v, vmax=v)
        else:
            im = ax.imshow(arr, extent=ext, cmap="viridis",
                           vmin=vmin, vmax=vmax)
        ax.set_title(title)
        ax.set_xlabel("x (km)")
        ax.set_ylabel("z (km)")
        fig.colorbar(im, ax=ax, shrink=0.8)
    path = os.path.join(outdir, "fwi_models.png")
    fig.savefig(path, dpi=120)
    print("wrote", path)


def plot_gather(data, dt, outdir):
    fig, axes = plt.subplots(1, 4, figsize=(16, 5), constrained_layout=True)
    names = ("pr", "vx", "vz", "ett (DAS)")
    for c, (ax, name) in enumerate(zip(axes, names)):
        d = data[c]
        v = np.abs(d).max() * 0.2 + 1e-30
        ax.imshow(d.T, aspect="auto", cmap="gray", vmin=-v, vmax=v,
                  extent=[0, d.shape[0], d.shape[1] * dt, 0])
        ax.set_title(name)
        ax.set_xlabel("receiver")
        ax.set_ylabel("t (s)")
    path = os.path.join(outdir, "shot_gather.png")
    fig.savefig(path, dpi=120)
    print("wrote", path)


def plot_snaps(snaps, outdir):
    n = snaps.shape[0]
    picks = np.linspace(1, n - 1, 6).astype(int)
    fig, axes = plt.subplots(2, 3, figsize=(14, 7), constrained_layout=True)
    v = np.abs(snaps[picks]).max() * 0.25
    for ax, k in zip(axes.flat, picks):
        ax.imshow(snaps[k], cmap="seismic", vmin=-v, vmax=v)
        ax.set_title(f"snapshot {k}")
        ax.axis("off")
    path = os.path.join(outdir, "wavefield.png")
    fig.savefig(path, dpi=120)
    print("wrote", path)


def plot_rtm(npz_path, outdir):
    with np.load(npz_path) as z:
        vp_t, img, z_refl = z["vp_true"], z["image_muted"], int(z["z_reflector"])
    npml = (img.shape[0] - vp_t.shape[0]) // 2
    img = img[npml:npml + vp_t.shape[0], npml:npml + vp_t.shape[1]]
    fig, axes = plt.subplots(1, 2, figsize=(10, 3.2), constrained_layout=True)
    axes[0].imshow(vp_t, aspect="auto", cmap="viridis")
    axes[0].set_title("true vp (reflector at z=%d)" % z_refl)
    lim = np.percentile(np.abs(img), 99.5) + 1e-30
    axes[1].imshow(img, aspect="auto", cmap="gray", vmin=-lim, vmax=lim)
    axes[1].set_title("RTM image (muted)")
    for ax in axes:
        ax.set_xlabel("x")
        ax.set_ylabel("z")
    path = os.path.join(outdir, "rtm.png")
    fig.savefig(path, dpi=120)
    print("wrote", path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="/tmp/figs")
    ap.add_argument("--exp", default="")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    import jax
    import jax.numpy as jnp
    import sep2023_tpu as st
    from sep2023_tpu import heads as H
    from sep2023_tpu import models, optimize, parallel
    from sep2023_tpu.cli import benchmark_problem
    from sep2023_tpu.propagator import propagate_snapshots

    nz, nx = 64, 128
    cfg, survey, geoms, stf = benchmark_problem(nz=nz, nx=nx, nt=501,
                                                npml=24)
    vp_t, vs_t, rho_t = models.anomaly_vp_vs_rho(nz, nx)
    vp_i = models.smooth(vp_t, 8.0)

    head = H.vp_vs_rho(cfg.grid, dict(vp=vp_i, vs=vs_t, rho=rho_t),
                       mask=H.default_mask(cfg.grid, freeze_top_rows=0))
    apply = lambda vp: head.apply({"vp": jnp.asarray(vp),
                                   "vs": jnp.asarray(vs_t),
                                   "rho": jnp.asarray(rho_t)})
    lam_t, mu_t, rr_t = apply(vp_t)
    fwd = jax.jit(lambda l, m, r, s, g: jax.vmap(
        lambda si, gi: st.propagate(cfg, l, m, r, si, gi))(s, g))
    obs = fwd(lam_t, mu_t, rr_t, stf, geoms)
    plot_gather(np.asarray(obs[len(obs) // 2]), cfg.dt, args.outdir)

    # wavefield movie for the middle shot
    gm = jax.tree.map(lambda a: a[len(survey.src_x) // 2], geoms)
    _, snaps = propagate_snapshots(cfg, lam_t, mu_t, rr_t, stf[0], gm,
                                   save_every=25)
    plot_snaps(np.asarray(snaps.vz), args.outdir)

    # RTM migration panel (the rtm CLI's twin experiment)
    from sep2023_tpu import cli as cli_mod
    rtm_npz = os.path.join(args.outdir, "rtm_image.npz")
    cli_mod.main(["rtm", "--nz", "64", "--nx", "128", "--nt", "800",
                  "--npml", "24", "--out", rtm_npz])
    plot_rtm(rtm_npz, args.outdir)

    if args.exp:
        snaps_files = sorted(glob.glob(os.path.join(args.exp, "Results",
                                                    "model_*.npz")))
        grads_files = sorted(glob.glob(os.path.join(args.exp, "Results",
                                                    "grad_*.npz")))
        with np.load(snaps_files[-1]) as z:
            vp_inv = z["vp"]
        grad = None
        if grads_files:
            with np.load(grads_files[0]) as z:
                grad = z["vp"]
        # rebuild true/init at the experiment's grid size
        ez, ex = vp_inv.shape
        vp_te, _, _ = models.anomaly_vp_vs_rho(ez, ex)
        vp_ie = models.smooth(vp_te, 8.0)
        plot_models(vp_te, vp_ie, vp_inv,
                    grad if grad is not None else np.zeros_like(vp_inv),
                    args.outdir, cfg.dx, cfg.dz)
        return

    # quick inline inversion for the figure; data threaded as aux (never
    # close a jitted loss over device arrays — CLAUDE.md JAX rules)
    w = jnp.ones((survey.n_shots,), jnp.float32)
    loss_d = parallel.make_local_misfit(cfg, channels=("ett", "vx", "vz"))

    def loss(p, stf_, obs_):
        lam, mu, rr = apply(p["vp"])
        return loss_d(lam, mu, rr, stf_, geoms, obs_, w)

    obj = optimize.ScipyObjective(loss, {"vp": vp_i}, aux=(stf, obs))
    f0 = obj.fun(obj.x0)                       # evaluate AT x0 first so
    grad0 = obj.unpack(obj.jac(obj.x0))["vp"]  # this really is iteration-0
    res = optimize.lbfgsb(obj, maxiter=15, disp=False, iprint=-1)
    vp_inv = np.asarray(obj.unpack(res.x)["vp"])
    plot_models(vp_t, vp_i, vp_inv, np.asarray(grad0), args.outdir,
                cfg.dx, cfg.dz)
    print(f"misfit {f0:.3e} -> {res.fun:.3e}")


if __name__ == "__main__":
    main()


def plot_overthrust(npz_path, outdir):
    """Overthrust spline-fiber DAS panel (examples/overthrust_das.py
    artifact): model + cable channels, initial and inverted Vp."""
    z = np.load(npz_path)
    vp_t, vp_i, vp_o = z["vp_true"], z["vp_init"], z["vp_out"]
    rec_z, rec_x = z["rec_z"], z["rec_x"]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4), constrained_layout=True)
    vmin, vmax = vp_t.min(), vp_t.max()
    for ax, (arr, title) in zip(axes, [
            (vp_t, "true Vp + spline DAS cable"),
            (vp_i, "initial Vp (smoothed)"),
            (vp_o, "inverted Vp (10 L-BFGS-B iters)")]):
        im = ax.imshow(arr, cmap="viridis", vmin=vmin, vmax=vmax)
        ax.set_title(title)
        ax.set_xlabel("x (cells)")
        ax.set_ylabel("z (cells)")
    axes[0].plot(rec_x, rec_z, "r.-", ms=4, lw=1, label="fiber channels")
    axes[0].legend(loc="lower right")
    fig.colorbar(im, ax=axes, shrink=0.8)
    path = os.path.join(outdir, "overthrust_das.png")
    fig.savefig(path, dpi=120)
    print("wrote", path)


def plot_marmousi(npz_path, outdir):
    """Marmousi-scale twin experiment
    (examples/marmousi_scale.py artifact): true / initial / inverted Vp,
    the true vs recovered anomaly perturbations, and the per-iteration
    IN-ANOMALY model error — the recovery metric."""
    z = np.load(npz_path)
    vp_t, vp_i, vp_o = z["vp_true"], z["vp_init"], z["vp_out"]
    nit = (len(z["anom_err_per_iter"]) - 1 if "anom_err_per_iter" in z
           else "?")
    fig = plt.figure(figsize=(14, 11), constrained_layout=True)
    gs = fig.add_gridspec(4, 2)
    vmin, vmax = vp_t.min(), vp_t.max()
    for r, (arr, title) in enumerate([
            (vp_t, "true Vp: overthrust + 3 Gaussian anomalies "
                   "(750x2000, 7.5x20 km)"),
            (vp_i, "initial Vp (smoothed background, no anomalies)"),
            (vp_o, f"inverted Vp ({nit} L-BFGS-B iters)")]):
        ax = fig.add_subplot(gs[r, :])
        im = ax.imshow(arr, cmap="viridis", vmin=vmin, vmax=vmax,
                       aspect="auto")
        ax.set_title(title)
        ax.set_ylabel("z (cells)")
        fig.colorbar(im, ax=ax, shrink=0.9)
    dv = np.abs(vp_t - vp_i).max()
    ax = fig.add_subplot(gs[3, 0])
    im = ax.imshow(vp_o - vp_i, cmap="seismic", vmin=-dv, vmax=dv,
                   aspect="auto")
    ax.set_title("recovered perturbation (inverted - initial)")
    ax.set_xlabel("x (cells)")
    ax.set_ylabel("z (cells)")
    fig.colorbar(im, ax=ax, shrink=0.9)
    if "anom_err_per_iter" in z:
        ax = fig.add_subplot(gs[3, 1])
        err = z["anom_err_per_iter"]
        ax.plot(np.arange(len(err)), err, "o-", color="tab:red")
        ax.set_title("in-anomaly mean |vp error| per iteration")
        ax.set_xlabel("L-BFGS-B iteration")
        ax.set_ylabel("m/s")
        ax.grid(alpha=0.3)
    path = os.path.join(outdir, "marmousi_scale.png")
    fig.savefig(path, dpi=110)
    print("wrote", path)
