"""Bring-up check on an NVIDIA GPU: forward modeling, boundary-saving
gradients and a 3-iteration L-BFGS inversion through the normal entry
points (`python -m sep2023_tpu forward|invert`, the `parallel` loss
builders) at the reference's sizes, checked on the card against the
plain-AD reference.

  python chip_smoke.py          one GPU, every phase below
  python chip_smoke.py --four   four GPUs: the sharded `invert` (19 shots
                                padded to 20) against the same run on one
                                GPU, and no other phase

Phases (a failed check raises, so the exit code is non-zero):
  device       platform, kind and count as JAX reports them, and the card's
               name and power limit from `nvidia-smi`; fails unless JAX's
               first device is a GPU (there is no CPU fallback)
  forward      `forward` at Main-000's workload (101x201 -> 165x265 padded,
               nt=1501, 19 shots, 181 receivers): compile s, run s, GCell/s
  memory       one gradient evaluation each at Main-004's rock-physics shape
               (201x321 -> 265x385, nt=4001, 1 shot) and at the Marmousi
               shape of examples/marmousi_scale.py (750x2000 -> 814x2064,
               nt=2001, 24 shots): the chunk auto_shot_chunk chose,
               memory_analysis() and peak_bytes_in_use
  correctness  2 shots at the reference width, nt=1501: the boundary-saving
               elastic and acoustic engines against plain AD
               (propagate_ad, propagate_acoustic_ad) in float32 and float64,
               and the forward against the Aki & Richards solution
  invert       `invert --head vp_vs_rho --niter 3` at the default shape; the
               logged loss must decrease

The last stdout line is {"ok": true, "device": {...}}; it is printed only
after every phase passed.
"""
import argparse
import functools
import json
import os
import shutil
import subprocess
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "scratch", "chip_smoke")

# Relative max-norm error bounds against the plain-AD reference.  The two
# engines sum in different orders, so float32 gradients get the looser
# bound; float64 agrees to ~1e-13 on the CPU.
TOL = {"float32": {"data": 1e-5, "grad": 1e-4},
       "float64": {"data": 1e-12, "grad": 1e-10}}
# Aki & Richards: the bounds tests/test_forward_analytic.py uses
ANALYTIC_MIN_CORR = 0.98
ANALYTIC_MAX_ARRIVAL_S = 0.05
# 4-device vs 1-device `invert` loss trajectories: the psum sums the
# per-shot misfits in another order, which float32 L-BFGS-B carries on
FOUR_RTOL = 1e-4


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(a, b, sl=...):
    a, b = np.asarray(a)[sl], np.asarray(b)[sl]
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def interior(cfg, shrink):
    """Where the boundary-saving gradient is defined: the interior, shrunk
    by the reach of the material-averaging chain rules (2 cells elastic;
    4 acoustic, whose reconstruction region starts at npml+2,
    ac_pressure.cu:56-65)."""
    return (..., slice(cfg.npml + shrink, cfg.nz - cfg.npml - shrink),
            slice(cfg.npml + shrink, cfg.nx - cfg.npml - shrink))


def card_lines():
    """`nvidia-smi` name and power limit of each card, from a child that
    does not import JAX (a second JAX process would want the card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def phase_device():
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    print(f"device: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}", flush=True)
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is "
                         f"{info['platform']}; this check runs on the card")
    return info


def phase_forward(card, cli_args=()):
    """`python -m sep2023_tpu forward` (cli.cmd_forward, the same code)."""
    from sep2023_tpu import cli

    r = cli.main(["forward", *cli_args])
    data = np.asarray(r["data"])
    check(np.isfinite(data).all() and np.abs(data).max() > 0,
          "forward seismograms are finite and nonzero")
    print(f"forward: data {data.shape}; compile {r['compile_s']:.2f} s, "
          f"run {r['run_s']:.4f} s, {r['GCell_per_s']:.3f} GCell/s "
          f"[{card}]", flush=True)
    return r


def gradient_memory(name, card, cfg, survey, lam, mu, rho,
                    budget_bytes=None):
    """One float32 gradient evaluation through make_local_misfit with the
    chunk auto_shot_chunk picks for this device (obs = 0, so the misfit
    is the synthetic energy on the fiber channel)."""
    import jax
    import jax.numpy as jnp

    import sep2023_tpu as st
    from sep2023_tpu import parallel

    f32 = jnp.float32
    pad = lambda m: jnp.asarray(st.medium.pad_model_np(m, cfg.npml), f32)
    lam, mu, rho = pad(lam), pad(mu), pad(rho)
    S = survey.n_shots
    chunk = parallel.auto_shot_chunk(cfg, S, budget_bytes=budget_bytes)
    geoms = parallel.survey_to_geoms(survey, cfg.npml, dtype=f32)
    stf = jnp.broadcast_to(jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt),
                                       f32), (S, cfg.nt))
    obs = jnp.zeros((S, 4, survey.n_rec, cfg.nt), f32)
    w = jnp.ones((S,), f32)
    loss = parallel.make_local_misfit(cfg, shot_chunk=chunk)
    args = (lam, mu, rho, stf, geoms, obs, w)

    t0 = time.perf_counter()
    compiled = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2))).lower(
        *args).compile()
    t_compile = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    t0 = time.perf_counter()
    val, grads = jax.block_until_ready(compiled(*args))
    t_run = time.perf_counter() - t0
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")

    check(np.isfinite(float(val)) and float(val) > 0,
          f"{name}: misfit finite and positive ({float(val)})")
    for g in grads:
        g = np.asarray(g)
        check(np.isfinite(g).all() and np.abs(g).max() > 0,
              f"{name}: gradient finite and nonzero")
    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * S
    strips = parallel.strip_bytes_per_shot(cfg)
    print(f"{name}: {S} shots {cfg.nz}x{cfg.nx} nt={cfg.nt}; shot_chunk "
          f"{chunk} (strips {strips / 1e9:.3f} GB/shot); compile "
          f"{t_compile:.1f} s, gradient {t_run:.3f} s = "
          f"{cells / t_run / 1e9:.3f} GCell/s; memory_analysis "
          f"{_mem_fields(ma)}; peak_bytes_in_use {peak} [{card}]",
          flush=True)
    return {"chunk": chunk, "seconds": t_run, "peak": peak}


def _mem_fields(ma):
    if ma is None:
        return "not reported"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{k.replace('_size_in_bytes', '')}="
                     f"{getattr(ma, k, None)}" for k in keys)


def phase_memory(card):
    import bench

    for name, problem in (("rock gradient", bench.rock_problem()),
                          ("marmousi gradient", bench.marmousi_problem())):
        cfg, survey, lam, mu, rho = problem
        cfg.check_stability(float(np.sqrt((lam + 2 * mu) / rho).max()))
        gradient_memory(name, card, cfg, survey, lam, mu, rho)


def engine_errors(dtype, nz=101, nx=201, nt=1501, shots=(4, 14)):
    """Seismogram and gradient errors of the boundary-saving elastic and
    acoustic engines against plain AD, on `shots` of the reference survey
    with the anomaly model (obs) and its smoothed start (syn).  The misfit
    is L2 over every recorded channel."""
    import jax
    import jax.numpy as jnp

    import sep2023_tpu as st
    from sep2023_tpu import cli, models
    from sep2023_tpu.acoustic import (AcGeom, propagate_acoustic,
                                      propagate_acoustic_ad)
    from sep2023_tpu.propagator import propagate_ad

    cfg, _, geoms, stf = cli.benchmark_problem(nz=nz, nx=nx, nt=nt,
                                               dtype=dtype)
    sel = np.asarray(shots)
    geoms = jax.tree.map(lambda a: a[sel], geoms)
    stf = stf[sel]
    vp, vs, rho = models.anomaly_vp_vs_rho(nz, nx)
    pad = lambda m: jnp.asarray(st.medium.pad_model_np(m, cfg.npml), dtype)
    true = st.Medium(pad(vp), pad(vs), pad(rho))
    start = st.Medium(*(pad(models.smooth(m, 8.0)) for m in (vp, vs, rho)))
    ac_geoms = AcGeom(geoms.src_z, geoms.src_x, geoms.rec_z, geoms.rec_x)

    def pair(fn, fn_ad, model_true, model0, g, shrink):
        def fwd(f, *m):
            return jax.vmap(lambda s, gi: f(cfg, *m, s, gi))(stf, g)

        obs = jax.jit(fwd, static_argnums=0)(fn_ad, *model_true)

        @functools.partial(jax.jit, static_argnums=0)
        def data_and_grad(f, obs_, *m):
            syn, pull = jax.vjp(lambda *mm: fwd(f, *mm), *m)
            # cotangent of 0.5 |obs - syn|^2 with sample 0 excluded
            # (ops.misfit.residual)
            return syn, pull((syn - obs_).at[..., 0].set(0.0))

        out = data_and_grad(fn, obs, *model0)
        ref = data_and_grad(fn_ad, obs, *model0)
        sl = interior(cfg, shrink)
        return (rel_err(out[0], ref[0]),
                max(rel_err(a, b, sl) for a, b in zip(out[1], ref[1])))

    el = pair(st.propagate, propagate_ad, (true.lam, true.mu, true.rho),
              (start.lam, start.mu, start.rho), geoms, shrink=2)
    ac = pair(propagate_acoustic, propagate_acoustic_ad,
              (true.rho * true.vp ** 2, true.rho),
              (start.rho * start.vp ** 2, start.rho), ac_geoms, shrink=4)
    return {"elastic": el, "acoustic": ac}


def analytic_errors(dtype):
    """tests/test_forward_analytic.py's homogeneous explosive-source run
    (000-Solver-Benchmark.ipynb cells 4-13) through propagate: waveform
    correlation of vx/vz with the Aki & Richards 2-D displacement, and the
    P arrival-time error."""
    import jax.numpy as jnp

    import sep2023_tpu as st
    from sep2023_tpu import analytic as an

    npml = 24
    cfg = st.SimConfig(nz=160 + 2 * npml, nx=240 + 2 * npml, dz=10.0,
                       dx=10.0, nt=700, dt=0.001, f0=10.0, npml=npml)
    vp = jnp.full(cfg.grid.shape, 4000.0, dtype)
    med = st.Medium(vp, vp / jnp.sqrt(3.0).astype(dtype),
                    jnp.full(cfg.grid.shape, 2500.0, dtype))
    src_z, src_x, rec_z, rec_x = npml + 30, npml + 60, npml + 110, npml + 160
    stf = jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt, amp=1.0), dtype)
    geom = st.ShotGeom(src_z=jnp.int32(src_z), src_x=jnp.int32(src_x),
                       rxz=jnp.asarray(1.0, dtype),
                       rec_z=jnp.array([rec_z], jnp.int32),
                       rec_x=jnp.array([rec_x], jnp.int32))
    data = np.asarray(st.propagate(cfg, med.lam, med.mu, med.rho, stf, geom))
    t = np.arange(cfg.nt) * cfg.dt
    U = an.displacement_2d(4000.0, 4000.0 / np.sqrt(3.0), 2500.0,
                           (rec_x - src_x) * cfg.dx, (rec_z - src_z) * cfg.dz,
                           t, cfg.f0, 1e16, np.eye(3))

    def corr(a, b):
        a = (a - a.mean()) / (a.std() + 1e-30)
        b = (b - b.mean()) / (b.std() + 1e-30)
        return float(np.mean(a * b))

    # the solver's +stf into (sxx, szz) is the moment -M0*I of the
    # tension-positive analytic convention
    t_arr = np.hypot(1000.0, 800.0) / 4000.0 + 1.2 / cfg.f0
    return {"corr_vx": corr(data[1, 0], -U[0]),
            "corr_vz": corr(data[2, 0], -U[2]),
            "arrival_err_s": abs(t[np.abs(data[0, 0]).argmax()] - t_arr)}


def phase_correctness(card, **sizes):
    import jax
    import jax.numpy as jnp

    for name in ("float32", "float64"):
        with jax.enable_x64(name == "float64"):
            errs = engine_errors(jnp.dtype(name), **sizes)
        for engine, (e_data, e_grad) in errs.items():
            tol = TOL[name]
            print(f"correctness {name} {engine} vs plain AD: seismograms "
                  f"{e_data:.3e} (bound {tol['data']:.0e}), gradients "
                  f"{e_grad:.3e} (bound {tol['grad']:.0e}) [{card}]",
                  flush=True)
            check(e_data <= tol["data"], f"{name} {engine} seismograms")
            check(e_grad <= tol["grad"], f"{name} {engine} gradients")
    a = analytic_errors(jnp.float32)
    print(f"correctness float32 vs Aki & Richards: corr vx "
          f"{a['corr_vx']:.4f}, vz {a['corr_vz']:.4f} (bound >= "
          f"{ANALYTIC_MIN_CORR}), P arrival error {a['arrival_err_s']:.4f} s "
          f"(bound {ANALYTIC_MAX_ARRIVAL_S} s) [{card}]", flush=True)
    check(min(a["corr_vx"], a["corr_vz"]) >= ANALYTIC_MIN_CORR,
          "analytic waveform correlation")
    check(a["arrival_err_s"] <= ANALYTIC_MAX_ARRIVAL_S, "analytic arrival")


def _invert(exp, n_devices, cli_args):
    from sep2023_tpu import cli

    shutil.rmtree(exp, ignore_errors=True)
    r = cli.main(["invert", "--head", "vp_vs_rho", "--niter", "3",
                  "--exp-name", exp, "--n-devices", str(n_devices),
                  *cli_args])
    hist = np.loadtxt(os.path.join(exp, "Results", "loss.txt"),
                      ndmin=2)[:, 1]
    check(r["n_devices"] == n_devices,
          f"invert ran on {r['n_devices']} devices, asked for {n_devices}")
    return hist, r["eval_seconds"]


def _steady(ev):
    """Mean seconds per evaluation after the first (which compiles)."""
    return np.mean(ev[1:]) if len(ev) > 1 else float("nan")


def phase_invert(card, cli_args=()):
    hist, ev = _invert(os.path.join(WORK, "invert"), 1, cli_args)
    print(f"invert: loss {hist.tolist()}; {len(ev)} evaluations, first "
          f"{ev[0]:.2f} s (incl. compile), then {_steady(ev):.4f} "
          f"s/evaluation [{card}]", flush=True)
    check(len(hist) >= 2 and bool(np.all(np.diff(hist) < 0)),
          f"invert loss decreases ({hist.tolist()})")


def phase_four(card, n_devices=4, cli_args=(), rtol=FOUR_RTOL):
    """`invert` over an n-device shot mesh (Main-001 runs --ngpu 4) against
    the same inversion on one device."""
    h_n, ev_n = _invert(os.path.join(WORK, f"four_{n_devices}"), n_devices,
                        cli_args)
    h_1, ev_1 = _invert(os.path.join(WORK, "four_1"), 1, cli_args)
    rel = float(np.abs(h_n - h_1).max() / np.abs(h_1).max())
    for n, h, ev in ((n_devices, h_n, ev_n), (1, h_1, ev_1)):
        print(f"four: {n}-device invert loss {h.tolist()}; {len(ev)} "
              f"evaluations, then {_steady(ev):.4f} s/evaluation [{card}]",
              flush=True)
    print(f"four: {n_devices}-device vs 1-device trajectories differ by "
          f"{rel:.3e} relative (bound {rtol:.0e})", flush=True)
    check(len(h_n) == len(h_1) >= 2, "equal trajectory lengths")
    check(rel <= rtol, "sharded trajectory matches one device")
    check(h_n[-1] < h_n[0], "sharded invert loss decreases")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-GPU sharded invert and its 1-GPU "
                        "comparison")
    args = p.parse_args(argv)

    info = phase_device()
    cards = card_lines()
    for ln in cards:
        print(f"card: {ln}", flush=True)
    card = cards[0]
    from sep2023_tpu import cli
    cli.enable_compile_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    if args.four:
        check(info["count"] >= 4, f"--four needs 4 GPUs, found "
                                  f"{info['count']}")
        phase_four(card)
    else:
        phase_forward(card)
        phase_memory(card)
        phase_correctness(card)
        phase_invert(card)
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()
