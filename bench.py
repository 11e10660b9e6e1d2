"""Benchmark of the XLA engine on one NVIDIA GPU, one JSON line per section.

Sections keep the shapes of the reference's workloads:
  forward            Main-000 (101x201 -> 165x265, nt=1501, 19 shots, 181
                     receivers): the `forward` command's jitted vmap
  gradient           misfit + (lam, mu, rho) gradients of the same 19 shots
                     through the boundary-saving adjoint, unchunked
  rock_gradient      Main-004 (201x321 -> 265x385, nt=4001): one shot
  chunked_gradient   12 shots at 265x385, nt=2001, in chunks of 4 (the
                     custom-vjp gradient accumulator)
  acoustic_gradient  the acoustic engine at the Main-000 workload
  marmousi           one shot at 750x2000 -> 814x2064, nt=601: gradient and
                     forward

Every line names the device as JAX reports it and the card's name and
power limit from `nvidia-smi`; off a GPU the script fails before measuring.
Times are host wall clock around calls that end in block_until_ready, after
a warm-up call; the median of `REPEATS` calls is reported.

SEP2023_TPU_PROFILE=<dir> also traces one warm call each of `forward` and
`gradient` with jax.profiler and adds, from that trace, the device kernels
per time step, the device idle share and the top kernels by device time.

Run:  python bench.py
"""
import glob
import json
import os
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPEATS = 5


def _device():
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX's first device is "
                         f"{d.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return ({"platform": d.platform, "kind": d.device_kind,
             "count": len(devs)}, card.strip().splitlines()[0])


def _time(fn, *args):
    """(median seconds, output) of REPEATS warm calls."""
    out = jax.block_until_ready(fn(*args))  # compile + warm up
    ts = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def reference_problem():
    import sep2023_tpu as st
    from sep2023_tpu import models
    from sep2023_tpu.cli import benchmark_problem

    cfg, survey, geoms, stf = benchmark_problem()
    vp, vs, rho = models.anomaly_vp_vs_rho(101, 201)
    pad = lambda m: jnp.asarray(st.medium.pad_model_np(m, cfg.npml),
                                jnp.float32)
    return cfg, survey, geoms, stf, st.Medium(pad(vp), pad(vs), pad(rho))


def chunked_problem():
    """The shot-chunked gradient workload: a homogeneous 265x385 grid
    (201x321 physical), nt=2001, 12 surface shots, a receiver row at
    z=1."""
    import sep2023_tpu as st

    cfg = st.SimConfig(nz=265, nx=385, dz=10.0, dx=10.0, nt=2001, dt=0.001,
                       f0=15.0, npml=32)
    survey = st.Survey(src_z=np.full(12, 1),
                       src_x=np.linspace(10, 310, 12).astype(int),
                       rec_z=np.full(301, 1), rec_x=np.arange(10, 311))
    vp = np.full((201, 321), 3000.0)
    return cfg, survey, (vp ** 2 / 3.0) * 2200.0, (vp ** 2 / 3.0) * 2200.0, \
        np.full_like(vp, 2200.0)


def rock_problem():
    """Main-004 (Main-004-FWI-Rock-Physics.py:28-33): 201x321 at 10 m,
    nt=4001, dt=1 ms, f0=15 Hz; the Gassmann reservoir model; one shot,
    301 receivers."""
    import sep2023_tpu as st
    from sep2023_tpu import models, rock_physics

    cfg = st.SimConfig(nz=265, nx=385, dz=10.0, dx=10.0, nt=4001,
                       dt=0.001, f0=15.0, npml=32)
    lam, mu, rho = (np.asarray(a) for a in rock_physics.pcs_to_lame_gassmann(
        *models.reservoir_pcs(201, 321)))
    survey = st.Survey(src_z=np.array([1]), src_x=np.array([160]),
                       rec_z=np.full(301, 190), rec_x=np.arange(10, 311))
    return cfg, survey, lam, mu, rho


def marmousi_problem(nz=750, nx=2000, nt=2001, n_shots=24, npml=32):
    """examples/marmousi_scale.py's acquisition: 24 surface shots, a deep
    receiver row at 0.6 nz, the overthrust background at 10 m, f0=6 Hz."""
    import sep2023_tpu as st
    from sep2023_tpu import models

    cfg = st.SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=10.0, dx=10.0,
                       nt=nt, dt=0.001, f0=6.0, npml=npml)
    vp = models.overthrust_vp(nz, nx, v_top=2600.0, v_step=300.0)
    vs, rho = vp / np.sqrt(3.0), np.full_like(vp, 2300.0)
    mx = max(4, nx // 50)
    survey = st.Survey(
        src_z=np.full(n_shots, 2),
        src_x=np.linspace(mx, nx - mx, n_shots).astype(np.int64),
        rec_z=np.full(nx - 2 * (mx // 2), int(0.6 * nz)),
        rec_x=np.arange(mx // 2, nx - mx // 2))
    return cfg, survey, (vp ** 2 - 2 * vs ** 2) * rho, vs ** 2 * rho, rho


def marmousi_single_shot(nt=601):
    """One shot on the Marmousi grid (750x2000 -> 814x2064), receivers on a
    row 12 cells above the bottom PML."""
    import sep2023_tpu as st

    cfg = st.SimConfig(nz=814, nx=2064, dz=10.0, dx=10.0, nt=nt, dt=0.001,
                       f0=10.0, npml=32)
    survey = st.Survey(src_z=np.array([1]), src_x=np.array([1000]),
                       rec_z=np.full(1980, 738), rec_x=np.arange(10, 1990))
    vp = np.full((750, 2000), 3000.0)
    return cfg, survey, (vp ** 2 / 3.0) * 2200.0, (vp ** 2 / 3.0) * 2200.0, \
        np.full_like(vp, 2200.0)


def gradient_fn(cfg, survey, lam, mu, rho, shot_chunk=0):
    """(jitted value_and_grad, args) of the float32 L2 misfit over obs = 0
    through parallel.make_local_misfit — the loss `invert` builds."""
    import sep2023_tpu as st
    from sep2023_tpu import parallel

    f32 = jnp.float32
    pad = lambda m: jnp.asarray(st.medium.pad_model_np(m, cfg.npml), f32)
    S = survey.n_shots
    args = (pad(lam), pad(mu), pad(rho),
            jnp.broadcast_to(jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt),
                                         f32), (S, cfg.nt)),
            parallel.survey_to_geoms(survey, cfg.npml, dtype=f32),
            jnp.zeros((S, 4, survey.n_rec, cfg.nt), f32),
            jnp.ones((S,), f32))
    loss = parallel.make_local_misfit(cfg, shot_chunk=shot_chunk)
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2))), args


def forward_fn(cfg):
    import sep2023_tpu as st

    return jax.jit(lambda lam, mu, rho, s, g: jax.vmap(
        lambda si, gi: st.propagate(cfg, lam, mu, rho, si, gi))(s, g))


def trace_metrics(trace_dir, n_steps):
    """Device metrics of one traced call from its .xplane.pb: kernels per
    time step, the idle share of the window from the first kernel's start
    to the last kernel's end (busy = union of kernel intervals), and the
    five kernels with the most device time.  Kernels are the events on
    the GPU planes' "Stream #n" lines."""
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    spans, per_name = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_name[ev.name] = per_name.get(ev.name, 0.0) + \
                    ev.duration_ns
    if not spans:
        raise RuntimeError(f"no device kernels in {path}")
    spans.sort()
    busy, cur0, cur1 = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur1:
            busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    window = spans[-1][1] - spans[0][0]
    total = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    return {"kernels": len(spans),
            "kernels_per_step": len(spans) / n_steps,
            "device_window_s": window * 1e-9,
            "device_busy_s": busy * 1e-9,
            "idle_share": 1.0 - busy / window,
            "top_kernels": [[name[:80], dur / total] for name, dur in top]}


def _traced(trace_dir, fn, *args):
    os.makedirs(trace_dir, exist_ok=True)
    jax.block_until_ready(fn(*args))  # warm (compiled by the timing above)
    jax.profiler.start_trace(trace_dir)
    try:
        jax.block_until_ready(fn(*args))
    finally:
        jax.profiler.stop_trace()


def main():
    device, card = _device()
    prof_dir = os.environ.get("SEP2023_TPU_PROFILE")

    from sep2023_tpu.acoustic import AcGeom, propagate_acoustic
    from sep2023_tpu.cli import enable_compile_cache

    enable_compile_cache()

    def emit(section, seconds, cells, extra=None):
        print(json.dumps({
            "section": section, "metric": "GCell-updates/s",
            "value": cells / seconds / 1e9, "seconds": seconds,
            "device": device, "card": card, "extra": extra or {}}),
            flush=True)

    cfg, survey, geoms, stf, med = reference_problem()
    lam, mu, rho = med.to_lame()
    S = survey.n_shots
    cells_ref = cfg.nz * cfg.nx * (cfg.nt - 1) * S

    fwd = forward_fn(cfg)
    t, data = _time(fwd, lam, mu, rho, stf, geoms)
    extra = {}
    if prof_dir:
        d = os.path.join(prof_dir, "forward")
        _traced(d, fwd, lam, mu, rho, stf, geoms)
        extra = trace_metrics(d, cfg.nt - 1)
    emit("forward", t, cells_ref, extra)

    from sep2023_tpu import parallel
    loss = parallel.make_local_misfit(cfg)
    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))
    gargs = (lam, mu, rho, stf, geoms, data, jnp.ones((S,), jnp.float32))
    t, _ = _time(grad, *gargs)
    extra = {}
    if prof_dir:
        d = os.path.join(prof_dir, "gradient")
        _traced(d, grad, *gargs)
        extra = trace_metrics(d, cfg.nt - 1)
    emit("gradient", t, cells_ref, extra)

    cfg_r, survey_r, *m_r = rock_problem()
    fn, args = gradient_fn(cfg_r, survey_r, *m_r)
    t, _ = _time(fn, *args)
    emit("rock_gradient", t, cfg_r.nz * cfg_r.nx * (cfg_r.nt - 1))

    cfg_c, survey_c, *m_c = chunked_problem()
    fn, args = gradient_fn(cfg_c, survey_c, *m_c, shot_chunk=4)
    t, _ = _time(fn, *args)
    emit("chunked_gradient", t,
         cfg_c.nz * cfg_c.nx * (cfg_c.nt - 1) * survey_c.n_shots,
         {"shots": survey_c.n_shots, "shot_chunk": 4})

    ac_geoms = AcGeom(geoms.src_z, geoms.src_x, geoms.rec_z, geoms.rec_x)

    def ac_loss(lam_, rho_, s):
        d = jax.vmap(lambda si, gi: propagate_acoustic(cfg, lam_, rho_, si,
                                                       gi))(s, ac_geoms)
        return 0.5 * jnp.sum(d * d)

    ac_grad = jax.jit(jax.grad(ac_loss, argnums=(0, 1)))
    t, _ = _time(ac_grad, rho * 2000.0 ** 2, rho, stf)
    emit("acoustic_gradient", t, cells_ref)

    cfg_m, survey_m, *m_m = marmousi_single_shot()
    fn, args = gradient_fn(cfg_m, survey_m, *m_m)
    t_g, _ = _time(fn, *args)
    t_f, _ = _time(forward_fn(cfg_m), *args[:5])
    cells_m = cfg_m.nz * cfg_m.nx * (cfg_m.nt - 1)
    emit("marmousi_gradient", t_g, cells_m)
    emit("marmousi_forward", t_f, cells_m)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"peak_bytes_in_use over the run: {peak}", file=sys.stderr)


if __name__ == "__main__":
    main()
