"""Experiment drivers: the framework's equivalents of the reference's
Main-000..005 scripts (`DAS_Waveform_Inversion/notebooks/Main-*.py`), as a
`python -m sep2023_tpu` CLI.

  forward   observed-data generation + throughput report   (Main-000)
  invert    twin-experiment FWI with any parameterization   (Main-001..005)
              --head vp_vs_rho   -> Main-001
              --head lame_rho    -> Main-002
              --head ip_is_rho   -> Main-003
              --head rock_vrh / rock_gassmann -> Main-004/005
  rtm       reverse-time migration twin experiment           (main.cu:322+)
  bench     single-GPU benchmark (JSON lines)

Models are synthesized (models.py) because the reference git-ignores its
Models/*.txt grids.

Multi-device: when more than one device is visible (several GPUs of one
host, or the CPU test mesh), `invert` shards shots over a 1-D mesh by
default — the production path of the reference's `--ngpu` OpenMP scheduler
(`Torch_Fwi.cpp:71-101`) — with `--n-devices 1` forcing a single device.
"""
from __future__ import annotations

import argparse
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

import sep2023_tpu as st
from sep2023_tpu import heads as H
from sep2023_tpu import io as sio
from sep2023_tpu import models, optimize, parallel, survey_tools
from sep2023_tpu.config import Survey


WAVELETS = {"ricker": st.ricker, "ricker_int": st.ricker_integrated,
            "klauder": st.klauder}


def benchmark_problem(nz=101, nx=201, dz=20.0, dx=20.0, nt=1501, dt=0.002,
                      f0=10.0, npml=32, dtype=jnp.float32, wavelet="ricker"):
    """The reference GPU benchmark workload (Main-000/001: 101x201 grid,
    19 shots at z=1, 181 receivers at z=95, nt=1501).

    For non-default nz the receiver row scales PROPORTIONALLY (z = 95/101 of
    the grid) so sweeps over grid size keep a geometrically comparable
    survey; jnp gathers would silently clamp out-of-range indices otherwise.
    """
    cfg = st.SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=dz, dx=dx,
                       nt=nt, dt=dt, f0=f0, npml=npml)
    src_x = np.arange(10, nx - 10, 10)
    rec_z = min(int(round(95 * nz / 101)), nz - 6)
    if nz != 101:
        print(f"note: receiver row scaled to z={rec_z} for nz={nz} "
              f"(reference survey is z=95 of 101)")
    survey = Survey(src_z=np.ones(len(src_x)), src_x=src_x,
                    rec_z=np.full(nx - 20, rec_z),
                    rec_x=np.arange(10, nx - 10))
    geoms = parallel.survey_to_geoms(survey, npml, dtype=dtype)
    stf = jnp.broadcast_to(
        jnp.asarray(WAVELETS[wavelet](f0, nt, dt), dtype),
        (survey.n_shots, nt))
    return cfg, survey, geoms, stf


def cmd_forward(args):
    dtype = jnp.float32
    cfg, survey, geoms, stf = benchmark_problem(
        nz=args.nz, nx=args.nx, dz=args.dz, dx=args.dx, nt=args.nt,
        dt=args.dt, f0=args.f0, npml=args.npml, wavelet=args.wavelet)
    # wavelet end-taper, matching the reference's upload path
    # (cuda_window(..., 0.001, ...), Src_Rec.cu:130-142)
    from sep2023_tpu.ops import signal as sg
    stf = stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, dtype=dtype)
    vp, vs, rho = models.anomaly_vp_vs_rho(args.nz, args.nx)
    med = st.Medium(jnp.asarray(st.medium.pad_model_np(vp, cfg.npml), dtype),
                    jnp.asarray(st.medium.pad_model_np(vs, cfg.npml), dtype),
                    jnp.asarray(st.medium.pad_model_np(rho, cfg.npml), dtype))
    cfg.check_stability(float(vp.max()))
    survey_tools.check_reach(cfg, survey, float(vp.max()))
    st.medium.check_lambda(med.lam)  # Model.cu:37-40

    if args.physics == "acoustic":
        # the standalone CLI's acoustic branch (main.cu:180-197)
        from sep2023_tpu.acoustic import AcGeom, propagate_acoustic
        lam_ac = med.rho * med.vp ** 2
        ac_geoms = AcGeom(src_z=geoms.src_z, src_x=geoms.src_x,
                          rec_z=geoms.rec_z, rec_x=geoms.rec_x)
        fwd = jax.jit(lambda lam, rho_, s, g: jax.vmap(
            lambda si, gi: propagate_acoustic(cfg, lam, rho_, si, gi))(s, g))
        t0 = time.perf_counter()
        data3 = jax.block_until_ready(fwd(lam_ac, med.rho, stf, ac_geoms))
        t_run = time.perf_counter() - t0
        print(f"acoustic forward: {survey.n_shots} shots in {t_run:.2f}s "
              f"(incl. compile)")
        if args.data_dir:
            # keep the 4-channel Shot_* format; ett is zero in acoustic mode
            d = np.zeros((survey.n_shots, 4, survey.n_rec, cfg.nt),
                         np.float32)
            d[:, :3] = np.asarray(data3)
            sio.write_shots(args.data_dir, d)
            _export_config(args.data_dir, cfg, survey)
            print(f"wrote {survey.n_shots} shots to {args.data_dir}")
        return {"data": data3}

    fwd = jax.jit(lambda lam, mu, rho_, s, g: jax.vmap(
        lambda si, gi: st.propagate(cfg, lam, mu, rho_, si, gi))(s, g))

    t0 = time.perf_counter()
    data = jax.block_until_ready(fwd(med.lam, med.mu, med.rho, stf, geoms))
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = jax.block_until_ready(fwd(med.lam, med.mu, med.rho, stf, geoms))
    t_run = time.perf_counter() - t0

    cells = cfg.nz * cfg.nx * (cfg.nt - 1) * survey.n_shots
    gcell = cells / t_run / 1e9
    print(f"forward: {survey.n_shots} shots, grid "
          f"{cfg.nz}x{cfg.nx}, nt={cfg.nt}; compile {t_compile:.1f}s, "
          f"run {t_run:.3f}s, {gcell:.2f} GCell/s")
    if args.data_dir:
        sio.write_shots(args.data_dir, np.asarray(data))
        _export_config(args.data_dir, cfg, survey)
        print(f"wrote {survey.n_shots} shots to {args.data_dir}")
    return {"data": data, "compile_s": t_compile, "run_s": t_run,
            "GCell_per_s": gcell}


def _export_config(data_dir, cfg, survey):
    """Reference-schema para_file.json + survey_file.json next to the Shot
    binaries (fwi_utils.py:46-124's two-file side channel), so the data dir
    is directly consumable by tooling built for the reference."""
    from sep2023_tpu.config import sim_config_to_json
    sj = os.path.join(data_dir, "survey_file.json")
    survey.to_json(sj)
    sim_config_to_json(cfg, os.path.join(data_dir, "para_file.json"),
                       sj, data_dir_name=data_dir)


def _resolve_mesh(args, n_shots):
    """Default-on multi-device: a 1-D shot mesh over all visible devices
    (capped by --n-devices and the shot count), None for a single device."""
    n_dev = args.n_devices or jax.device_count()
    n_dev = min(n_dev, jax.device_count(), n_shots)
    if n_dev <= 1:
        return None
    return parallel.shot_mesh(n_dev)


def build_stage_loss(cfg, geoms, *, mesh, shot_chunk, channels,
                     objective="l2", filter_corners=None, per_trace=False,
                     dynamic_bandpass=False, window=None):
    """One loss builder for every (sharding x misfit x conditioning)
    combination — the per-stage closures of the multiscale loop all route
    through here (a regression in one path breaks all stages, loudly).

    Returns data_loss(lam, mu, rho, stf, obs, weights, *trace_aux).

    dynamic_bandpass: the band-pass response arrives as a per-shot
    (S, nfreq) trace_aux ARRAY instead of static filter_corners, so all
    multiscale stages share one compiled executable (the rows are identical
    copies; broadcasting over the shot axis keeps every loss builder's
    vmap/shard_map plumbing unchanged).
    """
    from sep2023_tpu.ops import misfit as mfops

    if (per_trace or objective != "l2" or filter_corners is not None
            or dynamic_bandpass or window is not None):
        # NB with per_trace the (S, R) win_start/win_end aux supersedes the
        # scalar window (the reference's per-trace entries override if_win
        # the same way, Src_Rec.cu:145-200)
        fn = mfops.make_preprocessed_l2(
            channels=tuple(channels), dt=cfg.dt,
            filter_corners=filter_corners, per_trace=per_trace,
            objective=objective, dynamic_bandpass=dynamic_bandpass,
            window=window)
    else:
        fn = None
    n_aux = (3 if per_trace else 0) + (1 if dynamic_bandpass else 0)

    if mesh is not None:
        base = parallel.make_sharded_misfit(
            cfg, mesh, channels=tuple(channels), misfit_fn=fn,
            n_trace_aux=n_aux, shot_chunk=shot_chunk)
    else:
        base = parallel.make_local_misfit(
            cfg, channels=tuple(channels), misfit_fn=fn,
            shot_chunk=shot_chunk)
    # close over the (small, int) geometry so every stage loss has the
    # (lam, mu, rho, stf, obs, weights, *aux) signature
    return lambda lam, mu, rho, stf, obs, w_, *aux: base(
        lam, mu, rho, stf, geoms, obs, w_, *aux)


def cmd_invert(args):
    dtype = jnp.float64 if args.x64 else jnp.float32
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    if args.para_json:
        # run straight off a reference-schema para_file.json
        # (Parameter.cpp:17-178): grid/time/PML settings, plus its
        # survey_fname and data_dir_name unless overridden on the CLI
        import json as _json

        from sep2023_tpu.config import sim_config_from_json
        pcfg = sim_config_from_json(args.para_json)
        with open(args.para_json) as fp:
            pd = _json.load(fp)
        args.nz = pcfg.nz - 2 * pcfg.npml
        args.nx = pcfg.nx - 2 * pcfg.npml
        args.dz, args.dx = pcfg.dz, pcfg.dx
        args.nt, args.dt, args.f0 = pcfg.nt, pcfg.dt, pcfg.f0
        args.npml = pcfg.npml
        if not args.survey_json and pd.get("survey_fname"):
            args.survey_json = pd["survey_fname"]
        if not args.data_dir and pd.get("data_dir_name"):
            args.data_dir = pd["data_dir_name"]
        if not args.bands and pd.get("filter"):
            # para `filter` [f0,f1,f2,f3] (Parameter.cpp:139-177): run one
            # band-passed stage with the file's corners
            args.bands = ",".join(str(float(v)) for v in pd["filter"])
            print(f"band-pass from para filter: {args.bands}")
        if args.win is None and pd.get("if_win") and "win_start" in pd:
            args.win = f"{pd['win_start']},{pd['win_end']}"
        print(f"para loaded from {args.para_json}: grid {pcfg.nz}x{pcfg.nx} "
              f"(padded), nt={pcfg.nt}, dt={pcfg.dt}, npml={pcfg.npml}")
    cfg, survey, geoms, stf = benchmark_problem(
        nz=args.nz, nx=args.nx, dz=args.dz, dx=args.dx, nt=args.nt,
        dt=args.dt, f0=args.f0, npml=args.npml, dtype=dtype,
        wavelet=args.wavelet)
    if args.survey_json:
        # acquisition (incl. per-trace windows/weights/src_weights) from a
        # reference-schema survey_file.json (Src_Rec.cu:20-282)
        survey = Survey.from_json(args.survey_json)
        geoms = parallel.survey_to_geoms(survey, cfg.npml, dtype=dtype)
        stf = jnp.broadcast_to(
            jnp.asarray(WAVELETS[args.wavelet](cfg.f0, cfg.nt, cfg.dt),
                        dtype), (survey.n_shots, cfg.nt))
        print(f"survey loaded from {args.survey_json}: "
              f"{survey.n_shots} shots, {survey.n_rec} receivers")
    # taper the wavelet ends exactly as the reference does on upload
    # (cuda_window(..., 0.001, ...), Src_Rec.cu:130-142)
    from sep2023_tpu.ops import signal as sg
    stf = stf * sg.taper_window(cfg.nt, cfg.dt, ratio=0.001, dtype=dtype)
    win_tuple = None
    if args.win:
        try:
            w0, w1 = (float(v) for v in args.win.split(","))
        except ValueError:
            raise SystemExit(f"--win must be 'start,end' samples, "
                             f"got {args.win!r}")
        win_tuple = (w0, w1)
        print(f"scalar taper window [{w0:g}, {w1:g}] samples (if_win, "
              "utilities.cu:790-884)")
    grid = cfg.grid
    os.makedirs(args.exp_name, exist_ok=True)

    # --- true and initial parameter sets per head -----------------------
    true_params, init_params, bounds, invert_names = \
        models.twin_experiment_setup(args.head, args.nz, args.nx,
                                     model=args.model)

    mask = H.default_mask(grid, freeze_top_rows=4)
    head = H.HEADS[args.head](grid, init_params, mask=mask, bounds=bounds)

    # --- mesh + chunk selection ----------------------------------------
    # resolved BEFORE data generation so twin obs and --src-update
    # synthetics run through the SAME mesh/chunking as the stage losses
    # (no unsharded all-shots vmap bypass)
    n_shots_orig = survey.n_shots
    mesh = _resolve_mesh(args, survey.n_shots)
    if args.shot_chunk < 0:
        # auto-size shots-in-flight per device so the boundary-strip
        # residuals fit device memory
        per_dev = -(-survey.n_shots // (mesh.devices.size if mesh else 1))
        isz = 8 if args.x64 else 4
        args.shot_chunk = parallel.auto_shot_chunk(cfg, per_dev,
                                                   itemsize=isz)
        if args.shot_chunk:
            gb = parallel.strip_bytes_per_shot(cfg, itemsize=isz) / 2 ** 30
            print(f"shot-chunk auto: {args.shot_chunk} shots/chunk "
                  f"(~{gb:.2f} GB strips/shot)")

    def _make_fwd():
        return jax.jit(parallel.make_forward(
            cfg, survey, mesh=mesh, shot_chunk=args.shot_chunk, dtype=dtype))

    fwd = _make_fwd()

    # --- observed data (twin experiment) --------------------------------
    lam_t_pad, mu_t_pad, rho_t_pad = head.apply(
        {k: jnp.asarray(v, dtype) for k, v in true_params.items()})
    vp_max_t = float(jnp.sqrt((lam_t_pad + 2 * mu_t_pad) / rho_t_pad).max())
    cfg.check_stability(vp_max_t)
    survey_tools.check_reach(cfg, survey, vp_max_t)
    st.medium.check_lambda(lam_t_pad)  # Model.cu:37-40
    # ... and the INITIAL model, the one a user actually supplies (the
    # common way to feed a bad vp/vs pair into the inversion)
    lam_0_pad, _, _ = head.apply(
        {k: jnp.asarray(v, dtype) for k, v in init_params.items()})
    st.medium.check_lambda(lam_0_pad)
    data_dir = args.data_dir or os.path.join(args.exp_name, "Data")
    if (not args.generate_data
            and os.path.exists(os.path.join(data_dir, "Shot_pr0.bin"))):
        # the reference's two-invocation workflow: observed data produced by
        # a prior --generate_data run (or by the reference engine itself —
        # the Shot_*.bin format is identical), loaded via the native reader
        print(f"loading observed data from {data_dir} ...")
        obs = jnp.asarray(sio.read_shots_survey(data_dir, survey, cfg.nt),
                          dtype)
    else:
        print("generating observed data ...")
        obs = jax.block_until_ready(
            fwd(lam_t_pad, mu_t_pad, rho_t_pad, stf)).astype(dtype)
    if args.generate_data:
        sio.write_shots_survey(data_dir, np.asarray(obs), survey)
        _export_config(data_dir, cfg, survey)
        print(f"data written to {data_dir}; exiting (--generate_data)")
        return

    # --- per-trace conditioning + per-shot weights (Src_Rec.cu:145-200) --
    if args.energy_weights and survey.trace_weights is None:
        survey.trace_weights = survey_tools.energy_trace_weights(
            np.asarray(obs[:, 3]))  # balance on the DAS channel
        print("per-trace energy weights computed from observed data "
              "(weightObsTraces, fwi_util.jl:196+)")
    # ragged spreads fold their live-trace mask into the per-trace weights
    # (padded replica traces must carry zero weight, Src_Rec.cu:87-116)
    tw_live = survey.live_trace_weights()
    per_trace = survey.win_start is not None or tw_live is not None
    S, R = survey.n_shots, survey.n_rec
    if per_trace:
        ws = (survey.win_start if survey.win_start is not None
              else np.zeros((S, R)))
        we = (survey.win_end if survey.win_end is not None
              else np.full((S, R), cfg.nt - 1))
        tw = tw_live if tw_live is not None else np.ones((S, R))
        trace_aux = (jnp.asarray(ws, dtype), jnp.asarray(we, dtype),
                     jnp.asarray(tw, dtype))
        print("per-trace windows/weights active"
              + (" (incl. ragged live mask)" if survey.ragged else ""))
    else:
        trace_aux = ()
    # per-shot src_weight follows the REFERENCE semantics: the weight
    # multiplies the residual (utilities.cu:838), so the misfit scales with
    # weight^2 — the loss builders take per-shot MISFIT factors, hence the
    # square here (pinned by test_cli.test_src_weight_semantics; PARITY §2.3)
    w = (jnp.asarray(survey.src_weights, dtype) ** 2
         if survey.src_weights is not None
         else jnp.ones((survey.n_shots,), dtype))

    bad = [c for c in args.channels if c not in st.CHANNELS]
    if bad:
        raise SystemExit(f"unknown channel(s) {bad}; choose from {st.CHANNELS}")

    # --- shot padding for the mesh --------------------------------------
    if mesh is not None:
        n_dev = mesh.devices.size
        stf, geoms, obs, w, trace_aux = parallel.pad_shots(
            stf, geoms, obs, w, n_dev, trace_aux)
        # make_forward and the band-pass aux take their shot count from
        # the survey — keep it in lockstep with the padded arrays
        survey = parallel.pad_survey(survey, n_dev)
        print(f"multi-device: {n_dev}-device shot mesh "
              f"({stf.shape[0]} shots incl. padding)")
        # later synthetics (--src-update, scratch dumps) run on the PADDED
        # shot set — rebuild the shared forward on it
        fwd = _make_fwd()

    def make_data_loss(corners, dynamic=False):
        return build_stage_loss(
            cfg, geoms, mesh=mesh,
            shot_chunk=args.shot_chunk, channels=args.channels,
            objective=args.misfit, filter_corners=corners,
            per_trace=per_trace, dynamic_bandpass=dynamic,
            window=win_tuple)

    # observed data and wavelets are threaded as ARGUMENTS (aux), not
    # closures: closed-over device arrays become compiled-in constants
    # (duplicated in device memory and embedded in the compiled program)
    def make_param_loss(data_loss):
        def loss(params, stf_, obs_, *bp_aux):
            stf_used = params["stf"] if "stf" in params else stf_
            full = dict(init_params)
            full.update({k: v for k, v in params.items() if k != "stf"})
            lam, mu, rho = head.apply(
                {k: jnp.asarray(v, dtype) for k, v in full.items()})
            return data_loss(lam, mu, rho, stf_used, obs_, w, *trace_aux,
                             *bp_aux)
        return loss

    start_params = {k: init_params[k] for k in invert_names}
    if args.invert_stf:
        # joint source-model inversion: the d_stf gradients the reference
        # computes but never optimizes over (Torch_Fwi.cpp:102 returns
        # grad_stf; no driver uses it) become first-class parameters
        start_params["stf"] = np.asarray(stf)
        print("joint source inversion: stf added to the parameter set")
    if args.resume:
        # resume from the latest snapshot (the reference resumes manually
        # from its per-iteration .mat dumps, Main-001:137-154)
        import glob
        snaps = sorted(glob.glob(os.path.join(args.exp_name, "Results",
                                              "model_*.npz")))
        if snaps:
            with np.load(snaps[-1]) as z:
                for k in list(start_params):
                    if k in z.files:
                        start_params[k] = z[k]
            print(f"resumed from {snaps[-1]}")

    # multiscale frequency continuation: the reference's per-stage band-pass
    # list (Main-001:46-51).  --bands "f0,f1,f2,f3;..." configures the
    # corner schedule (stage count = list length); --multiscale alone keeps
    # the classic 2.5..7.5 Hz ramp; a para-JSON `filter` entry becomes a
    # single-stage band.
    if args.bands:
        try:
            stages = [tuple(float(v) for v in b.split(","))
                      for b in args.bands.split(";") if b.strip()]
        except ValueError:
            raise SystemExit(f"--bands must be 'f0,f1,f2,f3;...', "
                             f"got {args.bands!r}")
        if not stages or any(len(b) != 4 for b in stages):
            raise SystemExit("each --bands stage needs exactly 4 corner "
                             "frequencies f0,f1,f2,f3 (Main-001:46-51)")
        args.multiscale = True
    elif args.multiscale:
        stages = [(0.0, 1e-4, 2.0, hf) for hf in (2.5, 3.5, 4.5, 5.5, 6.5,
                                                  7.5)]
    else:
        stages = [None]
    iters_per_stage = max(1, args.niter // len(stages))
    iter_offset = 0
    eval_seconds = []   # host wall time of every scipy-path evaluation

    def current_stf():
        return (jnp.asarray(start_params["stf"], dtype)
                if "stf" in start_params else stf)

    # multiscale: ONE loss with the band-pass response as a runtime array
    # (per-shot broadcast), jitted once — stages reuse the same executable
    # instead of paying a cold compile each
    if args.multiscale:
        from sep2023_tpu.ops import signal as sg
        shared_loss = make_param_loss(make_data_loss(None, dynamic=True))
        shared_vg = jax.jit(jax.value_and_grad(shared_loss))

        def stage_bp_aux(corners):
            H = np.asarray(sg.bandpass_amplitude(cfg.nt, cfg.dt, *corners))
            return (jnp.asarray(np.broadcast_to(
                H, (survey.n_shots, H.shape[0])), dtype),)

    for istage, corners in enumerate(stages):
        if args.src_update and not args.invert_stf:
            # in-loop spectral (Wiener) source re-estimation from the
            # CURRENT model's synthetics at the start of every stage — the
            # reference's if_src_update workflow (source_update,
            # utilities.cu:905-978), not a one-shot pre-correction
            from sep2023_tpu.ops import signal as sg
            full = dict(init_params)
            full.update({k: v for k, v in start_params.items()
                         if k != "stf"})
            lam_c, mu_c, rho_c = head.apply(
                {k: jnp.asarray(v, dtype) for k, v in full.items()})
            syn_c = fwd(lam_c, mu_c, rho_c, stf)

            def upd(o, s_, w_):
                W = sg.source_update_filter(o[3], s_[3])
                return sg.apply_source_filter(w_, W)

            stf = jax.vmap(upd)(obs, syn_c, stf)
            print(f"stage {istage + 1}: source wavelets re-estimated "
                  "(Wiener spectral correction)")

        if args.multiscale:
            stage_loss, stage_vg = shared_loss, shared_vg
            bp_aux = stage_bp_aux(corners)
        else:
            stage_loss = make_param_loss(make_data_loss(corners))
            stage_vg, bp_aux = None, ()
        if corners is not None:
            print(f"multiscale stage {istage + 1}/{len(stages)}: "
                  f"band {corners}")

        stage_bounds = ({k: bounds[k] for k in invert_names}
                        if bounds else None)
        if args.optimizer == "ondevice":
            print(f"on-device L-BFGS: {iters_per_stage} iterations, "
                  f"head={args.head}")
            params_out, hist = optimize.lbfgs_on_device(
                stage_loss, start_params, iters_per_stage,
                bounds=stage_bounds, aux=(stf, obs, *bp_aux))
            rdir = os.path.join(args.exp_name, "Results")
            os.makedirs(rdir, exist_ok=True)
            with open(os.path.join(rdir, "loss.txt"), "a") as fp:
                for j, v in enumerate(hist):
                    fp.write(f"{iter_offset + j} {v}\n")
            iter_offset += len(hist)
            start_params = {k: np.asarray(v) for k, v in params_out.items()}
            np.savez(os.path.join(rdir, f"model_{iter_offset:04d}.npz"),
                     **start_params)
            print(f"stage misfit {hist[-1]:.6e} after {len(hist)} iterations")
        else:
            obj = optimize.ScipyObjective(stage_loss, start_params,
                                          bounds=stage_bounds,
                                          aux=(stf, obs, *bp_aux),
                                          value_and_grad_fn=stage_vg)
            logger = optimize.InversionLogger(
                os.path.join(args.exp_name, "Results"), obj,
                start_iter=iter_offset, save_mat=args.save_mat)
            print(f"L-BFGS-B: {iters_per_stage} iterations, head={args.head}")
            res = optimize.lbfgsb(obj, maxiter=iters_per_stage,
                                  callback=logger)
            iter_offset = logger.it
            start_params = {k: np.asarray(v)
                            for k, v in obj.unpack(res.x).items()}
            eval_seconds += obj.eval_seconds
            print(f"stage misfit {res.fun:.6e} after {res.nit} iterations "
                  f"({obj.n_evals} evaluations; first "
                  f"{obj.eval_seconds[0]:.2f}s incl. compile)")

    if args.scratch_dir:
        # final synthetics / residuals / conditioned obs, the reference's
        # if_save_scratch dumps (libCUFD.cu:732-752)
        full = dict(init_params)
        full.update({k: v for k, v in start_params.items() if k != "stf"})
        lam, mu, rho = head.apply(
            {k: jnp.asarray(v, dtype) for k, v in full.items()})
        syn = np.asarray(fwd(lam, mu, rho, current_stf()))
        res_d = np.array(np.asarray(obs) - syn)
        res_d[..., 0] = 0.0
        os.makedirs(args.scratch_dir, exist_ok=True)
        n0 = n_shots_orig  # drop mesh-padding replicas from the dumps
        sio.write_shots_survey(os.path.join(args.scratch_dir, "Syn"),
                               syn[:n0], survey)
        sio.write_shots_survey(os.path.join(args.scratch_dir, "Residual"),
                               res_d[:n0], survey)
        sio.write_shots_survey(os.path.join(args.scratch_dir, "CondObs"),
                               np.asarray(obs)[:n0], survey)
        print(f"scratch dumps written to {args.scratch_dir}")
    return {"eval_seconds": eval_seconds,
            "n_devices": 1 if mesh is None else int(mesh.devices.size)}


def cmd_rtm(args):
    """RTM driver: the standalone CLI's adjoint imaging flow (main.cu:322+).

    A twin experiment for imaging: observed data from a layered true model,
    migrated with a smooth background.  --physics elastic uses the zero-lag
    Vp condition (image_vel.cu via imaging.rtm_image); --physics acoustic
    with --time-derivative uses the p-dot condition (image_vel_time.cu).
    Writes the stacked image (and an illumination-compensated copy) to
    --out as .npz.
    """
    from sep2023_tpu import imaging

    dtype = jnp.float32
    if args.x64:
        jax.config.update("jax_enable_x64", True)
        dtype = jnp.float64
    # classic surface acquisition (shots and receivers near z=0, reflections
    # recorded from above) — the DAS bottom-row benchmark survey is an FWI
    # geometry, not a migration one
    cfg = st.SimConfig(nz=args.nz + 2 * args.npml, nx=args.nx + 2 * args.npml,
                       dz=args.dz, dx=args.dx, nt=args.nt, dt=args.dt,
                       f0=args.f0, npml=args.npml)
    src_x = np.arange(10, args.nx - 10, 10)
    survey = Survey(src_z=np.full(len(src_x), 2), src_x=src_x,
                    rec_z=np.full(args.nx - 20, 2),
                    rec_x=np.arange(10, args.nx - 10))
    geoms = parallel.survey_to_geoms(survey, cfg.npml, dtype=dtype)
    stf = jnp.broadcast_to(
        jnp.asarray(WAVELETS[args.wavelet](cfg.f0, cfg.nt, cfg.dt), dtype),
        (survey.n_shots, cfg.nt))

    # layered true model: a reflector at 2/3 depth the smooth background
    # lacks; the image must light it back up
    z_refl = int(args.nz * 2 / 3)
    vp_t = models.layered(args.nz, args.nx, [z_refl], [3000.0, 3450.0])
    vp_bg = models.smooth(vp_t, sigma=12.0)
    pad = lambda m: jnp.asarray(st.medium.pad_model_np(m, cfg.npml), dtype)
    rho_np = models.constant(args.nz, args.nx, 2400.0)
    rho = pad(rho_np)
    cfg.check_stability(float(vp_t.max()))
    survey_tools.check_reach(cfg, survey, float(vp_t.max()))

    if args.physics == "acoustic":
        from sep2023_tpu.acoustic import AcGeom, propagate_acoustic
        ac = AcGeom(src_z=geoms.src_z, src_x=geoms.src_x,
                    rec_z=geoms.rec_z, rec_x=geoms.rec_x)
        vpt, vpb = pad(vp_t), pad(vp_bg)

        @jax.jit
        def image_all(vpt_, vpb_):
            def per_shot(stf1, g):
                obs = propagate_acoustic(cfg, rho * vpt_ ** 2, rho, stf1, g)
                syn = propagate_acoustic(cfg, rho * vpb_ ** 2, rho, stf1, g)
                from sep2023_tpu.acoustic import rtm_image_time
                return rtm_image_time(cfg, vpb_, rho, stf1, g, obs - syn,
                                      return_illum=True)

            im, il = jax.vmap(per_shot)(stf, ac)
            return jnp.sum(im, axis=0), jnp.sum(il, axis=0)

        img, illum = image_all(vpt, vpb)
        condition = "time-derivative (image_vel_time.cu)"
    else:
        vpt, vpb = pad(vp_t), pad(vp_bg)
        vst, vsb = vpt / jnp.sqrt(2.2), vpb / jnp.sqrt(2.2)
        @jax.jit
        def image_all(vpt_, vpb_, vst_, vsb_):
            def per_shot(stf1, g):
                lam_t = (vpt_ ** 2 - 2 * vst_ ** 2) * rho
                obs = st.propagate(cfg, lam_t, vst_ ** 2 * rho, rho,
                                   stf1, g)
                return imaging.rtm_image(cfg, vpb_, vsb_, rho, stf1, g,
                                         obs, channels=tuple(args.channels))

            return jnp.sum(jax.vmap(per_shot)(stf, geoms), axis=0)

        img = image_all(vpt, vpb, vst, vsb)
        # per-cell source-energy illumination for the compensated product
        lam_b = (vpb ** 2 - 2.0 * vsb ** 2) * rho
        mu_b = vsb ** 2 * rho

        @jax.jit
        def illum_all():
            return jnp.sum(jax.vmap(
                lambda s, g: imaging.source_illumination(
                    cfg, lam_b, mu_b, rho, s, g))(stf, geoms), axis=0)

        illum = illum_all()
        condition = "zero-lag (image_vel.cu)"

    img = np.asarray(img)
    assert np.isfinite(img).all()
    # acquisition mute: the raw adjoint image carries the usual near-source/
    # receiver imprint; zero the shallow rows before diagnostics (standard
    # migration practice)
    muted = img.copy()
    mute_to = cfg.npml + 2 + max(6, int(round(3000.0 / cfg.f0 / cfg.dz / 2)))
    muted[:mute_to, :] = 0.0
    zi, xi = cfg.grid.interior_slices()
    prof = np.abs(muted[zi, xi]).mean(axis=1)
    print(f"rtm ({args.physics}, {condition}): {survey.n_shots} shots, "
          f"reflector at z={z_refl}, muted-image peak at "
          f"z={int(prof.argmax())}")
    out = args.out or "rtm_image.npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(out, image=img, image_muted=muted,
             illumination=np.asarray(illum),
             image_compensated=np.asarray(
                 imaging.illumination_compensate(jnp.asarray(img),
                                                 jnp.asarray(illum))),
             vp_true=vp_t, vp_background=vp_bg, z_reflector=z_refl)
    print(f"wrote {out}")


def cmd_bench(args):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache():
    """Persistent XLA compilation cache, so repeat invocations of the same
    workload skip the cold compile of the 1501-step scan.  When
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other path
    is set here; otherwise the cache lives at one fixed directory inside
    the checkout (CACHE_DIR, git-ignored) — the path is part of the cache
    key, so a moving directory would never hit.  Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path


def main(argv=None):
    enable_compile_cache()
    p = argparse.ArgumentParser(prog="sep2023_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--nz", type=int, default=101)
    common.add_argument("--nx", type=int, default=201)
    common.add_argument("--dz", type=float, default=20.0)
    common.add_argument("--dx", type=float, default=20.0)
    common.add_argument("--nt", type=int, default=1501)
    common.add_argument("--dt", type=float, default=0.002)
    common.add_argument("--f0", type=float, default=10.0)
    common.add_argument("--npml", type=int, default=32)
    common.add_argument("--wavelet", default="ricker",
                        choices=("ricker", "ricker_int", "klauder"))

    f = sub.add_parser("forward", parents=[common])
    f.add_argument("--data-dir", default="")
    f.add_argument("--physics", default="elastic",
                   choices=("elastic", "acoustic"))
    f.set_defaults(fn=cmd_forward)

    i = sub.add_parser("invert", parents=[common])
    i.add_argument("--head", default="vp_vs_rho", choices=sorted(H.HEADS))
    i.add_argument("--data-dir", default="",
                   help="observed-data directory (Shot_*.bin); generated "
                        "in-process when absent")
    i.add_argument("--exp-name", default="scratch/exp")
    i.add_argument("--niter", type=int, default=20)
    i.add_argument("--channels", nargs="+", default=["ett"])
    i.add_argument("--generate_data", action="store_true")
    i.add_argument("--x64", action="store_true")
    i.add_argument("--n-devices", type=int, default=0,
                   help="devices for shot sharding (0 = all visible; the "
                        "reference's --ngpu, Torch_Fwi.cpp:71-95)")
    i.add_argument("--misfit", default="l2", choices=("l2", "xcorr"),
                   help="objective: L2 (libCUFD.cu:427) or normalized "
                        "cross-correlation (if_cross_misfit, "
                        "utilities.cu:1011-1113)")
    i.add_argument("--src-update", action="store_true",
                   help="re-estimate source wavelets (Wiener spectral "
                        "correction) from the current model at every stage "
                        "(if_src_update, utilities.cu:905-978)")
    i.add_argument("--invert-stf", action="store_true",
                   help="joint source-model inversion: optimize the source "
                        "wavelets via their adjoint gradient")
    i.add_argument("--para-json", default="",
                   help="run from a reference-schema para_file.json "
                        "(grid/time/PML settings + survey_fname + "
                        "data_dir_name, Parameter.cpp:17-178)")
    i.add_argument("--survey-json", default="",
                   help="load acquisition (incl. per-trace win/weights) "
                        "from a reference-schema survey_file.json")
    i.add_argument("--energy-weights", action="store_true",
                   help="balance traces by 1/energy computed from the "
                        "observed data (weightObsTraces, fwi_util.jl:196+)")
    i.add_argument("--multiscale", action="store_true",
                   help="frequency-continuation over the reference's "
                        "band-pass stages (Main-001:46-51)")
    i.add_argument("--bands", default="",
                   help="custom multiscale schedule "
                        "'f0,f1,f2,f3;f0,f1,f2,f3;...' — one band-pass "
                        "stage per ;-separated corner quadruple "
                        "(Main-001:46-51); implies --multiscale")
    i.add_argument("--win", default=None,
                   help="scalar taper window 'start,end' in samples applied "
                        "to obs+syn (the para if_win flag, "
                        "utilities.cu:790-884)")
    i.add_argument("--resume", action="store_true",
                   help="resume from the latest Results/model_*.npz")
    i.add_argument("--save-mat", action="store_true",
                   help="also write reference-format .mat snapshots per "
                        "iteration (Main-001:144-150)")
    i.add_argument("--model", default="anomaly",
                   choices=("anomaly", "rock"),
                   help="'rock' + a velocity head = Main-005 (NO-PCS) flow")
    i.add_argument("--optimizer", default="scipy",
                   choices=("scipy", "ondevice"),
                   help="scipy L-BFGS-B (host bridge) or on-device "
                        "projected L-BFGS (optax, no host round-trips)")
    i.add_argument("--scratch-dir", default="",
                   help="write final syn/residual/obs shot dumps "
                        "(if_save_scratch, libCUFD.cu:732-752)")
    i.add_argument("--shot-chunk", type=int, default=-1,
                   help="shots per gradient chunk per device (bounds "
                        "boundary-strip memory; -1 = auto-size from the "
                        "grid so the strips fit device memory, 0 = "
                        "unchunked)")
    i.set_defaults(fn=cmd_invert)

    r = sub.add_parser("rtm", parents=[common])
    r.add_argument("--physics", default="acoustic",
                   choices=("elastic", "acoustic"),
                   help="acoustic = the reference's main.cu RTM path with "
                        "the image_vel_time.cu condition; elastic = zero-lag "
                        "Vp condition via the FWI gradient machinery")
    r.add_argument("--channels", nargs="+", default=["pr", "vx", "vz"],
                   help="elastic imaging channels")
    r.add_argument("--out", default="",
                   help="output .npz path (default rtm_image.npz)")
    r.add_argument("--x64", action="store_true")
    r.set_defaults(fn=cmd_rtm)

    b = sub.add_parser("bench")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
