"""Shot-level data parallelism over a device mesh.

The reference's only scaling axis is shots across GPUs: an OpenMP thread per
GPU over contiguous shot chunks with a host-side gradient sum
(`Torch_Fwi.cpp:71-101`).  The JAX expression is:

  * within a device:  `vmap` over shots (propagator.propagate_shots)
  * across devices:   `shard_map` over the 'shot' axis of a
                      `jax.sharding.Mesh` with a `psum` reducing the misfit
                      (and therefore — via AD — the model gradient) over the
                      device interconnect.

The model (lam, mu, rho) is replicated; stf / geometry / observed data are
sharded along the shot axis.  `jax.grad` through the shard-mapped loss
automatically inserts the gradient all-reduce that `Torch_Fwi.cpp:96-101`
performs on the host.

If the shot count does not divide the mesh, pad with dummy shots carrying
shot_weight = 0 (`pad_shots`).

All loss builders share the signature
    loss(lam, mu, rho, stf, [geoms,] obs, weights, *trace_aux)
where `trace_aux` are optional per-shot arrays (leading S axis) vmapped
alongside obs/syn and passed positionally to `misfit_fn` — the vehicle for
the reference's per-trace win_start/win_end/trace-weight conditioning
(`Src_Rec.cu:145-200`).  `weights` is the per-shot weight vector (the
survey's src_weight entries; ones by default).
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from sep2023_tpu.config import SimConfig, Survey
from sep2023_tpu.ops import misfit as mf
from sep2023_tpu.propagator import ShotGeom, propagate


def shot_mesh(n_devices: Optional[int] = None, axis: str = "shot") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def survey_to_geoms(survey: Survey, npml: int, dtype=jnp.float32) -> ShotGeom:
    """Batched ShotGeom (leading shot axis) with the npml offset applied
    (Src_Rec.cu:87-116 does the same when parsing the survey JSON).  Ragged
    surveys carry their per-shot padded (S, R_max) spreads straight through
    (padding replicates real receivers; zero its weights via
    `survey.live_trace_weights()`)."""
    S = survey.n_shots
    return ShotGeom(
        src_z=jnp.asarray(survey.src_z + npml, jnp.int32),
        src_x=jnp.asarray(survey.src_x + npml, jnp.int32),
        rxz=jnp.asarray(survey.src_rxz, dtype),
        rec_z=jnp.broadcast_to(jnp.asarray(survey.rec_z + npml, jnp.int32),
                               (S, survey.n_rec)),
        rec_x=jnp.broadcast_to(jnp.asarray(survey.rec_x + npml, jnp.int32),
                               (S, survey.n_rec)),
    )


def pad_shots(stf, geoms: ShotGeom, obs, weights, n_devices: int,
              trace_aux=()):
    """Pad the shot axis to a multiple of n_devices with zero-weight shots."""
    S = stf.shape[0]
    rem = (-S) % n_devices
    if rem == 0:
        return stf, geoms, obs, weights, trace_aux
    pad = lambda a: jnp.concatenate(
        [a, jnp.repeat(a[-1:], rem, axis=0)], axis=0)
    w = jnp.concatenate([weights, jnp.zeros((rem,), weights.dtype)])
    return (pad(stf), jax.tree.map(pad, geoms), pad(obs), w,
            jax.tree.map(pad, trace_aux))


def pad_survey(survey: Survey, n_devices: int) -> Survey:
    """Replicate the last shot's source entries so the survey's shot count
    matches `pad_shots`' padded arrays (`make_forward` and the multiscale
    band-pass aux derive their shot count from the survey).  Ragged surveys
    replicate the last shot's receiver rows / live mask too."""
    S = survey.n_shots
    rem = (-S) % n_devices
    if rem == 0:
        return survey
    rep = lambda a: np.concatenate([a, np.repeat(a[-1:], rem, axis=0)])
    ragged = survey.ragged
    return Survey(src_z=rep(survey.src_z), src_x=rep(survey.src_x),
                  rec_z=rep(survey.rec_z) if ragged else survey.rec_z,
                  rec_x=rep(survey.rec_x) if ragged else survey.rec_x,
                  src_rxz=rep(survey.src_rxz),
                  rec_live=(rep(survey.rec_live)
                            if survey.rec_live is not None else None))


def default_shot_misfit(channels: Sequence[str] = ("ett",)):
    return lambda o, s: mf.l2_misfit(o, s, channels=channels)


def strip_bytes_per_shot(cfg: SimConfig, acoustic: bool = False,
                         itemsize: int = 4) -> int:
    """Boundary-strip residual bytes one shot's gradient holds in device
    memory: (nt-1) steps of the flat top/bottom/left/right strips
    (`propagator._extract_strips`, n_bnd_layers deep) of the 5 elastic or
    3 acoustic fields.  ~1.15 GB/shot at a Marmousi-style 814x2064/nt=2001,
    the term that makes an unchunked many-shot gradient exceed device
    memory.  itemsize: 8 for x64 validation runs."""
    n_fields = 3 if acoustic else 5
    per_field = 2 * cfg.n_bnd_layers * (cfg.nz + cfg.nx)
    return (cfg.nt - 1) * n_fields * per_field * itemsize


def hbm_budget_bytes(device=None, fallback: int = 6 << 30) -> int:
    """Boundary-strip memory budget for `auto_shot_chunk`: 3/8 of the
    device's reported `bytes_limit` (the remaining 5/8 covers model and
    gradient planes, recordings and XLA temporaries).  XLA:CPU reports no
    memory stats, so a CPU device gets `fallback`; an accelerator that
    reports no limit raises rather than guessing."""
    dev = device if device is not None else jax.devices()[0]
    limit = int((dev.memory_stats() or {}).get("bytes_limit", 0))
    if limit > 0:
        return max(1 << 30, (limit * 3) // 8)
    if dev.platform == "cpu":
        return fallback
    raise RuntimeError(f"{dev.platform} device reports no bytes_limit; "
                       "pass budget_bytes to auto_shot_chunk")


def auto_shot_chunk(cfg: SimConfig, n_shots: int, *, acoustic: bool = False,
                    budget_bytes: int | None = None, itemsize: int = 4,
                    n_devices: int = 1) -> int:
    """Default shots-in-flight bound for gradient evaluations: the largest
    chunk whose strip residuals fit the memory budget (`hbm_budget_bytes()`
    when budget_bytes is None), or 0 (unchunked) when every shot fits.
    `n_shots` is the GLOBAL shot count; under shot data-parallelism pass
    `n_devices` so the bound applies to each device's ceil(S/D) local
    shots (the CLI divides before calling; both routes agree).  Chunking
    is close to free since the gradient accumulator replaced the remat
    re-forward, so the budget errs toward safety."""
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes()
    local_shots = -(-max(1, n_shots) // max(1, n_devices))
    per_shot = strip_bytes_per_shot(cfg, acoustic, itemsize)
    if per_shot * local_shots <= budget_bytes:
        return 0
    return max(1, min(local_shots, int(budget_bytes // per_shot)))


def _split_shots(tree, *, S: int, used: int, n_full: int, chunk: int):
    """THE chunking split, shared by the accumulator, the remat oracle and
    the forward map (one definition so the equality tests compare the same
    semantics): a leading-S pytree -> (head reshaped to (n_full, chunk,
    ...), ragged tail or None)."""
    resh = lambda a: a[:used].reshape(n_full, chunk, *a.shape[1:])
    head = jax.tree.map(resh, tree)
    if used == S:
        return head, None
    return head, jax.tree.map(lambda a: a[used:], tree)


def _aval(a):
    """Static (shape, dtype) snapshot of a primal — captured while the
    tracer is LIVE so the custom-vjp bwd never touches escaped tracers."""
    return jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a))


def _zero_ct(aval):
    """Zero cotangent for a ShapeDtypeStruct: float0 for integer leaves."""
    if jnp.issubdtype(aval.dtype, jnp.inexact):
        return jnp.zeros(aval.shape, aval.dtype)
    return np.zeros(aval.shape, jax.dtypes.float0)


def _chunked_sum(chunk_loss, model, stf, rest, weights, shot_chunk: int):
    """Sum chunk_loss(model, stf_chunk, rest_chunk, w_chunk) over contiguous
    shot chunks via `lax.map` (jaxpr size stays flat in S — the reference's
    OpenMP chunk loop, Torch_Fwi.cpp:59-95, without the unrolled-Python
    compile blowup).

    With more than one chunk the differentiated path is a custom-vjp
    GRADIENT ACCUMULATOR: each `lax.map` body evaluates one chunk's value
    AND its (model, stf) cotangents together (per-chunk jax.vjp), so only
    one chunk's boundary-strip residuals are ever live — the peak memory of
    the old jax.checkpoint rematerialization WITHOUT its extra forward pass
    per chunk (a chunked gradient is forward + reconstruction + adjoint =
    3 wavefield passes, not 4).

    Differentiation contract (chunked path): gradients flow to `model` and
    `stf` — exactly the set the reference's native op emits ({misfit,
    gLambda, gMu, gDen, gStf}, Torch_Fwi.cpp:102-103).  `rest` (geometry,
    observed data, per-trace conditioning) and `weights` are data: asking
    for their gradients returns ZEROS (test-pinned) — set
    SEP2023_TPU_CHUNK_REMAT=1 (or shot_chunk=0) when a workflow genuinely
    needs data-side cotangents.  The single-chunk path is a plain call
    (fully differentiable).

    A ragged tail runs as ONE smaller trailing evaluation (not zero-weight
    replica padding): a 31-shot / chunk-6 gradient does exactly 31
    propagations.

    SEP2023_TPU_CHUNK_REMAT=1 selects the previous jax.checkpoint
    rematerialization instead (the fully-differentiable oracle the
    accumulator is equality-tested against, and the baseline for the
    measured speedup).  The oracle is also the path to use for
    FORWARD-mode AD (jvp/jacfwd/Hessian-vector products): custom_vjp
    functions reject jvp, so the accumulator supports reverse mode
    only."""
    S = weights.shape[0]
    chunk = shot_chunk if shot_chunk and shot_chunk < S else S
    if chunk == S:
        return chunk_loss(model, stf, rest, weights)
    n_full = S // chunk
    used = n_full * chunk
    split = functools.partial(_split_shots, S=S, used=used, n_full=n_full,
                              chunk=chunk)

    if os.environ.get("SEP2023_TPU_CHUNK_REMAT"):
        remat_loss = jax.checkpoint(chunk_loss)
        head, tail = split((stf, rest, weights))
        total = jnp.sum(jax.lax.map(
            lambda xs: remat_loss(model, *xs), head))
        if tail is not None:
            total = total + remat_loss(model, *tail)
        return total

    # static shape/dtype snapshots for the bwd zero cotangents (the bwd
    # must not reference the enclosing trace's tracers — they are dead by
    # the time it runs when the CALLER differentiates w.r.t. rest/weights)
    rest_avals = jax.tree.map(_aval, rest)
    w_aval = _aval(weights)

    @jax.custom_vjp
    def total(model, stf, rest, weights):
        head, tail = split((stf, rest, weights))
        t = jnp.sum(jax.lax.map(lambda xs: chunk_loss(model, *xs), head))
        if tail is not None:
            t = t + chunk_loss(model, *tail)
        return t

    def total_fwd(model, stf, rest, weights):
        head, tail = split((stf, rest, weights))

        def eval_vg(stf_c, rest_c, w_c):
            val, pull = jax.vjp(
                lambda m, s: chunk_loss(m, s, rest_c, w_c), model, stf_c)
            gm, gs = pull(jnp.ones((), val.dtype))
            return val, gm, gs

        vals, gms, gstfs = jax.lax.map(lambda xs: eval_vg(*xs), head)
        t = jnp.sum(vals)
        gm = jax.tree.map(lambda a: jnp.sum(a, axis=0), gms)
        gstf = gstfs.reshape(used, *stf.shape[1:])
        if tail is not None:
            val_t, gm_t, gs_t = eval_vg(*tail)
            t = t + val_t
            gm = jax.tree.map(jnp.add, gm, gm_t)
            gstf = jnp.concatenate([gstf, gs_t], axis=0)
        return t, (gm, gstf)

    def total_bwd(res, ct):
        gm, gstf = res
        return (jax.tree.map(lambda a: ct * a, gm), ct * gstf,
                jax.tree.map(_zero_ct, rest_avals), _zero_ct(w_aval))

    total.defvjp(total_fwd, total_bwd)
    return total(model, stf, rest, weights)


def make_local_misfit(cfg: SimConfig, channels: Sequence[str] = ("ett",),
                      shot_chunk: int = 0, misfit_fn=None):
    """Single-device (vmap only) loss:
    loss(lam, mu, rho, stf, geoms, obs, weights, *trace_aux).

    misfit_fn(obs_shot, syn_shot, *trace_aux_shot) overrides the per-shot
    objective (e.g. ops.misfit.make_preprocessed_l2 for windowed / filtered /
    per-trace-conditioned data); the adjoint source flows back into the
    propagator as the data cotangent either way."""
    fn = misfit_fn or default_shot_misfit(channels)

    def loss(lam, mu, rho, stf, geoms, obs, weights, *trace_aux):
        def chunk_loss(model, stf_c, rest_c, w_c):
            lam_, mu_, rho_ = model
            geoms_c, obs_c, aux_c = rest_c
            syn = jax.vmap(lambda s, g: propagate(cfg, lam_, mu_, rho_,
                                                  s, g))(stf_c, geoms_c)
            per_shot = jax.vmap(fn)(obs_c, syn, *aux_c)
            return jnp.sum(w_c * per_shot)

        return _chunked_sum(chunk_loss, (lam, mu, rho), stf,
                            (geoms, obs, tuple(trace_aux)), weights,
                            shot_chunk)

    return loss


def make_sharded_misfit(cfg: SimConfig, mesh: Mesh,
                        channels: Sequence[str] = ("ett",), axis: str = "shot",
                        misfit_fn=None, n_trace_aux: int = 0,
                        shot_chunk: int = 0):
    """Build  loss(lam, mu, rho, stf, geoms, obs, weights, *trace_aux) ->
    scalar  with the shot axis sharded over `mesh` and the misfit
    psum-reduced over the mesh.

    Differentiable: jax.grad(loss) yields replicated (all-reduced) model
    gradients — the in-graph `Torch_Fwi.cpp:96-101`.  The shot count must
    be a multiple of the mesh size (use `pad_shots`)."""
    geom_spec = ShotGeom(src_z=P(axis), src_x=P(axis), rxz=P(axis),
                         rec_z=P(axis), rec_x=P(axis))
    local = make_local_misfit(cfg, channels=channels, shot_chunk=shot_chunk,
                              misfit_fn=misfit_fn)

    # check_vma=False: the propagator's scan starts from a constant zero
    # state that only becomes shot-varying after the first source injection,
    # which the varying-manual-axes checker would reject.
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), geom_spec, P(axis), P(axis))
        + (P(axis),) * n_trace_aux,
        out_specs=P(), check_vma=False)
    def loss(lam, mu, rho, stf, geoms, obs, weights, *trace_aux):
        return jax.lax.psum(
            local(lam, mu, rho, stf, geoms, obs, weights, *trace_aux), axis)

    return loss


def _chunked_map(fn, shot_args, S: int, shot_chunk: int):
    """Map fn over contiguous shot chunks and concatenate the (leading-S)
    outputs; ragged tails run as one smaller trailing call (peak memory
    bounded by shot_chunk, no replica waste)."""
    chunk = shot_chunk if shot_chunk and shot_chunk < S else S
    if chunk == S:
        return fn(shot_args)
    n_full = S // chunk
    used = n_full * chunk
    head, tail = _split_shots(shot_args, S=S, used=used, n_full=n_full,
                              chunk=chunk)
    out = jax.lax.map(fn, head)
    out = out.reshape(used, *out.shape[2:])
    if tail is not None:
        out = jnp.concatenate([out, fn(tail)], axis=0)
    return out


def make_forward(cfg: SimConfig, survey: Survey, *,
                 mesh: Optional[Mesh] = None, shot_chunk: int = 0,
                 axis: str = "shot", dtype=jnp.float32):
    """Observed-data generation forward through the SAME mesh + chunking
    selection as the stage losses (build_stage_loss): twin-experiment obs
    and `--src-update` synthetics do not bypass the production path with an
    unsharded all-shots vmap.

    Returns fwd(lam, mu, rho, stf) -> (S, 4, R, nt) float32-or-dtype.
    Ragged surveys come back on their padded (S, R_max) spreads."""
    geoms = survey_to_geoms(survey, cfg.npml, dtype=dtype)
    S = survey.n_shots
    n_dev = 1 if mesh is None else int(mesh.devices.size)

    def fwd(lam, mu, rho, stf):
        def chunk_fn(model, args):
            lam_, mu_, rho_ = model
            stf_c, g_c = args
            return jax.vmap(lambda s, g: propagate(cfg, lam_, mu_, rho_,
                                                   s, g))(stf_c, g_c)

        model = (lam, mu, rho)
        shot_args = (stf, geoms)
        if mesh is None:
            return _chunked_map(functools.partial(chunk_fn, model),
                                shot_args, S, shot_chunk)

        pad = (-S) % n_dev
        if pad:
            shot_args = jax.tree.map(
                lambda a: jnp.concatenate(
                    [a, jnp.repeat(a[-1:], pad, axis=0)], axis=0),
                shot_args)

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=((P(), P(), P()),
                                     jax.tree.map(lambda _: P(axis),
                                                  shot_args)),
                           out_specs=P(axis), check_vma=False)
        def sharded(model_, args):
            return _chunked_map(functools.partial(chunk_fn, model_), args,
                                (S + pad) // n_dev, shot_chunk)

        return sharded(model, shot_args)[:S]

    return fwd


def mesh_2d(n_shot: int, n_x: int, devices=None) -> Mesh:
    """2-D device mesh: data-parallel shots x spatial domain decomposition."""
    devs = jax.devices() if devices is None else devices
    assert len(devs) >= n_shot * n_x
    return Mesh(np.array(devs[:n_shot * n_x]).reshape(n_shot, n_x),
                ("shot", "x"))


def make_dd_misfit(cfg: SimConfig, mesh: Mesh,
                   channels: Sequence[str] = ("ett",)):
    """Shot-parallel + spatially-decomposed loss on a ('shot', 'x') mesh.

    The model's x-axis is sharded across the 'x' mesh axis; GSPMD inserts
    the 2-cell halo exchanges (collective-permutes between devices) that the
    O(4) stencil slices require — the wave-equation analogue of tensor
    parallelism, expressed purely as sharding annotations (no manual halo
    code; cf. the jax scaling-book recipe: pick a mesh, annotate, let XLA
    insert collectives).

    Differentiable; grads come out replicated.  Use under jit.
    """
    from jax.sharding import NamedSharding

    model_s = NamedSharding(mesh, P(None, "x"))
    shot_s = NamedSharding(mesh, P("shot"))
    wsc = jax.lax.with_sharding_constraint

    def loss(lam, mu, rho, stf, geoms, obs, weights):
        lam = wsc(lam, model_s)
        mu = wsc(mu, model_s)
        rho = wsc(rho, model_s)
        stf = wsc(stf, shot_s)
        obs = wsc(obs, shot_s)
        syn = jax.vmap(lambda s, g: propagate(cfg, lam, mu, rho, s, g))(
            stf, geoms)
        per_shot = jax.vmap(
            lambda o, s: mf.l2_misfit(o, s, channels=channels))(obs, syn)
        return jnp.sum(weights * per_shot)

    return loss
