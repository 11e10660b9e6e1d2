"""Misfit functionals on (4, n_rec, nt) seismogram arrays.

The reference computes residuals with the first time sample zeroed
(`gpuMinus`, utilities.cu:154-167), sums squares per channel
(`cuda_cal_objective`, utilities.cu:169-205) and keeps ONLY the Ett (DAS)
term in the objective, scaled by 0.5 (`libCUFD.cu:410-427, 776-779`).

Everything here is ordinary JAX: gradients flow back into `propagate` as
data cotangents, which the custom VJP turns into adjoint sources (replacing
`res_injection_exx` and friends).
"""
from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

_CH_INDEX = {"pr": 0, "vx": 1, "vz": 2, "ett": 3}


def residual(obs, syn):
    """obs - syn with the first time sample zeroed (utilities.cu:158-163)."""
    r = obs - syn
    return r.at[..., 0].set(0.0)


def l2_misfit(obs, syn, channels: Sequence[str] = ("ett",), weights=None):
    """0.5 * sum of squared residuals over the selected channels
    (default: Ett only, matching `libCUFD.cu:427`)."""
    r = residual(obs, syn)
    idx = jnp.array([_CH_INDEX[c] for c in channels])
    r = r[..., idx, :, :] if r.ndim == 4 else r[idx]
    if weights is not None:
        r = r * weights
    return 0.5 * jnp.sum(r * r)


def make_preprocessed_l2(channels=("ett",), dt=None, filter_corners=None,
                         window=None, win_ratio=0.005, per_trace=False,
                         objective="l2", dynamic_bandpass=False):
    """Misfit with the reference's optional data preconditioning chain
    applied identically to observed and synthetic data: taper window
    (`cuda_window`, utilities.cu:790-884; para flag if_win) and trapezoid
    band-pass (`bp_filter1d`, utilities.cu:733-763; para flag filter).

    Because the chain is differentiable, the adjoint source automatically
    includes the re-filter/re-window steps the reference applies to the
    residual (`libCUFD.cu:444-457`).

    per_trace=True returns a loss with the extended per-shot signature
        loss(obs, syn, win_start, win_end, trace_weights)
    where win_start / win_end are (R,) sample bounds and trace_weights is
    (R,) — the survey-JSON per-trace conditioning the reference parses in
    `Src_Rec.cu:145-200` and applies in `cuda_window` / the weighted
    residual (`utilities.cu:790-884`).  Loss builders vmap these alongside
    obs/syn (`trace_aux` in parallel.py).

    objective: 'l2' (default) or 'xcorr' (normalized cross-correlation,
    the if_cross_misfit capability, utilities.cu:1011-1113).

    dynamic_bandpass=True appends a trailing `bph` argument — the (nfreq,)
    band-pass amplitude response as a runtime ARRAY
    (signal.bandpass_amplitude) instead of the static `filter_corners`
    closure.  Multiscale stages then share ONE compiled executable, differing
    only in the bph value (one cold compile per stage saved).
    """
    from sep2023_tpu.ops import signal as sg

    def condition(obs, syn, win=None, tw=None, bph=None):
        nt = obs.shape[-1]
        if win is not None:
            w = sg.taper_window(nt, dt, win[0], win[1], ratio=win_ratio,
                                dtype=obs.dtype)
            obs = obs * w
            syn = syn * w
        if filter_corners is not None:
            obs = sg.bandpass(obs, dt, filter_corners)
            syn = sg.bandpass(syn, dt, filter_corners)
        if bph is not None:
            obs = sg.apply_bandpass_amplitude(obs, bph)
            syn = sg.apply_bandpass_amplitude(syn, bph)
        if tw is not None:
            obs = obs * tw[:, None]
            syn = syn * tw[:, None]
        return obs, syn

    final = (l2_misfit if objective == "l2"
             else normalized_crosscorr_misfit)

    if per_trace and dynamic_bandpass:
        def loss(obs, syn, win_start, win_end, trace_weights, bph):
            obs, syn = condition(obs, syn, win=(win_start, win_end),
                                 tw=trace_weights, bph=bph)
            return final(obs, syn, channels=channels)
    elif per_trace:
        def loss(obs, syn, win_start, win_end, trace_weights):
            obs, syn = condition(obs, syn, win=(win_start, win_end),
                                 tw=trace_weights)
            return final(obs, syn, channels=channels)
    elif dynamic_bandpass:
        def loss(obs, syn, bph):
            obs, syn = condition(obs, syn, win=window, bph=bph)
            return final(obs, syn, channels=channels)
    else:
        def loss(obs, syn):
            obs, syn = condition(obs, syn, win=window)
            return final(obs, syn, channels=channels)

    return loss


def trace_normalize(d, eps=1e-12):
    n = jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    return d / (n + eps)


def normalized_crosscorr_misfit(obs, syn, channels: Sequence[str] = ("ett",)):
    """Global-correlation (normalized cross-correlation) misfit,
    1 - <obs_hat, syn_hat> per trace, the capability behind the reference's
    if_cross_misfit flag (`utilities.cu:1011-1113`)."""
    idx = jnp.array([_CH_INDEX[c] for c in channels])
    o = obs[..., idx, :, :] if obs.ndim == 4 else obs[idx]
    s = syn[..., idx, :, :] if syn.ndim == 4 else syn[idx]
    o = trace_normalize(o)
    s = trace_normalize(s)
    return jnp.sum(1.0 - jnp.sum(o * s, axis=-1))
