"""Signal processing on seismogram arrays: trapezoid band-pass filtering,
taper windows, and Wiener spectral source estimation.

JAX equivalents of the reference's cuFFT-based utilities:
  - sin^2/cos^2 trapezoid band-pass  `cuda_bp_filter1d` (utilities.cu:733-763)
  - taper window                     `cuda_window`     (utilities.cu:790-884)
  - spectral source update           `source_update`   (utilities.cu:1170-1325)
All operate along the trailing (time) axis via jnp.fft (XLA-fused), and are
fully differentiable so they compose with `propagate` in any misfit chain.
"""
from __future__ import annotations

import jax.numpy as jnp


def bandpass_amplitude(nt: int, dt: float, f0: float, f1: float, f2: float,
                       f3: float):
    """Trapezoid |H(f)|: sin^2 ramp f0->f1, flat f1->f2, cos^2 roll-off f2->f3
    (matching the piecewise form in utilities.cu:749-758, applied as an
    amplitude-only zero-phase filter)."""
    freq = jnp.fft.rfftfreq(nt, d=dt)
    up = jnp.where((freq >= f0) & (freq < f1),
                   jnp.sin(jnp.pi / 2.0 * (freq - f0) / max(f1 - f0, 1e-20)), 0.0)
    flat = jnp.where((freq >= f1) & (freq < f2), 1.0, 0.0)
    down = jnp.where((freq >= f2) & (freq < f3),
                     jnp.cos(jnp.pi / 2.0 * (freq - f2) / max(f3 - f2, 1e-20)), 0.0)
    return up + flat + down


def bandpass(data, dt: float, corners):
    """Zero-phase trapezoid band-pass along the last axis.

    corners = (f0, f1, f2, f3) as in the reference's `filter` JSON entry
    (Parameter.cpp:139-177)."""
    nt = data.shape[-1]
    H = bandpass_amplitude(nt, dt, *corners).astype(data.dtype)
    return jnp.fft.irfft(jnp.fft.rfft(data, axis=-1) * H, n=nt, axis=-1)


def apply_bandpass_amplitude(data, H):
    """Apply a precomputed zero-phase amplitude response H (nfreq,) along the
    last axis.  Passing H as a runtime ARRAY (rather than baking corner
    frequencies into the trace) lets every multiscale stage share one
    compiled executable — stages differ only in the H value."""
    nt = data.shape[-1]
    return jnp.fft.irfft(jnp.fft.rfft(data, axis=-1) * H.astype(data.dtype),
                         n=nt, axis=-1)


def taper_window(nt: int, dt: float, win_start=None, win_end=None,
                 ratio: float = 0.005, dtype=jnp.float32):
    """Per-sample taper: 1 inside [win_start, win_end] (in samples) with
    sin^2 ramps of width ratio*nt on both sides (cuda_window,
    utilities.cu:790-884).

    win_start / win_end may be scalars (one window for all traces, the
    reference's if_win default) or (R,) arrays (the per-trace win_start /
    win_end entries of the survey JSON, Src_Rec.cu:145-200).  Returns (nt,)
    for scalars, (R, nt) for per-trace bounds."""
    if win_start is None:
        win_start = 0
    if win_end is None:
        win_end = nt - 1
    ws = jnp.asarray(win_start)
    we = jnp.asarray(win_end)
    if ws.ndim or we.ndim:
        ws = jnp.atleast_1d(ws)[..., None]   # (R, 1)
        we = jnp.atleast_1d(we)[..., None]
    ramp = jnp.maximum(ratio * nt, 1.0)
    t = jnp.arange(nt)
    up = jnp.clip((t - ws) / ramp, 0.0, 1.0)
    down = jnp.clip((we - t) / ramp, 0.0, 1.0)
    w = jnp.sin(0.5 * jnp.pi * up) ** 2 * jnp.sin(0.5 * jnp.pi * down) ** 2
    return w.astype(dtype)


def source_update_filter(obs, syn, eps: float = 1e-8):
    """Wiener deconvolution filter W(f) = sum conj(S) O / (sum |S|^2 + eps)
    estimated over receivers — the spectral source-correction of
    `source_update` / `cuda_spectrum_update` (utilities.cu:905-978,
    1170-1325).  obs/syn: (..., n_rec, nt).  Returns the complex filter
    (nfreq,) to apply to the current source wavelet."""
    O = jnp.fft.rfft(obs, axis=-1)
    S = jnp.fft.rfft(syn, axis=-1)
    num = jnp.sum(jnp.conj(S) * O, axis=tuple(range(O.ndim - 1)))
    den = jnp.sum(jnp.abs(S) ** 2, axis=tuple(range(S.ndim - 1)))
    scale = jnp.maximum(jnp.max(den), 1.0)
    return num / (den + eps * scale)


def apply_source_filter(stf, W):
    """Apply a spectral filter W (from `source_update_filter`) to a source
    wavelet (nt,) -> corrected wavelet (nt,)."""
    nt = stf.shape[-1]
    return jnp.fft.irfft(jnp.fft.rfft(stf, axis=-1) * W, n=nt, axis=-1)
