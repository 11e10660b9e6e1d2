"""DAS (distributed acoustic sensing) operators: fiber geometry, directional
sensitivity weights, and the gauge-length quadrature response.

Python/JAX re-design of:
  - fiber geometry + Frenet-tangent sensitivity generation
    (`DAS_Waveform_Modeling/matlab/DAS_Geometry_Homogeneous.m`,
     `frenet.m`, `interparc.m`, `segment.m` — MATLAB, offline) — here
    `arc_fiber`, `spline_fiber`, `resample_arclength` (spline-parametric
    true arc length), `segment_cable` (fiber -> gauge channels),
    `tangents`, `sensitivity_weights`
  - the analytical gauge-length response by quadrature along the cable
    (`DAS_Waveform_Modeling/src/dasResponse.py`) — here `das_response`
  - the differentiable gauge-averaging map for the inversion path — here
    `gauge_matrix` (compose with the propagator's per-point strain channels).

A cable is represented as an array (npts, 9): columns (x, y, z, w1..w6) with
the 6 tangential-projection weights
    [TxTx, 2 TxTy, 2 TxTz, TyTy, 2 TyTz, TzTz]
(order of `DAS_Geometry_Homogeneous.m:78-85` and the Cable*_quad_*.dat files),
so that the fiber-axis strain is  e_tt = sum_i w_i * E_i  with
E = (Exx, Exy, Exz, Eyy, Eyz, Ezz).
"""
from __future__ import annotations

import numpy as np

from sep2023_tpu import analytic as an

N_CABLE_PTS = 21  # canonical cable discretization (dasResponse.py:20)

# quadrature point subsets on the 21-point cable (dasResponse.py:26-39)
QUAD_POINTS = {
    1: (np.array([10]), 21),
    3: (np.array([3, 10, 17]), 7),
    7: (np.array([1, 4, 7, 10, 13, 16, 19]), 3),
    21: (np.arange(21), 1),
}


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def _arc_spline(points: np.ndarray):
    """Parametric cubic spline through (m, d) points, parameterized by
    normalized chord length (interparc.m 'spline' mode: the spline fit of
    interparc.m:254-305), plus a dense true-arc-length table s(u) from
    integrating the spline speed |dC/du| (the integral interparc.m solves
    with ode45; composite trapezoid on a 64x-per-segment grid here — the
    inversion error is O((du)^2) and far below the gauge discretization).

    Returns (eval_at_s, tangent_at_s, L): callables mapping TRUE arc-length
    positions (scalar or array in [0, L]) to points / unit tangents on the
    spline (the exact Frenet T of `frenet.m`), and the total arc length."""
    pts = np.asarray(points, np.float64)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    pts = pts[np.concatenate([[True], seg > 0])]  # drop duplicate knots
    if pts.shape[0] < 4:   # not-a-knot needs 4 knots; fall back to chords
        s = np.concatenate(
            [[0.0], np.cumsum(np.linalg.norm(np.diff(pts, axis=0), axis=1))])

        def eval_linear(s_q):
            return np.stack([np.interp(s_q, s, pts[:, d])
                             for d in range(pts.shape[1])], axis=-1)

        def tan_linear(s_q):
            return tangents(eval_linear(np.linspace(0.0, s[-1], 101)))[
                np.clip(np.rint(np.asarray(s_q) / s[-1] * 100), 0,
                        100).astype(int)]

        return eval_linear, tan_linear, float(s[-1])
    from scipy.interpolate import CubicSpline
    chord = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    u = np.concatenate([[0.0], np.cumsum(chord)])
    u /= u[-1]
    sp = CubicSpline(u, pts, axis=0)
    dsp = sp.derivative()
    uu = np.linspace(0.0, 1.0, 64 * (pts.shape[0] - 1) + 1)
    speed = np.linalg.norm(dsp(uu), axis=1)
    s = np.concatenate(
        [[0.0],
         np.cumsum(0.5 * (speed[1:] + speed[:-1]) * np.diff(uu))])

    def eval_at(s_q):
        return sp(np.interp(s_q, s, uu))

    def tangent_at(s_q):
        d = dsp(np.interp(s_q, s, uu))
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    return eval_at, tangent_at, float(s[-1])


def resample_arclength(points: np.ndarray, n: int,
                       method: str = "spline") -> np.ndarray:
    """Resample a polyline (m, d) to n points equally spaced in TRUE arc
    length along a parametric cubic spline through the points — the role
    (and default mode) of the vendored `interparc.m`.  method='linear'
    keeps the chordal-polyline variant (interparc's 'linear' mode; also
    the automatic fallback below 4 distinct points)."""
    if method == "linear":
        seg = np.linalg.norm(np.diff(points, axis=0), axis=1)
        s = np.concatenate([[0.0], np.cumsum(seg)])
        s_new = np.linspace(0.0, s[-1], n)
        return np.stack([np.interp(s_new, s, points[:, d])
                         for d in range(points.shape[1])], axis=1)
    if method != "spline":
        raise ValueError(method)
    eval_at, _, L = _arc_spline(points)
    return eval_at(np.linspace(0.0, L, n))


def tangents(points: np.ndarray) -> np.ndarray:
    """Unit tangents along a polyline (m, d) by centered differences — the
    T output of `frenet.m`."""
    g = np.gradient(points, axis=0)
    return g / np.linalg.norm(g, axis=1, keepdims=True)


def sensitivity_weights(T: np.ndarray) -> np.ndarray:
    """(m, 3) unit tangents -> (m, 6) strain-projection weights
    [TxTx, 2TxTy, 2TxTz, TyTy, 2TyTz, TzTz]."""
    tx, ty, tz = T[:, 0], T[:, 1], T[:, 2]
    return np.stack([tx * tx, 2 * tx * ty, 2 * tx * tz,
                     ty * ty, 2 * ty * tz, tz * tz], axis=1)


def _finish_cable(pts3: np.ndarray) -> np.ndarray:
    w = sensitivity_weights(tangents(pts3))
    return np.concatenate([pts3, w], axis=1)


def arc_fiber(gauge_length: float, radius_over_gl: float,
              center=(0.0, 0.0, 0.0), npts: int = N_CABLE_PTS,
              plane: str = "xy") -> np.ndarray:
    """Cable shaped as a circular arc of unit arc-length (scaled by the gauge
    length) with curvature radius `radius_over_gl * GL`
    (DAS_Geometry_Homogeneous.m:19-40 uses r in {1/pi, 2/pi, 1e10/pi}).

    Returns (npts, 9) cable array.  `plane` places the arc in 'xy' or 'xz'.
    """
    r = radius_over_gl
    theta = 1.0 / r
    t = np.linspace(np.pi / 2 - theta / 2, np.pi / 2 + theta / 2, 101)
    x = r * np.cos(t) * gauge_length
    y = r * np.sin(t) * gauge_length
    y = y - y[0]
    curve = np.stack([x, y], axis=1)
    curve = resample_arclength(curve, npts)
    zero = np.zeros((npts, 1))
    if plane == "xy":
        pts3 = np.concatenate([curve, zero], axis=1)
    elif plane == "xz":
        pts3 = np.stack([curve[:, 0], zero[:, 0], curve[:, 1]], axis=1)
    else:
        raise ValueError(plane)
    pts3 = pts3 + np.asarray(center)[None, :]
    return _finish_cable(pts3)


def straight_fiber(gauge_length: float, direction=(1.0, 0.0, 0.0),
                   center=(0.0, 0.0, 0.0), npts: int = N_CABLE_PTS) -> np.ndarray:
    d = np.asarray(direction, dtype=np.float64)
    d = d / np.linalg.norm(d)
    s = np.linspace(-gauge_length / 2, gauge_length / 2, npts)
    pts3 = np.asarray(center)[None, :] + s[:, None] * d[None, :]
    return _finish_cable(pts3)


def spline_fiber(control_points: np.ndarray, npts: int = N_CABLE_PTS) -> np.ndarray:
    """Cable through arbitrary 3D control points, resampled to equal TRUE
    arc length along the chord-length-parameterized cubic spline (the
    Overthrust generator, DAS_Geometry_Overthrust.m:28-66, whose
    `interparc(n, Px, Py, Pz, 'spline')` call this mirrors)."""
    cp = np.asarray(control_points, dtype=np.float64)
    return _finish_cable(resample_arclength(cp, npts, method="spline"))


def segment_cable(points: np.ndarray, gauge_length: float,
                  pts_per_channel: int = N_CABLE_PTS):
    """Cut one long fiber into equal-arc gauge channels (`segment.m:1-41` +
    the channel/quadrature layout of DAS_Geometry_Overthrust.m:60-66).

    The reference brute-force searches the channel-node count whose mean
    interparc spacing is closest to `gauge_length` (segment.m:13-28); a
    true-arc-length resampler spaces nodes at exactly L/(n_nodes-1), so
    the optimal count is closed-form: n_nodes = round(L/GL) + 1, and the
    residual `error` segment.m prints is |L/(n_nodes-1) - GL|.

    Channels are the INTERIOR nodes (the reference's first/last nodes
    degenerate to single-point sensitivities — Overthrust.m:81-95 — i.e.
    no full gauge fits around them); each channel gets `pts_per_channel`
    points spanning the centered gauge [s_i - GL/2, s_i + GL/2], grouped
    contiguously so `gauge_matrix(n_channels, pts_per_channel)` composes
    directly with the recorded per-point strains.

    Returns (cable, nodes, error): cable (n_channels*pts_per_channel, 9)
    with EXACT spline-tangent sensitivity weights (no finite differences
    across channel-group seams), nodes (n_nodes, 3) the segment.m node
    output, and the mean-spacing error."""
    eval_at, tangent_at, L = _arc_spline(points)
    if L <= gauge_length:
        raise ValueError(f"fiber arc length {L:.3f} shorter than one "
                         f"gauge ({gauge_length})")
    # >= 3 nodes: channels are interior nodes, so 2 nodes would return
    # an EMPTY cable for fibers between 1 and ~1.5 gauge lengths — give
    # them their one (center) channel instead
    n_nodes = max(3, int(round(L / gauge_length)) + 1)
    spacing = L / (n_nodes - 1)
    s_nodes = np.linspace(0.0, L, n_nodes)
    nodes = eval_at(s_nodes)
    off = np.linspace(-gauge_length / 2, gauge_length / 2, pts_per_channel)
    s_ch = np.clip((s_nodes[1:-1, None] + off[None, :]).reshape(-1), 0.0, L)
    cable = np.concatenate(
        [eval_at(s_ch), sensitivity_weights(tangent_at(s_ch))], axis=1)
    return cable, nodes, abs(spacing - gauge_length)


# ---------------------------------------------------------------------------
# Analytical gauge-length response (validation oracle)
# ---------------------------------------------------------------------------

def das_response(vp, vs, rho, gauge_length, cable, nquad, src_xyz,
                 tmin, tmax, dt, f0, M0, M):
    """Gauge-length DAS response by N-point quadrature of the analytical
    strain along the cable (dasResponse.py:15-74): per quadrature point the
    6-component strain is projected onto the fiber with the sensitivity
    weights of the surrounding cable points, then trapezoid-averaged over the
    gauge length."""
    if cable.shape[0] != N_CABLE_PTS:
        raise ValueError(f"cable must have {N_CABLE_PTS} points")
    if nquad not in QUAD_POINTS:
        raise ValueError("nquad must be one of 1, 3, 7, 21")
    points, nq = QUAD_POINTS[nquad]

    t = np.arange(tmin, tmax + dt, dt)
    das_point = np.zeros((N_CABLE_PTS, t.shape[0]))
    sx, sy, sz = src_xyz
    for p in points:
        x, y, z = cable[p, 0] - sx, cable[p, 1] - sy, cable[p, 2] - sz
        U = an.solution(vp, vs, rho, x, y, z, tmin, tmax, dt, f0, M0, M,
                        dim="3D", comp="strain")
        E = np.stack([U["Exx"], U["Exy"], U["Exz"],
                      U["Eyy"], U["Eyz"], U["Ezz"]])
        lo, hi = p - nq // 2, p + nq // 2 + 1
        for j in range(lo, hi):
            das_point[j] = cable[j, 3:9] @ E
    s = np.linspace(-gauge_length / 2, gauge_length / 2, N_CABLE_PTS)
    return np.trapezoid(das_point, s, axis=0) / gauge_length


# ---------------------------------------------------------------------------
# Cable -> solver acquisition (the 2D inversion path)
# ---------------------------------------------------------------------------

def cable_to_receivers(cable: np.ndarray, dx: float, dz: float,
                       origin=(0.0, 0.0)):
    """Map a cable array (from arc_fiber/spline_fiber/straight_fiber, built
    in the MATLAB x-y plane) onto the 2D solver's (z, x) grid:

      cable x -> solver x,  cable y -> solver z (depth), cable z ignored
      (the same plane identification the reference uses when feeding
      Cable*_quad_*.dat weights to elasticSolver.py:269-276)

    Returns (rec_z, rec_x, das_w): integer grid indices (PHYSICAL grid,
    nearest node) and (npts, 3) weights for the solver's (exx, exz, ezz)
    strain channels — columns (TxTx, 2TxTy, TyTy) of the 6-weight set.
    """
    ox, oz = origin
    rec_x = np.rint((cable[:, 0] - ox) / dx).astype(np.int32)
    rec_z = np.rint((cable[:, 1] - oz) / dz).astype(np.int32)
    das_w = cable[:, [3, 4, 6]].astype(np.float64)
    return rec_z, rec_x, das_w


def apply_gauge(ett_points, A):
    """Gauge-average per-point fiber strains: ett_points (..., npts_total,
    nt) x A (nchan, npts_total) -> (..., nchan, nt).  Constant linear map —
    composes differentiably with any misfit.  HIGHEST precision keeps a
    float32 contraction out of reduced-precision (TF32) tensor-core
    arithmetic."""
    import jax.numpy as jnp
    from jax import lax
    return jnp.einsum("cp,...pt->...ct", jnp.asarray(A, ett_points.dtype),
                      ett_points, precision=lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# Differentiable gauge averaging for the inversion path
# ---------------------------------------------------------------------------

def gauge_matrix(n_channels: int, pts_per_channel: int = N_CABLE_PTS,
                 gauge_length: float = 1.0) -> np.ndarray:
    """Linear map A: per-point fiber strains -> gauge-averaged channels.

    The propagator records one 'ett' trace per cable point (with the point's
    sensitivity weights, das_channel='weighted'); the gauge average is then
    data_gauge = A @ data_points, A of shape
    (n_channels, n_channels*pts_per_channel) carrying the trapezoid weights
    of `np.trapz(..)/GL` (dasResponse.py:72-73).  Being a constant linear
    operator it is trivially differentiable and fuses into the misfit.
    """
    m = pts_per_channel
    w = np.full(m, gauge_length / (m - 1))
    w[0] *= 0.5
    w[-1] *= 0.5
    w = w / gauge_length
    A = np.zeros((n_channels, n_channels * m))
    for c in range(n_channels):
        A[c, c * m:(c + 1) * m] = w
    return A
