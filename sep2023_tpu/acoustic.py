"""2D acoustic (pressure-velocity) propagator with CPML — the secondary
physics mode of the reference (`ac_pressure.cu`, `ac_velocity.cu`, exercised
by the standalone CLI path `main.cu:180-197`, not the Torch path).

Same architecture as the elastic engine (propagator.py): one
`lax.scan`, uniform CPML, boundary-saving custom_vjp whose backward pass is
time-reversed reconstruction + per-step `jax.vjp`.

Scheme (p carried in the reference's d_szz array):
  p  += lambda * (Dz+ vz + Dx- vx) * dt        (ac_pressure.cu:30-46)
  vz += byc_a * Dz- p * dt                     (ac_velocity.cu, b_z profile)
  vx += byc_b * Dx+ p * dt                     (ac_velocity.cu, b_x_half)
Reconstruction region: [npml+2, n-3-npml] (ac_pressure.cu:56-65).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sep2023_tpu import cpml as cpml_mod
from sep2023_tpu.config import SimConfig
from sep2023_tpu.medium import _shift_left, _shift_up
from sep2023_tpu.ops import fd
from sep2023_tpu.propagator import (Strips, _extract_strips, _inject_strips)


class AcFields(NamedTuple):
    p: jax.Array
    vz: jax.Array
    vx: jax.Array


class AcPsi(NamedTuple):
    vz_dz: jax.Array
    vx_dx: jax.Array
    p_dz: jax.Array
    p_dx: jax.Array


class AcState(NamedTuple):
    f: AcFields
    psi: AcPsi


class AcGeom(NamedTuple):
    src_z: jax.Array
    src_x: jax.Array
    rec_z: jax.Array
    rec_x: jax.Array


AC_CHANNELS = ("pr", "vx", "vz")


def _zero_state(nz, nx, dtype):
    z = lambda: jnp.zeros((nz, nx), dtype)
    return AcState(AcFields(z(), z(), z()), AcPsi(z(), z(), z(), z()))


def _consts(cfg: SimConfig, dtype):
    cp = cpml_mod.cpml_scaled(cfg.nz, cfg.nx, cfg.npml, cfg.dz, cfg.dx,
                              cfg.dt, cfg.f0, dtype=dtype)
    mzf, mxf = fd.update_mask(cfg.nz, cfg.nx, 2, cfg.nz - 3, 2, cfg.nx - 3,
                              dtype)
    mzi, mxi = fd.update_mask(cfg.nz, cfg.nx, cfg.npml + 2,
                              cfg.nz - 3 - cfg.npml, cfg.npml + 2,
                              cfg.nx - 3 - cfg.npml, dtype)
    return cp, (mzf, mxf), (mzi, mxi)


def _buoyancies(rho):
    return 2.0 / (_shift_up(rho) + rho), 2.0 / (_shift_left(rho) + rho)


def ac_step(state: AcState, lam, byc_a, byc_b, amp, geom: AcGeom, cp,
            mask, cfg: SimConfig):
    mz, mx = mask
    f, psi = state
    dt = cfg.dt

    # division-free CPML form (cpml.CpmlScaled) on raw stencil differences
    dvz = fd.dz_plus(f.vz)
    p_vz = cp.bz_h * psi.vz_dz + cp.az_h * dvz
    dvz_e = dvz * cp.ikz_h + p_vz
    dvx = fd.dx_minus(f.vx)
    p_vx = cp.bx * psi.vx_dx + cp.ax * dvx
    dvx_e = dvx * cp.ikx + p_vx
    p = f.p + (mz * mx) * (lam * (dvz_e + dvx_e) * dt)
    p = p.at[geom.src_z, geom.src_x].add(cfg.src_scale * dt * amp)

    dpz = fd.dz_minus(p)
    p_pz = cp.bz * psi.p_dz + cp.az * dpz
    dpz_e = dpz * cp.ikz + p_pz
    vz = f.vz + (mz * mx) * (dpz_e * byc_a * dt)

    dpx = fd.dx_plus(p)
    p_px = cp.bx_h * psi.p_dx + cp.ax_h * dpx
    dpx_e = dpx * cp.ikx_h + p_px
    vx = f.vx + (mz * mx) * (dpx_e * byc_b * dt)

    new = AcState(AcFields(p, vz, vx), AcPsi(p_vz, p_vx, p_pz, p_px))
    rz, rx = geom.rec_z, geom.rec_x
    rec = jnp.stack([p[rz, rx], vx[rz, rx], vz[rz, rx]])
    return new, rec


def _velocity_reverse(f: AcFields, byc_a, byc_b, mask_i, cfg):
    """Undo the velocity update (which used the post-source p_{t+1}).
    Multiplies by the reciprocal spacing to bitwise-match the forward's
    scaled-profile interior (see cpml.CpmlScaled)."""
    mz, mx = mask_i
    dt = cfg.dt
    idz, idx = 1.0 / cfg.dz, 1.0 / cfg.dx
    vz = f.vz - (mz * mx) * (fd.dz_minus(f.p) * idz * byc_a * dt)
    vx = f.vx - (mz * mx) * (fd.dx_plus(f.p) * idx * byc_b * dt)
    return AcFields(f.p, vz, vx)


def _pressure_reverse(f: AcFields, lam, mask_i, cfg):
    mz, mx = mask_i
    idz, idx = 1.0 / cfg.dz, 1.0 / cfg.dx
    p = f.p - (mz * mx) * (lam * (fd.dz_plus(f.vz) * idz
                                  + fd.dx_minus(f.vx) * idx) * cfg.dt)
    return AcFields(p, f.vz, f.vx)


class AcBnd(NamedTuple):
    p: Strips
    vz: Strips
    vx: Strips


def _forward(cfg, lam, rho, stf, geom, save_bnd):
    dtype = lam.dtype
    byc_a, byc_b = _buoyancies(rho)
    cp, mask_f, _ = _consts(cfg, dtype)
    cp = jax.tree.map(jnp.asarray, cp)
    s0 = _zero_state(cfg.nz, cfg.nx, dtype)

    def body(s, amp):
        if save_bnd:
            bnd = AcBnd(_extract_strips(s.f.p, cfg),
                        _extract_strips(s.f.vz, cfg),
                        _extract_strips(s.f.vx, cfg))
        s2, rec = ac_step(s, lam, byc_a, byc_b, amp, geom, cp, mask_f, cfg)
        return (s2, (rec, bnd)) if save_bnd else (s2, rec)

    final, ys = jax.lax.scan(body, s0, stf[:cfg.nt - 1])
    rec = ys[0] if save_bnd else ys
    R = geom.rec_z.shape[0]
    data = jnp.concatenate(
        [jnp.zeros((3, R, 1), dtype), jnp.moveaxis(rec, 0, -1)], axis=-1)
    if save_bnd:
        return data, final, ys[1]
    return data


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def propagate_acoustic(cfg: SimConfig, lam, rho, stf, geom: AcGeom):
    """Acoustic forward: seismograms (3, n_rec, nt), channels (pr, vx, vz).
    Differentiable in lam (= rho*vp^2), rho, stf."""
    return _forward(cfg, lam, rho, stf, geom, save_bnd=False)


def _fwd(cfg, lam, rho, stf, geom):
    data, final, bnds = _forward(cfg, lam, rho, stf, geom, save_bnd=True)
    return data, (lam, rho, stf, geom, final, bnds)


def _bwd(cfg, res, d_data):
    lam, rho, stf, geom, final, bnds = res
    dtype = lam.dtype
    (byc_a, byc_b), byc_vjp = jax.vjp(_buoyancies, rho)
    cp, mask_f, mask_i = _consts(cfg, dtype)
    cp = jax.tree.map(jnp.asarray, cp)

    def step_fn(s, lam_, ba, bb, a):
        return ac_step(s, lam_, ba, bb, a, geom, cp, mask_f, cfg)

    d_rec_seq = jnp.moveaxis(d_data[:, :, 1:], -1, 0)
    zero_psi = _zero_state(cfg.nz, cfg.nx, dtype).psi
    adj0 = jax.tree.map(jnp.zeros_like, _zero_state(cfg.nz, cfg.nx, dtype))
    g0 = (jnp.zeros_like(lam), jnp.zeros_like(byc_a), jnp.zeros_like(byc_b))

    def rbody(carry, xs):
        s_tp1, adj, (glam, gba, gbb) = carry
        bnd, d_rec, amp = xs
        f = _velocity_reverse(s_tp1.f, byc_a, byc_b, mask_i, cfg)
        f = AcFields(p=f.p,
                     vz=_inject_strips(f.vz, bnd.vz, cfg),
                     vx=_inject_strips(f.vx, bnd.vx, cfg))
        f = AcFields(f.p.at[geom.src_z, geom.src_x].add(
            -cfg.src_scale * cfg.dt * amp), f.vz, f.vx)
        f = _pressure_reverse(f, lam, mask_i, cfg)
        f = AcFields(p=_inject_strips(f.p, bnd.p, cfg), vz=f.vz, vx=f.vx)
        s_t = AcState(f, zero_psi)
        _, vjp_fn = jax.vjp(step_fn, s_t, lam, byc_a, byc_b, amp)
        d_s, d_lam, d_ba, d_bb, d_amp = vjp_fn((adj, d_rec))
        return (s_t, d_s, (glam + d_lam, gba + d_ba, gbb + d_bb)), d_amp

    xs = (bnds, d_rec_seq, stf[:cfg.nt - 1])
    (_, _, (glam, gba, gbb)), d_stf_main = jax.lax.scan(
        rbody, (final, adj0, g0), xs, reverse=True)

    mzi, mxi = mask_i
    glam = glam * (mzi * mxi)
    (d_rho,) = byc_vjp((gba * (mzi * mxi), gbb * (mzi * mxi)))
    d_stf = jnp.concatenate([d_stf_main, jnp.zeros((1,), dtype)])
    d_geom = AcGeom(
        src_z=np.zeros(geom.src_z.shape, dtype=jax.dtypes.float0),
        src_x=np.zeros(geom.src_x.shape, dtype=jax.dtypes.float0),
        rec_z=np.zeros(geom.rec_z.shape, dtype=jax.dtypes.float0),
        rec_x=np.zeros(geom.rec_x.shape, dtype=jax.dtypes.float0))
    return glam, d_rho, d_stf, d_geom


propagate_acoustic.defvjp(_fwd, _bwd)


def rtm_image_time(cfg: SimConfig, vp, rho, stf, geom: AcGeom, residual,
                   return_illum: bool = False):
    """Time-derivative RTM imaging condition (`image_vel_time.cu:25-37`):

        I(z, x) = sum_t  -2 / vp * (p_{t+1} - p_t) * p_adj_t

    accumulated over the time-reversed loop of the acoustic backward pass —
    forward pressure reconstructed by boundary saving, adjoint pressure
    propagated by the machine-derived step transpose with the data residual
    injected at the receivers (the standalone CLI's acoustic RTM path,
    main.cu:322+).  Returns the image on the padded grid, interior-masked
    like the reference kernel's [nPml, n-nPml-1] window.

    return_illum=True also returns the per-cell SOURCE-wavefield energy
    sum_t p_t^2 (accumulated from the same boundary-saving reconstruction,
    at zero extra propagation cost) — the denominator for
    `imaging.illumination_compensate`, conditioning the image_vel kernel
    (image_vel.cu:26-27) against acquisition-geometry amplitude bias.
    """
    dtype = vp.dtype
    lam = rho * vp ** 2
    byc_a, byc_b = _buoyancies(rho)
    cp, mask_f, mask_i = _consts(cfg, dtype)
    cp = jax.tree.map(jnp.asarray, cp)
    _, final, bnds = _forward(cfg, lam, rho, stf, geom, save_bnd=True)

    def step_fn(s, a):
        return ac_step(s, lam, byc_a, byc_b, a, geom, cp, mask_f, cfg)

    d_rec_seq = jnp.moveaxis(residual[:, :, 1:], -1, 0)
    zero_psi = _zero_state(cfg.nz, cfg.nx, dtype).psi
    adj0 = jax.tree.map(jnp.zeros_like, _zero_state(cfg.nz, cfg.nx, dtype))
    img0 = jnp.zeros_like(vp)
    ill0 = jnp.zeros_like(vp)

    def rbody(carry, xs):
        s_tp1, adj, img, ill = carry
        bnd, d_rec, amp = xs
        p_tp1 = s_tp1.f.p
        f = _velocity_reverse(s_tp1.f, byc_a, byc_b, mask_i, cfg)
        f = AcFields(p=f.p,
                     vz=_inject_strips(f.vz, bnd.vz, cfg),
                     vx=_inject_strips(f.vx, bnd.vx, cfg))
        f = AcFields(f.p.at[geom.src_z, geom.src_x].add(
            -cfg.src_scale * cfg.dt * amp), f.vz, f.vx)
        f = _pressure_reverse(f, lam, mask_i, cfg)
        f = AcFields(p=_inject_strips(f.p, bnd.p, cfg), vz=f.vz, vx=f.vx)
        s_t = AcState(f, zero_psi)
        _, vjp_fn = jax.vjp(lambda s: step_fn(s, amp), s_t)
        (d_s,) = vjp_fn((adj, d_rec))
        img = img + (-2.0 / vp) * (p_tp1 - f.p) * d_s.f.p
        ill = ill + f.p * f.p
        return (s_t, d_s, img, ill), None

    xs = (bnds, d_rec_seq, stf[:cfg.nt - 1])
    (_, _, img, ill), _ = jax.lax.scan(rbody, (final, adj0, img0, ill0), xs,
                                       reverse=True)
    mzi, mxi = mask_i
    if return_illum:
        return img * (mzi * mxi), ill * (mzi * mxi)
    return img * (mzi * mxi)


def propagate_acoustic_ad(cfg, lam, rho, stf, geom):
    """Plain-AD oracle (no boundary saving)."""
    byc_a, byc_b = _buoyancies(rho)
    cp, mask_f, _ = _consts(cfg, lam.dtype)
    cp = jax.tree.map(jnp.asarray, cp)

    def body(s, amp):
        return ac_step(s, lam, byc_a, byc_b, amp, geom, cp, mask_f, cfg)

    _, rec = jax.lax.scan(body, _zero_state(cfg.nz, cfg.nx, lam.dtype),
                          stf[:cfg.nt - 1])
    R = geom.rec_z.shape[0]
    return jnp.concatenate(
        [jnp.zeros((3, R, 1), lam.dtype), jnp.moveaxis(rec, 0, -1)], axis=-1)
