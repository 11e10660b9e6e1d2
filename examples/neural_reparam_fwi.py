"""FWI through a neural-network model reparameterization.

TorchFWI's headline pitch is that wrapping the propagator as an autograd
op "enables the integration of FWI with neural networks and makes it easy
to create complex inversion workflows" (reference README; the nn.Module
heads of `Ops/FWI/FWI_ops.py` are the shipped instance).  Here the same
composability is the custom_vjp propagator under jax.grad: the velocity
model is the output of a deep-image-prior-style decoder CNN (flax), its
weights trained with optax Adam against the waveform misfit — gradients
flow data -> propagator adjoint -> vp -> conv kernels with no extra code.

The CNN acts as a learned regularizer: with a FIXED random latent input,
optimizing the decoder weights biases the inversion toward smooth,
coherent structure (Ulyanov et al.'s deep image prior), which is the
standard NN-reparameterized-FWI construction.

Run:  python examples/neural_reparam_fwi.py [outdir] [n_steps]
(defaults run the reference-scale grid on a GPU; tests drive `invert_nn`
on a tiny CPU grid).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import sep2023_tpu as st
from sep2023_tpu import models, parallel


def make_decoder(nz: int, nx: int, width: int = 16, scale: float = 300.0):
    """(params, apply): a 3-level upsampling decoder mapping a fixed
    random latent (nz/4, nx/4, width) to a (nz, nx) velocity PERTURBATION
    in [-scale, scale] m/s (added to the smooth background)."""
    import flax.linen as nn

    class Decoder(nn.Module):
        @nn.compact
        def __call__(self, z):
            for factor in (2, 2):
                z = nn.Conv(width, (3, 3))(z)
                z = nn.gelu(z)
                z = jax.image.resize(
                    z, (z.shape[0] * factor, z.shape[1] * factor,
                        z.shape[2]), "bilinear")
            z = nn.Conv(width, (3, 3))(z)
            z = nn.gelu(z)
            z = nn.Conv(1, (3, 3))(z)
            return scale * jnp.tanh(z[..., 0])

    dec = Decoder()
    latent = jax.random.normal(jax.random.PRNGKey(0),
                               (-(-nz // 4), -(-nx // 4), width),
                               jnp.float32)
    params = dec.init(jax.random.PRNGKey(1), latent)

    def apply(params):
        dvp = dec.apply(params, latent)
        return dvp[:nz, :nx]   # odd sizes: crop the 4-multiple upsample

    return params, apply


def invert_nn(cfg, survey, vp_bg, rho_const, stf, obs, n_steps=60,
              lr=2e-3, width=16):
    """Train the decoder weights against the waveform misfit; returns
    (vp_out, losses).  vp_bg: smooth background (PHYSICAL grid); the CNN
    produces the perturbation.  The loss builder is the production one
    (parallel.make_local_misfit)."""
    import optax

    nz, nx = vp_bg.shape
    params0, apply = make_decoder(nz, nx, width=width)
    geoms = parallel.survey_to_geoms(survey, cfg.npml)
    w = jnp.ones((survey.n_shots,), jnp.float32)
    data_loss = parallel.make_local_misfit(cfg)
    vp_bg = jnp.asarray(vp_bg, jnp.float32)

    # observed data / wavelets / background are jit ARGUMENTS, not closure
    # captures (closed-over device arrays become compiled-in constants,
    # duplicated in device memory); rho is built from the scalar inside
    # the trace (a free broadcast)
    def loss_fn(params, vp_bg_, stf_, obs_):
        rho = jnp.full(cfg.grid.shape, rho_const, jnp.float32)
        vp = vp_bg_ + apply(params)
        vp_pad = jnp.pad(vp, cfg.npml, mode="edge")
        vs_pad = vp_pad / jnp.sqrt(3.0)
        lam = (vp_pad ** 2 - 2 * vs_pad ** 2) * rho
        mu = vs_pad ** 2 * rho
        return data_loss(lam, mu, rho, stf_, geoms, obs_, w)

    opt = optax.adam(lr)
    state = opt.init(params0)

    @jax.jit
    def step(params, state, vp_bg_, stf_, obs_):
        val, g = jax.value_and_grad(loss_fn)(params, vp_bg_, stf_, obs_)
        upd, state = opt.update(g, state)
        return optax.apply_updates(params, upd), state, val

    params, losses = params0, []
    for _ in range(n_steps):
        params, state, val = step(params, state, vp_bg, stf, obs)
        losses.append(float(val))
    return np.asarray(vp_bg + apply(params)), losses


def main(outdir="scratch/neural_reparam", n_steps=80):
    os.makedirs(outdir, exist_ok=True)
    nz, nx, npml = 101, 201, 32
    cfg = st.SimConfig(nz=nz + 2 * npml, nx=nx + 2 * npml, dz=20.0, dx=20.0,
                       nt=1001, dt=0.002, f0=10.0, npml=npml)
    vp_t, _, _ = models.anomaly_vp_vs_rho(nz, nx)
    vp_bg = models.smooth(vp_t, 12.0)
    src_x = np.arange(10, nx - 10, 10)
    survey = st.Survey(src_z=np.full(len(src_x), 1), src_x=src_x,
                       rec_z=np.full(nx - 20, nz // 2),
                       rec_x=np.arange(10, nx - 10))
    stf = jnp.broadcast_to(
        jnp.asarray(st.ricker(cfg.f0, cfg.nt, cfg.dt), jnp.float32),
        (len(src_x), cfg.nt))
    rho = 2500.0

    gen = jax.jit(parallel.make_forward(cfg, survey))
    vp_pad = jnp.asarray(st.medium.pad_model_np(vp_t, npml), jnp.float32)
    vs_pad = vp_pad / jnp.sqrt(3.0)
    rr = jnp.full(cfg.grid.shape, rho, jnp.float32)
    obs = gen((vp_pad ** 2 - 2 * vs_pad ** 2) * rr, vs_pad ** 2 * rr, rr,
              stf)

    vp_out, losses = invert_nn(cfg, survey, vp_bg, rho, stf, obs,
                               n_steps=int(n_steps))
    err0 = np.abs(vp_bg - vp_t).mean()
    err1 = np.abs(vp_out - vp_t).mean()
    np.savez(os.path.join(outdir, "neural_reparam.npz"), vp_true=vp_t,
             vp_init=np.asarray(vp_bg), vp_out=vp_out,
             losses=np.asarray(losses))
    print(f"misfit {losses[0]:.4e} -> {losses[-1]:.4e} over "
          f"{len(losses)} Adam steps; mean |vp err| {err0:.1f} -> "
          f"{err1:.1f} m/s")


if __name__ == "__main__":
    main(*sys.argv[1:])
