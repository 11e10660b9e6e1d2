"""L-BFGS-B outer loop: JAX <-> scipy.optimize bridge with bounds, result
caching and per-iteration checkpointing.

Functional re-design of the reference's PyTorchObjective
(`Ops/FWI/obj_wrapper.py`) and its driver loop
(`Main-001-FWI-Anomaly-Vp-Vs-Den.py:127-168`):
  - parameters: a dict of named arrays, flattened to a float64 vector
  - one jitted value_and_grad evaluation serves both fun and jac
    (the reference's is_new/cache dedupe, obj_wrapper.py:62-85)
  - bounds packed per parameter (obj_wrapper.py:51-60)
  - a callback that logs the loss history and snapshots parameters each
    iteration (Main-001:137-154 saved .mat files; we save .npz)
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from scipy import optimize as sciopt


class ScipyObjective:
    """Wrap a JAX scalar loss over a dict of arrays as a scipy objective."""

    def __init__(self, loss_fn: Callable[..., jnp.ndarray],
                 params0: Dict[str, np.ndarray],
                 bounds: Optional[Dict[str, tuple]] = None,
                 jit: bool = True, aux: tuple = (),
                 value_and_grad_fn: Optional[Callable] = None):
        """loss_fn(params, *aux) -> scalar.  Pass large fixed arrays (observed
        data, wavelets) through `aux`, NOT via closure: closed-over device
        arrays are baked into the compiled program as constants (duplicated
        in device memory and embedded in the executable).

        value_and_grad_fn: a prebuilt (jitted) value_and_grad(loss_fn) to
        reuse across objective instances — the multiscale stage loop passes
        one so all stages share a single compiled executable."""
        self.names = list(params0)
        self.shapes = {n: np.asarray(params0[n]).shape for n in self.names}
        self.sizes = {n: int(np.prod(self.shapes[n])) for n in self.names}
        self.x0 = np.concatenate(
            [np.asarray(params0[n], dtype=np.float64).ravel()
             for n in self.names])
        self._dtype = jnp.asarray(params0[self.names[0]]).dtype
        self._aux = tuple(aux)
        if value_and_grad_fn is not None:
            self._vg = value_and_grad_fn
        else:
            vg = jax.value_and_grad(loss_fn)
            self._vg = jax.jit(vg) if jit else vg
        self.bounds = self.pack_bounds(bounds) if bounds else None
        self._cached_x = None
        self.f = None
        self.g = None
        self.n_evals = 0
        self.eval_seconds = []   # host wall time of each evaluation

    # -- packing -------------------------------------------------------------
    def unpack(self, x: np.ndarray) -> Dict[str, jnp.ndarray]:
        out, i = {}, 0
        for n in self.names:
            out[n] = jnp.asarray(
                x[i:i + self.sizes[n]].reshape(self.shapes[n]), self._dtype)
            i += self.sizes[n]
        return out

    def pack_bounds(self, bounds: Dict[str, tuple]) -> sciopt.Bounds:
        lo, hi = [], []
        for n in self.names:
            if n in bounds and bounds[n] is not None:
                l, h = bounds[n]
                lo.append(np.broadcast_to(np.asarray(l, np.float64),
                                          self.shapes[n]).ravel())
                hi.append(np.broadcast_to(np.asarray(h, np.float64),
                                          self.shapes[n]).ravel())
            else:
                lo.append(np.full(self.sizes[n], -np.inf))
                hi.append(np.full(self.sizes[n], np.inf))
        return sciopt.Bounds(np.concatenate(lo), np.concatenate(hi))

    # -- evaluation ----------------------------------------------------------
    def _eval(self, params):
        """(float f, packed float64 jac); converting to host values waits
        for the device, so the timing covers the whole evaluation."""
        t0 = time.perf_counter()
        f, g = self._vg(params, *self._aux)
        out = float(f), np.concatenate(
            [np.asarray(g[n], dtype=np.float64).ravel() for n in self.names])
        self.eval_seconds.append(time.perf_counter() - t0)
        return out

    def _ensure(self, x: np.ndarray):
        if self._cached_x is None or not np.array_equal(x, self._cached_x):
            self.f, self.g = self._eval(self.unpack(x))
            self._cached_x = np.array(x)
            self.n_evals += 1

    def fun(self, x):
        self._ensure(np.asarray(x))
        return self.f

    def jac(self, x):
        self._ensure(np.asarray(x))
        return self.g


class InversionLogger:
    """Per-iteration checkpointing: loss.txt + parameter/gradient snapshots
    (`Main-001:137-154`); enables manual resume like the reference."""

    def __init__(self, result_dir: str, objective: ScipyObjective,
                 save_every: int = 1, start_iter: int = 0,
                 save_mat: bool = False):
        self.dir = result_dir
        self.obj = objective
        self.save_every = save_every
        self.it = start_iter
        self.loss_history = []
        self.save_mat = save_mat
        os.makedirs(result_dir, exist_ok=True)

    def _snapshot(self, stem: str, arrays: dict):
        arrays = {n: np.asarray(v) for n, v in arrays.items()}
        np.savez(os.path.join(self.dir, f"{stem}.npz"), **arrays)
        if self.save_mat:
            # reference-format .mat snapshots (Main-001:144-150 writes
            # model/gradient .mat per iteration) so existing post-processing
            # scripts read this build's Results/ unchanged
            from scipy.io import savemat
            savemat(os.path.join(self.dir, f"{stem}.mat"), arrays)

    def __call__(self, x):
        self.loss_history.append(self.obj.f)
        with open(os.path.join(self.dir, "loss.txt"), "a") as fp:
            fp.write(f"{self.it} {self.obj.f}\n")
        if self.it % self.save_every == 0:
            self._snapshot(f"model_{self.it:04d}",
                           self.obj.unpack(np.asarray(x)))
            self._snapshot(f"grad_{self.it:04d}", self.obj.unpack(self.obj.g))
        self.it += 1


def lbfgs_on_device(loss_fn, params0: Dict[str, jnp.ndarray], n_iter: int,
                    bounds: Optional[Dict[str, tuple]] = None,
                    memory_size: int = 5, aux: tuple = ()):
    """On-device L-BFGS with box projection — an alternative to the scipy
    bridge: parameters never leave the device (the scipy path
    round-trips a float64 copy of the full model through the host on every
    evaluation, like the reference's numpy<->torch<->C++ chain).

    Box bounds are enforced by projection after each update (projected
    L-BFGS rather than scipy's true L-BFGS-B active-set method — adequate
    for the velocity/porosity box constraints used here).

    Returns (params, loss_history list of floats).
    """
    import optax

    params = {k: jnp.asarray(v) for k, v in params0.items()}

    if bounds:
        lo = {k: (jnp.asarray(bounds[k][0]) if k in bounds and
                  bounds[k] is not None else -jnp.inf) for k in params}
        hi = {k: (jnp.asarray(bounds[k][1]) if k in bounds and
                  bounds[k] is not None else jnp.inf) for k in params}
        clip = lambda p: {k: jnp.clip(p[k], lo[k], hi[k]) for k in p}

        # optimize loss(clip(p)) + pullback penalty: keeps L-BFGS curvature
        # consistent (projecting the iterates directly corrupts the memory)
        def obj(p, *a):
            pc = clip(p)
            pen = sum(jnp.sum((p[k] - pc[k]) ** 2) for k in p)
            return loss_fn(pc, *a) + 0.5 * pen
    else:
        clip = lambda p: p
        obj = loss_fn

    opt = optax.lbfgs(memory_size=memory_size)
    state = opt.init(params)

    @jax.jit
    def step(params, state, *a):
        # bind aux inside the jit so the data stays an argument (a closure
        # over device arrays would bake it into the program as a constant)
        obj_a = lambda p: obj(p, *a)
        value, grad = optax.value_and_grad_from_state(obj_a)(params,
                                                             state=state)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=obj_a)
        params = optax.apply_updates(params, updates)
        return params, state, value

    history = []
    for _ in range(n_iter):
        params, state, value = step(params, state, *aux)
        history.append(float(value))
    return clip(params), history


# L-BFGS-B options matching the reference driver (Main-001:157-168).
# The reference also sets disp/iprint; scipy deprecated those (1.18), so
# progress reporting lives in InversionLogger instead.
REFERENCE_LBFGSB_OPTIONS = dict(gtol=1e-16, ftol=1e-12, maxcor=5,
                                maxfun=1500, maxls=6)


def lbfgsb(objective: ScipyObjective, maxiter: int,
           callback: Optional[Callable] = None, **options):
    opts = dict(REFERENCE_LBFGSB_OPTIONS)
    opts.update(options)
    opts.pop("disp", None)   # deprecated scipy options, accepted and
    opts.pop("iprint", None)  # ignored for backward compatibility
    opts["maxiter"] = maxiter
    return sciopt.minimize(objective.fun, objective.x0, method="L-BFGS-B",
                           jac=objective.jac, bounds=objective.bounds,
                           tol=None, callback=callback, options=opts)
