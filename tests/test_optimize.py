"""Optimizer bridge: flatten/unflatten, caching, bounds enforcement,
preprocessed misfit chain."""
import jax
import jax.numpy as jnp
import numpy as np

from sep2023_tpu import optimize as opt
from sep2023_tpu.ops import misfit as mf


def _quad_problem():
    target = {"a": np.array([[1.0, 2.0], [3.0, 4.0]]), "b": np.array([5.0])}

    def loss(p):
        return (jnp.sum((p["a"] - jnp.asarray(target["a"])) ** 2)
                + jnp.sum((p["b"] - 5.0) ** 2))

    return loss, target


def test_unconstrained_converges():
    loss, target = _quad_problem()
    obj = opt.ScipyObjective(loss, {"a": np.zeros((2, 2)), "b": np.zeros(1)})
    res = opt.lbfgsb(obj, maxiter=50, disp=False, iprint=-1)
    out = obj.unpack(res.x)
    assert np.allclose(np.asarray(out["a"]), target["a"], atol=1e-5)
    assert np.allclose(np.asarray(out["b"]), 5.0, atol=1e-5)


def test_bounds_enforced():
    loss, _ = _quad_problem()
    obj = opt.ScipyObjective(loss, {"a": np.zeros((2, 2)), "b": np.zeros(1)},
                             bounds={"a": (0.0, 2.5), "b": (0.0, 10.0)})
    res = opt.lbfgsb(obj, maxiter=50, disp=False, iprint=-1)
    out = obj.unpack(res.x)
    a = np.asarray(out["a"])
    assert a.max() <= 2.5 + 1e-12  # clipped at the upper bound
    assert np.allclose(a.ravel()[:2], [1.0, 2.0], atol=1e-5)  # interior free


def test_eval_caching():
    """fun+jac at the same x must cost one evaluation (obj_wrapper.py:62-70
    semantics)."""
    loss, _ = _quad_problem()
    obj = opt.ScipyObjective(loss, {"a": np.zeros((2, 2)), "b": np.zeros(1)})
    x = obj.x0.copy()
    obj.fun(x)
    obj.jac(x)
    obj.fun(x)
    assert obj.n_evals == 1
    x2 = x + 1.0
    obj.fun(x2)
    assert obj.n_evals == 2


def test_on_device_lbfgs():
    loss, target = _quad_problem()
    params, hist = opt.lbfgs_on_device(
        loss, {"a": np.zeros((2, 2)), "b": np.zeros(1)}, n_iter=40)
    assert hist[-1] < 1e-8 * max(hist[0], 1.0)
    assert np.allclose(np.asarray(params["a"]), target["a"], atol=1e-3)


def test_on_device_lbfgs_bounds():
    loss, _ = _quad_problem()
    params, hist = opt.lbfgs_on_device(
        loss, {"a": np.zeros((2, 2)), "b": np.zeros(1)}, n_iter=40,
        bounds={"a": (0.0, 2.5), "b": None})
    a = np.asarray(params["a"])
    assert a.max() <= 2.5 + 1e-9
    assert np.allclose(a.ravel()[:2], [1.0, 2.0], atol=1e-3)


def test_preprocessed_l2_chain():
    rng = np.random.default_rng(0)
    obs = jnp.asarray(rng.normal(size=(4, 3, 256)))
    syn = jnp.asarray(rng.normal(size=(4, 3, 256)))
    loss = mf.make_preprocessed_l2(channels=("ett",), dt=0.002,
                                   filter_corners=(1.0, 3.0, 40.0, 60.0),
                                   window=(20, 230))
    v = float(loss(obs, syn))
    assert np.isfinite(v) and v > 0
    # identical data -> zero misfit through the whole chain
    assert float(loss(obs, obs)) < 1e-20
    # differentiable
    g = jax.grad(lambda s: loss(obs, s))(syn)
    assert np.isfinite(np.asarray(g)).all()
