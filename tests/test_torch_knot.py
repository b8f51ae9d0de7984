"""Augmented (force-feedback) knot of the PyTorch port == the JAX package's
vector/analytic knot, float64, on the CPU; plus a finite-difference check of
the port's own dynamics Jacobians.

Tolerance vs JAX: 1e-12 times the field's largest magnitude (the bar the JAX
package holds its own derivative kernels to): both sides run the same
formulas in float64 and differ by summation order only.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ffmpc_tpu.core import panda as jpanda
from ffmpc_tpu.ocp import weights as jw, action as jaction, problem as jprob
from ffmpc_tpu.mpc.controllers import make_vertical_down_R
from ffmpc_tpu_torch.core import panda as tpanda
from ffmpc_tpu_torch.ocp import weights as tw, action as taction

B, N = 3, 4
REL = 1e-12


def T(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{name}: err {err:.3e} scale {scale:.3e}"


@pytest.fixture(scope="module")
def setup():
    mj = jpanda.make_panda_model("plant", jnp.float64)
    mt = tpanda.panda_model_from_numpy(
        {k: np.asarray(v) for k, v in mj._asdict().items()},
        dtype=torch.float64, device="cpu")
    W = jw.flagship_weights()
    rng = np.random.default_rng(0)
    q0 = jpanda.KEYFRAMES["neutral"]
    x0 = np.concatenate([q0 + 0.05 * rng.normal(size=(B, 7)),
                         0.3 * rng.normal(size=(B, 7)),
                         5.0 * rng.normal(size=(B, 7))], axis=-1)
    ts = np.array([0.1, 0.5, 1.2])
    tau_ref = rng.normal(size=(B, 7))
    x_reg = np.concatenate([q0, np.zeros(7)])
    rrj, rTj = jax.vmap(lambda t, tr, x: jprob.build_problem_refs(
        jw.flagship_trajectory(), t, N, W.dt_ocp, x_reg, tr,
        jnp.asarray(make_vertical_down_R()), y_ref=x, dtype=jnp.float64))(
        ts, tau_ref, x0)
    rrt = tw.problem_refs_from_numpy(
        {k: np.asarray(v) for k, v in rrj._asdict().items()},
        dtype=torch.float64, device="cpu")
    rTt = tw.problem_refs_from_numpy(
        {k: np.asarray(v) for k, v in rTj._asdict().items()},
        dtype=torch.float64, device="cpu")
    xs = x0[:, None, :] + 0.05 * rng.normal(size=(B, N, 21))
    # controls beyond the soft limit so the barrier terms are active too
    us = 5.0 * rng.normal(size=(B, N, 7))
    us[0] *= 4.0
    return dict(mj=mj, mt=mt, rrj=rrj, rTj=rTj, rrt=rrt, rTt=rTt, xs=xs, us=us)


def knots(setup, surface):
    kj = jaction.make_augmented_knot(setup["mj"], jw.flagship_weights(), surface,
                                     deriv_mode="analytic", calc_mode="vector")
    kt = taction.make_augmented_knot(setup["mt"], tw.flagship_weights(), surface)
    return kj, kt


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_calc_and_diff_equal_jax(setup, surface):
    kj, kt = knots(setup, surface)
    assert (kt.nx, kt.nu, kt.u_lb, kt.u_ub) == (kj.nx, kj.nu, kj.u_lb, kj.u_ub)
    xs, us = setup["xs"], setup["us"]
    dj = jax.jit(jax.vmap(jax.vmap(kj.diff)))(setup["rrj"], xs, us)
    dt = kt.diff(setup["rrt"], T(xs), T(us))
    for name in dj._fields:
        close(getattr(dt, name).numpy(), getattr(dj, name), name)
    xn_j, c_j = jax.jit(jax.vmap(jax.vmap(kj.calc)))(setup["rrj"], xs, us)
    xn_t, c_t = kt.calc(setup["rrt"], T(xs), T(us))
    close(xn_t.numpy(), xn_j, "calc.xnext")
    close(c_t.numpy(), c_j, "calc.cost")
    # calc and diff agree with each other inside the port
    close(dt.xnext.numpy(), xn_t.numpy(), "diff.xnext vs calc")
    close(dt.cost.numpy(), c_t.numpy(), "diff.cost vs calc")


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_terminal_equal_jax(setup, surface):
    kj, kt = knots(setup, surface)
    xT = setup["xs"][:, -1]
    tj = jax.jit(jax.vmap(kj.term_diff))(setup["rTj"], xT)
    tt = kt.term_diff(setup["rTt"], T(xT))
    for name, gj, gt in zip(("cost", "Lx", "Lxx"), tj, tt):
        close(gt.numpy(), gj, "term_diff." + name)
    close(kt.term_calc(setup["rTt"], T(xT)).numpy(),
          jax.jit(jax.vmap(kj.term_calc))(setup["rTj"], xT), "term_calc")


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_dynamics_jacobians_match_finite_difference(setup, surface):
    """Fx / Fu against a central difference of the port's own calc.
    Step 1e-6; tolerance 2e-7 of the Jacobian's scale (truncation h^2 times
    third derivatives of the contact dynamics, plus roundoff eps/h)."""
    _, kt = knots(setup, surface)
    xs, us, ref = T(setup["xs"]), T(setup["us"]), setup["rrt"]
    d = kt.diff(ref, xs, us)
    h = 1e-6

    def fd(of_x):
        n = 21 if of_x else 7
        cols = []
        for j in range(n):
            e = torch.zeros(n, dtype=torch.float64)
            e[j] = h
            if of_x:
                p, m = kt.calc(ref, xs + e, us)[0], kt.calc(ref, xs - e, us)[0]
            else:
                p, m = kt.calc(ref, xs, us + e)[0], kt.calc(ref, xs, us - e)[0]
            cols.append((p - m) / (2 * h))
        return torch.stack(cols, dim=-1)

    for name, an, num in (("Fx", d.Fx, fd(True)), ("Fu", d.Fu, fd(False))):
        scale = max(1.0, float(an.abs().max()))
        err = float((an - num).abs().max())
        assert err <= 2e-7 * scale, f"{name}: {err:.3e} vs scale {scale:.3e}"


def test_cost_gradient_matches_finite_difference(setup):
    """Lx / Lu are exact gradients of the cost (Gauss-Newton drops only
    second derivatives): central difference of the port's own calc cost,
    step 1e-6, tolerance 1e-6 of the gradient's scale."""
    _, kt = knots(setup, True)
    xs, us, ref = T(setup["xs"]), T(setup["us"]), setup["rrt"]
    d = kt.diff(ref, xs, us)
    h = 1e-6
    gx = []
    for j in range(21):
        e = torch.zeros(21, dtype=torch.float64)
        e[j] = h
        gx.append((kt.calc(ref, xs + e, us)[1] - kt.calc(ref, xs - e, us)[1]) / (2 * h))
    gu = []
    for j in range(7):
        e = torch.zeros(7, dtype=torch.float64)
        e[j] = h
        gu.append((kt.calc(ref, xs, us + e)[1] - kt.calc(ref, xs, us - e)[1]) / (2 * h))
    for name, an, num in (("Lx", d.Lx, torch.stack(gx, -1)), ("Lu", d.Lu, torch.stack(gu, -1))):
        scale = max(1.0, float(an.abs().max()))
        assert float((an - num).abs().max()) <= 1e-6 * scale, name


def test_other_contact_models_raise(setup):
    """The normal_1d and point3d contacts are ported (point3d is held
    against JAX in ``tests/test_torch_point3d.py``); the knot refuses any
    other contact model's name instead of computing something untested."""
    import dataclasses
    W = dataclasses.replace(tw.flagship_weights(), contact_model="hertz")
    with pytest.raises(ValueError, match="hertz"):
        taction.make_augmented_knot(setup["mt"], W, True)
