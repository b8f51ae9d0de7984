"""PyTorch port of the problem-construction modules == the JAX package.

Pure data and elementwise float64 formulas evaluated in the same order on
both sides: equal to 1e-14 (absolute, values are O(1)).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ffmpc_tpu.core import panda as jpanda
from ffmpc_tpu.ocp import weights as jw, problem as jprob, activations as jact
from ffmpc_tpu.mpc.controllers import make_vertical_down_R as j_make_R
from ffmpc_tpu.tasks.trajectories import ApproachCircleTraj as JTraj
from ffmpc_tpu_torch.ocp import weights as tw, problem as tprob, activations as tact
from ffmpc_tpu_torch.mpc.controllers import make_vertical_down_R as t_make_R
from ffmpc_tpu_torch.tasks.trajectories import ApproachCircleTraj as TTraj

TOL = 1e-14


def T(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def test_flagship_presets_equal():
    assert dataclasses.asdict(tw.flagship_weights()) == dataclasses.asdict(jw.flagship_weights())
    assert dataclasses.asdict(tw.OCPWeights()) == dataclasses.asdict(jw.OCPWeights())
    assert dataclasses.asdict(tw.flagship_trajectory()) == dataclasses.asdict(jw.flagship_trajectory())
    assert tw.flagship_ff_alpha() == jw.flagship_ff_alpha()
    assert tw.flagship_ff_alpha(tw.FLAGSHIP_DT_MPC) == jw.flagship_ff_alpha(jw.FLAGSHIP_DT_MPC)
    assert np.array_equal(t_make_R(), j_make_R())


@pytest.mark.parametrize("kwargs", [
    dict(),                                            # flagship
    dict(t_pre=0.0, t_stabilize=0.0, ee_start=None, z_pre=None),
], ids=["flagship", "no_pre_no_hold"])
def test_trajectory_equals_jax(kwargs):
    base = dataclasses.asdict(jw.flagship_trajectory())
    base.update(kwargs)
    trj, trt = JTraj(**base), TTraj(**base)
    ts = np.concatenate([np.linspace(-0.1, 2.5, 53), [0.25, 0.8, 1.0]])
    pj, vj, sj = jax.vmap(trj)(jnp.asarray(ts))
    pt, vt, st = trt(T(ts))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=TOL)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    # tensor times of any shape
    p2, _, s2 = trt(T(ts).reshape(7, 8))
    assert p2.shape == (7, 8, 3) and s2.shape == (7, 8)


def test_build_problem_refs_equals_jax():
    rng = np.random.default_rng(0)
    B, N = 3, 6
    W = jw.flagship_weights()
    q0 = jpanda.KEYFRAMES["neutral"]
    x_reg = np.concatenate([q0, np.zeros(7)])
    ts = np.array([0.1, 0.5, 1.2])
    tau_ref = rng.normal(size=(B, 7))
    x0 = rng.normal(size=(B, 21))
    R = j_make_R()
    rrj, rTj = jax.vmap(lambda t, tr, x: jprob.build_problem_refs(
        jw.flagship_trajectory(), t, N, W.dt_ocp, x_reg, tr, jnp.asarray(R),
        y_ref=x, dtype=jnp.float64))(ts, tau_ref, x0)
    rrt, rTt = tprob.build_problem_refs(
        tw.flagship_trajectory(), ts, N, W.dt_ocp, x_reg, tau_ref, R,
        y_ref=x0, dtype=torch.float64, device="cpu")
    for name in rrj._fields:
        for gj, gt in ((getattr(rrj, name), getattr(rrt, name)),
                       (getattr(rTj, name), getattr(rTt, name))):
            assert tuple(gt.shape) == tuple(gj.shape), name
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                                       atol=TOL, err_msg=name)
    # the numpy bridge gives the same tensors
    bridged = tw.problem_refs_from_numpy(
        {k: np.asarray(v) for k, v in rrj._asdict().items()},
        dtype=torch.float64, device="cpu")
    for name in rrj._fields:
        np.testing.assert_allclose(getattr(bridged, name).numpy(),
                                   getattr(rrt, name).numpy(), rtol=0, atol=TOL)


def test_build_problem_refs_default_y_ref_and_bad_t0():
    W = tw.flagship_weights()
    rr, rT = tprob.build_problem_refs(
        tw.flagship_trajectory(), np.array([1.0, 1.1]), 4, W.dt_ocp,
        np.zeros(14), np.zeros(7), np.eye(3), dtype=torch.float64, device="cpu")
    assert rr.y_ref.shape == (2, 4, 21) and rT.y_ref.shape == (2, 21)
    assert float(rr.y_ref.abs().max()) == 0.0
    with pytest.raises(ValueError):
        tprob.build_problem_refs(tw.flagship_trajectory(), 1.0, 4, W.dt_ocp,
                                 np.zeros(14), np.zeros(7), np.eye(3),
                                 dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("kind", ["quad", "wquad", "barrier"])
def test_activations_equal_jax(kind):
    rng = np.random.default_rng(1)
    r = rng.normal(size=(4, 5))
    if kind == "quad":
        aj, at = jact.quad(), tact.quad()
    elif kind == "wquad":
        w = rng.uniform(0, 2, size=5)
        aj, at = jact.wquad(w), tact.wquad(w)
    else:
        lb, ub = [-0.5, -np.inf, 0.1, -1.0, -0.2], [0.5, 0.3, np.inf, 1.0, 0.2]
        aj, at = jact.barrier(lb, ub), tact.barrier(lb, ub)
    assert tuple(at) == tuple(aj)
    np.testing.assert_allclose(tact.value(at, T(r)).numpy(),
                               np.asarray(jax.vmap(lambda x: jact.value(aj, x))(r)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tact.grad(at, T(r)).numpy(),
                               np.asarray(jact.grad(aj, jnp.asarray(r))), rtol=0, atol=TOL)
    np.testing.assert_allclose(tact.hess_diag(at, T(r)).numpy(),
                               np.asarray(jact.hess_diag(aj, jnp.asarray(r))),
                               rtol=0, atol=TOL)
