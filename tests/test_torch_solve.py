"""The ported slices as a whole: batched BoxFDDP solve of the force-feedback
OCP, PyTorch port (CPU, float64, default settings: backward, rollout and diff
mode "kernel", so the plain versions on these CPU tensors; and with
diff_mode "plain") == the JAX package's
``make_batched_solve_fn(..., calc_mode="vector", solve_impl="vmap")`` with
the fused backward kernel in interpret mode.  (The rollout's plain version
is held against the JAX scalar knot, the TPU rollout kernel's own body, in
``test_torch_rollout.py``.)

Decisions (iterations, converged / diverged / feasible flags) must be equal.
Trajectories, gains, cost and stop agree to rtol 1e-6 / atol 1e-7, the bar the
JAX package uses between its own two backward implementations, with rtol
taken against each field's largest magnitude.  The reason it cannot be
tighter or element by element: once the box QP's Newton step has converged,
its 4-candidate argmin sits on an exact tie (objectives differ by O(reg^2)),
two summation orders break the tie differently, and kff moves by one
regularized Newton step, reg / lambda_min(Quu) = 1e-9 / 6e-4 relative on the
flagship problem, whatever the element's own size.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ffmpc_tpu.core import make_panda_model as j_make_model, KEYFRAMES, gravity_torque as j_gravity
from ffmpc_tpu.ocp.weights import flagship_weights as j_weights, flagship_trajectory as j_traj
from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings
from ffmpc_tpu.run.batch_runner import make_batched_solve_fn as j_make, EpisodeConfig as JEpisode
from ffmpc_tpu_torch.core import panda_model_from_numpy
from ffmpc_tpu_torch.ocp.weights import flagship_weights as t_weights, flagship_trajectory as t_traj
from ffmpc_tpu_torch.solver.fddp import FDDPSettings as TSettings
from ffmpc_tpu_torch.run.batch_runner import make_batched_solve_fn as t_make, EpisodeConfig as TEpisode

B, N = 3, 5
FLOAT_FIELDS = ("xs", "us", "K", "k", "cost", "stop")
FLAG_FIELDS = ("iters", "converged", "diverged", "feasible")


def assert_fields_close(got, want, rtol=1e-6, atol=1e-7):
    for name in FLOAT_FIELDS:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= atol + rtol * scale, f"{name}: err {err:.3e}, scale {scale:.3e}"


@pytest.fixture(scope="module")
def problem():
    """Warm starts built as the benchmark builds them (x0 = neutral pose +
    noise with gravity torques, trajectory held at x0), with one lane's
    controls far off so torque bounds go active in the box QP."""
    mj = j_make_model("plant", jnp.float64)
    mt = panda_model_from_numpy({k: np.asarray(v) for k, v in mj._asdict().items()},
                                dtype=torch.float64, device="cpu")
    q0 = np.asarray(KEYFRAMES["neutral"])
    tau_g = np.asarray(j_gravity(mj, jnp.asarray(q0)))
    rng = np.random.default_rng(5)
    y0 = np.concatenate([q0, np.zeros(7), tau_g])
    y0s = y0[None] + 0.02 * rng.normal(size=(B, 21))
    ts = np.full((B,), 1.2)
    xs = np.tile(y0s[:, None, :], (1, N + 1, 1))
    us = np.tile(tau_g[None, None], (B, N, 1))
    us[0] += 30.0 * rng.normal(size=(N, 7))
    return dict(mj=mj, mt=mt, q0=q0, args=(ts, y0s, xs, us))


def FDDPResultNumpy(res):
    """The port's result with numpy fields."""
    return type(res)(*(f.numpy() for f in res))


def t_solver(problem, max_iters, mode="plain", diff_mode=None):
    return t_make(problem["mt"], t_weights(),
                  TSettings(max_iters=max_iters, backward_mode=mode, rollout_mode=mode,
                            diff_mode=diff_mode or mode),
                  t_traj(),
                  TEpisode(controller="force_feedback", horizon=N),
                  problem["q0"], dtype=torch.float64, device="cpu")


# max_iters=6: lane 0 converges after 5 iterations while lanes 1-2 use the
# whole budget, so one JAX compile (the expensive part of this file) covers
# the plain iterations, the active torque box of lane 0 and the frozen-lane
# semantics (a finished problem keeps its carry while the batch goes on).
@pytest.mark.parametrize("max_iters,want_iters", [(6, [5, 6, 6])])
def test_batched_solve_equals_jax(problem, max_iters, want_iters):
    solve_j = jax.jit(j_make(
        problem["mj"], j_weights(),
        JSettings(max_iters=max_iters, backward_mode="pallas"), j_traj(),
        JEpisode(controller="force_feedback", horizon=N, deriv_mode="analytic"),
        problem["q0"], dtype=jnp.float64, calc_mode="vector", solve_impl="vmap"))
    rj = solve_j(*[jnp.asarray(a) for a in problem["args"]])
    st = TSettings(max_iters=max_iters)
    assert (st.backward_mode, st.rollout_mode, st.diff_mode) == ("kernel",) * 3
    for diff_mode in ("kernel", "plain"):
        rt = t_solver(problem, max_iters, mode="kernel", diff_mode=diff_mode)(*problem["args"])
        for name in FLAG_FIELDS:
            assert np.array_equal(getattr(rt, name).numpy(),
                                  np.asarray(getattr(rj, name))), (diff_mode, name)
        assert rt.iters.tolist() == want_iters
        assert_fields_close(FDDPResultNumpy(rt), rj)
        np.testing.assert_allclose(rt.xreg.numpy(), np.asarray(rj.xreg), rtol=1e-12)


def test_finished_lane_is_frozen_and_lanes_are_independent(problem):
    """A lane solved inside a batch equals the same lane solved alone, also
    when it finishes earlier than its neighbours.  Same code and float64
    arithmetic per lane, but batched matmuls may block their sums
    differently at another batch size, and the box QP's argmin ties turn
    such last-bit differences into the ones described at the top: same
    tolerance as against JAX."""
    args = problem["args"]
    batch = t_solver(problem, 6)(*args)
    assert batch.iters.tolist() == [5, 6, 6]
    assert batch.converged.tolist() == [True, False, False]
    # accepted step lengths: one of 2^0 .. 2^-9 per iteration run (0 if every
    # step length was rejected), and 0 for the iteration lane 0 did not run
    assert batch.alpha_hist.shape == (B, 6)
    assert batch.alpha_hist[0, 5].item() == 0.0
    steps = set(batch.alpha_hist.flatten().tolist())
    assert steps <= {0.0} | {0.5 ** i for i in range(10)}
    assert bool((batch.alpha_hist[:, 0] > 0).all())
    for b in range(B):
        single = t_solver(problem, 6)(*[a[b:b + 1] for a in args])
        # (the accepted step lengths are not compared: near convergence the
        # acceptance test itself sits on a rounding-level tie)
        assert single.alpha_hist.shape == (1, 6)
        for name in FLAG_FIELDS:
            assert torch.equal(getattr(single, name)[0], getattr(batch, name)[b]), name
        assert_fields_close(
            FDDPResultNumpy(type(batch)(*(f[b:b + 1] for f in batch))),
            FDDPResultNumpy(single))


def test_first_iteration_has_active_torque_bounds(problem):
    """The lane with far-off controls really exercises the box: its first
    backward sweep clamps some controls (zero gain rows)."""
    from ffmpc_tpu_torch.core import gravity_torque
    from ffmpc_tpu_torch.mpc.controllers import make_vertical_down_R
    from ffmpc_tpu_torch.ocp.action import make_augmented_knot
    from ffmpc_tpu_torch.ocp.problem import build_problem_refs
    from ffmpc_tpu_torch.solver.backward_cuda import backward_box_reference
    from ffmpc_tpu_torch.solver.diff_cuda import diff_reference
    from ffmpc_tpu_torch.solver.fddp import backward_inputs, control_bounds
    W = t_weights()
    ts, y0s, xs, us = (torch.as_tensor(a) for a in problem["args"])
    x_reg = torch.cat([torch.as_tensor(problem["q0"]), torch.zeros(7, dtype=torch.float64)])
    refs_run, ref_T = build_problem_refs(
        t_traj(), ts, N, W.dt_ocp, x_reg, gravity_torque(problem["mt"], y0s[:, :7]),
        make_vertical_down_R(), y_ref=y0s, dtype=torch.float64, device="cpu")
    knot = make_augmented_knot(problem["mt"], W, surface=True)
    bi = backward_inputs(diff_reference(knot, refs_run, ref_T, xs, us), y0s, xs, us,
                         torch.zeros(B, dtype=torch.bool),
                         *control_bounds(knot, torch.float64, "cpu"))
    assert not bool(bi.feasible.any())            # gaps are open on a cold rollout
    reg = torch.full((B,), 1e-9, dtype=torch.float64)
    K = backward_box_reference(*bi.args, reg, reg)[0]
    clamped = (K.abs().sum(-1) == 0).any(-1).any(-1)
    assert bool(clamped[0])


def test_kernel_mode_on_cpu_tensors_takes_the_plain_version(problem):
    r_k = t_solver(problem, 2, mode="kernel")(*problem["args"])
    r_p = t_solver(problem, 2, mode="plain")(*problem["args"])
    for a, b in zip(r_k, r_p):
        assert torch.equal(a, b)


def test_backward_retry_raises_regularization_per_lane(problem):
    """An indefinite Quu in one lane (a negative control-cost weight is not
    expressible through OCPWeights, so the retry is driven through the
    sweep directly): only that lane's regularization climbs."""
    from ffmpc_tpu_torch.solver import fddp as tfddp
    from ffmpc_tpu_torch.solver.backward_cuda import backward_box_reference
    rng = np.random.default_rng(9)
    nx, nu, n, nb = 21, 7, 3, 2
    eye_x, eye_u = np.eye(nx), np.eye(nu)
    A = 0.3 * rng.normal(size=(nb, n, nx, nx))
    Luu = np.tile(0.8 * eye_u, (nb, n, 1, 1))
    Luu[1, 1] = -3e-3 * eye_u                       # lane 1 needs ureg > 3e-3
    Fu = 0.2 * rng.normal(size=(nb, n, nx, nu))
    Fu[1, 1] = 0.0                                  # so that Quu = Luu + ureg I there
    args = [torch.as_tensor(a) for a in (
        eye_x + 0.05 * rng.normal(size=(nb, n, nx, nx)),
        Fu,
        rng.normal(size=(nb, n, nx)), rng.normal(size=(nb, n, nu)),
        A @ np.swapaxes(A, -1, -2) + 0.5 * eye_x,
        np.zeros((nb, n, nx, nu)), Luu,
        np.zeros((nb, n + 1, nx)), rng.normal(size=(nb, nx)),
        np.tile(1e-6 * eye_x, (nb, 1, 1)),
        np.full((nb, n, nu), -50.0), np.full((nb, n, nu), 50.0))]
    reg = torch.full((nb,), 1e-9, dtype=torch.float64)
    out = backward_box_reference(*args, reg, reg)
    assert out[5].tolist() == [False, True]
    # the loop of fddp.iteration, spelled out on these inputs
    xreg = reg
    while True:
        pred = out[5] & (xreg < 1e9)
        if not bool(pred.any()):
            break
        xr_n = torch.clamp(xreg * 10.0, max=1e9)
        out_n = backward_box_reference(*args, xr_n, xr_n)
        out = tuple(tfddp._select(pred, n_, o_) for n_, o_ in zip(out_n, out))
        xreg = torch.where(pred, xr_n, xreg)
    assert xreg[0].item() == 1e-9 and xreg[1].item() > 3e-3
    assert not bool(out[5].any())
    first = backward_box_reference(*args, reg, reg)
    assert torch.equal(out[0][0], first[0][0])       # lane 0 kept its outputs


def test_unsupported_settings_raise(problem):
    # the backward pass is always box-constrained: there is no switch
    with pytest.raises(TypeError, match="use_box"):
        TSettings(use_box=False)
    for field in ("backward_mode", "rollout_mode", "diff_mode"):
        with pytest.raises(ValueError, match=field):
            t_make(problem["mt"], t_weights(), TSettings(**{field: "pallas"}), t_traj(),
                   TEpisode(controller="force_feedback", horizon=N), problem["q0"],
                   dtype=torch.float64, device="cpu")(*problem["args"])
    # an unknown controller is refused by the batched solve and by the
    # closed loop (both take "force_feedback" and "classical": the classical
    # ones are tests/test_torch_classical.py's and
    # tests/test_torch_classical_loop.py's)
    with pytest.raises(ValueError, match="force_feedback"):
        t_make(problem["mt"], t_weights(), TSettings(), t_traj(),
               TEpisode(controller="lqr", horizon=N), problem["q0"],
               dtype=torch.float64, device="cpu")
    from ffmpc_tpu_torch.run.batch_runner import make_episode_fn
    from ffmpc_tpu_torch.sim.device_plant import make_table_params
    with pytest.raises(ValueError, match="force_feedback"):
        make_episode_fn(problem["mt"], t_weights(), TSettings(), t_traj(),
                        make_table_params(0.0, dtype=torch.float64, device="cpu"),
                        TEpisode(controller="lqr", horizon=N), problem["q0"],
                        dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="model lives on"):
        t_make(problem["mt"], t_weights(), TSettings(), t_traj(),
               TEpisode(controller="force_feedback", horizon=N), problem["q0"],
               dtype=torch.float32, device="cpu")


def _accept_step_with_gap_products(S, xs, us, cost_cur, xs_try, us_try, cost_try, w_all,
                                   dg, dq):
    """The acceptance as ``solver/fddp.py::accept_step`` read before the
    rollout formed the gap sum (the gap products in, dv formed here)."""
    from ffmpc_tpu_torch.solver.fddp import LineSearchStep, _select
    B, A = cost_try.shape
    alphas = 0.5 ** torch.arange(A, dtype=xs.dtype, device=xs.device)
    dV = cost_cur[:, None] - cost_try
    dx_all = xs[:, None] - xs_try
    dv = -torch.sum(w_all[:, None] * dx_all, dim=(2, 3))
    d1 = dg[:, None] + dv
    d2 = dq[:, None] - 2.0 * dv
    dVexp = alphas * (d1 + 0.5 * alphas * d2)
    finite = torch.isfinite(cost_try)
    cost_guard = (S.neg_step_cost_factor * cost_cur + S.neg_step_cost_slack)[:, None]
    ok_pos = (dVexp >= 0) & (
        ((d1.abs() < S.th_grad) & (cost_try < cost_guard))
        | (dV > S.th_acceptstep * dVexp))
    ok_neg = ((dVexp < 0) & (dV > S.th_acceptnegstep * dVexp)
              & (cost_try < cost_guard))
    ok = finite & (ok_pos | ok_neg)
    accepted = ok.any(dim=1)
    sel = torch.argmax(ok.to(torch.int8), dim=1)
    rows = torch.arange(B, device=xs.device)
    return LineSearchStep(
        accepted=accepted, alpha=alphas[sel],
        xs=_select(accepted, xs_try[rows, sel], xs),
        us=_select(accepted, us_try[rows, sel], us),
        cost=torch.where(accepted, cost_try[rows, sel], cost_cur))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_step_takes_the_rollouts_gap_sum(seed):
    """``accept_step`` given the rollout's ``dv_try`` picks the same step
    length and the same trajectory as the formula it held before, on seeded
    cases with non-finite costs (inf and NaN rows, a problem with none
    finite) and with ties: several step lengths passing, alpha = 1 among
    them, equal costs across step lengths."""
    from ffmpc_tpu_torch.solver import fddp as tfddp
    rng = np.random.default_rng(seed)
    nb, na, nh, nx, nu = 8, 10, 4, 21, 7
    xs = torch.as_tensor(rng.normal(size=(nb, nh + 1, nx)))
    us = torch.as_tensor(rng.normal(size=(nb, nh, nu)))
    xs_try = xs[:, None] + torch.as_tensor(0.05 * rng.normal(size=(nb, na, nh + 1, nx)))
    us_try = us[:, None] + torch.as_tensor(0.05 * rng.normal(size=(nb, na, nh, nu)))
    w_all = torch.as_tensor(rng.normal(size=(nb, nh + 1, nx)))
    cost_cur = torch.as_tensor(10.0 + rng.random(nb))
    cost_try = cost_cur[:, None] - torch.as_tensor(rng.random((nb, na)))
    cost_try[0, 1:] = float("inf")                 # only alpha = 1 finite
    cost_try[1, :] = float("nan")                  # nothing finite
    cost_try[2, 0] = float("nan")                  # alpha = 1 NaN, the rest pass
    cost_try[3, :] = cost_try[3, 0]                # equal costs at every step length
    cost_try[4, 0] = cost_try[4, 1]                # a tie between alpha = 1 and 1/2
    dg = torch.as_tensor(-rng.random(nb))
    dq = torch.as_tensor(-rng.random(nb))
    S = tfddp.FDDPSettings()
    want = _accept_step_with_gap_products(S, xs, us, cost_cur, xs_try, us_try, cost_try,
                                          w_all, dg, dq)
    # dv_try as rollout_reference forms it
    dv = -torch.sum(w_all[:, None] * (xs[:, None] - xs_try), dim=(2, 3))
    got = tfddp.accept_step(S, xs, us, cost_cur, xs_try, us_try, cost_try, dv, dg, dq)
    for name, a, b in zip(tfddp.LineSearchStep._fields, got, want):
        assert torch.equal(a, b), name
    assert bool(want.accepted[0]) and want.alpha[0].item() == 1.0
    assert not bool(want.accepted[1])
    assert torch.equal(want.xs[1], xs[1]) and want.cost[1] == cost_cur[1]
    assert bool(want.accepted[3]) and want.alpha[3].item() == 1.0
    assert bool(want.accepted[4]) and want.alpha[4].item() == 1.0
