"""The point contact (``contact_model="point3d"``: the contact force in R^3,
with the linearized friction cone's barrier on A f) in both knot families
of the port, float64 on the CPU unless marked:

- the force-feedback (augmented) and classical knots' calc, diff,
  term_calc and term_diff == the JAX package's vector/analytic knots on
  seeded inputs where the cone's barrier is live, at 1e-12 of each field's
  scale (``tests/test_torch_knot.py``'s bar: the same formulas, summed in
  another order);
- the kernels' constant packer for point3d == the JAX spec: the cone's 4
  barrier rows on A f with the spec's mu, 3-row unilateral and fn_track;
- ``diff_reference`` == the JAX package's channel diff (the TPU kernel's
  body, per knot, op by op) at 1e-12, and ``rollout_reference`` == its
  fused-rollout reference (the alpha-vmapped scan) at 1e-11;
- the batched solve of each controller (``make_batched_solve_fn``, the
  plain versions on these CPU tensors) == the JAX package's
  ``vmap(fddp.solve)`` at B=3, N=5: the same iterations and accepted step
  lengths, and us within rtol 1e-6 / atol 1e-7 of its scale (the bar of
  ``tests/test_torch_classical.py``'s batched solve);
- ``tests/test_point3d_closed_loop.py``'s episode (the classical
  controller, horizon 8, 3 iterations, 70 ticks into contact) on the port
  in plain mode with the cone (w = 3e2): both of that file's properties
  (finite telemetry with the normal force developed; the cone's weight
  changing the applied torques in contact, against the JAX episode without
  the cone), and tau_cmd and fn_meas against the JAX episode's, each tick
  within 1e-6 or within 10x the JAX package's own spread between its
  scalar and vector knots (the controller sits on box-QP ties, which
  carry such differences from tick to tick);
- ``cuda``-marked tests of the four point3d instantiations of the
  derivative and rollout kernels against their plain versions on the card
  (skipped without one).

The JAX solves' and episodes' figures are kept in this file (``JAX_SOLVES``,
``JAX_EPISODES``: their traces and XLA:CPU compiles take minutes), and
``JAX_PLATFORMS=cpu python tests/test_torch_point3d.py`` prints them anew.
The JAX knots, channel diff and fused rollout are run here, imported only
inside the comparisons with them (the ``jx`` fixture), which skip where JAX
is not installed: on a card's machine the ``cuda`` tests run with
``python -m pytest --noconftest tests/test_torch_point3d.py -m cuda``.
"""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

if __name__ == "__main__":      # run as a script: the repo's packages
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ffmpc_tpu_torch.core import KEYFRAMES, gravity_torque, make_panda_model
from ffmpc_tpu_torch.core.dynamics import fwd_dynamics_contact
from ffmpc_tpu_torch.mpc.controllers import make_vertical_down_R
from ffmpc_tpu_torch.ocp import action as taction
from ffmpc_tpu_torch.ocp.action import KnotDeriv
from ffmpc_tpu_torch.ocp.problem import build_problem_refs
from ffmpc_tpu_torch.ocp.weights import (OCPWeights, ProblemRefs, flagship_trajectory,
                                         flagship_weights)
from ffmpc_tpu_torch.run.batch_runner import (EpisodeConfig, make_batched_solve_fn,
                                              make_episode_fn)
from ffmpc_tpu_torch.sim.device_plant import make_table_params
from ffmpc_tpu_torch.solver import diff_cuda as dc
from ffmpc_tpu_torch.solver import rollout_cuda as rc
from ffmpc_tpu_torch.solver.fddp import FDDPSettings
from ffmpc_tpu_torch.tasks.trajectories import ApproachCircleTraj
from jax_figures import print_figures, stored

# One intra-op thread for torch in the test process: these tests run many
# tiny batched ops, which several threads only slow down, and steeply so
# when the test runner's worker processes share the machine's cores.
torch.set_num_threads(1)

# the point3d values MPCConfig gives a run (ffmpc_tpu/mpc/config.py:54-57)
P3 = dict(contact_model="point3d", w_friction_cone=2.0e2, mu=0.6, friction_margin=1e-3)
FAMILIES = ("augmented", "classical")
NX = {"augmented": 21, "classical": 14}
B, N, NA = 3, 4, 4
FIELDS = KnotDeriv._fields
TERM_FIELDS = ("cost_T", "LxT", "LxxT")


def weights():
    return dataclasses.replace(flagship_weights(), **P3)


def T(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def scale_of(want):
    return max(float(np.abs(np.asarray(want)).max()), 1.0)


def close(got, want, rtol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale_of(want), f"{name}: err {err:.3e} scale {scale_of(want):.3e}"


def make_knot(model, family, surface=True, W=None):
    make = taction.make_augmented_knot if family == "augmented" else taction.make_classical_knot
    return make(model, W or weights(), surface)


@pytest.fixture(scope="module")
def setup():
    """B problems of N knots, built with the port alone: states around the
    neutral pose (q by 0.05, v by 0.3, the torque state by 5 Nm), controls
    by 5 Nm around gravity torque (problem 0's 4x wider, so the torque
    barriers act), and the flagship trajectory's references in contact
    (t = 1.2, 1.5, 1.8 s), each problem's first state its state reference.
    Problems 0 and 1 move, and their contact forces leave the cone (its
    barrier acts); problem 2 rests at gravity torque with the contact's
    anchor 2 cm above its tool, pressed into it inside the cone (the
    barrier adds nothing)."""
    from ffmpc_tpu_torch.core.kinematics import fk
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    q0 = np.asarray(KEYFRAMES["neutral"])
    tau_g = gravity_torque(model, T(q0)).numpy()
    rng = np.random.default_rng(2)
    x0 = np.concatenate([q0 + 0.05 * rng.normal(size=(B, 7)), 0.3 * rng.normal(size=(B, 7)),
                         tau_g + 5.0 * rng.normal(size=(B, 7))], axis=-1)
    xs = x0[:, None, :] + 0.05 * rng.normal(size=(B, N + 1, 21))
    us = tau_g + 5.0 * rng.normal(size=(B, N, 7))
    us[0] *= 4.0
    xs[2, :, :7] = q0 + 0.01 * rng.normal(size=(N + 1, 7))
    xs[2, :, 7:14], xs[2, :, 14:], us[2] = 0.0, tau_g, tau_g
    x0[2] = xs[2, 0]
    W = weights()
    rr, rT = build_problem_refs(
        flagship_trajectory(), T([1.2, 1.5, 1.8]), N, W.dt_ocp,
        T(np.concatenate([q0, np.zeros(7)])), T(tau_g), T(make_vertical_down_R()),
        y_ref=T(x0), dtype=torch.float64, device="cpu")
    anchor = fk(model, T(xs[2, :, :7])).ee_p + T([0.0, 0.0, 0.02 + W.z_press])
    rr.p_ref[2], rT.p_ref[2] = anchor[:-1], anchor[-1]
    rr, rT = (ProblemRefs(*(a.contiguous() for a in r)) for r in (rr, rT))
    return SimpleNamespace(model=model, xs=xs, us=us, rr=rr, rT=rT, tau_g=tau_g, q0=q0)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces the comparisons need; skipped where JAX is
    not installed."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.core import make_panda_model as j_make_model
    from ffmpc_tpu.ocp import action as jaction
    from ffmpc_tpu.ocp.weights import OCPWeights as JWeights, ProblemRefs as JRefs
    from ffmpc_tpu.ocp.weights import flagship_weights as j_flagship
    return SimpleNamespace(jax=jax, jnp=jnp, mj=j_make_model("plant", jnp.float64),
                           jaction=jaction, JRefs=JRefs, JWeights=JWeights,
                           W=dataclasses.replace(j_flagship(), **P3))


def j_refs(jx, refs, index=()):
    return jx.JRefs(**{k: jx.jnp.asarray(getattr(refs, k)[index].numpy())
                       for k in ProblemRefs._fields})


def compiled_o0(jx, fn, args):
    """``fn`` jitted and compiled for ``args`` with LLVM at -O0 (the XLA:CPU
    compile is the cost of the comparisons with JAX)."""
    return jx.jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})


def cone_rows(knot, refs, xs, us):
    """The cone's residuals A f at the knots (..., 4), from the port's own
    contact dynamics."""
    W = knot.W
    x = xs[..., :14]
    tau = xs[..., 14:21] if knot.family == "augmented" else us
    ref_pos = torch.cat([refs.p_ref[..., :2], refs.p_ref[..., 2:3] - W.z_press], dim=-1)
    dyn = fwd_dynamics_contact(
        knot.model, x[..., :7], x[..., 7:14], tau, ref_pos=ref_pos, nc1=False,
        baumgarte_kp=W.contact_gains[0], baumgarte_kd=W.contact_gains[1],
        damping_c=W.contact_inv_damping)
    A = torch.as_tensor(taction._friction_cone_A(W.mu), dtype=torch.float64)
    return (A @ dyn.force[..., None])[..., 0]


# ---------------------------------------------------------------------------
# the knots against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_knot_equals_jax(setup, jx, family):
    """calc, diff, term_calc and term_diff of the point3d knot at 1e-12 of
    each field's scale, on knots where the cone's barrier acts (some A f
    below its bound friction_margin) and where it does not."""
    nx = NX[family]
    make = (jx.jaction.make_augmented_knot if family == "augmented"
            else jx.jaction.make_classical_knot)
    kj = make(jx.mj, jx.W, True, deriv_mode="analytic", calc_mode="vector")
    kt = make_knot(setup.model, family)
    assert (kt.nx, kt.nu, kt.u_lb, kt.u_ub) == (kj.nx, kj.nu, kj.u_lb, kj.u_ub)
    xs, us = setup.xs[..., :nx], setup.us
    xT = xs[:, -1]
    cone = cone_rows(kt, setup.rr, T(xs[:, :-1]), T(us))
    live = (cone < kt.W.friction_margin).any(-1)
    assert bool(live.any()) and not bool(live.all()), live
    jax = jx.jax
    vv = lambda f: jax.vmap(jax.vmap(f))  # noqa: E731

    def all_of(rr, rT, x, u, xT):
        return (vv(kj.diff)(rr, x, u), vv(kj.calc)(rr, x, u),
                jax.vmap(kj.term_diff)(rT, xT), jax.vmap(kj.term_calc)(rT, xT))
    args = (j_refs(jx, setup.rr), j_refs(jx, setup.rT), xs[:, :-1], us, xT)
    dj, (xn_j, c_j), tj, tcj = compiled_o0(jx, all_of, args)(*args)
    dt = kt.diff(setup.rr, T(xs[:, :-1]), T(us))
    for name in FIELDS:
        close(getattr(dt, name).numpy(), getattr(dj, name), 1e-12, "diff." + name)
    xn_t, c_t = kt.calc(setup.rr, T(xs[:, :-1]), T(us))
    close(xn_t.numpy(), xn_j, 1e-12, "calc.xnext")
    close(c_t.numpy(), c_j, 1e-12, "calc.cost")
    tt = kt.term_diff(setup.rT, T(xT))
    for name, gj, gt in zip(("cost", "Lx", "Lxx"), tj, tt):
        close(gt.numpy(), gj, 1e-12, "term_diff." + name)
    close(kt.term_calc(setup.rT, T(xT)).numpy(), tcj, 1e-12, "term_calc")
    # the cone's term is in the cost: at w = 0 the cost differs where it acts
    c0 = make_knot(setup.model, family, W=dataclasses.replace(weights(), w_friction_cone=0.0))
    dcost = (c_t - c0.calc(setup.rr, T(xs[:, :-1]), T(us))[1]).abs()
    assert bool((dcost[live] > 0).all()) and bool((dcost[~live] == 0).all())


# ---------------------------------------------------------------------------
# the kernels' constant packer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_packer_matches_jax_spec(setup, jx, family):
    """The point3d cost table on the kernels' slots (the cone's after
    vz_damp): every JAX spec term's scale, activation rows and bounds; the
    cone's 4 barrier rows [friction_margin, inf) on A f, unilateral's 3 rows
    bounded on the normal force only, fn_track weighting it only; mu first
    in the constants; and the cone's rows the kernels form, (-f0 + mu f2,
    f0 + mu f2, -f1 + mu f2, f1 + mu f2), are the JAX package's A."""
    W = jx.W
    spec = dict(jx.jaction._make_spec(jx.mj, W, True)[0])
    # the inner terms the augmented knot drops (its own y / w terms instead)
    dropped = taction.augmented_spec(setup.model, weights(), True)[1] if (
        family == "augmented") else []
    slots = rc._cost_slots("point3d")
    names = [n for n, _ in slots]
    assert names[names.index("vz_damp") + 1:names.index("y_reg")] == [
        "friction_cone", "unilateral", "fn_track"]
    table = rc.cost_table(setup.model, weights(), True, family)
    row0 = dict(zip(names, np.cumsum([0] + [n for _, n in slots])[:-1]))
    for s, (name, nr) in enumerate(slots):
        t = spec.get(name)
        if t is None or name in dropped:
            continue
        assert table["slot_scale"][s] == t.weight * W.dt_ocp, name
        rows = slice(row0[name], row0[name] + nr)
        a = t.activation
        if a.kind == "barrier":
            assert table["slot_barrier"][s] == 1.0, name
            np.testing.assert_array_equal(table["row_lb"][rows], np.asarray(a.lb, float))
            np.testing.assert_array_equal(table["row_ub"][rows], np.asarray(a.ub, float))
        elif a.kind == "wquad":
            np.testing.assert_array_equal(table["row_w"][rows], np.asarray(a.weights, float))
    cone = slice(row0["friction_cone"], row0["friction_cone"] + 4)
    np.testing.assert_array_equal(table["row_lb"][cone], [W.friction_margin] * 4)
    uni = slice(row0["unilateral"], row0["unilateral"] + 3)
    np.testing.assert_array_equal(table["row_lb"][uni], [-np.inf, -np.inf, W.friction_margin])
    fn = slice(row0["fn_track"], row0["fn_track"] + 3)
    np.testing.assert_array_equal(table["row_w"][fn], [0.0, 0.0, 1.0])
    consts = rc.pack_knot_consts(setup.model, weights(), True, torch.float64, family)
    assert consts.numel() == rc.consts_len(family, "point3d") != rc.consts_len(family)
    assert float(consts[0]) == W.mu
    A = np.asarray(jx.jaction._friction_cone_A(W.mu))
    mu = W.mu
    np.testing.assert_array_equal(A, [[-1, 0, mu], [1, 0, mu], [0, -1, mu], [0, 1, mu]])
    np.testing.assert_array_equal(A, taction._friction_cone_A(mu))


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_diff_reference_matches_jax_channel_diff(setup, jx, family):
    """Running knots of problems 0 and 1 at their first two knots:
    ``diff_reference`` against the channel diff (covering nc = 3), called per
    knot and op by op as ``tests/test_torch_diff.py`` calls it."""
    from ffmpc_tpu.ocp.channel_diff import diff_via_channels
    nx = NX[family]
    kt = make_knot(setup.model, family)
    xs, us = T(setup.xs[..., :nx]), T(setup.us)
    got = dc.diff_reference(kt, setup.rr, setup.rT, xs, us)
    ch = diff_via_channels(jx.mj, jx.W, True, family)
    for b in range(2):
        for t in range(2):
            want = ch(j_refs(jx, setup.rr, (b, t)), jx.jnp.asarray(setup.xs[b, t, :nx]),
                      jx.jnp.asarray(setup.us[b, t]))
            for name in FIELDS:
                close(getattr(got.run, name)[b, t].numpy(), getattr(want, name), 1e-12,
                      f"{family} ({b}, {t}) {name}")


def rollout_inputs(setup, nx, seed=7):
    """Seeded rollout inputs (``tests/test_torch_rollout.py``'s recipe):
    states around the setup's first states, controls around gravity torque,
    random gains, feed-forwards, gaps and gap products, every other problem
    feasible."""
    rng = np.random.default_rng(seed)
    x0 = setup.xs[:, 0, :nx] + 0.05 * rng.normal(size=(B, nx))
    xs = np.tile(x0[:, None], (1, N + 1, 1)) + 0.02 * rng.normal(size=(B, N + 1, nx))
    us = setup.tau_g + 2.0 * rng.normal(size=(B, N, 7))
    K = 0.1 * rng.normal(size=(B, N, 7, nx))
    kff = rng.normal(size=(B, N, 7))
    fs = 0.1 * rng.normal(size=(B, N + 1, nx))
    w_all = 0.3 * rng.normal(size=(B, N + 1, nx))
    feas = torch.arange(B) % 2 == 1
    return [T(a) for a in (x0, xs, us, K, kff, fs, w_all)] + [feas]


@pytest.mark.parametrize("family", FAMILIES)
def test_rollout_reference_matches_jax_fused_rollout(setup, jx, family):
    """``rollout_reference`` against the JAX package's plain fused-rollout
    reference (``make_fused_rollout``: the alpha-vmapped scan, called
    unbatched per problem) at rtol 1e-11 (the bar of
    ``tests/test_torch_rollout.py``), with the gap sums formed from its
    trajectories as ``ffmpc_tpu/solver/fddp.py`` forms them."""
    from ffmpc_tpu.solver.rollout_pallas import make_fused_rollout
    nx = NX[family]
    make = (jx.jaction.make_augmented_knot if family == "augmented"
            else jx.jaction.make_classical_knot)
    kj = make(jx.mj, jx.W, True, deriv_mode="analytic", calc_mode="vector")
    kt = make_knot(setup.model, family)
    arrays = rollout_inputs(setup, nx)
    got = rc.rollout_reference(kt, *arrays, setup.rr, setup.rT, NA)
    fn = make_fused_rollout(kj, NA, use_box=True)
    jnp = jx.jnp
    args0 = [jnp.asarray(a[0].numpy()) for a in arrays[:6]] + [jnp.asarray(bool(arrays[7][0]))]
    run = compiled_o0(jx, fn, (*args0, j_refs(jx, setup.rr, 0), j_refs(jx, setup.rT, 0)))
    outs = [run(*[jnp.asarray(a[b].numpy()) for a in arrays[:6]], jnp.asarray(bool(arrays[7][b])),
                j_refs(jx, setup.rr, b), j_refs(jx, setup.rT, b)) for b in range(B)]
    want = [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]
    xs_np, w_np = arrays[1].numpy(), arrays[6].numpy()
    dv = -np.sum(w_np[:, None] * (xs_np[:, None] - want[0]), axis=(2, 3))
    for name, g, w, rtol in zip(("xs_try", "us_try", "cost_try", "dv_try"), got, want + [dv],
                                (1e-11, 1e-11, 1e-11, 1e-12)):
        close(g.numpy(), w, rtol, f"{family} {name}")
    assert all(bool(torch.isfinite(g).all()) for g in got)


# ---------------------------------------------------------------------------
# the batched solves
# ---------------------------------------------------------------------------

SOLVE_B, SOLVE_N, SOLVE_ITERS = 3, 5, 6
CONTROLLERS = ("force_feedback", "classical")


def solve_problem(controller):
    """Warm starts as ``chip_smoke.py`` builds them (x0 the neutral pose
    plus noise, at rest, with gravity torque for the force-feedback state;
    the trajectory held at x0; controls at gravity torque), in contact at
    t = 1.2 s, problem 0's controls far off so the torque box goes active."""
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    q0 = np.asarray(KEYFRAMES["neutral"])
    tau_g = gravity_torque(model, T(q0)).numpy()
    rng = np.random.default_rng(5)
    x_nom = np.concatenate([q0, np.zeros(7)] + ([tau_g] if controller == "force_feedback"
                                                 else []))
    x0s = x_nom[None] + 0.02 * rng.normal(size=(SOLVE_B, x_nom.size))
    xs = np.tile(x0s[:, None], (1, SOLVE_N + 1, 1))
    us = np.tile(tau_g[None, None], (SOLVE_B, SOLVE_N, 1))
    us[0] += 30.0 * rng.normal(size=(SOLVE_N, 7))
    return model, q0, (np.full((SOLVE_B,), 1.2), x0s, xs, us)


def jax_solve_figures(controller):
    """The JAX package's ``make_batched_solve_fn`` solve (its vmapped
    ``fddp.solve`` over the vector knot), with each problem's accepted step
    length at every iteration (``fddp.solve(..., debug_history=True)``: its
    step length where the iteration accepted one, else 0)."""
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.core import gravity_torque as j_gravity, make_panda_model as j_make_model
    from ffmpc_tpu.ocp import action as jaction
    from ffmpc_tpu.ocp.problem import build_problem_refs as j_build_refs
    from ffmpc_tpu.ocp.weights import flagship_trajectory as j_traj
    from ffmpc_tpu.ocp.weights import flagship_weights as j_flagship
    from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings, solve as j_solve
    jax.config.update("jax_enable_x64", True)
    mj = j_make_model("plant", jnp.float64)
    W = dataclasses.replace(j_flagship(), **P3)
    is_ff = controller == "force_feedback"
    make = jaction.make_augmented_knot if is_ff else jaction.make_classical_knot
    knot = make(mj, W, True, deriv_mode="analytic", calc_mode="vector")
    _, q0, args = solve_problem(controller)
    x_reg = jnp.concatenate([jnp.asarray(q0), jnp.zeros(7)])
    R_des = jnp.asarray(make_vertical_down_R())

    def one(t, x0, xs_w, us_w):
        rr, rT = j_build_refs(j_traj(), t, SOLVE_N, W.dt_ocp, x_reg, j_gravity(mj, x0[:7]),
                              R_des, y_ref=(x0 if is_ff else None), dtype=jnp.float64)
        return j_solve(knot, rr, rT, x0, xs_w, us_w, JSettings(max_iters=SOLVE_ITERS),
                       debug_history=True)
    j_args = [jnp.asarray(a) for a in args]
    res, hist = jax.jit(jax.vmap(one)).lower(*j_args).compile(
        {"xla_backend_optimization_level": 0})(*j_args)
    iters = np.asarray(res.iters)
    # the accepted step length (0: rejected), as the port's alpha_hist
    # records it, over the iterations that ran
    alphas = np.where(np.asarray(hist["accepted"]), np.asarray(hist["alpha"], np.float64), 0.0)
    alphas = np.where(np.arange(SOLVE_ITERS)[None] < iters[:, None], alphas, 0.0)
    return {"iters": iters, "alpha_hist": alphas, "us": np.asarray(res.us)}


@pytest.mark.parametrize("controller", CONTROLLERS)
def test_batched_solve_equals_jax(controller):
    """``make_batched_solve_fn`` of each controller on the point3d knot (all
    modes "kernel": the plain versions on these CPU tensors) against the JAX
    package's solve of the same problems (``JAX_SOLVES``): the same
    iterations and accepted step lengths at every iteration, and us within
    rtol 1e-6 / atol 1e-7 of its scale."""
    model, q0, args = solve_problem(controller)
    res = make_batched_solve_fn(
        model, weights(), FDDPSettings(max_iters=SOLVE_ITERS), flagship_trajectory(),
        EpisodeConfig(controller=controller, horizon=SOLVE_N), q0, surface=True,
        dtype=torch.float64, device="cpu")(*args)
    want = stored(JAX_SOLVES)[controller]
    iters = res.iters.numpy()
    assert np.array_equal(iters, want["iters"])
    assert bool((iters > 1).all())
    np.testing.assert_array_equal(res.alpha_hist.numpy(), want["alpha_hist"])
    err = float(np.abs(res.us.numpy() - want["us"]).max())
    assert err <= 1e-7 + 1e-6 * float(np.abs(want["us"]).max()), err


# ---------------------------------------------------------------------------
# the closed loop (tests/test_point3d_closed_loop.py's episode)
# ---------------------------------------------------------------------------

Z_C = 0.342
N_TICKS = 70
CONE_WEIGHTS = (0.0, 3.0e2)
LOOP_W = dict(dt_ocp=0.01, w_ee_pos=1.2e3, w_plane_z=9.0e2, w_vz=3.0e2,
              w_tangent_pos=3.6e3, w_tangent_vel=1.2e3,
              contact_gains=(145.0, 85.0), fn_des=22.0, w_fn=3.0e1,
              w_unilateral=3.0e1, z_press=0.0065, contact_model="point3d", mu=0.6)
# fast approach so contact engages within the short episode
LOOP_TRAJ = dict(center=(-0.5, 0.0, Z_C), radius=0.10, omega=1.5, z_contact=Z_C,
                 t_approach=0.12, z_pre=Z_C + 0.02, t_pre=0.06,
                 ee_start=(-0.3, 0.0, 0.633), t_stabilize=0.04)
LOOP_EP = dict(controller="classical", horizon=8, n_ticks=N_TICKS)
LOOP_RTOL, LOOP_ATOL = 1e-6, 1e-7
# The episode sits on the classical controller's box-QP ties, which carry a
# knot's rounding-level differences from tick to tick: the JAX package's own
# two calc modes (make_classical_knot's default "scalar", the TPU kernels'
# code, and "vector", about 1e-9 a knot apart, ``tests/test_torch_rollout.py``)
# part by 1e-4 of the torques by tick 55 and by their full range from tick
# 60 on, in contact.  So a tick of the port holds where its distance from
# the JAX episode is within LOOP_RTOL / LOOP_ATOL of the field's largest
# magnitude or within LOOP_TIE_FACTOR times the JAX package's own spread
# between its calc modes up to that tick (``chip_smoke.py``'s
# CL_LOOP_TIE_FACTOR); iterations stay equal.
LOOP_TIE_FACTOR = 10.0


def jax_episode_figures(w_cone, calc_mode=None):
    """The JAX episode of ``tests/test_point3d_closed_loop.py`` at the cone
    weight ``w_cone``: its tau_cmd, fn_meas and iterations; with
    ``calc_mode`` ("vector"), over knots built with that calc mode (the
    episode builds them with make_classical_knot's default, "scalar")."""
    import functools
    from unittest import mock
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.core import make_panda_model as j_make_model
    from ffmpc_tpu.ocp import action as jaction
    from ffmpc_tpu.ocp.weights import OCPWeights as JWeights
    from ffmpc_tpu.run import batch_runner as jrunner
    from ffmpc_tpu.sim.device_plant import make_table_params as j_table
    from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings
    from ffmpc_tpu.tasks.trajectories import ApproachCircleTraj as JTraj
    jax.config.update("jax_enable_x64", True)
    knot = jaction.make_classical_knot
    if calc_mode is not None:
        knot = functools.partial(knot, calc_mode=calc_mode)
    with mock.patch.object(jrunner, "make_classical_knot", knot):
        episode = jax.jit(jrunner.make_episode_fn(
            j_make_model("plant", jnp.float64), JWeights(**LOOP_W, w_friction_cone=w_cone),
            JSettings(max_iters=3, use_box=True), JTraj(**LOOP_TRAJ),
            j_table(0.0, dtype=jnp.float64), jrunner.EpisodeConfig(**LOOP_EP),
            np.asarray(KEYFRAMES["neutral"]), dtype=jnp.float64))
        telem = episode(jnp.asarray(KEYFRAMES["neutral"], jnp.float64))
    return {k: np.asarray(telem[k]) for k in ("tau_cmd", "fn_meas", "iters")}


def port_episode():
    """The port's episode with the cone (w = 3e2), plain mode, float64."""
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    plain = FDDPSettings(max_iters=3, backward_mode="plain", rollout_mode="plain",
                         diff_mode="plain")
    ep = make_episode_fn(
        model, OCPWeights(**LOOP_W, w_friction_cone=CONE_WEIGHTS[1]), plain,
        ApproachCircleTraj(**LOOP_TRAJ), make_table_params(0.0, dtype=torch.float64,
                                                           device="cpu"),
        EpisodeConfig(**LOOP_EP), np.asarray(KEYFRAMES["neutral"]), dtype=torch.float64,
        device="cpu")
    telem = ep(torch.as_tensor(np.asarray(KEYFRAMES["neutral"]))[None])
    return {k: v[0].numpy() for k, v in telem.items()}


def test_point3d_closed_loop_episode():
    """The episode of ``tests/test_point3d_closed_loop.py`` on the port with
    the cone, in one test (one run of the episode, about a minute of plain
    mode):
    - its first property: finite telemetry, and the normal force developed
      and held at the end;
    - its second: the cone's weight changes the applied torques once in
      contact.  The port's torques with the cone stand against the JAX
      episode's without it (``JAX_EPISODES``): the same up to contact (to
      1e-6 of scale), apart in the last 10 ticks;
    - tau_cmd and fn_meas of every tick, and the iterations, against the JAX
      episode's with the cone, each tick within LOOP_RTOL / LOOP_ATOL of
      the field's largest magnitude or within LOOP_TIE_FACTOR times the JAX
      package's own spread between its scalar and vector calc modes, up to
      that tick."""
    episode = port_episode()
    assert np.all(np.isfinite(episode["q"]))
    assert np.all(np.isfinite(episode["tau_cmd"]))
    assert not episode["fallback"].any()
    assert episode["fn_meas"][-5:].min() > 1.0, f"no contact force: {episode['fn_meas'][-5:]}"

    figs = stored(JAX_EPISODES)
    off = figs["w_cone=0"]["tau_cmd"]
    dmax = np.max(np.abs(episode["tau_cmd"] - off), axis=1)
    assert dmax[:20].max() <= 1e-6 * float(np.abs(off).max()), dmax[:20]
    assert dmax[-10:].max() > 1e-6, "w_friction_cone had no closed-loop effect"

    want = figs[f"w_cone={CONE_WEIGHTS[1]:g}"]
    vector = figs[f"w_cone={CONE_WEIGHTS[1]:g}/vector"]
    np.testing.assert_array_equal(episode["iters"], want["iters"])
    for name in ("tau_cmd", "fn_meas"):
        g, w, y = episode[name], want[name], vector[name]
        assert g.shape == w.shape, name
        err = np.abs(g - w).reshape(len(w), -1).max(axis=1)
        yard = np.maximum.accumulate(np.abs(y - w).reshape(len(w), -1).max(axis=1))
        bar = np.maximum(LOOP_ATOL + LOOP_RTOL * float(np.abs(w).max()), LOOP_TIE_FACTOR * yard)
        assert (err <= bar).all(), (name, np.flatnonzero(err > bar), err.max())


# ---------------------------------------------------------------------------
# the point3d instantiations on the card (python -m pytest --noconftest -m cuda)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kernel", ["knot_diff", "rollout"])
def test_cuda_point3d_kernel_matches_plain_version(kernel, family):
    """Each point3d instantiation against its plain version on the card,
    float64 and float32, at B = 1, 3 and 1,024, on seeded inputs and on the
    point3d main path's first-iteration inputs, at ``chip_smoke.py``'s
    gates (phase ``point3d``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the point3d kernels have no CPU build")
    import chip_smoke as cs
    recs = cs.point3d_kernel_checks(kernel, family)
    failed = [r for r in recs if not r["ok"]]
    assert recs and not failed, failed


# ---------------------------------------------------------------------------
# the JAX package's figures this file keeps
# ---------------------------------------------------------------------------

# printed by `JAX_PLATFORMS=cpu python tests/test_torch_point3d.py`
JAX_SOLVES = {
    'force_feedback': {
        'iters': ((3,), [
            6.0, 6.0, 6.0,
        ]),
        'alpha_hist': ((3, 6), [
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0,
            0.0,
        ]),
        'us': ((3, 5, 7), [
            0.0007612083663045575, 1.9305736074514515, -0.555741915238024, -13.755811056309351,
            1.9414236190972172, 4.870081437642624, -1.2693748838892664, -0.007826219528152737,
            -0.18985195752327444, -0.029786126068699435, 9.948993134344814, -0.02043506780268218,
            0.8355359803781496, -0.47569656659312437, -0.06750170376396411, -0.08782529748408174,
            -0.12068900795060347, 9.167942655368153, 0.46197900061028707, 0.2424114002134867,
            -0.2581496577611583, -0.0588771648212661, -0.3215577647988396, -0.05060580814920335,
            8.852960908715291, 0.19365151756801907, 0.6427033850212672, -0.09083567150007786,
            0.05897737324926803, -0.6987805058091916, 0.15323814448781065, 8.432821126596298,
            -0.8188972130255302, 1.594042645108931, 0.08768736120239078, -0.037759803887028154,
            2.614389303933876, -0.45752773330920693, -12.815386458070062, 0.9624442461259748,
            4.587717697983508, -0.9624683782875247, -0.0027179726506572355, 0.043706674472370484,
            0.04854414054140438, 10.141798584531994, -0.19996113753625722, -0.02788794640727066,
            -0.42489932289667676, -0.0650963372448426, -0.031080419883004307, -0.07782303060914088,
            9.249842975493896, 0.414243060402577, 0.035043416131378236, -0.29302414347786865,
            -0.05259626371703824, -0.45133926234516475, -0.0067269098869410515, 9.013658599801767,
            0.14948293245941596, 0.16592985872908866, -0.13810359116188367, 0.07234188352849505,
            -0.9472754720395273, 0.20452142741543267, 8.772192825124234, -0.8762436612583404,
            0.33336050149891966, 0.09120323780044397, -0.08752378194723873, 2.7398686906598546,
            -0.15776588834098104, -12.323182436954763, 0.28308327584942505, 4.421061815720675,
            -0.2903994658297785, -0.09861622357328176, 0.15310297015487348, 0.2554291148056298,
            10.073461054377109, -0.4058581819714164, -0.08315907221567687, -0.18110505424314005,
            -0.15079298904500055, -0.014656200857705581, 0.05771576002221605, 9.25770073215704,
            0.42686821103357203, -0.027439775036333047, -0.19674680035311762, -0.10891964835133998,
            -0.45898759644572584, 0.09070653801045095, 9.029361192672468, 0.18802830335166518,
            0.10545217123706452, -0.10853482061414657, 0.09128044592677437, -0.9330238874739113,
            0.2581773387024121, 8.776617764740962, -0.9233399576088149, 0.2815718779310949,
            0.08467168731831873,
        ]),
    },
    'classical': {
        'iters': ((3,), [
            6.0, 6.0, 6.0,
        ]),
        'alpha_hist': ((3, 6), [
            1.0, 1.0, 1.0, 0.5, 0.25, 1.0, 1.0, 0.5, 0.5, 1.0, 0.125, 0.25, 1.0, 1.0, 1.0, 0.5,
            1.0, 0.0625,
        ]),
        'us': ((3, 5, 7), [
            -87.0, 87.0, 82.03298967632486, -86.17182175497541, -9.724047104708283,
            6.488453669629431, 3.0, -87.0, 44.47199363178922, 64.84833036073468, 7.543772419943559,
            11.486919519121114, -5.019269544085806, 6.0231214750666275, 84.48046244576747,
            59.95511857432266, -69.47141881119428, 24.13908796497644, 3.84907959386987, -12.0,
            -5.306715154025143, -76.27506264996698, 31.663226477023244, 85.93307681530513,
            0.43698293629845286, -11.83969414948292, -11.671348993223686, -11.506668983349208,
            50.856445388983886, 59.58996456894442, -55.3582206626347, 16.25574161602288,
            2.660933705744288, -12.0, -6.938390869253111, 15.971981933456732, 51.219754926451515,
            -21.91729572790411, -60.6446042273962, -8.826906729193416, 9.394040777541871,
            0.44442246548117126, -87.0, 25.39311409168109, 55.98429797368776, 4.411484463152092,
            12.0, 1.7276959560345342, -12.0, -87.0, 32.70258085258923, 87.0, 9.41047681600496,
            12.0, -7.286510099061598, -12.0, -86.41043851839504, 45.170620373980285,
            86.62971077154792, 18.232432010364544, 11.09094837527959, -12.0, -11.235447416869427,
            19.77963836851111, 21.55400393813789, -68.8633622958927, 26.71022375072924, 12.0,
            -11.98585199745894, 5.009144855688227, -87.0, 87.0, 87.0, -87.0, -12.0, 12.0, -12.0,
            5.4375, 33.943043218137106, -18.564730389381186, 8.083570561204635, 0.854847718803602,
            -0.75, 6.836582629420042, -11.775055118105097, 82.86962005103638, -19.254633821018462,
            12.095104502124785, -0.7342662982847535, -12.0, -0.75, -81.57843782282573,
            15.118951440836474, 49.86633201216991, 8.01814202274077, 11.119757300946478,
            -0.19350367262104695, -11.301646136811604, 86.19235350127907, 10.634933340296236,
            -87.0, 18.418140755942428, 12.0, -1.0907082867634976, 10.954687640743536,
        ]),
    },
}
JAX_EPISODES = {
    'w_cone=0': {
        'tau_cmd': ((70, 7), [
            -11.524621786813947, 87.0, -28.337122616156815, -87.0, -3.7983637685840526,
            7.000744355689221, 0.8846324696396826, -7.041900269120886, 85.4391428103405,
            3.1729834655479205, -87.0, -1.3611028977358923, 4.065434511544449, 0.39520019045264254,
            -19.76500770820147, 87.0, 16.5039680108211, -87.0, -0.02299695157170656,
            7.1971880665009875, -2.406989068281688, -22.464091006983995, 87.0, 18.611737780570802,
            -87.0, 0.2872922089157219, 8.726748850972983, -3.323788148466584, -27.04274491203013,
            87.0, 20.56770520255925, -87.0, 0.767043729190324, 9.97259608740156, -4.37791659957487,
            -28.96514809255884, 87.0, 28.160880081660252, -87.0, 1.7961916455324571,
            10.806770438913917, -5.070966420169153, -24.901000102808972, 87.0, 25.162758907794675,
            -87.0, 1.9484142543376788, 11.92595086096675, -4.577102636161595, -9.666714917520647,
            87.0, 39.36143119928842, -87.0, 3.4813022184566424, 12.0, -2.5640659013759874,
            -11.028993002669282, 87.0, 33.821634668871916, -87.0, 3.2237718795427988, 12.0,
            -2.7740980149981156, -3.3321324918643764, 87.0, 25.311505216551716, -87.0,
            2.4313651508620504, 12.0, -1.4567353031521186, -1.0130128507513314, 87.0,
            6.919848622621011, -87.0, 0.41026726073129455, 12.0, -0.6474229881425042,
            3.012521133287473, 87.0, 5.399368656602034, -87.0, 0.2862172593964403, 12.0,
            -0.13555463795894884, 11.170788593242602, 87.0, -3.6179925045856622,
            -72.20339874711622, -0.5389448814258264, 12.0, 1.5452660497410777, 12.579423520886742,
            87.0, -11.334333010429631, -34.34064451777024, -0.23672413775764323, 12.0,
            2.4183691196194186, 13.780010493183132, 48.28345792460276, -14.368751967218774,
            45.72018994394724, 1.5209424693207665, 12.0, 3.118998102043872, 14.27183717598989,
            16.124952592633196, -19.753159332606124, 56.39212073547437, 0.8745727181090268, 12.0,
            3.062624269650036, 10.661771463001763, -50.36768598807068, -16.04380580668533,
            74.59906844570853, 1.4675943604945731, 10.219927888213551, 1.9121693927540209,
            3.8968666543413946, -74.11719970073817, -12.807245369275684, 85.78120152903163,
            2.808128198720425, 4.891314370586437, 0.12792445547107897, -1.3612947491110106,
            -37.403246158493076, -17.47320544111563, 87.0, 1.8846812465366716, 8.406164426527768,
            1.2238867607431272, 8.92665158511254, 16.120985750631668, -27.95374929688184, 87.0,
            -0.10628989402550532, 12.0, 3.126429904026976, 0.9484967898683733, -50.15057440123905,
            -17.316045388419816, 87.0, 0.841379666362418, 7.314600854009132, 1.3584392664912688,
            3.8245784927730018, -36.51078680357035, -16.91151618079432, 87.0, 1.045899374975058,
            8.095027051988898, 1.3783893846025994, 2.17158889098213, -15.272987004736411,
            -21.334088952398847, 87.0, -0.09337380659447081, 7.985382178291963, 2.046676592574687,
            -0.23444022058494685, -38.61999938662378, -14.164180429368958, 87.0,
            0.4002567865566393, 5.292084182361962, 1.5750233763315498, 0.7697573609530778,
            -41.28000493004701, -19.75560319264119, 87.0, -0.17553522446869843, 5.033855674746125,
            1.6206243505978257, -0.8183899168590316, -53.617851265362525, -12.319005372601834,
            87.0, 0.532659277762245, 3.387784071673313, 1.1789726720205516, -0.039577152684703576,
            -61.849299321742485, -14.277196742091617, 87.0, 0.3586431386850145, 2.6723372354076806,
            1.1428447129184145, 0.4477540188336959, -69.69401031996155, -11.886667580143595, 87.0,
            0.5546894040090251, 1.6258122329476796, 1.0315437020832887, -5.776251456018681,
            -70.26764045749084, -16.123449383393158, 84.23006175294115, 0.6065877171412795,
            1.0500300297008414, 0.24315610101104232, -4.855227524113315, -70.23707720697664,
            -13.569120040271121, 72.77843588038567, 0.6423595788297062, 0.5416642932830763,
            0.07625841044412711, -3.986836164086251, -69.15500362893786, -11.502640544116126,
            62.91236223027404, 0.6685304929416406, 0.2172080851307949, -0.05244602022569824,
            -2.9290909268035676, -54.61013810685176, -8.410935810286272, 37.295979198388245,
            1.0117400909361178, -6.87181775762844, -0.13329158521067488, -2.075002943770151,
            -44.21598385803626, -6.192551040724636, 19.498868481419343, 1.0161746669179705,
            -8.888451586957492, -0.22432431828437713, -1.242775462985185, -36.65565191532008,
            -4.457159456345824, 7.506882266547972, 0.9005849302908832, -8.69653733004504,
            -0.28616261344926774, -0.6747534842083216, -30.995048134314306, -3.290662499294921,
            -0.32170189147780914, 0.7597877571319129, -7.690939465236105, -0.33778480647165776,
            -0.09210399703015396, -26.643614896055638, -2.303211373316307, -5.191117156862936,
            0.6315883297939249, -6.507957021811145, -0.35101278056942076, 21.90354424145385,
            -71.39563649302985, -22.105762454416904, -20.739132523959555, -2.9606860746571186,
            7.524722010069586, -9.054458208807251, -60.467199068605865, -55.70017245179778,
            60.730229725617804, -21.55650726292406, 8.19980010956117, 8.797168540798927,
            2.733970171515061, -63.549495220184326, -42.293241707147175, -11.725252389907837,
            -8.558975138750807, 7.097406554774542, 8.765447616577148, 5.070051307826703,
            21.43452099184679, -76.23250860319007, -10.408160608023497, -78.10110888031107,
            -8.976690557133757, 12.0, 7.186298268755249, 87.0, -31.605218919541493,
            4.817520020536183, -87.0, -5.224185791817166, 12.0, -1.0840045205202005, -87.0,
            -50.32785357471289, 87.0, -39.08352278301894, 9.790822977712908, 12.0,
            -1.6093056231677083, 87.0, 35.293517502308774, -87.0, 17.91689797404129,
            2.212764596399909, 12.0, 1.8983741615666776, -87.0, -29.653956490050845, 87.0,
            25.09762440564876, 12.0, 12.0, 12.0, -12.976966492298505, -6.552717928672845,
            52.00839239181627, -20.74674082142835, -0.4336876045345215, -12.0, -5.877647379518249,
            87.0, 25.782139559057562, -13.622081616905064, 47.693624809623635, 5.138940670124464,
            -9.458779900671043, -6.273858685829274, -87.0, -10.696195484841045, 51.4630499682973,
            87.0, -5.1684823448314, -11.984342252176436, 3.2315320337614235, 43.939752275956785,
            1.3193960746720679, -44.772958062157414, -26.986338794436893, -4.035793908027156,
            -12.0, 3.7961996784059684, -51.92315366785613, -22.46853929087131, 57.050700954733834,
            -7.33609806459042, 7.652084297836342, -5.877739512279536, -12.0, 70.90419700020065,
            14.777142983649236, -87.0, -53.06893309494434, -5.15981438855184, 1.357260517493463,
            -9.239165745111448, -12.474655654552103, 23.304551628898427, -0.7648959858595994,
            76.75696211510032, -5.793211104449133, -10.258805014582043, 12.0, 21.22335239752018,
            20.79531704771778, -32.786779934975556, 47.18894875940176, -3.2042465635919033,
            -10.582524826176947, 6.179445387879276, -21.043562078320335, -15.149759034911739,
            29.104878659676636, 12.628341884179882, 4.594503188529327, -1.664011394862605,
            0.3790771913477189, -17.36192481107598, -9.713934894785925, 8.500005638028535,
            11.874648774723756, 5.076174303559113, -0.2858684410011625, -2.022886943103373,
            58.55788056843196, 31.512368797439322, -43.70066711694918, 25.444825060371997,
            5.028422810732165, -11.322306889164437, -4.399372467561812, -18.706272275627466,
            -9.949845018325252, 6.990146559538097, -29.726633032781372, 12.0, -7.945322355298691,
            -3.983263171707314, -44.2251683964677, -0.9918706166061968, -0.8377062463459981,
            17.6186842989514, 9.597122627175835, -7.280109977717576, -9.325567454984407,
            -19.280543423005998, 15.53585010657109, -18.695484359902164, 63.737185684030074,
            1.364087827256343, -9.997155467881306, -5.19850848863464, -49.85280372356218,
            5.452560362166845, -84.9560499768429, -82.89953943658608, -9.684562157290188,
            -5.197829757401278, 3.6956309839571646, -58.212771303757165, 7.599700742305383,
            -52.99704164041391, -40.62077743341927, -6.0, -1.3115668011899553, 5.0019439567687884,
            -20.127615670393375, 28.33676325057288, -69.57316475071545, 11.245496532142933,
            -9.08264923210854, -1.7581470549444251, 4.709887526179475, -42.6544758993885,
            12.046513734311553, -58.03772227883769, -30.205396483091565, -12.0, -5.016378150490015,
            10.620434769930577, -60.34284181340467, 6.525652420918211, -42.734399862668184,
            23.947089257047114, -10.001727698912303, -9.823930031627013, 10.669853920635948,
            -63.115543486249514, 6.4882500565611725, -44.99617786679828, -8.235535039111753,
            -5.220373571775365, -1.5491377534868507, 6.635207351482113, -82.57564095849884,
            -15.837107560859696, -59.374309630527314, -57.9702899374687, -5.8784866014871096,
            -10.819896768953946, 8.326342973121521, -22.403168122192355, 28.70121943229328,
            -60.78588912690946, -25.156191530507016, -10.473279495046505, -5.88967974192537,
            6.724920978120074, -66.08909382132573, 29.885147742045103, -48.23459545088906,
            52.81227181675985, 1.2355860766567162, 2.235926945624584, -1.9766956379322869,
            22.368596166966697, 15.415605206639052, -82.04421842428576, 12.77901438747346, -12.0,
            6.1098362521685665, 8.266225315875543, -77.39555720018522, -36.82789309773101,
            11.530515433856799, -22.841716600189315, -3.742490644698064, -10.350253280102095,
            5.445651367040337, -6.70349389141127, -8.138276494990398, -28.11278293391987,
            -43.02246934195595, -7.659115990473393, 10.28455475591614, -10.58277211740474,
        ]),
        'fn_meas': ((70,), [
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 115.96558596311922,
            94.40435561333112, 78.34025115776137, 66.53046768686269, 57.975946475038135,
            51.86165346918325, 14.687996427999423, 33.031614168409554, 7.210440064297775,
            74.1711375468509, 121.55849842078334, 48.730497620949805, 3.3758318211280813, 0.0,
            62.31393341388157, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 14.805017968809222, 31.1443398268123,
            22.952547797165188, 36.605173967131634, 86.81274297775296, 23.4798662453725, 0.0,
            110.8791566125172, 66.15109054746229, 11.510914850649312, 61.94259757017859, 0.0,
            30.142236178694077, 87.56635375542962, 68.46223921468986, 0.0, 0.0, 0.0, 0.0,
        ]),
        'iters': ((70,), [
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0,
        ]),
    },
    'w_cone=300': {
        'tau_cmd': ((70, 7), [
            -11.524621786813947, 87.0, -28.337122616156815, -87.0, -3.7983637685840526,
            7.000744355689221, 0.8846324696396826, -7.041900269120886, 85.4391428103405,
            3.1729834655479205, -87.0, -1.3611028977358923, 4.065434511544449, 0.39520019045264254,
            -19.76500770820147, 87.0, 16.5039680108211, -87.0, -0.02299695157170656,
            7.1971880665009875, -2.406989068281688, -22.464091006983995, 87.0, 18.611737780570802,
            -87.0, 0.2872922089157219, 8.726748850972983, -3.323788148466584, -27.04274491203013,
            87.0, 20.56770520255925, -87.0, 0.767043729190324, 9.97259608740156, -4.37791659957487,
            -28.96514809255884, 87.0, 28.160880081660252, -87.0, 1.7961916455324571,
            10.806770438913917, -5.070966420169153, -24.901000102808972, 87.0, 25.162758907794675,
            -87.0, 1.9484142543376788, 11.92595086096675, -4.577102636161595, -9.666714917520647,
            87.0, 39.36143119928842, -87.0, 3.4813022184566424, 12.0, -2.5640659013759874,
            -11.028993002669282, 87.0, 33.821634668871916, -87.0, 3.2237718795427988, 12.0,
            -2.7740980149981156, -3.3321324918643764, 87.0, 25.311505216551716, -87.0,
            2.4313651508620504, 12.0, -1.4567353031521186, -1.0130128507513314, 87.0,
            6.919848622621011, -87.0, 0.41026726073129455, 12.0, -0.6474229881425042,
            3.012521133287473, 87.0, 5.399368656602034, -87.0, 0.2862172593964403, 12.0,
            -0.13555463795894884, 11.170788593242602, 87.0, -3.6179925045856622,
            -72.20339874711622, -0.5389448814258264, 12.0, 1.5452660497410777, 12.579423520886742,
            87.0, -11.334333010429631, -34.34064451777024, -0.23672413775764323, 12.0,
            2.4183691196194186, 13.780010493183132, 48.28345792460276, -14.368751967218774,
            45.72018994394724, 1.5209424693207665, 12.0, 3.118998102043872, 14.27183717598989,
            16.124952592633196, -19.753159332606124, 56.39212073547437, 0.8745727181090268, 12.0,
            3.062624269650036, 10.661771463001763, -50.36768598807068, -16.04380580668533,
            74.59906844570853, 1.4675943604945731, 10.219927888213551, 1.9121693927540209,
            3.8968666543413946, -74.11719970073817, -12.807245369275684, 85.78120152903163,
            2.808128198720425, 4.891314370586437, 0.12792445547107897, -1.3612947491110106,
            -37.403246158493076, -17.47320544111563, 87.0, 1.8846812465366716, 8.406164426527768,
            1.2238867607431272, 8.92665158511254, 16.120985750631668, -27.95374929688184, 87.0,
            -0.10628989402550532, 12.0, 3.126429904026976, 0.9484967898683733, -50.15057440123905,
            -17.316045388419816, 87.0, 0.841379666362418, 7.314600854009132, 1.3584392664912688,
            3.8245784927730018, -36.51078680357035, -16.91151618079432, 87.0, 1.045899374975058,
            8.095027051988898, 1.3783893846025994, 2.17158889098213, -15.272987004736411,
            -21.334088952398847, 87.0, -0.09337380659447081, 7.985382178291963, 2.046676592574687,
            -0.23444022058494685, -38.61999938662378, -14.164180429368958, 87.0,
            0.4002567865566393, 5.292084182361962, 1.5750233763315498, 0.7697573609530778,
            -41.28000493004701, -19.75560319264119, 87.0, -0.17553522446869843, 5.033855674746125,
            1.6206243505978257, -0.8183899168590316, -53.617851265362525, -12.319005372601834,
            87.0, 0.532659277762245, 3.387784071673313, 1.1789726720205516, -0.039577152684703576,
            -61.849299321742485, -14.277196742091617, 87.0, 0.3586431386850145, 2.6723372354076806,
            1.1428447129184145, 0.4477540188336959, -69.69401031996155, -11.886667580143595, 87.0,
            0.5546894040090251, 1.6258122329476796, 1.0315437020832887, -5.776251456018681,
            -70.26764045749084, -16.123449383393158, 84.23006175294115, 0.6065877171412795,
            1.0500300297008414, 0.24315610101104232, -4.855227524113315, -70.23707720697664,
            -13.569120040271121, 72.77843588038567, 0.6423595788297062, 0.5416642932830763,
            0.07625841044412711, -3.986836164086251, -69.15500362893786, -11.502640544116126,
            62.91236223027404, 0.6685304929416406, 0.2172080851307949, -0.05244602022569824,
            -2.9290909268035676, -54.61013810685176, -8.410935810286272, 37.295979198388245,
            1.0117400909361178, -6.87181775762844, -0.13329158521067488, -2.075002943770151,
            -44.21598385803626, -6.192551040724636, 19.498868481419343, 1.0161746669179705,
            -8.888451586957492, -0.22432431828437713, -1.242775462985185, -36.65565191532008,
            -4.457159456345824, 7.506882266547972, 0.9005849302908832, -8.69653733004504,
            -0.28616261344926774, -0.6747534842083216, -30.995048134314306, -3.290662499294921,
            -0.32170189147780914, 0.7597877571319129, -7.690939465236105, -0.33778480647165776,
            -0.09210399703015396, -26.643614896055638, -2.303211373316307, -5.191117156862936,
            0.6315883297939249, -6.507957021811145, -0.35101278056942076, 43.807088482907695,
            -55.79127298605971, 42.78847509116618, -41.478265047919095, 6.078627850685763,
            5.580967440407433, -6.108916417614503, -87.0, -87.0, 87.0, -60.001072629179845, -12.0,
            -3.8324628772403155, -12.0, 67.32562906185248, -8.236238028548131, -76.06363551155333,
            -33.008654939463995, 12.0, 10.830072145386223, 7.167062827199415, 34.36055511460225,
            0.256199557866303, -33.89277648925781, -13.375296588514004, -4.65668900399064,
            3.1526164365510043, 4.192788611106324, 87.0, 74.41295924346518, -87.0, -43.5, -12.0,
            -12.0, 12.0, 13.100914249759612, 26.581090500226786, -87.0, 24.395697340947898,
            -10.805601274310309, -10.803964476307574, 6.893086492932883, -28.53093117268032,
            -46.32107842101414, 87.0, 4.512461365151054, 3.460739656142965, 6.060226968929127,
            -6.990920618545704, -0.2745641372931189, 1.0667654639032234, -53.20839383474775,
            16.865145001712218, 12.0, -8.602652675534024, 3.2391176122511043, 11.975307225448484,
            -29.527346302680808, 28.04924291026966, 3.8225889455007307, -12.0, 2.2416085053328216,
            4.269760951395064, 38.78395353608989, -13.221512033567972, -16.385917681115536,
            -10.160334885044826, -9.025387909743678, 3.389998034351084, -4.0798674759787,
            -14.985971695163588, -23.960456056886645, 17.87896293338898, 60.61829836052168,
            11.432760755466074, -12.0, -0.9461742412022813, -58.114376082827164, 4.194844803173517,
            87.0, 20.089396463846192, 12.0, -8.186556802382363, -9.700613256201207,
            -73.15151881207682, -7.791051070322493, 87.0, -35.51592150962489, 12.0,
            8.12901435138224, 0.27354382941234734, 51.57630636290284, -11.957866337834563, -87.0,
            8.059734909421001, -5.168841734326935, 12.0, -8.551683811716272, 7.644697814402404,
            -16.548530015536922, -21.14862760159014, 1.2578581978548482, -3.393963344329243,
            6.911186886371267, -4.452837247114007, -11.431091481547437, -21.017606163372612,
            11.285290958100422, -2.714008801547826, 4.446803895798608, 11.47088459802649,
            -2.84033442970063, -22.58072058856279, -10.131013642596882, 38.33912804743495,
            1.2387714698212324, 1.6143696777428265, 3.7544068211201282, 0.7987266036849967,
            -13.684379983003812, -8.263729794179426, -0.5446628274734748, 7.006738165799025,
            7.984591367057506, -0.337540156389429, 2.4945399024449477, -27.772800019211147,
            -2.0052670112086965, 28.516620897492466, 27.128516345631137, 7.401440186134427,
            -8.893582837136238, -1.2229957930567776, 38.51770857903822, -6.623306964998901,
            -76.74638454552866, -10.267889497158409, -10.281355878700047, 10.583484292669151,
            1.0912497392735143, -32.57461730262625, -5.796967746500166, 55.087011558349644,
            8.053946316223595, 1.9893819723918365, -4.364452028900166, 3.0150070474861046,
            -27.465829785069065, -9.317443236971096, 38.47494256011559, 2.3485912002927516,
            5.694089749047667, 0.8314327351538715, 1.0148361703901274, 43.630684195778024,
            6.520027281701274, -72.38024056166107, 17.7878797542614, -4.7606875746600785,
            -6.647045938001955, -7.975990786812256, 2.7949690845362456, -9.198416216675419,
            -2.0413460002205612, -1.5785304332924186, -2.3858744896189528, 2.1480542488346543,
            5.809012258547113, -10.549319198911288, -8.78732089705052, 16.20247707234792,
            -5.830828035992129, -1.415085312784693, 5.0960058080770185, 2.205098263906833,
            6.054282607539323, -3.475200107472551, -3.089982463698626, 7.706881818306682,
            4.508551263917775, -1.9089904930544352, -1.2264526572956156, 16.928277636998896,
            -6.169557999750703, -21.753682428265726, -6.064551403735115, -2.4708970516365754,
            6.51933171577311, -2.888681514252165, -7.432161571978875, -3.771630511379569,
            27.34989782493883, 9.608649959472459, 5.88658449046291, -4.688380428811662,
            -0.0710804628707378, 1.8222075613430282, -7.991810613650356, 22.251584766101278,
            -2.2478221989302427, 0.7071333766419984, 3.46007816368861, -2.202973463663282,
            7.211397823806838, -1.8535476545163307, -12.556807402966223, 6.108664639259582,
            7.691101686064297, -0.5638875210258824, -11.372889782700682, -6.500323296582253,
            -4.111207679145794, 33.846562920890136, 11.717199492719264, 4.74009921814644,
            -1.9294931819034018, -0.18612744918262836, 39.08666381930926, 4.471531207878016,
            -67.70142387544148, 5.60289264102488, -4.171738048861937, -2.0621979243410413,
            -2.9711340786823404, -17.444303526082816, -6.481267068750211, 48.050539350324584,
            20.14430490447981, 1.2049018392670914, -1.6606863586959304, 1.8312896763270818,
            -21.282009364589648, -8.194683105554345, 59.21878170229689, 5.449385329419048,
            2.2279150992738703, -3.0741537713215292, 5.809574403355496,
        ]),
        'fn_meas': ((70,), [
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 115.96558596311922,
            94.40435561333112, 78.34025115776137, 66.53046768686269, 57.975946475038135,
            51.86165346918325, 71.51736169888633, 76.98019202247475, 61.19585312276783,
            43.98023892861557, 142.15187852627375, 6.981380719292199, 0.0, 16.957062821973995,
            3.4050187990451795, 30.58577338050312, 0.0, 10.46088323653444, 65.38873080772218, 0.0,
            4.869965840608413, 7.848180772039486, 21.12078467415257, 21.801881489593903,
            10.847142761882207, 26.42428213368839, 29.36095893965016, 27.793316454661273,
            23.037062419810454, 29.465460116584197, 32.1396641668326, 28.45629202702482,
            30.39380835170535, 31.204914190590085, 30.76961062334524, 30.099219492167617,
            24.030827820296214, 30.93048222422863, 10.90251900217418, 30.655358723170696,
        ]),
        'iters': ((70,), [
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0,
        ]),
    },
    'w_cone=300/vector': {
        'tau_cmd': ((70, 7), [
            -11.524621483987064, 87.0, -28.33712255556225, -87.0, -3.7983637687537875,
            7.000744355670641, 0.8846325171710152, -7.041900107201547, 85.43914281181868,
            3.1729834617897126, -87.0, -1.3611029032196305, 4.065434512282661, 0.39520021807107386,
            -19.765007452721992, 87.0, 16.50396794252937, -87.0, -0.022996966834380572,
            7.197188066797665, -2.4069890240989764, -22.464090684328777, 87.0, 18.611737608079082,
            -87.0, 0.2872921780775196, 8.726748851443537, -3.323788091013477, -27.042744560543614,
            87.0, 20.567704529096552, -87.0, 0.7670436342059697, 9.972596088884709,
            -4.377916529845289, -28.965147906224043, 87.0, 28.160879607061297, -87.0,
            1.7961915940479476, 10.806770440565808, -5.070966375106847, -24.901000166299713, 87.0,
            25.16275874649338, -87.0, 1.9484142126911688, 11.925950864830083, -4.577102639003279,
            -9.66671529308936, 87.0, 39.361430793938325, -87.0, 3.4813021620553135, 12.0,
            -2.564065949569739, -11.028993200086905, 87.0, 33.82163463358709, -87.0,
            3.2237718649896316, 12.0, -2.774098043634415, -3.3321326542221845, 87.0,
            25.31150513739597, -87.0, 2.4313651304631856, 12.0, -1.4567353257804776,
            -1.0130128426836158, 87.0, 6.919848749502485, -87.0, 0.41026726107195494, 12.0,
            -0.6474229892649066, 3.012521211311018, 87.0, 5.3993687184012655, -87.0,
            0.2862172475083361, 12.0, -0.1355546252673865, 11.170788653339747, 87.0,
            -3.617992440227818, -72.20339859307234, -0.5389448891198108, 12.0, 1.5452660606595794,
            12.579423529017678, 87.0, -11.334332881117984, -34.340644546874195,
            -0.23672414263344654, 12.0, 2.4183691154592992, 13.780010470021423, 48.28345780267475,
            -14.368751801869339, 45.72018999790694, 1.5209424761095618, 12.0, 3.118998088219,
            14.271837150520835, 16.12495235986426, -19.753159123780932, 56.39212074772209,
            0.8745727295736994, 12.0, 3.062624254833035, 10.66177142596904, -50.36768597555568,
            -16.04380564163186, 74.59906841792778, 1.4675943686139, 10.219927886548652,
            1.9121693848112957, 3.896866647602725, -74.1171996989604, -12.807245245963212,
            85.7812015281769, 2.8081281977637578, 4.8913143704340305, 0.12792445868451052,
            -1.361294726499844, -37.40324618510866, -17.47320529497005, 87.0, 1.8846812569085305,
            8.406164428656107, 1.2238867557739392, 8.92665154262149, 16.12098575557079,
            -27.953749064916945, 87.0, -0.10628987020699115, 12.0, 3.1264298864134936,
            0.9484967931710376, -50.150574402947015, -17.316045245339428, 87.0, 0.8413796814224186,
            7.314600856523521, 1.3584392601632291, 3.824578465681399, -36.510786836314765,
            -16.911516034660536, 87.0, 1.0458994025585355, 8.095027049996364, 1.3783893980529793,
            2.171588874350013, -15.27298700492641, -21.334088786484678, 87.0, -0.09337378881847769,
            7.985382179059211, 2.046676571097481, -0.23444021517009822, -38.61999942524027,
            -14.164180319515156, 87.0, 0.4002568049579764, 5.292084180261599, 1.5750233661327144,
            0.7697573491001247, -41.2800049480448, -19.755603047188025, 87.0, -0.17553520466105982,
            5.033855674165825, 1.6206243365153363, -0.8183899203456302, -53.61785128789222,
            -12.31900528459701, 87.0, 0.5326592943940354, 3.3877840709694698, 1.1789726642863354,
            -0.039577164374852175, -61.84929935352297, -14.277196641702734, 87.0,
            0.35864315515269196, 2.6723372344247234, 1.1428447038997676, 0.44775400295373236,
            -69.69401035748142, -11.886667498296227, 87.0, 0.5546894191309133, 1.625812231906284,
            1.031543694685177, -5.776251472342615, -70.26764050167824, -16.123449319713014,
            84.2300617664337, 0.6065877305445804, 1.0500300284331527, 0.24315609481101774,
            -4.855227541733081, -70.23707725149234, -13.569119990444767, 72.77843589163218,
            0.6423595892534737, 0.5416642920912306, 0.07625840588310079, -3.9868361832735886,
            -69.15500367333537, -11.502640505176435, 62.91236223960279, 0.6685305008124445,
            0.2172080840271981, -0.05244602353460519, -2.929090948394335, -54.61013814543492,
            -8.41093579152966, 37.29597920201685, 1.0117400969839634, -6.8718177596498,
            -0.13329158725356294, -2.0750029673916273, -44.21598389139851, -6.192551035353009,
            19.498868480609854, 1.0161746707315933, -8.888451589414975, -0.22432431937697261,
            -1.2427754880882462, -36.655651944292785, -4.457159459661331, 7.5068822626665055,
            0.9005849321195272, -8.696537332488187, -0.2861626138758429, -0.6747535101617981,
            -30.995048159593477, -3.2906625081169403, -0.32170189726841447, 0.7597877574199495,
            -7.690939467471209, -0.3377848064544727, -0.09210402323708097, -26.643614918137253,
            -2.303211385425928, -5.191117163858698, 0.6315883290020737, -6.507957023766955,
            -0.35101278028425525, 43.80708847207194, -55.79127299562707, 42.788475087406816,
            -41.47826505014508, 6.078627849907942, 5.580967439262256, -6.10891641778971, -87.0,
            -87.0, 87.0, -60.001073679698294, -12.0, -3.832462279420616, -12.0, 67.32562928057345,
            -8.236237425944177, -76.06363569625293, -33.00865426880488, 12.0, 10.83007157445489,
            7.167062861714788, 34.36055511891245, 0.2561994116838129, -33.89277648925781,
            -13.375296701802412, -4.656689003940561, 3.1526164481991774, 4.19278860365979, 87.0,
            74.4129591766272, -87.0, -43.5, -12.0, -12.0, 12.0, 13.10091472653777,
            26.58109010773619, -87.0, 24.395697122918694, -10.80560127638034, -10.803964376377955,
            6.893086562528291, -28.53093175468834, -46.321078683997044, 87.0, 4.51246186803702,
            3.4607405148669295, 6.060227098098691, -6.990920462166974, -0.274564979526172,
            1.06676502919604, -53.20839408203273, 16.865144508960864, 12.0, -8.602652299755032,
            3.2391168681909432, 11.975302937924694, -29.52734670477937, 28.049254101883687,
            3.822589045538354, -12.0, 2.241608584050929, 4.26976056047958, 38.78395459610502,
            -13.221511142615897, -16.38591961127222, -10.16032938160931, -9.025387299877506,
            3.3899994086041048, -4.079867446212494, -14.985977380371786, -23.96045948198752,
            17.878967538575147, 60.618293295688474, 11.432760685235717, -12.0, -0.9461843261984455,
            -58.11437573981466, 4.194846693583389, 87.0, 20.08940199035384, 12.0,
            -8.186560830296239, -9.700617242004618, -73.1515185773929, -7.791056537611871, 87.0,
            -35.51591063587241, 12.0, 8.129013687407538, 0.2735425890790301, 51.57633303060402,
            -11.95786715450568, -87.0, 8.059759354256812, -5.168872558128454, 12.0,
            -8.551685437584888, 7.644766593262702, -16.548511239282664, -21.148753128142733,
            1.2578676477793342, -3.3939871528956385, 6.911180978515898, -4.45282892624669,
            -11.43101729406894, -21.017576815997792, 11.285164482520972, -2.713993457171424,
            4.44676945206313, 11.470868618226476, -2.8403271929111478, -22.58059739221116,
            -10.13097163169743, 38.33888502488344, 1.2387580327125887, 1.614320978530321,
            3.754403543634224, 0.7987545323456628, -13.684321189912936, -8.263682465029813,
            -0.544776697478416, 7.006698593190151, 7.984548268181135, -0.3375410390031575,
            2.4945696639764416, -27.7726562057091, -2.0052283284011088, 28.516389539673877,
            27.12851397172722, 7.401397810533188, -8.893583426372784, -1.2229555066475832,
            38.51792224070527, -6.623333592672393, -76.74667147285875, -10.268041641371834,
            -10.281383459371591, 10.58356941949014, 1.0913091616968693, -32.574606154518094,
            -5.796926726294798, 55.08693464418059, 8.05413700808234, 1.989375030275867,
            -4.36456305451268, 3.0149580768012094, -27.4659642316938, -9.31738605214812,
            38.47511696362976, 2.348603207254688, 5.694105369827325, 0.8314553858659988,
            1.0148121016243485, 43.63073027927271, 6.519957042285242, -72.38014501521704,
            17.787906814470258, -4.760684700123961, -6.647058355918742, -7.97597652343945,
            2.794994620842698, -9.198534140073507, -2.041319547791696, -1.5786132060953837,
            -2.3858621172804613, 2.148143677265529, 5.809006846310392, -9.257883671283716,
            -8.5871015079505, 13.774940496369112, -5.6962811790393015, -1.7119009283568751,
            4.963573713136109, 2.1672229955611364, 10.374234521486631, -3.249851623215171,
            -8.459424159221259, 6.797160958816741, 3.081354659393229, -1.5961323909938288,
            0.025999884393767436, 15.757892181063086, -5.090513583821184, -21.688280453854077,
            -3.107342919239095, -0.9452991419550241, 4.824386913995182, -4.2494549848581675,
            -7.554502211313376, -4.624834972437916, 26.966790131990408, 7.515296590861878,
            5.5456275403027595, -3.3132208305708977, 0.521352347505101, -0.828607338091321,
            -7.7838082478149735, 26.667589320982934, -1.6120284684260837, 1.219843228998616,
            3.0823455409470073, -2.3630125893562224, -2.5866632801083966, -4.59685335563319,
            18.17424669061451, 5.6620451015329785, 9.757816313013825, -1.2619137877597841, -12.0,
            33.18826320307227, 4.092662124347725, -54.30339175665314, 9.780744846447101,
            -3.5702409246166926, -5.602145098575163, 2.407113625902805, -58.2426932399958,
            -11.94547568029138, 87.0, 15.023982557421657, 10.543701063489493, -8.507844544267378,
            7.892787127487758, -6.713197697206018, -7.623925744161922, 11.96234140615457,
            23.56353443775664, 8.796132459993236, -12.0, 7.170655989376509, 34.31593601843684,
            2.230752918441498, -61.33928860062871, 8.622639662403506, -8.846405743157307,
            -1.8833991990384273, -7.041095649456268,
        ]),
        'fn_meas': ((70,), [
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 115.96558599400441,
            94.40435563769717, 78.34025117833032, 66.5304677041775, 57.97594648961367,
            51.861653481329824, 71.51736164757456, 76.98019279410157, 61.19585330131652,
            43.980239031990315, 142.15187859833344, 6.981380758080333, 0.0, 16.957062485150864,
            3.4050194001189777, 30.58576479685693, 0.0, 10.460883805381535, 65.38871336141585, 0.0,
            4.869943594194064, 7.848174040354129, 21.120812056676783, 21.801957726969803,
            10.847167933793791, 26.42435402654603, 29.360871368354438, 27.793328356963265,
            23.037032489561806, 29.465368389878904, 32.11615120863759, 28.809512090528088,
            30.003392700532675, 31.309493818103814, 30.917953082746276, 31.56906584887414,
            31.517805592270044, 26.91311868524742, 19.650915359156613, 23.622110107536482,
        ]),
        'iters': ((70,), [
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0,
            3.0, 3.0,
        ]),
    },
}


if __name__ == "__main__":
    print_figures("JAX_SOLVES", {c: jax_solve_figures(c) for c in CONTROLLERS})
    print_figures("JAX_EPISODES", {**{f"w_cone={w:g}": jax_episode_figures(w)
                                      for w in CONE_WEIGHTS},
                                   f"w_cone={CONE_WEIGHTS[1]:g}/vector":
                                   jax_episode_figures(CONE_WEIGHTS[1], "vector")})
