"""The classical controller's slice of the port (x = (q, v), u = tau, nx = 14),
float64 on the CPU unless marked:

- ``make_classical_knot``'s calc, diff, term_calc and term_diff == the JAX
  package's ``make_classical_knot(calc_mode="vector",
  deriv_mode="analytic")`` on seeded inputs, free and contact, at 1e-12 of
  each field's scale (the bar of ``tests/test_torch_knot.py``: the same
  formulas, summed in another order);
- the kernels' constant packer for the classical family == the JAX spec
  (running table dt-scaled, terminal table unscaled);
- the port's batched solve (``make_batched_solve_fn(controller=
  "classical")``, the plain versions on these CPU tensors) reproduces the
  framework-free golden fixture's ``classical_free`` and
  ``classical_contact`` cases at ``tests/test_solver_golden.py``'s bars, and
  equals ``vmap(fddp.solve)`` of the JAX package on a small batch by
  decisions and trajectories;
- the classical device code of ``csrc/knot_chain.cuh``, compiled for the
  host with g++, == the plain versions at 1e-11 of scale: the derivative
  pass (``diff_knot_serial_classical``, running and terminal knots, each
  column part on its own too) and the rollout's lane group
  (``rollout_group_serial<..., Classical>``);
- ``cuda``-marked tests of the three classical instantiations against their
  plain versions on the card (skipped without one).

The inputs are built with the port alone, and the JAX package is imported
only inside the comparisons with it (the ``jx`` fixture), which skip where
JAX is not installed: on a card's machine the ``cuda`` tests run with
``python -m pytest --noconftest tests/test_torch_classical.py -m cuda``.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ffmpc_tpu_torch.core import KEYFRAMES, gravity_torque, make_panda_model
from ffmpc_tpu_torch.mpc.controllers import make_vertical_down_R
from ffmpc_tpu_torch.ocp import action as taction
from ffmpc_tpu_torch.ocp.action import KnotDeriv
from ffmpc_tpu_torch.ocp.problem import build_problem_refs
from ffmpc_tpu_torch.ocp.weights import (OCPWeights, ProblemRefs, flagship_trajectory,
                                         flagship_weights)
from ffmpc_tpu_torch.run.batch_runner import EpisodeConfig, make_batched_solve_fn
from ffmpc_tpu_torch.solver import _cuda_build
from ffmpc_tpu_torch.solver import diff_cuda as dc
from ffmpc_tpu_torch.solver import rollout_cuda as rc
from ffmpc_tpu_torch.solver.fddp import FDDPSettings

B, N, A = 2, 3, 4
NX, NU = 14, 7
FIELDS = KnotDeriv._fields
TERM_FIELDS = ("cost_T", "LxT", "LxxT")
GOLDEN = Path(__file__).resolve().parent / "fixtures" / "solver_golden.npz"


def T(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def scale_of(want):
    return max(float(np.abs(np.asarray(want)).max()), 1.0)


def seeded(Bn, Nn, seed, wide=True):
    """Bn classical problems of Nn knots around the neutral pose, built with
    the port alone: states perturbed by 0.1, controls by 2 Nm around gravity
    torque (problem 0's 4x wider where ``wide``, so the torque barrier
    acts), and the flagship trajectory's references at times over its
    approach and circle (problem 0 at 0.1 s, problem 1 at 1.2 s)."""
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    q0 = np.asarray(KEYFRAMES["neutral"])
    tau_g = gravity_torque(model, T(q0)).numpy()
    x0 = np.concatenate([q0, np.zeros(7)])
    rng = np.random.default_rng(seed)
    xs = x0 + 0.1 * rng.normal(size=(Bn, Nn + 1, NX))
    us = tau_g + 2.0 * rng.normal(size=(Bn, Nn, NU))
    if wide:
        us[0] *= 4.0
    ts = np.array([0.1, 1.2] + list(rng.uniform(0.0, 2.0, size=max(Bn - 2, 0))))[:Bn]
    W = flagship_weights()
    rr, rT = build_problem_refs(
        flagship_trajectory(), T(ts), Nn, W.dt_ocp, T(x0), T(tau_g),
        T(make_vertical_down_R()), dtype=torch.float64, device="cpu")
    rr, rT = (ProblemRefs(*(a.contiguous() for a in r)) for r in (rr, rT))
    return SimpleNamespace(model=model, xs=xs, us=us, rr=rr, rT=rT, tau_g=tau_g, q0=q0)


@pytest.fixture(scope="module")
def setup():
    return seeded(B, N, 3)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces the comparisons need; skipped where JAX is
    not installed."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.core import make_panda_model as j_make_model
    from ffmpc_tpu.ocp import action as jaction
    from ffmpc_tpu.ocp.weights import ProblemRefs as JRefs, flagship_weights as j_weights
    return SimpleNamespace(jax=jax, jnp=jnp, mj=j_make_model("plant", jnp.float64),
                           jaction=jaction, JRefs=JRefs, j_weights=j_weights)


def knot(setup, surface):
    return taction.make_classical_knot(setup.model, flagship_weights(), surface)


def j_refs(jx, refs):
    return jx.JRefs(**{k: jx.jnp.asarray(getattr(refs, k).numpy()) for k in ProblemRefs._fields})


def compiled_o0(jx, fn, args):
    """``fn`` jitted and compiled for ``args`` with LLVM at -O0 (the XLA:CPU
    compile is the cost of the comparisons with JAX; ``tests/
    test_torch_episode.py`` does the same)."""
    return jx.jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})


def close(got, want, rtol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale_of(want), f"{name}: err {err:.3e} scale {scale_of(want):.3e}"


# ---------------------------------------------------------------------------
# the knot against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_knot_equals_jax(setup, jx, surface):
    kj = jx.jaction.make_classical_knot(jx.mj, jx.j_weights(), surface,
                                        deriv_mode="analytic", calc_mode="vector")
    kt = knot(setup, surface)
    assert (kt.nx, kt.nu, kt.u_lb, kt.u_ub, kt.family) == (kj.nx, kj.nu, kj.u_lb, kj.u_ub,
                                                           "classical")
    jax = jx.jax
    vv = lambda f: jax.vmap(jax.vmap(f))  # noqa: E731

    def all_of(rr, rT, x, u, xT):
        return (vv(kj.diff)(rr, x, u), vv(kj.calc)(rr, x, u),
                jax.vmap(kj.term_diff)(rT, xT), jax.vmap(kj.term_calc)(rT, xT))
    xT = setup.xs[:, -1]
    args = (j_refs(jx, setup.rr), j_refs(jx, setup.rT), setup.xs[:, :-1], setup.us, xT)
    dj, (xn_j, c_j), tj, tcj = compiled_o0(jx, all_of, args)(*args)
    dt = kt.diff(setup.rr, T(setup.xs[:, :-1]), T(setup.us))
    for name in FIELDS:
        close(getattr(dt, name).numpy(), getattr(dj, name), 1e-12, "diff." + name)
    xn_t, c_t = kt.calc(setup.rr, T(setup.xs[:, :-1]), T(setup.us))
    close(xn_t.numpy(), xn_j, 1e-12, "calc.xnext")
    close(c_t.numpy(), c_j, 1e-12, "calc.cost")
    close(dt.cost.numpy(), c_t.numpy(), 1e-12, "diff.cost vs calc")
    tt = kt.term_diff(setup.rT, T(xT))
    for name, gj, gt in zip(("cost", "Lx", "Lxx"), tj, tt):
        close(gt.numpy(), gj, 1e-12, "term_diff." + name)
    close(kt.term_calc(setup.rT, T(xT)).numpy(), tcj, 1e-12, "term_calc")


def test_knot_refuses_other_contact_models(setup):
    W = dataclasses.replace(flagship_weights(), contact_model="point3d")
    with pytest.raises(ValueError, match="normal_1d"):
        taction.make_classical_knot(setup.model, W, True)


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_constant_packer_matches_jax_spec(setup, jx, surface):
    """The classical cost table on the kernels' slots: the JAX spec's terms,
    weight x dt on the running knots and the weight alone on the terminal
    knot; two sets of constants, no torque filter."""
    W = jx.j_weights()
    spec = dict(jx.jaction._make_spec(jx.mj, W, surface)[0])
    names = [n for n, _ in rc.COST_SLOTS]
    for terminal in (False, True):
        table = rc.cost_table(setup.model, flagship_weights(), surface, "classical", terminal)
        for s, name in enumerate(names):
            t = spec.get(name)
            if t is None:
                assert table["slot_scale"][s] == 0.0, name
                continue
            want = t.weight * (1.0 if terminal else W.dt_ocp)
            assert table["slot_scale"][s] == want, (name, terminal)
            assert table["slot_terminal"][s] == float(t.terminal), name
    consts = rc.pack_knot_consts(setup.model, flagship_weights(), surface, torch.float64,
                                 "classical")
    assert consts.shape == (rc.consts_len("classical"),) == (2 * rc.N_CONSTS,)
    aug = rc.pack_knot_consts(setup.model, flagship_weights(), surface, torch.float64)
    off = dict(zip([n for n, _ in rc.CONST_FIELDS],
                   np.cumsum([0] + [n for _, n in rc.CONST_FIELDS])[:-1]))
    for name in ("lpf_alpha", "lpf_beta"):
        assert consts[off[name]] == 0.0 and consts[rc.N_CONSTS + off[name]] == 0.0
    # the model constants are the augmented knot's, in both sets
    n_model = off["dt"]
    assert torch.equal(consts[:n_model], aug[:n_model])
    assert torch.equal(consts[rc.N_CONSTS:rc.N_CONSTS + n_model], aug[:n_model])
    with pytest.raises(ValueError, match="family"):
        rc.pack_knot_consts(setup.model, flagship_weights(), surface, torch.float64, "lpf")


# ---------------------------------------------------------------------------
# the batched solve
# ---------------------------------------------------------------------------

GOLDEN_W = dict(dt_ocp=0.01, w_ee_pos=1.2e3, w_q_soft_limits=8.0,
                w_tau_soft_limits=2.0, w_plane_z=1.2e3, w_vz=5.0e2,
                contact_gains=(140.0, 80.0), fn_des=22.0, w_fn=28.0,
                ff_alpha=float(np.exp(-2 * np.pi * 25.0 * 0.01)),
                w_w=6.0e-4, w_w_soft_limits=2.0, w_y=8.0e-4)


# The step lengths the JAX package's solver accepts at each of the 10
# iterations of the fixture's classical contact case (its per-iteration
# telemetry, ``fddp.solve(..., debug_history=True)``; ``python
# tests/test_torch_classical.py`` prints them anew), and the relative
# distance between the fixture's two recorded costs of that same problem
# (the JAX package's scalar and vector knots: 8.8e-7).
GOLDEN_CONTACT_ALPHAS = (1.0, 1.0, 1.0, 1.0, 0.25, 0.25, 1.0, 0.5, 0.5, 0.25)


def golden_solve(case):
    """The fixture's case through ``make_batched_solve_fn(controller=
    "classical")`` in plain mode: (result, fixture us, fixture cost, the
    other calc mode's fixture cost)."""
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    q0 = np.asarray(KEYFRAMES["neutral"])
    tau_g = gravity_torque(model, T(q0)).numpy()
    Ng, surface = 12, case == "classical_contact"
    solve = make_batched_solve_fn(
        model, OCPWeights(**GOLDEN_W),
        FDDPSettings(max_iters=10, backward_mode="plain", rollout_mode="plain",
                     diff_mode="plain"),
        flagship_trajectory(), EpisodeConfig(controller="classical", horizon=Ng), q0,
        surface=surface, dtype=torch.float64, device="cpu")
    x0 = np.concatenate([q0, np.zeros(7)])
    res = solve(np.array([1.2 if surface else 0.3]), x0[None], np.tile(x0, (1, Ng + 1, 1)),
                np.tile(tau_g, (1, Ng, 1)))
    with np.load(GOLDEN) as z:
        return (res, z[f"{case}_vector_us"], float(z[f"{case}_vector_cost"]),
                float(z[f"{case}_scalar_cost"]))


@pytest.mark.parametrize("case", ["classical_free", "classical_contact"])
def test_batched_solve_matches_golden_fixture(case):
    """The framework-free golden fixture's classical cases
    (``tests/test_solver_golden.py``: float64, N=12, 10 iterations, its own
    weights; free space at t = 0.3 s, contact at 1.2 s) through
    ``make_batched_solve_fn(controller="classical")`` in plain mode
    (``chip_smoke.py`` phase ``classical`` solves them on the kernels).

    Free space: that test's bar, us atol 1e-6 and cost rtol 1e-8.  Contact:
    the problem sits on the box QP's argmin tie (ROADMAP queue 3): Quu is
    about 1e-5 there (the torque weight times dt), so the tie moves kff by
    reg / lambda_min(Quu) ~ 1e-4 of its size from the second iteration on,
    and no other summation order reproduces the fixture's us to 1e-6 (the
    JAX package's own scalar and vector knots differ by 0.025 in us, its
    while-loop and scan solves by 0.08).  So it is held by its decisions: 10
    iterations and the JAX package's accepted step length at every one, and
    the cost within twice the distance between the fixture's two costs;
    max|du| is measured, not gated."""
    res, us_ref, cost_ref, cost_other = golden_solve(case)
    assert tuple(res.xs.shape) == (1, 13, NX)
    du = float(np.abs(res.us[0].numpy() - us_ref).max())
    if case == "classical_free":
        assert du <= 1e-6
        assert np.isclose(float(res.cost[0]), cost_ref, rtol=1e-8)
        return
    assert int(res.iters[0]) == len(GOLDEN_CONTACT_ALPHAS)
    assert tuple(res.alpha_hist[0].tolist()) == GOLDEN_CONTACT_ALPHAS
    spread = abs(cost_other - cost_ref) / abs(cost_ref)
    assert abs(float(res.cost[0]) - cost_ref) / abs(cost_ref) <= 2.0 * spread, du


SOLVE_B, SOLVE_N, SOLVE_ITERS = 3, 5, 6


def solve_problem(surface):
    """Warm starts as ``chip_smoke.py`` builds them (x0 = the neutral pose
    plus noise, trajectory held at x0, controls at gravity torque), problem
    0's controls far off so the torque box goes active."""
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    q0 = np.asarray(KEYFRAMES["neutral"])
    tau_g = gravity_torque(model, T(q0)).numpy()
    rng = np.random.default_rng(5)
    x0s = np.concatenate([q0, np.zeros(7)])[None] + 0.02 * rng.normal(size=(SOLVE_B, NX))
    xs = np.tile(x0s[:, None], (1, SOLVE_N + 1, 1))
    us = np.tile(tau_g[None, None], (SOLVE_B, SOLVE_N, 1))
    us[0] += 30.0 * rng.normal(size=(SOLVE_N, 7))
    ts = np.full((SOLVE_B,), 1.2 if surface else 0.3)
    return model, q0, (ts, x0s, xs, us)


def test_batched_solve_equals_jax(jx):
    """``make_batched_solve_fn(controller="classical")`` (all modes "kernel":
    the plain versions on these CPU tensors) == the JAX package's
    ``vmap(fddp.solve)`` (its ``make_batched_solve_fn`` with the vector knot)
    on B=3 contact problems of N=5 knots: the same iterations and flags, and
    xs, us, K, k, cost and stop within rtol 1e-6 / atol 1e-7 of each field's
    scale (``tests/test_torch_solve.py``'s bar: the box QP's argmin ties).
    One knot family (the contact knot, the main path's): the JAX solve's
    trace and compile, about a minute, is the cost of this file."""
    surface = True
    from ffmpc_tpu.ocp.weights import flagship_trajectory as j_traj
    from ffmpc_tpu.run.batch_runner import (EpisodeConfig as JEpisode,
                                            make_batched_solve_fn as j_make)
    from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings
    model, q0, args = solve_problem(surface)
    j_args = [jx.jnp.asarray(a) for a in args]
    rj = compiled_o0(jx, j_make(
        jx.mj, jx.j_weights(), JSettings(max_iters=SOLVE_ITERS), j_traj(),
        JEpisode(controller="classical", horizon=SOLVE_N, deriv_mode="analytic"), q0,
        surface=surface, dtype=jx.jnp.float64, calc_mode="vector", solve_impl="vmap"),
        j_args)(*j_args)
    rt = make_batched_solve_fn(
        model, flagship_weights(), FDDPSettings(max_iters=SOLVE_ITERS), flagship_trajectory(),
        EpisodeConfig(controller="classical", horizon=SOLVE_N), q0, surface=surface,
        dtype=torch.float64, device="cpu")(*args)
    for name in ("iters", "converged", "diverged", "feasible"):
        assert np.array_equal(getattr(rt, name).numpy(), np.asarray(getattr(rj, name))), name
    for name in ("xs", "us", "K", "k", "cost", "stop"):
        g, w = getattr(rt, name).numpy(), np.asarray(getattr(rj, name))
        assert g.shape == w.shape, name
        err, sc = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= 1e-7 + 1e-6 * sc, f"{name}: err {err:.3e}, scale {sc:.3e}"


def test_episode_still_refuses_the_classical_controller(setup):
    """The closed loop takes the classical controller: an episode of E=2
    (horizon 4, 1 iteration, two ticks) runs on x = (q, v) and returns
    (E, ticks, ...) telemetry (held against the JAX episode in
    ``tests/test_torch_classical_loop.py``)."""
    from ffmpc_tpu_torch.run.batch_runner import make_episode_fn
    from ffmpc_tpu_torch.sim.device_plant import make_table_params
    episode = make_episode_fn(setup.model, flagship_weights(), FDDPSettings(max_iters=1),
                              flagship_trajectory(),
                              make_table_params(0.0, dtype=torch.float64, device="cpu"),
                              EpisodeConfig(controller="classical", horizon=4, n_ticks=2),
                              setup.q0, dtype=torch.float64, device="cpu")
    q0s = T(np.stack([setup.q0, setup.q0 + 0.01]))
    carry = episode.init(q0s)
    assert tuple(carry[1].shape) == (2, 5, NX) and tuple(carry[2].shape) == (2, 4, NU)
    telem = episode(q0s)
    assert tuple(telem["q"].shape) == (2, 2, 7) and tuple(telem["tau_cmd"].shape) == (2, 2, 7)
    for key in ("t", "err_tan", "err_3d", "fn_meas", "cost", "iters", "fallback"):
        assert tuple(telem[key].shape) == (2, 2), key
    assert all(bool(torch.isfinite(v).all()) for v in telem.values() if v.is_floating_point())
    assert not telem["fallback"].any()


# ---------------------------------------------------------------------------
# the classical device code, compiled for the host
# ---------------------------------------------------------------------------

_HOST_HARNESS = r"""
#include <cstring>
#include "knot_chain.cuh"

// Every classical knot of the batch, one after the other, through the parts
// in turn (diff_knot_serial_classical, on the running knots' constants, the
// first of the two sets).
extern "C" int diff_classical_host_f64(const void* consts, const void* xs, const void* us,
                                       const void* const* refs, const void* const* refs_T,
                                       void* const* outs, int B, int N, int surface,
                                       const int* columns, int n_columns) {
  ffmpc::KnotConstants<double> C[2];
  std::memcpy(C, consts, sizeof(C));
  const auto a = ffmpc::diff_args<double>(xs, us, refs, refs_T, outs, B, N);
  for (int b = 0; b < B; ++b)
    for (int t = 0; t <= N; ++t) {
      if (surface)
        ffmpc::diff_knot_serial_classical<double, true>(C[0], a, b, t, columns, n_columns);
      else
        ffmpc::diff_knot_serial_classical<double, false>(C[0], a, b, t, columns, n_columns);
    }
  return 0;
}

// Every (problem, step length) of a classical batch, as the kernel's lane
// group runs it.
extern "C" int rollout_classical_host_f64(const void* consts, const void* const* arrays,
                                          const void* const* refs, const void* const* refs_T,
                                          void* const* outs, int B, int N, int A, int surface) {
  ffmpc::KnotConstants<double> C[2];
  std::memcpy(C, consts, sizeof(C));
  ffmpc::RolloutArgs<double> a;
  const double** in[7] = {&a.x0, &a.xs, &a.us, &a.K, &a.kff, &a.fs, &a.w_all};
  for (int k = 0; k < 7; ++k) *in[k] = (const double*)arrays[k];
  a.feasible = (const unsigned char*)arrays[7];
  for (int f = 0; f < 6; ++f) {
    a.ref[f] = (const double*)refs[f];
    a.ref_T[f] = (const double*)refs_T[f];
  }
  a.xs_try = (double*)outs[0];
  a.us_try = (double*)outs[1];
  a.cost_try = (double*)outs[2];
  a.dv_try = (double*)outs[3];
  a.B = B;
  a.N = N;
  a.A = A;
  for (int b = 0; b < B; ++b)
    for (int ai = 0; ai < A; ++ai) {
      if (surface)
        ffmpc::rollout_group_serial<double, true, ffmpc::Classical>(C, a, b, ai);
      else
        ffmpc::rollout_group_serial<double, false, ffmpc::Classical>(C, a, b, ai);
    }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the device code cannot be built for the host")
    d = tmp_path_factory.mktemp("classical_host")
    src, lib = d / "harness.cpp", d / "libclassical_host.so"
    src.write_text(_HOST_HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(_cuda_build.CSRC_DIR), "-o", str(lib), str(src)], check=True)
    cdll = ctypes.CDLL(str(lib))
    diff = cdll.diff_classical_host_f64
    diff.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
    roll = cdll.rollout_classical_host_f64
    roll.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    for fn in (diff, roll):
        fn.restype = ctypes.c_int
    return SimpleNamespace(diff=diff, rollout=roll)


def host_diff(lib, kn, rr, rT, xs, us, columns=None):
    """The header's classical parts over every knot, into outputs that
    start NaN; ``columns``: the columns to run (all if None)."""
    Bn, Nn = us.shape[:2]
    consts = rc.pack_knot_consts(kn.model, kn.W, kn.surface, torch.float64, "classical")

    def nan(*shape):
        return torch.full(shape, float("nan"), dtype=torch.float64)

    run = KnotDeriv(nan(Bn, Nn, NX), nan(Bn, Nn), nan(Bn, Nn, NX, NX), nan(Bn, Nn, NX, NU),
                    nan(Bn, Nn, NX), nan(Bn, Nn, NU), nan(Bn, Nn, NX, NX),
                    nan(Bn, Nn, NX, NU), nan(Bn, Nn, NU, NU))
    out = dc.KnotDerivs(run, nan(Bn), nan(Bn, NX), nan(Bn, NX, NX))
    p6 = ctypes.c_void_p * 6
    cols = None if columns is None else (ctypes.c_int * len(columns))(*columns)
    lib.diff(consts.data_ptr(), xs.data_ptr(), us.data_ptr(),
             p6(*(a.data_ptr() for a in rr)), p6(*(a.data_ptr() for a in rT)),
             (ctypes.c_void_p * 12)(*(a.data_ptr() for a in (*run, *out[1:]))), Bn, Nn,
             int(kn.surface), cols, 0 if columns is None else len(columns))
    return out


def assert_derivs_close(got, want, rtol, what):
    """Every field within rtol of its scale, finite where the plain
    version's is."""
    pairs = [(f"run.{n}", getattr(got.run, n), getattr(want.run, n)) for n in FIELDS]
    pairs += list(zip(TERM_FIELDS, got[1:], want[1:]))
    for name, g, w in pairs:
        assert g.shape == w.shape, (what, name)
        assert torch.equal(torch.isfinite(g), torch.isfinite(w)), (what, name)
        fin = torch.isfinite(w)
        err = float((g - w)[fin].abs().max()) if bool(fin.any()) else 0.0
        sc = max(float(w[fin].abs().max()), 1.0) if bool(fin.any()) else 1.0
        assert err <= rtol * sc, f"{what} {name}: err {err:.3e} scale {sc:.3e}"


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_host_build_of_the_diff_device_code_matches_reference(setup, host_lib, surface):
    kn = knot(setup, surface)
    xs, us = T(setup.xs), T(setup.us)
    want = dc.diff_reference(kn, setup.rr, setup.rT, xs, us)
    assert all(bool(torch.isfinite(a).all()) for a in (*want.run, *want[1:]))
    assert_derivs_close(host_diff(host_lib, kn, setup.rr, setup.rT, xs, us), want, 1e-11,
                        "seeded")


def test_host_build_runs_each_diff_column_on_its_own(setup, host_lib):
    """Each of the 21 column parts, run alone after the primal part, writes
    its own column of [Fx | Fu] (state columns 0-13, control columns 14-20)
    at every running knot and no other, within 1e-11 of scale."""
    kn = knot(setup, True)
    xs, us = T(setup.xs), T(setup.us)
    want = dc.diff_reference(kn, setup.rr, setup.rT, xs, us).run
    want = torch.cat([want.Fx, want.Fu], dim=-1)
    sc = max(float(want.abs().max()), 1.0)
    for c in range(NX + NU):
        got = host_diff(host_lib, kn, setup.rr, setup.rT, xs, us, columns=[c]).run
        got = torch.cat([got.Fx, got.Fu], dim=-1)
        others = [j for j in range(NX + NU) if j != c]
        assert bool(torch.isnan(got[..., others]).all()), c
        err = float((got[..., c] - want[..., c]).abs().max())
        assert err <= 1e-11 * sc, f"column {c}: err {err:.3e}"


def rollout_inputs(setup, Bn=B, Nn=N, seed=7):
    """Seeded classical rollout inputs (the recipe of
    ``tests/test_torch_rollout.py`` at nx = 14): states around the setup's
    first states, controls around gravity torque, random gains, feed-
    forwards, gaps and gap products, every other problem feasible."""
    rng = np.random.default_rng(seed)
    x0 = setup.xs[:Bn, 0] + 0.05 * rng.normal(size=(Bn, NX))
    xs = np.tile(x0[:, None], (1, Nn + 1, 1)) + 0.02 * rng.normal(size=(Bn, Nn + 1, NX))
    us = setup.tau_g + 2.0 * rng.normal(size=(Bn, Nn, NU))
    K = 0.1 * rng.normal(size=(Bn, Nn, NU, NX))
    kff = rng.normal(size=(Bn, Nn, NU))
    fs = 0.1 * rng.normal(size=(Bn, Nn + 1, NX))
    w_all = 0.3 * rng.normal(size=(Bn, Nn + 1, NX))
    feas = torch.arange(Bn) % 2 == 1
    return [T(a) for a in (x0, xs, us, K, kff, fs, w_all)] + [feas]


def host_rollout(lib, kn, arrays, rr, rT, Aa=A):
    Bn, Nn = arrays[2].shape[:2]
    consts = rc.pack_knot_consts(kn.model, kn.W, kn.surface, torch.float64, "classical")
    outs = [torch.full(shape, float("nan"), dtype=torch.float64)
            for shape in ((Bn, Aa, Nn + 1, NX), (Bn, Aa, Nn, NU), (Bn, Aa), (Bn, Aa))]
    p6 = ctypes.c_void_p * 6
    lib.rollout(consts.data_ptr(), (ctypes.c_void_p * 8)(*(a.data_ptr() for a in arrays)),
                p6(*(a.data_ptr() for a in rr)), p6(*(a.data_ptr() for a in rT)),
                (ctypes.c_void_p * 4)(*(o.data_ptr() for o in outs)), Bn, Nn, Aa,
                int(kn.surface))
    return outs


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_host_build_of_the_rollout_device_code_matches_reference(setup, host_lib, surface):
    kn = knot(setup, surface)
    rr, rT = setup.rr, setup.rT
    arrays = rollout_inputs(setup)
    want = rc.rollout_reference(kn, *arrays, rr, rT, A)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    got = host_rollout(host_lib, kn, arrays, rr, rT)
    for name, g, w in zip(("xs_try", "us_try", "cost_try", "dv_try"), got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-11 * scale_of(w.numpy()), f"{name}: err {err:.3e}"


# ---------------------------------------------------------------------------
# the classical instantiations on the card (python -m pytest --noconftest -m cuda)
# ---------------------------------------------------------------------------

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the classical kernels have no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("kernel", ["backward_sweep", "knot_diff", "rollout"])
def test_cuda_classical_kernel_matches_plain_version(kernel, dtype, surface):
    """Each classical instantiation against its plain version on the card,
    N=36, B=1024 (the float32 gates count shares and percentiles of
    problems), on seeded inputs and on the classical main path's
    first-iteration inputs, at ``chip_smoke.py``'s gates for its kernel
    (phase ``classical``)."""
    need_card()
    import chip_smoke as cs
    recs = cs.classical_kernel_checks(kernel, dtype, surface)
    failed = [r for r in recs if not r["ok"]]
    assert recs and not failed, failed


if __name__ == "__main__":
    # The JAX package's accepted step lengths on the fixture's classical
    # contact case (GOLDEN_CONTACT_ALPHAS): JAX_PLATFORMS=cpu python
    # tests/test_torch_classical.py
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.core import gravity_torque as j_gravity, make_panda_model as j_model
    from ffmpc_tpu.ocp.action import make_classical_knot as j_knot
    from ffmpc_tpu.ocp.problem import build_problem_refs as j_refs_of
    from ffmpc_tpu.ocp.weights import OCPWeights as JWeights, flagship_trajectory as j_traj
    from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings, solve as j_solve
    jax.config.update("jax_enable_x64", True)
    mj = j_model("plant", dtype=jnp.float64)
    q0 = jnp.asarray(KEYFRAMES["neutral"])
    tau_g = j_gravity(mj, q0)
    x0 = jnp.concatenate([q0, jnp.zeros(7)])
    W = JWeights(**GOLDEN_W)
    rr, rT = j_refs_of(j_traj(), 1.2, 12, W.dt_ocp, x0, tau_g,
                       jnp.asarray(make_vertical_down_R()), dtype=jnp.float64)
    res, hist = j_solve(j_knot(mj, W, True, calc_mode="vector"), rr, rT, x0,
                        jnp.tile(x0, (13, 1)), jnp.tile(tau_g, (12, 1)),
                        JSettings(max_iters=10), debug_history=True)
    print("iterations", int(res.iters), "accepted step lengths",
          tuple(float(a) for a in np.asarray(hist["alpha"])))
