"""Line-search rollout of the PyTorch port (the module that holds the CUDA
rollout kernel) == the JAX package's fused-rollout reference, the
alpha-vmapped scan of ``make_fused_rollout`` called unbatched, float64 on
the CPU, with the acceptance's gap sum ``dv_try`` formed from the JAX
outputs as ``ffmpc_tpu/solver/fddp.py`` forms it; the kernel's device code
(``csrc/knot_chain.cuh``: the lane group's phases, through
``rollout_group_serial``, compiled for the host with g++) == the plain
version; the kernel's constant packer == the JAX knot's cost spec; and the
port's solve == the framework-free golden fixture.  (The slice as a whole
against the JAX batched solve is ``test_torch_solve.py``, which runs the
port's default settings, both kernel modes.)

On the CPU ``rollout`` runs its plain version, ``rollout_reference``; the
CUDA kernel itself runs only on a card (the ``cuda``-marked tests, skipped
here).

Tolerances, each against the field's largest magnitude:
- against the JAX vector knot, rtol 1e-11: the same formulas in float64,
  summed in another order, through 4 knots of stiff contact dynamics; the
  gap sum, rtol 1e-12: one sum of products over the same trajectory;
- against the JAX scalar knot (the TPU kernel's own body), rtol 1e-8 /
  atol 1e-10: the scalar chain differs from the vector one by its Newton
  arccos and its op order, about 1e-9 per knot
  (``tests/test_scalar_knot.py``);
- the host build of the device code against the plain version, rtol 1e-11:
  the same knot evaluated another way on 8 lanes (the link frames as prefix
  products, the bias RNEA and the contact drift as world-frame sums, the
  mass matrix from composite bodies, the cost rows and the gap sum split
  over the lanes, the pivots' reciprocal square roots in the Cholesky
  solves), contracted into FMAs where the compiler chooses;
- the kernel on the card against the plain version: float64 rtol 5e-9 /
  atol 1e-10 with equal non-finite sets, float32 at ``chip_smoke.py``'s
  gates.

The inputs are built with the port alone, and the JAX package is imported
only inside the comparisons with it (the ``jx`` fixture), which skip where
JAX is not installed: a card's machine has none, and there the
``cuda``-marked test runs with
``python -m pytest --noconftest tests/test_torch_rollout.py -m cuda``.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ffmpc_tpu_torch.core import KEYFRAMES, gravity_torque, make_panda_model
from ffmpc_tpu_torch.ocp import action as taction
from ffmpc_tpu_torch.ocp.weights import (OCPWeights as TWeights, ProblemRefs,
                                         flagship_weights as t_fweights)
from ffmpc_tpu_torch.ocp.problem import build_problem_refs as t_build_refs
from ffmpc_tpu_torch.solver import rollout_cuda as rc
from ffmpc_tpu_torch.solver import _cuda_build
from ffmpc_tpu_torch.solver.fddp import FDDPSettings as TSettings, solve as t_solve
from ffmpc_tpu_torch.tasks.trajectories import ApproachCircleTraj as TTraj

# the inputs of the JAX package's own fused-rollout test
# (tests/test_rollout_pallas.py): horizon, problems, step lengths
NH, BN, NA = 4, 2, 6
Z_C = 0.342
W_KW = dict(dt_ocp=0.01, w_ee_pos=1.2e3, w_plane_z=9.0e2, contact_gains=(145.0, 85.0),
            fn_des=22.0, w_fn=3.0e1, z_press=0.0065, ff_alpha=0.3, w_w=6.0e-4, w_y=8.0e-4)
TRAJ_KW = dict(center=(-0.5, 0.0, Z_C), radius=0.10, omega=1.5, z_contact=Z_C,
               t_approach=0.55, z_pre=Z_C + 0.05, t_pre=0.25,
               ee_start=(-0.3, 0.0, 0.633), t_stabilize=0.2)


def T(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def setup():
    """The inputs, built with the port alone (a card's machine has no JAX):
    the problem references of one point of the trajectory, shared by the
    problems, and seeded states, controls, gains and gaps."""
    mt = make_panda_model("plant", dtype=torch.float64, device="cpu")
    q0 = torch.as_tensor(KEYFRAMES["neutral"], dtype=torch.float64)
    tau_g = gravity_torque(mt, q0)
    y0 = torch.cat([q0, torch.zeros(7, dtype=torch.float64), tau_g])
    x_reg = torch.cat([q0, torch.zeros(7, dtype=torch.float64)])
    rr1, rT1 = t_build_refs(
        TTraj(**TRAJ_KW), torch.tensor([1.2], dtype=torch.float64), NH, W_KW["dt_ocp"],
        x_reg, tau_g, torch.as_tensor(np.diag([1.0, -1.0, -1.0])), y_ref=y0,
        dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(7)
    nx = 21
    y0n, tgn = y0.numpy(), tau_g.numpy()
    x0 = y0n[None] + 0.05 * rng.normal(size=(BN, nx))
    xs = np.tile(x0[:, None, :], (1, NH + 1, 1)) + 0.02 * rng.normal(size=(BN, NH + 1, nx))
    us = np.tile(tgn, (BN, NH, 1)) + 2.0 * rng.normal(size=(BN, NH, 7))
    K = 0.1 * rng.normal(size=(BN, NH, 7, nx))
    kff = rng.normal(size=(BN, NH, 7))
    fs = 0.1 * rng.normal(size=(BN, NH + 1, nx))
    feas = np.array([False, True])
    w_all = 0.3 * rng.normal(size=(BN, NH + 1, nx))
    # the port's refs carry the batch: the same problem refs for every problem
    t_rr = ProblemRefs(*(a.expand(BN, *a.shape[1:]).contiguous() for a in rr1))
    t_rT = ProblemRefs(*(a.expand(BN, *a.shape[1:]).contiguous() for a in rT1))
    return dict(mt=mt, refs_run=rr1, ref_T=rT1, t_rr=t_rr, t_rT=t_rT,
                arrays=(x0, xs, us, K, kff, fs, feas), w_all=w_all)


@pytest.fixture(scope="module")
def jx(setup):
    """The JAX package's pieces the comparisons need: its model, and the
    setup's problem references as its ProblemRefs (one problem, unbatched).
    Skipped where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from ffmpc_tpu.core import make_panda_model as j_make_model
    from ffmpc_tpu.ocp.weights import ProblemRefs as JRefs

    def j_refs(r):
        return JRefs(**{k: jnp.asarray(getattr(r, k)[0].numpy()) for k in ProblemRefs._fields})
    return SimpleNamespace(mj=j_make_model("plant", jnp.float64),
                           refs_run=j_refs(setup["refs_run"]), ref_T=j_refs(setup["ref_T"]))


_jax_rollouts = {}


def jax_rollout(jx, surface, calc_mode):
    """The JAX package's plain fused-rollout reference (alpha-vmapped scan),
    jitted once per knot and called unbatched per problem."""
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.ocp import action as jaction
    from ffmpc_tpu.ocp.weights import OCPWeights as JWeights
    from ffmpc_tpu.solver.rollout_pallas import make_fused_rollout
    key = (surface, calc_mode)
    if key not in _jax_rollouts:
        knot = jaction.make_augmented_knot(jx.mj, JWeights(**W_KW), surface,
                                           deriv_mode="analytic", calc_mode=calc_mode)
        _jax_rollouts[key] = jax.jit(make_fused_rollout(knot, NA, use_box=True))
    fn = _jax_rollouts[key]

    def run(arrays):
        outs = [fn(*(jnp.asarray(a[b]) for a in arrays), jx.refs_run, jx.ref_T)
                for b in range(BN)]
        return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]
    return run


def port_args(setup, arrays):
    """``rollout``'s arrays from the setup's (x0, xs, us, K, kff, fs,
    feasible), with the setup's gap products."""
    x0, xs, us, K, kff, fs, feas = arrays
    return ([T(a) for a in (x0, xs, us, K, kff, fs, setup["w_all"])]
            + [torch.as_tensor(feas)])


def port_rollout(setup, surface, arrays, fn=rc.rollout_reference):
    knot = taction.make_augmented_knot(setup["mt"], TWeights(**W_KW), surface)
    args = port_args(setup, arrays)
    if fn is rc.rollout:
        consts = rc.pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64)
        return fn(knot, consts, *args, setup["t_rr"], setup["t_rT"], NA)
    return fn(knot, *args, setup["t_rr"], setup["t_rT"], NA)


OUT_FIELDS = ("xs_try", "us_try", "cost_try", "dv_try")


def assert_close(got, want, rtol, atol, what):
    for name, g, w in zip(OUT_FIELDS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        fin = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), fin), (what, name, "non-finite sets differ")
        scale = float(np.abs(w[fin]).max())
        err = float(np.abs(g[fin] - w[fin]).max())
        assert err <= atol + rtol * scale, f"{what} {name}: err {err:.3e} scale {scale:.3e}"


@pytest.mark.parametrize("surface,calc_mode,rtol,atol", [
    (True, "vector", 1e-11, 0.0), (False, "vector", 1e-11, 0.0),
    (True, "scalar", 1e-8, 1e-10), (False, "scalar", 1e-8, 1e-10)],
    ids=["contact-vector", "free-vector", "contact-scalar", "free-scalar"])
def test_reference_matches_jax_fused_rollout_reference(setup, jx, surface, calc_mode, rtol,
                                                       atol):
    want = jax_rollout(jx, surface, calc_mode)(setup["arrays"])
    got = [o.numpy() for o in port_rollout(setup, surface, setup["arrays"])]
    assert got[0].shape == (BN, NA, NH + 1, 21) and got[2].shape == (BN, NA)
    assert got[3].shape == (BN, NA)
    assert_close(got[:3], want, rtol, atol, f"{surface}/{calc_mode}")


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_reference_gap_sum_matches_jax_outputs(setup, jx, surface):
    """``dv_try`` == -sum w_all (xs - xs_try) (``ffmpc_tpu/solver/fddp.py``'s
    dv), formed with numpy from the JAX fused-rollout reference's states."""
    want_xs = jax_rollout(jx, surface, "vector")(setup["arrays"])[0]
    xs = setup["arrays"][1]
    want = -np.sum(setup["w_all"][:, None] * (xs[:, None] - want_xs), axis=(2, 3))
    got = port_rollout(setup, surface, setup["arrays"])[3].numpy()
    scale = float(np.abs(want).max())
    assert scale > 0.0
    assert float(np.abs(got - want).max()) <= 1e-12 * scale


def test_non_finite_rollouts_match_jax_and_nan_controls_survive_the_clip(setup, jx):
    """Problem 0 (infeasible) carries a huge gap at one knot, so every step
    length below 1 (which keeps (alpha - 1) of it) blows up while alpha = 1
    stays finite; problem 1 has a NaN gain entry, so its controls are NaN
    from that knot on at every step length: the clip must not turn them
    into a bound.  Same non-finite (problem, alpha) sets as JAX."""
    x0, xs, us, K, kff, fs, feas = (np.array(a) for a in setup["arrays"])
    fs[0, 2] = 1e200
    K[1, 1, 3, 5] = np.nan
    arrays = (x0, xs, us, K, kff, fs, feas)
    got = [o.numpy() for o in port_rollout(setup, True, arrays)]
    want = jax_rollout(jx, True, "vector")(arrays)
    fin = np.isfinite(got[2])
    assert fin[0].tolist() == [True] + [False] * (NA - 1)
    assert not fin[1].any()
    assert np.isnan(got[1][1, :, 1:]).any(-1).all()     # NaN controls, not clipped
    assert not np.isnan(got[1][1, :, 0]).any()
    assert np.array_equal(np.isfinite(got[3]), fin)      # the gap sums with them
    assert_close(got[:3], want, 1e-11, 0.0, "non-finite case")


def _jax_table(mj, W, surface):
    """Expected kernel cost table from the JAX package's own spec: its
    ``_make_spec`` and the outer terms its ``make_augmented_knot`` adds, as
    name -> (kind, weight x dt scale, row weights, lb, ub, terminal)."""
    from ffmpc_tpu.ocp import action as jaction
    from ffmpc_tpu.ocp import activations as jact
    spec = dict(jaction._make_spec(mj, W, surface)[0])
    if not W.use_inner_state_reg:
        spec.pop("posture", None)
        spec.pop("v_damp", None)
    if not W.use_inner_tau_reg:
        spec.pop("tau_reg", None)
        spec.pop("tau_soft_limits", None)
    lim = np.maximum(np.asarray(W.tau_limits) - max(W.tau_soft_limit_margin, 0.0), 1e-9)
    if W.w_y > 0.0:
        spec["y_reg"] = jaction.CostTerm(
            W.w_y, jact.wquad([float(v) ** 2 for v in W.y_weights]), False, True)
    if W.w_w > 0.0:
        spec["w_reg"] = jaction.CostTerm(W.w_w, jact.quad(), False, True)
    if W.w_w_soft_limits > 0.0:
        spec["w_soft"] = jaction.CostTerm(W.w_w_soft_limits, jact.barrier(-lim, lim),
                                          False, True)
    return {name: (t.activation.kind, t.weight * (W.dt_ocp if t.dt_scaled else 1.0),
                   t.activation.weights, t.activation.lb, t.activation.ub, t.terminal)
            for name, t in spec.items()}


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
@pytest.mark.parametrize("variant", ["flagship", "zeros"])
def test_constant_packer_matches_jax_spec(setup, jx, surface, variant):
    from ffmpc_tpu.ocp.weights import flagship_weights as j_fweights
    W = j_fweights()
    if variant == "zeros":
        # terms off or at zero weight: absent from the table, or scale 0
        W = dataclasses.replace(W, w_posture=0.0, w_y=0.0, w_w_soft_limits=0.0,
                                w_q_soft_limits=0.0, w_vz=0.0, use_inner_tau_reg=False)
    Wt = TWeights(**dataclasses.asdict(W))
    mt = setup["mt"]
    table = rc.cost_table(mt, Wt, surface)
    want = _jax_table(jx.mj, W, surface)
    row0 = 0
    for s, (name, nr) in enumerate(rc.COST_SLOTS):
        rows = slice(row0, row0 + nr)
        row0 += nr
        if name not in want:
            assert table["slot_scale"][s] == 0.0, name
            continue
        kind, scale, wts, lb, ub, terminal = want[name]
        assert table["slot_scale"][s] == scale, name
        assert table["slot_terminal"][s] == float(terminal), name
        assert table["slot_barrier"][s] == float(kind == "barrier"), name
        if kind == "quad":
            assert (table["row_w"][rows] == 1.0).all(), name
        elif kind == "wquad":
            assert table["row_w"][rows].tolist() == list(wts), name
        else:
            assert table["row_lb"][rows].tolist() == list(lb), name
            assert table["row_ub"][rows].tolist() == list(ub), name
    if variant == "zeros":
        names = [n for n, _ in rc.COST_SLOTS]
        for off in ("posture", "y_reg", "w_soft", "q_soft_limits", "vz_damp", "tau_reg"):
            assert table["slot_scale"][names.index(off)] == 0.0, off
    # the whole constant block: model constants as the JAX model holds them,
    # the knot's scalars, the table, in the kernel's field order
    consts = rc.pack_knot_consts(mt, Wt, surface, torch.float64)
    assert consts.shape == (rc.N_CONSTS,) and consts.dtype == torch.float64
    off = 0
    fields = {}
    for name, n in rc.CONST_FIELDS:
        fields[name] = consts[off:off + n].numpy()
        off += n
    for name in ("j_rot", "inertia", "com", "mass", "armature", "damping", "ee_rot"):
        np.testing.assert_array_equal(fields[name], np.asarray(getattr(jx.mj, name)).ravel())
    assert fields["lpf_alpha"][0] + fields["lpf_beta"][0] == 1.0
    assert (fields["kp"][0], fields["kd"][0]) == tuple(W.contact_gains)
    np.testing.assert_array_equal(fields["slot_scale"], table["slot_scale"])


def test_packer_refuses_what_the_kernel_does_not_compute(setup):
    """The kernels are built for the normal_1d and point3d contacts: another
    contact model's name, a knot without its model, or a dtype the kernels
    are not built for raises (point3d packs, with its own layout)."""
    mt = setup["mt"]
    with pytest.raises(ValueError, match="hertz"):
        rc.pack_knot_consts(mt, dataclasses.replace(t_fweights(), contact_model="hertz"),
                            True, torch.float64)
    p3 = rc.pack_knot_consts(mt, dataclasses.replace(t_fweights(), contact_model="point3d"),
                             True, torch.float64)
    assert p3.numel() == rc.consts_len("augmented", "point3d") != rc.consts_len("augmented")
    with pytest.raises(ValueError, match="model"):
        rc.pack_knot_consts(None, t_fweights(), True, torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        rc.pack_knot_consts(mt, t_fweights(), True, torch.float16)


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch(setup):
    before = rc.rollout.launches
    got = port_rollout(setup, True, setup["arrays"], fn=rc.rollout)
    want = port_rollout(setup, True, setup["arrays"])
    assert rc.rollout.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_wrong_shapes_and_types(setup):
    knot = taction.make_augmented_knot(setup["mt"], TWeights(**W_KW), True)
    consts = rc.pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64)
    args = port_args(setup, setup["arrays"])

    def call(a):
        return rc.rollout(knot, consts, *a, setup["t_rr"], setup["t_rT"], NA)

    bad = list(args)
    bad[3] = bad[3][:, :-1]                      # K with a knot missing
    with pytest.raises(ValueError, match="K"):
        call(bad)
    bad = list(args)
    bad[4] = bad[4].to(torch.float32)            # kff in another dtype
    with pytest.raises(ValueError, match="kff"):
        call(bad)
    bad = list(args)
    bad[6] = bad[6][:, :-1]                      # w_all with a knot missing
    with pytest.raises(ValueError, match="w_all"):
        call(bad)
    bad = list(args)
    bad[7] = bad[7].to(torch.float64)            # feasible must be bool
    with pytest.raises(ValueError, match="feasible"):
        call(bad)


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """A changed header gives every library a new name, so a stale build is
    never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _cuda_build.CSRC_DIR.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_cuda_build, "CSRC_DIR", csrc)
    before = {s: _cuda_build._target(csrc / f"{s}.cu") for s in ("rollout", "backward_sweep")}
    assert before["rollout"].name != before["backward_sweep"].name
    header = csrc / "knot_chain.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    after = {s: _cuda_build._target(csrc / f"{s}.cu") for s in ("rollout", "backward_sweep")}
    assert before["rollout"] != after["rollout"]
    assert before["backward_sweep"] != after["backward_sweep"]
    assert after["rollout"].name.startswith("librollout_")


# ---------------------------------------------------------------------------
# the kernel's device code, compiled for the host
# ---------------------------------------------------------------------------

_HOST_HARNESS = r"""
#include <cstring>
#include "knot_chain.cuh"

// Every (problem, step length) of the batch, one after the other, each as
// the kernel's lane group runs it (rollout_group_serial).
extern "C" int rollout_host_f64(const void* consts, const void* const* arrays,
                                const void* const* refs, const void* const* refs_T,
                                void* const* outs, int B, int N, int A, int surface) {
  ffmpc::KnotConstants<double> C;
  std::memcpy(&C, consts, sizeof(C));
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
        ffmpc::rollout_group_serial<double, true>(C, a, b, ai);
      else
        ffmpc::rollout_group_serial<double, false>(C, a, b, ai);
    }
  return 0;
}

// The same for the point contact's families (nc = 3; the classical knot's
// two sets of constants).
template <typename F>
int rollout_point3d_host(const void* consts, const void* const* arrays,
                         const void* const* refs, const void* const* refs_T, void* const* outs,
                         int B, int N, int A, int surface) {
  ffmpc::KnotConstants<double, 3> C[F::kConstSets];
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
        ffmpc::rollout_group_serial<double, true, F>(C, a, b, ai);
      else
        ffmpc::rollout_group_serial<double, false, F>(C, a, b, ai);
    }
  return 0;
}

extern "C" int rollout_point3d_host_f64(const void* consts, const void* const* arrays,
                                        const void* const* refs, const void* const* refs_T,
                                        void* const* outs, int B, int N, int A, int surface) {
  return rollout_point3d_host<ffmpc::AugmentedPoint3d>(consts, arrays, refs, refs_T, outs, B,
                                                       N, A, surface);
}

extern "C" int rollout_classical_point3d_host_f64(const void* consts, const void* const* arrays,
                                                  const void* const* refs,
                                                  const void* const* refs_T, void* const* outs,
                                                  int B, int N, int A, int surface) {
  return rollout_point3d_host<ffmpc::ClassicalPoint3d>(consts, arrays, refs, refs_T, outs, B,
                                                       N, A, surface);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the device code cannot be built for the host")
    d = tmp_path_factory.mktemp("rollout_host")
    src, lib = d / "harness.cpp", d / "librollout_host.so"
    src.write_text(_HOST_HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(_cuda_build.CSRC_DIR), "-o", str(lib), str(src)], check=True)
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for key, name in ((None, "rollout_host_f64"), ("augmented", "rollout_point3d_host_f64"),
                      ("classical", "rollout_classical_point3d_host_f64")):
        fn = getattr(cdll, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
        fns[key] = fn
    # the augmented normal-contact harness itself; the point contact's by family
    fn = fns[None]
    fn.point3d = fns
    return fn


def host_rollout(fn, setup, surface, arrays):
    """The header's lane-group rollout of every (problem, step length) into
    outputs that start NaN."""
    knot = taction.make_augmented_knot(setup["mt"], TWeights(**W_KW), surface)
    consts = rc.pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64)
    args = [a.contiguous() for a in port_args(setup, arrays)]
    outs = [torch.full(shape, float("nan"), dtype=torch.float64)
            for shape in ((BN, NA, NH + 1, 21), (BN, NA, NH, 7), (BN, NA), (BN, NA))]
    p6 = ctypes.c_void_p * 6
    fn(consts.data_ptr(), (ctypes.c_void_p * 8)(*(a.data_ptr() for a in args)),
       p6(*(a.data_ptr() for a in setup["t_rr"])), p6(*(a.data_ptr() for a in setup["t_rT"])),
       (ctypes.c_void_p * 4)(*(o.data_ptr() for o in outs)), BN, NH, NA, int(surface))
    return outs


# the point contact (contact_model="point3d": the force in R^3 and the
# friction cone's barrier, at the values MPCConfig gives a point3d run)
P3 = dict(contact_model="point3d", w_friction_cone=2.0e2, mu=0.6, friction_margin=1e-3)


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
@pytest.mark.parametrize("family", ["augmented", "classical"])
def test_host_build_of_the_point3d_device_code_matches_reference(setup, host_lib, family,
                                                                 surface):
    """The point contact's lane-group phases (the drift's three rows on lane
    6, the solves on lanes 4-7, the force and acceleration in a phase of
    their own on lane 7, the force's and the cone's cost rows on lanes 0-3)
    == ``rollout_reference`` at 1e-11 of scale, for both knot families (the
    classical knot on the states' and gains' first 14 columns)."""
    make = taction.make_augmented_knot if family == "augmented" else taction.make_classical_knot
    knot = make(setup["mt"], TWeights(**W_KW, **P3), surface)
    nx = knot.nx
    x0, xs, us, K, kff, fs, w_all, feas = port_args(setup, setup["arrays"])
    args = [a.contiguous() for a in (x0[:, :nx], xs[..., :nx], us, K[..., :nx], kff,
                                     fs[..., :nx], w_all[..., :nx])] + [feas]
    want = rc.rollout_reference(knot, *args, setup["t_rr"], setup["t_rT"], NA)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    consts = rc.pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64, family)
    outs = [torch.full(shape, float("nan"), dtype=torch.float64)
            for shape in ((BN, NA, NH + 1, nx), (BN, NA, NH, 7), (BN, NA), (BN, NA))]
    p6 = ctypes.c_void_p * 6
    host_lib.point3d[family](
        consts.data_ptr(), (ctypes.c_void_p * 8)(*(a.data_ptr() for a in args)),
        p6(*(a.data_ptr() for a in setup["t_rr"])), p6(*(a.data_ptr() for a in setup["t_rT"])),
        (ctypes.c_void_p * 4)(*(o.data_ptr() for o in outs)), BN, NH, NA, int(surface))
    assert_close(outs, want, 1e-11, 0.0, f"point3d host build, {family}, surface={surface}")


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_host_build_of_the_device_code_matches_reference(setup, host_lib, surface):
    got = host_rollout(host_lib, setup, surface, setup["arrays"])
    want = port_rollout(setup, surface, setup["arrays"])
    assert all(bool(torch.isfinite(w).all()) for w in want)
    assert_close(got, want, 1e-11, 0.0, f"host build, surface={surface}")


def test_host_build_non_finite_sets_match_reference(setup, host_lib):
    """The non-finite case above (a huge gap at one knot of problem 0, a NaN
    gain of problem 1) through the host build: the same non-finite entries,
    costs and gap sums as the plain version."""
    x0, xs, us, K, kff, fs, feas = (np.array(a) for a in setup["arrays"])
    fs[0, 2] = 1e200
    K[1, 1, 3, 5] = np.nan
    arrays = (x0, xs, us, K, kff, fs, feas)
    got = host_rollout(host_lib, setup, True, arrays)
    want = port_rollout(setup, True, arrays)
    assert not bool(torch.isfinite(want[2]).all())
    assert_close(got, want, 1e-11, 0.0, "host build, non-finite case")


# ---------------------------------------------------------------------------
# the kernel on the card (python -m pytest --noconftest -m cuda)
# ---------------------------------------------------------------------------

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel has no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_cuda_kernel_matches_plain_version(setup, surface):
    """The hand-written kernel against its plain version on the card,
    float64, all four outputs, at the tolerance of the JAX package's
    kernel-vs-scan test (rtol 5e-9 / atol 1e-10 of scale).  `python3
    chip_smoke.py` runs the same comparison at the flagship shapes."""
    need_card()
    knot = taction.make_augmented_knot(
        make_panda_model("plant", dtype=torch.float64, device="cuda"), TWeights(**W_KW),
        surface)
    consts = rc.pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64).cuda()
    args = ([a.cuda() for a in port_args(setup, setup["arrays"])]
            + [type(setup["t_rr"])(*(a.cuda() for a in r)) for r in (setup["t_rr"], setup["t_rT"])])
    before = rc.rollout.launches
    got = rc.rollout(knot, consts, *args, NA)
    torch.cuda.synchronize()
    assert rc.rollout.launches == before + 1
    want = rc.rollout_reference(knot, *args, NA)
    assert_close([g.cpu() for g in got], [w.cpu() for w in want], 5e-9, 1e-10, "kernel")


@pytest.mark.cuda
def test_cuda_non_finite_sets_match_plain_version(setup):
    """The non-finite case above (a huge gap at one knot of problem 0, a NaN
    gain of problem 1) on the card, float64: the same non-finite entries,
    costs and gap sums as the plain version, the rest within rtol 5e-9."""
    need_card()
    knot = taction.make_augmented_knot(
        make_panda_model("plant", dtype=torch.float64, device="cuda"), TWeights(**W_KW), True)
    consts = rc.pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64).cuda()
    x0, xs, us, K, kff, fs, feas = (np.array(a) for a in setup["arrays"])
    fs[0, 2] = 1e200
    K[1, 1, 3, 5] = np.nan
    args = ([a.cuda() for a in port_args(setup, (x0, xs, us, K, kff, fs, feas))]
            + [type(setup["t_rr"])(*(a.cuda() for a in r)) for r in (setup["t_rr"], setup["t_rT"])])
    got = rc.rollout(knot, consts, *args, NA)
    want = rc.rollout_reference(knot, *args, NA)
    assert not bool(torch.isfinite(want[2]).all())
    assert_close([g.cpu() for g in got], [w.cpu() for w in want], 5e-9, 1e-10, "non-finite")


def pooled(knot, consts, args, k, A):
    """The batch as consecutive launches of k problems (the last n % k left
    out), outputs concatenated, and the inputs cut to match."""
    import chip_smoke as cs
    n = args[0].shape[0] // k * k
    outs = [rc.rollout(knot, consts, *cs.rollout_slice(args, i, i + k), A)
            for i in range(0, n, k)]
    return cs.rollout_slice(args, 0, n), tuple(torch.cat(f) for f in zip(*outs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N", [1, 40])
@pytest.mark.parametrize("B", [1, 3, 1024])
def test_cuda_kernel_at_flagship_shapes(B, N, dtype):
    """The flagship knot on the seeded inputs of ``chip_smoke.py``, 10 step
    lengths.  float64: all four outputs within rtol 5e-9 / atol 1e-10 of
    scale, equal non-finite sets.  float32: ``chip_smoke.py``'s rollout
    gates against the plain float64 version; launches of 1 or 3 problems are
    pooled over 1,024 problems, since those gates count shares of problems."""
    need_card()
    import chip_smoke as cs
    f64 = dtype == "float64"
    knot, consts, args = cs.seeded_rollout_args(1024 if not f64 else B, N,
                                                getattr(torch, dtype), 7)
    if f64:
        out_k = rc.rollout(knot, consts, *args, cs.N_ALPHAS)
    else:
        args, out_k = pooled(knot, consts, args, B, cs.N_ALPHAS)
    torch.cuda.synchronize()
    knot64 = cs.flagship_knot(torch.float64)
    rec = cs.rollout_gate(knot, args, out_k, knot64)
    assert rec["ok"], rec


@pytest.mark.cuda
def test_cuda_rollout_takes_device_constants_and_copies_nothing(setup):
    """A launch reads the constants where the caller put them on the card:
    it records no copy (no ``aten::copy_`` or ``aten::_to_copy``) and host
    constants for card tensors are refused, not copied."""
    need_card()
    knot = taction.make_augmented_knot(
        make_panda_model("plant", dtype=torch.float64, device="cuda"), TWeights(**W_KW), True)
    consts = rc.pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64)
    args = ([a.cuda() for a in port_args(setup, setup["arrays"])]
            + [type(setup["t_rr"])(*(a.cuda() for a in r)) for r in (setup["t_rr"], setup["t_rT"])])
    with pytest.raises(ValueError, match="consts"):
        rc.rollout(knot, consts, *args, NA)
    consts = consts.cuda()
    first = rc.rollout(knot, consts, *args, NA)
    torch.cuda.synchronize()
    launches = rc.rollout.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        second = rc.rollout(knot, consts, *args, NA)
        torch.cuda.synchronize()
    assert rc.rollout.launches == launches + 1
    ops = {e.name for e in prof.events()}
    assert not ops & {"aten::copy_", "aten::_to_copy", "aten::to"}, ops
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the golden fixture
# ---------------------------------------------------------------------------

GOLDEN = "tests/fixtures/solver_golden.npz"


def test_solve_matches_golden_fixture():
    """The force-feedback contact case of the framework-free golden fixture
    (``tests/test_solver_golden.py``: float64, N=12, 10 iterations, its own
    weights), solved by the port with its default settings, all three modes
    "kernel" (backward, rollout and diff; the plain versions on the CPU), at
    that test's bar: us atol 1e-6, cost rtol 1e-8."""
    from pathlib import Path
    from ffmpc_tpu_torch.mpc.controllers import make_vertical_down_R
    path = Path(__file__).resolve().parents[1] / GOLDEN
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    q0 = torch.as_tensor(KEYFRAMES["neutral"], dtype=torch.float64)
    tau_g = gravity_torque(model, q0)
    W = TWeights(dt_ocp=0.01, w_ee_pos=1.2e3, w_q_soft_limits=8.0,
                 w_tau_soft_limits=2.0, w_plane_z=1.2e3, w_vz=5.0e2,
                 contact_gains=(140.0, 80.0), fn_des=22.0, w_fn=28.0,
                 ff_alpha=float(np.exp(-2 * np.pi * 25.0 * 0.01)),
                 w_w=6.0e-4, w_w_soft_limits=2.0, w_y=8.0e-4)
    Ng = 12
    x0 = torch.cat([q0, torch.zeros(7, dtype=torch.float64), tau_g])
    refs_run, ref_T = t_build_refs(
        TTraj(**TRAJ_KW), torch.tensor([1.2], dtype=torch.float64), Ng, W.dt_ocp,
        torch.cat([q0, torch.zeros(7, dtype=torch.float64)]), tau_g,
        torch.as_tensor(make_vertical_down_R()), y_ref=x0, dtype=torch.float64,
        device="cpu")
    knot = taction.make_augmented_knot(model, W, surface=True)
    settings = TSettings(max_iters=10)
    assert (settings.backward_mode, settings.rollout_mode, settings.diff_mode) == ("kernel",) * 3
    res = t_solve(knot, refs_run, ref_T, x0[None], x0.repeat(1, Ng + 1, 1),
                  tau_g.repeat(1, Ng, 1), settings)
    with np.load(path) as z:
        us_ref = z["ff_contact_vector_us"]
        cost_ref = float(z["ff_contact_vector_cost"])
    assert np.abs(res.us[0].numpy() - us_ref).max() <= 1e-6
    assert np.isclose(float(res.cost[0]), cost_ref, rtol=1e-8)
