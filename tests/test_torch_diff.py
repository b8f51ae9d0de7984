"""Derivative pass of the PyTorch port (the module that holds the CUDA
knot-derivative kernel), float64 on the CPU:

- the plain version ``diff_reference`` == the JAX package's channel diff
  (``ocp/channel_diff.py::diff_via_channels``, the TPU kernel's own body, run
  per knot) on the running knots, and == the JAX knot's ``term_diff`` on the
  terminal knot, at 1e-12 of each field's scale (the bar of the JAX package's
  ``tests/test_diff_pallas.py``): the same derivatives, summed in another
  order;
- the kernel's device code (``csrc/knot_chain.cuh``: the primal part's
  stages, the 21 per-column parts and the Lxx columns, through
  ``diff_knot_serial``, compiled for the host with g++) == ``diff_reference``
  at 1e-11 of scale, running and terminal knots, also each column part on
  its own: the same derivatives, the tangent passes formed in closed form
  and from the primal part's link values, reassociated, and contracted into
  FMAs where the compiler chooses;
- the wrapper ``diff_all`` on CPU tensors, its argument checks, and
  ``cuda``-marked tests of the kernel itself (skipped without a card).

A field's scale is max(max|plain|, 1), as in ``tests/test_diff_pallas.py``.
The inputs are built with the port alone, and the JAX package is imported
only inside the comparisons with it (the ``jx`` fixture), which skip where
JAX is not installed: a card's machine has none, and there the ``cuda``
tests run with ``python -m pytest --noconftest tests/test_torch_diff.py -m
cuda``.
"""

import ctypes
import dataclasses
import math
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ffmpc_tpu_torch.core import KEYFRAMES, gravity_torque, make_panda_model
from ffmpc_tpu_torch.core.kinematics import fk as t_fk
from ffmpc_tpu_torch.mpc.controllers import make_vertical_down_R
from ffmpc_tpu_torch.ocp import action as taction
from ffmpc_tpu_torch.ocp.action import KnotDeriv
from ffmpc_tpu_torch.ocp.problem import build_problem_refs
from ffmpc_tpu_torch.ocp.weights import (ProblemRefs, flagship_trajectory,
                                         flagship_weights as t_weights,
                                         problem_refs_from_numpy)
from ffmpc_tpu_torch.solver import _cuda_build
from ffmpc_tpu_torch.solver import diff_cuda as dc
from ffmpc_tpu_torch.solver.rollout_cuda import pack_knot_consts

B, N = 2, 3
FIELDS = KnotDeriv._fields
TERM_FIELDS = ("cost_T", "LxT", "LxxT")


def T(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def rot_z(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def seeded_problems(Bn, Nn, seed, dtype=torch.float64, device="cpu", wide=True):
    """Bn problems of Nn knots around the neutral pose, built with the port
    alone: states perturbed by 0.1, controls by 2 Nm around gravity torque
    (problem 0's controls 4x wider where ``wide``, so the torque barriers
    act), and the problem references of the flagship trajectory at times
    spread over its approach and circle (problem 0 at 0.1 s, problem 1 at
    1.2 s), each with its own first state as the state reference.
    Returns (model, xs, us, refs_run, ref_T) as numpy float64, the model
    and the references in ``dtype`` on ``device``."""
    model = make_panda_model("plant", dtype=dtype, device=device)
    q0 = np.asarray(KEYFRAMES["neutral"])
    tau_g = gravity_torque(make_panda_model("plant", dtype=torch.float64, device="cpu"),
                           T(q0)).numpy()
    y0 = np.concatenate([q0, np.zeros(7), tau_g])
    rng = np.random.default_rng(seed)
    xs = y0 + 0.1 * rng.normal(size=(Bn, Nn + 1, 21))
    us = tau_g + 2.0 * rng.normal(size=(Bn, Nn, 7))
    if wide:
        us[0] *= 4.0
    ts = np.array([0.1, 1.2] + list(rng.uniform(0.0, 2.0, size=max(Bn - 2, 0))))[:Bn]
    W = t_weights()
    rr, rT = build_problem_refs(
        flagship_trajectory(), torch.as_tensor(ts, dtype=dtype), Nn, W.dt_ocp,
        torch.as_tensor(y0[:14], dtype=dtype), torch.as_tensor(tau_g, dtype=dtype),
        torch.as_tensor(make_vertical_down_R(), dtype=dtype),
        y_ref=torch.as_tensor(xs[:, 0], dtype=dtype), dtype=dtype, device=device)
    return model, xs, us, rr, rT


@pytest.fixture(scope="module")
def setup():
    """B problems of N knots (``seeded_problems``, seed 3: the recipe of
    ``tests/test_diff_pallas.py``).  Knot (1, 1) and problem 1's terminal
    knot get a desired orientation 1e-7 rad from the tool's own, an
    orientation error near zero."""
    mt, xs, us, rr, rT = seeded_problems(B, N, 3)
    rr = {k: getattr(rr, k).numpy().copy() for k in ProblemRefs._fields}
    rT = {k: getattr(rT, k).numpy().copy() for k in ProblemRefs._fields}
    ee_R = t_fk(mt, T(xs[..., :7])).ee_R.numpy()
    rr["R_des"][1, 1] = ee_R[1, 1] @ rot_z(1e-7)
    rT["R_des"][1] = ee_R[1, N] @ rot_z(1e-7)
    return dict(mt=mt, xs=xs, us=us, rr=rr, rT=rT)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces the comparisons need (its model and
    weights); skipped where JAX is not installed."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.core import make_panda_model as j_make_model
    from ffmpc_tpu.ocp import action as jaction
    from ffmpc_tpu.ocp.channel_diff import diff_via_channels
    from ffmpc_tpu.ocp.weights import ProblemRefs as JRefs, flagship_weights as j_weights
    return SimpleNamespace(jax=jax, jnp=jnp, mj=j_make_model("plant", jnp.float64),
                           jaction=jaction, diff_via_channels=diff_via_channels,
                           JRefs=JRefs, j_weights=j_weights)


def port_refs(setup):
    return (problem_refs_from_numpy(setup["rr"], dtype=torch.float64, device="cpu"),
            problem_refs_from_numpy(setup["rT"], dtype=torch.float64, device="cpu"))


def port_knot(setup, surface):
    return taction.make_augmented_knot(setup["mt"], t_weights(), surface)


def scale_of(want):
    return max(float(np.abs(want).max()), 1.0)


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_reference_matches_jax_channel_diff(setup, jx, surface):
    """Running knots: ``diff_reference`` against the TPU kernel's body, the
    channel diff, called per knot and op by op, as ``tests/test_diff_pallas.py``
    calls it (jitting it costs minutes of XLA compile on the CPU)."""
    rr_t, rT_t = port_refs(setup)
    got = dc.diff_reference(port_knot(setup, surface), rr_t, rT_t,
                            T(setup["xs"]), T(setup["us"]))
    ch = jx.diff_via_channels(jx.mj, jx.j_weights(), surface, "augmented")
    for b in range(B):
        for t in range(N):
            ref = jx.JRefs(**{k: jx.jnp.asarray(v[b, t]) for k, v in setup["rr"].items()})
            want = ch(ref, jx.jnp.asarray(setup["xs"][b, t]), jx.jnp.asarray(setup["us"][b, t]))
            for name in FIELDS:
                w = np.asarray(getattr(want, name))
                g = getattr(got.run, name)[b, t].numpy()
                err = float(np.abs(g - w).max())
                assert err <= 1e-12 * scale_of(w), (surface, b, t, name, err)


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_terminal_matches_jax_term_diff(setup, jx, surface):
    rr_t, rT_t = port_refs(setup)
    got = dc.diff_reference(port_knot(setup, surface), rr_t, rT_t,
                            T(setup["xs"]), T(setup["us"]))
    kj = jx.jaction.make_augmented_knot(jx.mj, jx.j_weights(), surface,
                                        deriv_mode="analytic", calc_mode="vector")
    rT_j = jx.JRefs(**{k: jx.jnp.asarray(v) for k, v in setup["rT"].items()})
    want = jx.jax.jit(jx.jax.vmap(kj.term_diff))(rT_j, jx.jnp.asarray(setup["xs"][:, -1]))
    for name, g, w in zip(TERM_FIELDS, got[1:], want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-12 * scale_of(w), (surface, name, err)


# ---------------------------------------------------------------------------
# the kernel's device code, compiled for the host
# ---------------------------------------------------------------------------

_HOST_HARNESS = r"""
#include <cstring>
#include "knot_chain.cuh"

// Every knot of the batch, one after the other, each through the parts in
// turn (the primal part, the columns, the Lxx columns): what the kernel's
// blocks do.  columns / n_columns: the columns to run at every knot, in that
// order (null: all of them, ascending).
extern "C" int knot_diff_host_f64(const void* consts, const void* xs, const void* us,
                                  const void* const* refs, const void* const* refs_T,
                                  void* const* outs, int B, int N, int surface,
                                  const int* columns, int n_columns) {
  ffmpc::KnotConstants<double> C;
  std::memcpy(&C, consts, sizeof(C));
  const auto a = ffmpc::diff_args<double>(xs, us, refs, refs_T, outs, B, N);
  for (int b = 0; b < B; ++b)
    for (int t = 0; t <= N; ++t) {
      if (surface)
        ffmpc::diff_knot_serial<double, true>(C, a, b, t, columns, n_columns);
      else
        ffmpc::diff_knot_serial<double, false>(C, a, b, t, columns, n_columns);
    }
  return 0;
}

// The same for the point contact's families (nc = 3), the classical knot's
// on the running knots' constants, the first of its two sets.
template <typename F>
int diff_point3d_host(const void* consts, const void* xs, const void* us,
                      const void* const* refs, const void* const* refs_T, void* const* outs,
                      int B, int N, int surface, const int* columns, int n_columns) {
  ffmpc::KnotConstants<double, 3> C[F::kConstSets];
  std::memcpy(C, consts, sizeof(C));
  const auto a = ffmpc::diff_args<double>(xs, us, refs, refs_T, outs, B, N);
  for (int b = 0; b < B; ++b)
    for (int t = 0; t <= N; ++t) {
      if constexpr (F::kClassical) {
        if (surface)
          ffmpc::diff_knot_serial_classical<double, true>(C[0], a, b, t, columns, n_columns);
        else
          ffmpc::diff_knot_serial_classical<double, false>(C[0], a, b, t, columns, n_columns);
      } else if (surface) {
        ffmpc::diff_knot_serial<double, true>(C[0], a, b, t, columns, n_columns);
      } else {
        ffmpc::diff_knot_serial<double, false>(C[0], a, b, t, columns, n_columns);
      }
    }
  return 0;
}

extern "C" int knot_diff_point3d_host_f64(const void* consts, const void* xs, const void* us,
                                          const void* const* refs, const void* const* refs_T,
                                          void* const* outs, int B, int N, int surface,
                                          const int* columns, int n_columns) {
  return diff_point3d_host<ffmpc::AugmentedPoint3d>(consts, xs, us, refs, refs_T, outs, B, N,
                                                    surface, columns, n_columns);
}

extern "C" int knot_diff_classical_point3d_host_f64(const void* consts, const void* xs,
                                                    const void* us, const void* const* refs,
                                                    const void* const* refs_T,
                                                    void* const* outs, int B, int N,
                                                    int surface, const int* columns,
                                                    int n_columns) {
  return diff_point3d_host<ffmpc::ClassicalPoint3d>(consts, xs, us, refs, refs_T, outs, B, N,
                                                    surface, columns, n_columns);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the device code cannot be built for the host")
    d = tmp_path_factory.mktemp("knot_diff_host")
    src, lib = d / "harness.cpp", d / "libknot_diff_host.so"
    src.write_text(_HOST_HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(_cuda_build.CSRC_DIR), "-o", str(lib), str(src)], check=True)
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for key, name in ((None, "knot_diff_host_f64"),
                      ("augmented", "knot_diff_point3d_host_f64"),
                      ("classical", "knot_diff_classical_point3d_host_f64")):
        fn = getattr(cdll, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                                  ctypes.c_int]
        fn.restype = ctypes.c_int
        fns[key] = fn
    # the augmented normal-contact harness itself; the point contact's by family
    fn = fns[None]
    fn.point3d = fns
    return fn


def host_diff(fn, knot, refs_run, ref_T, xs, us, columns=None):
    """The header's parts over every knot (``diff_knot_serial``, or
    ``diff_knot_serial_classical`` for a classical knot), into outputs that
    start NaN; ``columns``: the columns to run (all if None)."""
    Bn, Nn = us.shape[:2]
    nx = knot.nx
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64, knot.family)

    def nan(*shape):
        return torch.full(shape, float("nan"), dtype=torch.float64)

    run = KnotDeriv(nan(Bn, Nn, nx), nan(Bn, Nn), nan(Bn, Nn, nx, nx), nan(Bn, Nn, nx, 7),
                    nan(Bn, Nn, nx), nan(Bn, Nn, 7), nan(Bn, Nn, nx, nx),
                    nan(Bn, Nn, nx, 7), nan(Bn, Nn, 7, 7))
    out = dc.KnotDerivs(run, nan(Bn), nan(Bn, nx), nan(Bn, nx, nx))
    p6 = ctypes.c_void_p * 6
    cols = None if columns is None else (ctypes.c_int * len(columns))(*columns)
    fn(consts.data_ptr(), xs.data_ptr(), us.data_ptr(),
       p6(*(a.data_ptr() for a in refs_run)), p6(*(a.data_ptr() for a in ref_T)),
       (ctypes.c_void_p * 12)(*(a.data_ptr() for a in (*run, *out[1:]))), Bn, Nn,
       int(knot.surface), cols, 0 if columns is None else len(columns))
    return out


def assert_derivs_close(got, want, rtol, what):
    """Every field within rtol of its scale on the entries finite in both,
    and the same (knot, field) pairs non-finite.  Sets are compared per knot:
    the plain version's dense products spread a NaN over a Jacobian's
    structural zeros (0 * NaN) where the kernel multiplies live columns only,
    so inside a knot that is non-finite in both, the two may mark different
    entries; the backward sweep consumes a knot's block whole."""
    pairs = [(f"run.{n}", getattr(got.run, n), getattr(want.run, n), 2) for n in FIELDS]
    pairs += [(n, g, w, 1) for n, g, w in zip(TERM_FIELDS, got[1:], want[1:])]
    for name, g, w, lead in pairs:
        assert g.shape == w.shape, (what, name)
        knot_bad = [(~torch.isfinite(a)).reshape(a.shape[:lead] + (-1,)).any(-1)
                    for a in (g, w)]
        assert torch.equal(*knot_bad), (what, name, "non-finite knots differ")
        both = torch.isfinite(g) & torch.isfinite(w)
        w_fin = w[torch.isfinite(w)]
        scale = max(float(w_fin.abs().max()), 1.0) if w_fin.numel() else 1.0
        err = float((g - w)[both].abs().max()) if bool(both.any()) else 0.0
        assert err <= rtol * scale, f"{what} {name}: err {err:.3e} scale {scale:.3e}"


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_host_build_of_the_device_code_matches_reference(setup, host_lib, surface):
    knot = port_knot(setup, surface)
    rr_t, rT_t = port_refs(setup)
    xs, us = T(setup["xs"]), T(setup["us"])
    want = dc.diff_reference(knot, rr_t, rT_t, xs, us)
    assert all(bool(torch.isfinite(a).all()) for a in (*want.run, *want[1:]))
    assert_derivs_close(host_diff(host_lib, knot, rr_t, rT_t, xs, us), want, 1e-11,
                        "seeded")


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_host_build_non_finite_sets_match_reference(setup, host_lib, surface):
    """A NaN torque state at running knot (1, 2) and at problem 0's terminal
    knot (NaN acceleration and force: Fx, Lx, Lxx and the cost go NaN, Fu
    stays finite), and a contact reference 1e200 m away at knot (0, 1) and
    problem 1's terminal knot (the force overflows the cost)."""
    knot = port_knot(setup, surface)
    rr_t, rT_t = port_refs(setup)
    xs, us = T(setup["xs"]), T(setup["us"])
    xs[1, 2, 16] = float("nan")
    xs[0, N, 15] = float("nan")
    rr_t.p_ref[0, 1, 2] = 1e200
    rT_t.p_ref[1, 2] = 1e200
    want = dc.diff_reference(knot, rr_t, rT_t, xs, us)
    assert not bool(torch.isfinite(want.run.cost).all())
    assert not bool(torch.isfinite(want.cost_T).all())
    assert_derivs_close(host_diff(host_lib, knot, rr_t, rT_t, xs, us), want, 1e-11,
                        "non-finite inputs")


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_host_build_runs_each_column_part_on_its_own(setup, host_lib, surface):
    """Each of the 21 per-column parts (7 q-passes, 7 v-passes, 7 control
    columns), run alone after the primal part, writes its own column of
    Fx's rows 0-13 at every running knot and no other, within 1e-11 of
    scale of ``diff_reference``; and the 21 run in reverse order give the
    same bits as in order (a column reads only the primal part's record, as
    the kernel's warps, which run them concurrently, require)."""
    knot = port_knot(setup, surface)
    rr_t, rT_t = port_refs(setup)
    xs, us = T(setup["xs"]), T(setup["us"])
    want = dc.diff_reference(knot, rr_t, rT_t, xs, us).run.Fx[:, :, :14]
    scale = max(float(want.abs().max()), 1.0)
    for c in range(21):
        got = host_diff(host_lib, knot, rr_t, rT_t, xs, us, columns=[c]).run.Fx[:, :, :14]
        others = [j for j in range(21) if j != c]
        assert bool(torch.isnan(got[..., others]).all()), c
        err = float((got[..., c] - want[..., c]).abs().max())
        assert err <= 1e-11 * scale, f"column {c}: err {err:.3e} scale {scale:.3e}"
    fwd = host_diff(host_lib, knot, rr_t, rT_t, xs, us)
    rev = host_diff(host_lib, knot, rr_t, rT_t, xs, us, columns=list(range(20, -1, -1)))
    for a, b in zip((*fwd.run, *fwd[1:]), (*rev.run, *rev[1:])):
        assert torch.equal(a, b)


# the point contact (contact_model="point3d": the force in R^3 and the
# friction cone's barrier, at the values MPCConfig gives a point3d run)
P3 = dict(contact_model="point3d", w_friction_cone=2.0e2, mu=0.6, friction_margin=1e-3)


def point3d_knot(setup, family, surface):
    W = dataclasses.replace(t_weights(), **P3)
    make = taction.make_augmented_knot if family == "augmented" else taction.make_classical_knot
    return make(setup["mt"], W, surface)


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
@pytest.mark.parametrize("family", ["augmented", "classical"])
def test_host_build_of_the_point3d_device_code_matches_reference(setup, host_lib, family,
                                                                 surface):
    """The point contact's device code (``ContactRecord<3>``: three M^-1 Jc^T
    columns, the 3 x 3 Schur factor, three h2 rows a column staged outside
    the record and copied after the columns, the cone folded into the force
    rows' Hessian) == ``diff_reference`` at 1e-11 of scale, running and
    terminal knots; on these inputs the cone's barrier acts."""
    knot = point3d_knot(setup, family, surface)
    rr_t, rT_t = port_refs(setup)
    xs, us = T(setup["xs"][..., :knot.nx]), T(setup["us"])
    want = dc.diff_reference(knot, rr_t, rT_t, xs, us)
    assert all(bool(torch.isfinite(a).all()) for a in (*want.run, *want[1:]))
    if surface:
        # the cone's term in the cost: at w = 0 the cost differs
        make = (taction.make_augmented_knot if family == "augmented"
                else taction.make_classical_knot)
        knot0 = make(setup["mt"], dataclasses.replace(knot.W, w_friction_cone=0.0), surface)
        assert bool((dc.diff_reference(knot0, rr_t, rT_t, xs, us).run.cost
                     != want.run.cost).any())
    got = host_diff(host_lib.point3d[family], knot, rr_t, rT_t, xs, us)
    assert_derivs_close(got, want, 1e-11, f"point3d {family}")


def test_host_build_runs_each_point3d_column_part_on_its_own(setup, host_lib):
    """The point contact's columns stage their outputs apart from the
    record: each of the 21, run alone after the primal part, writes its own
    column of Fx's rows 0-13 and no other, within 1e-11 of scale; and the
    21 in reverse order give the same bits as in order."""
    knot = point3d_knot(setup, "augmented", True)
    rr_t, rT_t = port_refs(setup)
    xs, us = T(setup["xs"]), T(setup["us"])
    fn = host_lib.point3d["augmented"]
    want = dc.diff_reference(knot, rr_t, rT_t, xs, us).run.Fx[:, :, :14]
    scale = max(float(want.abs().max()), 1.0)
    for c in range(21):
        got = host_diff(fn, knot, rr_t, rT_t, xs, us, columns=[c]).run.Fx[:, :, :14]
        others = [j for j in range(21) if j != c]
        assert bool(torch.isnan(got[..., others]).all()), c
        err = float((got[..., c] - want[..., c]).abs().max())
        assert err <= 1e-11 * scale, f"column {c}: err {err:.3e} scale {scale:.3e}"
    fwd = host_diff(fn, knot, rr_t, rT_t, xs, us)
    rev = host_diff(fn, knot, rr_t, rT_t, xs, us, columns=list(range(20, -1, -1)))
    for a, b in zip((*fwd.run, *fwd[1:]), (*rev.run, *rev[1:])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch(setup):
    knot = port_knot(setup, True)
    rr_t, rT_t = port_refs(setup)
    xs, us = T(setup["xs"]), T(setup["us"])
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64)
    before = dc.diff_all.launches
    got = dc.diff_all(knot, consts, rr_t, rT_t, xs, us)
    want = dc.diff_reference(knot, rr_t, rT_t, xs, us)
    assert dc.diff_all.launches == before
    for a, b in zip((*got.run, *got[1:]), (*want.run, *want[1:])):
        assert torch.equal(a, b)


def test_wrapper_rejects_wrong_shapes_and_types(setup):
    knot = port_knot(setup, True)
    rr_t, rT_t = port_refs(setup)
    xs, us = T(setup["xs"]), T(setup["us"])
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64)

    def call(xs_, us_, rr_=rr_t, rT_=rT_t):
        return dc.diff_all(knot, consts, rr_, rT_, xs_, us_)

    with pytest.raises(ValueError, match="xs"):
        call(xs[:, :-1], us)                              # a state missing
    with pytest.raises(ValueError, match="us"):
        call(xs, us.to(torch.float32))                    # another dtype
    with pytest.raises(ValueError, match="tau_ref"):
        call(xs, us, rr_=rr_t._replace(tau_ref=rr_t.tau_ref[:, :-1]))
    with pytest.raises(ValueError, match="ref_T.R_des"):
        call(xs, us, rT_=rT_t._replace(R_des=rT_t.R_des.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_cuda_kernel_matches_plain_version(setup, surface):
    """The hand-written kernel against its plain version on the card,
    float64, at 1e-11 of scale.  `python3 chip_smoke.py` runs the same
    comparison at the flagship shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the diff kernel has no CPU build")
    mt = make_panda_model("plant", dtype=torch.float64, device="cuda")
    knot = taction.make_augmented_knot(mt, t_weights(), surface)
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64)
    rr_t, rT_t = (ProblemRefs(*(a.cuda() for a in r)) for r in port_refs(setup))
    xs, us = T(setup["xs"]).cuda(), T(setup["us"]).cuda()
    before = dc.diff_all.launches
    got = dc.diff_all(knot, consts, rr_t, rT_t, xs, us)
    torch.cuda.synchronize()
    assert dc.diff_all.launches == before + 1
    want = dc.diff_reference(knot, rr_t, rT_t, xs, us)
    cpu = lambda d: dc.KnotDerivs(KnotDeriv(*(a.cpu() for a in d.run)),
                                  *(a.cpu() for a in d[1:]))
    assert_derivs_close(cpu(got), cpu(want), 1e-11, "kernel")


# The kernel's float32 gate, chip_smoke.py's (see the reasons there): per
# knot and field, its largest error against the plain float64 version is at
# most DIFF_F32_FACTOR times the plain float32 version's own, plus
# DIFF_F32_FLOOR of the field's scale; on every knot but those whose float64
# contact force lies within UNILATERAL_EDGE_N of the unilateral barrier's
# bound (at most DIFF_MAX_EDGE_SHARE of the knots).
DIFF_F32_FACTOR, DIFF_F32_FLOOR = 4.0, 1e-6
UNILATERAL_EDGE_N = 1e-2
DIFF_MAX_EDGE_SHARE = 1e-3
CUDA_SHAPES = ((1, 1), (1, 40), (3, 1), (3, 40), (1024, 1), (1024, 40))


def unilateral_edge(knot64, refs_run, ref_T, xs):
    """Running (B, N) and terminal (B,) masks of the knots whose float64
    contact force lies within UNILATERAL_EDGE_N of the barrier's bound."""
    from ffmpc_tpu_torch.core.dynamics import fwd_dynamics_contact
    W = knot64.W

    def force(y, ref):
        dyn = fwd_dynamics_contact(
            knot64.model, y[..., :7], y[..., 7:14], y[..., 14:], nc1=True,
            ref_pos=ref.p_ref[..., 2].double() - W.z_press,
            baumgarte_kp=W.contact_gains[0], baumgarte_kd=W.contact_gains[1],
            damping_c=W.contact_inv_damping)
        return dyn.force[..., 0]
    xs = xs.double()
    return ((force(xs[:, :-1], refs_run) - W.friction_margin).abs() <= UNILATERAL_EDGE_N,
            (force(xs[:, -1], ref_T) - W.friction_margin).abs() <= UNILATERAL_EDGE_N)


def assert_f32_within_gate(got, plain32, plain64, edge_run, edge_T, what):
    pairs = [(n, getattr(got.run, n), getattr(plain32.run, n), getattr(plain64.run, n), 2)
             for n in FIELDS]
    pairs += [(n, g, p, r, 1) for n, g, p, r in zip(TERM_FIELDS, got[1:], plain32[1:],
                                                      plain64[1:])]
    n_knots = edge_run.numel() + edge_T.numel()
    assert int(edge_run.sum() + edge_T.sum()) <= DIFF_MAX_EDGE_SHARE * n_knots, what
    for name, g, p, r, lead in pairs:
        scale = max(float(r.abs().max()), 1.0)
        ek = (g.double() - r).abs().reshape(r.shape[:lead] + (-1,)).amax(-1)
        ep = (p.double() - r).abs().reshape(r.shape[:lead] + (-1,)).amax(-1)
        over = ~(ek <= DIFF_F32_FACTOR * ep + DIFF_F32_FLOOR * scale)   # NaN counts as over
        edge = edge_run if lead == 2 else edge_T
        assert not bool((over & ~edge).any()), (what, name, int((over & ~edge).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_cuda_kernel_layout_matches_plain_version(dtype, surface):
    """The kernel at the batch sizes and horizons its block layout cuts
    differently (B in 1, 3, 1024: a block's 32 knots from one problem or
    many, a partial last block, terminal blocks of 1, 3 and 32 problems;
    N in 1, 40), on seeded inputs built with the port alone (seed 5), against
    its plain version on the card: float64 at 1e-11 of scale with the same
    non-finite (knot, field) pairs; float32 within chip_smoke.py's gate.
    One launch each (``diff_all.launches``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the diff kernel has no CPU build")
    for Bn, Nn in CUDA_SHAPES:
        model, xs_np, us_np, rr, rT = seeded_problems(Bn, Nn, 5, dtype=dtype, device="cuda")
        knot = taction.make_augmented_knot(model, t_weights(), surface)
        consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype)
        rr = ProblemRefs(*(a.contiguous() for a in rr))
        rT = ProblemRefs(*(a.contiguous() for a in rT))
        xs = torch.as_tensor(xs_np, dtype=dtype, device="cuda")
        us = torch.as_tensor(us_np, dtype=dtype, device="cuda")
        before = dc.diff_all.launches
        got = dc.diff_all(knot, consts, rr, rT, xs, us)
        torch.cuda.synchronize()
        assert dc.diff_all.launches == before + 1
        want = dc.diff_reference(knot, rr, rT, xs, us)
        cpu = lambda d: dc.KnotDerivs(KnotDeriv(*(a.cpu() for a in d.run)),  # noqa: E731
                                      *(a.cpu() for a in d[1:]))
        what = f"B={Bn} N={Nn}"
        if dtype == torch.float64:
            assert_derivs_close(cpu(got), cpu(want), 1e-11, what)
            continue
        model64 = make_panda_model("plant", dtype=torch.float64, device="cuda")
        knot64 = taction.make_augmented_knot(model64, t_weights(), surface)
        rr64 = ProblemRefs(*(a.double() for a in rr))
        rT64 = ProblemRefs(*(a.double() for a in rT))
        want64 = dc.diff_reference(knot64, rr64, rT64, xs.double(), us.double())
        if surface:
            edge_run, edge_T = unilateral_edge(knot64, rr64, rT64, xs)
        else:
            edge_run = torch.zeros(Bn, Nn, dtype=torch.bool, device="cuda")
            edge_T = torch.zeros(Bn, dtype=torch.bool, device="cuda")
        assert_f32_within_gate(got, want, want64, edge_run, edge_T, what)
