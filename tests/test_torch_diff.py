"""Derivative pass of the PyTorch port (the module that holds the CUDA
knot-derivative kernel), float64 on the CPU:

- the plain version ``diff_reference`` == the JAX package's channel diff
  (``ocp/channel_diff.py::diff_via_channels``, the TPU kernel's own body, run
  per knot) on the running knots, and == the JAX knot's ``term_diff`` on the
  terminal knot, at 1e-12 of each field's scale (the bar of the JAX package's
  ``tests/test_diff_pallas.py``): the same derivatives, summed in another
  order;
- the kernel's device code (``csrc/knot_chain.cuh::diff_knot``, compiled for
  the host with g++) == ``diff_reference`` at 1e-11 of scale, running and
  terminal knots: the same formulas, reassociated, and contracted into FMAs
  where the compiler chooses;
- the wrapper ``diff_all`` on CPU tensors, its argument checks, and a
  ``cuda``-marked test of the kernel itself (skipped without a card).

A field's scale is max(max|plain|, 1), as in ``tests/test_diff_pallas.py``.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ffmpc_tpu.core import make_panda_model as j_make_model, KEYFRAMES, gravity_torque as j_gravity
from ffmpc_tpu.ocp import action as jaction
from ffmpc_tpu.ocp.channel_diff import diff_via_channels
from ffmpc_tpu.ocp.problem import build_problem_refs as j_build_refs
from ffmpc_tpu.ocp.weights import (ProblemRefs as JRefs, flagship_weights as j_weights,
                                   flagship_trajectory as j_traj)
from ffmpc_tpu.mpc.controllers import make_vertical_down_R
from ffmpc_tpu_torch.core import panda_model_from_numpy
from ffmpc_tpu_torch.core.kinematics import fk as t_fk
from ffmpc_tpu_torch.ocp import action as taction
from ffmpc_tpu_torch.ocp.action import KnotDeriv
from ffmpc_tpu_torch.ocp.weights import ProblemRefs, flagship_weights as t_weights
from ffmpc_tpu_torch.ocp.weights import problem_refs_from_numpy
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


@pytest.fixture(scope="module")
def setup():
    """B problems of N knots around the neutral pose (states perturbed as in
    ``tests/test_diff_pallas.py``: 0.1 on the state, 2 Nm on the controls,
    one problem's controls 4x wider so the torque barriers act), with the
    problem references of three points of the flagship trajectory.  Knot
    (1, 1) and problem 1's terminal knot get a desired orientation 1e-7 rad
    from the tool's own, an orientation error near zero."""
    mj = j_make_model("plant", jnp.float64)
    mt = panda_model_from_numpy({k: np.asarray(v) for k, v in mj._asdict().items()},
                                dtype=torch.float64, device="cpu")
    q0 = np.asarray(KEYFRAMES["neutral"])
    tau_g = np.asarray(j_gravity(mj, jnp.asarray(q0)))
    y0 = np.concatenate([q0, np.zeros(7), tau_g])
    rng = np.random.default_rng(3)
    xs = y0 + 0.1 * rng.normal(size=(B, N + 1, 21))
    us = tau_g + 2.0 * rng.normal(size=(B, N, 7))
    us[0] *= 4.0
    W = j_weights()
    rr, rT = jax.vmap(lambda t, x: j_build_refs(
        j_traj(), t, N, W.dt_ocp, jnp.asarray(y0[:14]), jnp.asarray(tau_g),
        jnp.asarray(make_vertical_down_R()), y_ref=x, dtype=jnp.float64))(
        jnp.asarray([0.1, 1.2]), jnp.asarray(xs[:, 0]))
    rr = {k: np.array(v) for k, v in rr._asdict().items()}
    rT = {k: np.array(v) for k, v in rT._asdict().items()}
    ee_R = t_fk(mt, T(xs[..., :7])).ee_R.numpy()
    rr["R_des"][1, 1] = ee_R[1, 1] @ rot_z(1e-7)
    rT["R_des"][1] = ee_R[1, N] @ rot_z(1e-7)
    return dict(mj=mj, mt=mt, xs=xs, us=us, rr=rr, rT=rT)


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
def test_reference_matches_jax_channel_diff(setup, surface):
    """Running knots: ``diff_reference`` against the TPU kernel's body, the
    channel diff, called per knot and op by op, as ``tests/test_diff_pallas.py``
    calls it (jitting it costs minutes of XLA compile on the CPU)."""
    rr_t, rT_t = port_refs(setup)
    got = dc.diff_reference(port_knot(setup, surface), rr_t, rT_t,
                            T(setup["xs"]), T(setup["us"]))
    ch = diff_via_channels(setup["mj"], j_weights(), surface, "augmented")
    for b in range(B):
        for t in range(N):
            ref = JRefs(**{k: jnp.asarray(v[b, t]) for k, v in setup["rr"].items()})
            want = ch(ref, jnp.asarray(setup["xs"][b, t]), jnp.asarray(setup["us"][b, t]))
            for name in FIELDS:
                w = np.asarray(getattr(want, name))
                g = getattr(got.run, name)[b, t].numpy()
                err = float(np.abs(g - w).max())
                assert err <= 1e-12 * scale_of(w), (surface, b, t, name, err)


@pytest.mark.parametrize("surface", [True, False], ids=["contact", "free"])
def test_terminal_matches_jax_term_diff(setup, surface):
    rr_t, rT_t = port_refs(setup)
    got = dc.diff_reference(port_knot(setup, surface), rr_t, rT_t,
                            T(setup["xs"]), T(setup["us"]))
    kj = jaction.make_augmented_knot(setup["mj"], j_weights(), surface,
                                     deriv_mode="analytic", calc_mode="vector")
    rT_j = JRefs(**{k: jnp.asarray(v) for k, v in setup["rT"].items()})
    want = jax.jit(jax.vmap(kj.term_diff))(rT_j, jnp.asarray(setup["xs"][:, -1]))
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

// Every knot of the batch, one after the other: what the kernel's threads do.
extern "C" int knot_diff_host_f64(const void* consts, const void* xs, const void* us,
                                  const void* const* refs, const void* const* refs_T,
                                  void* const* outs, int B, int N, int surface) {
  ffmpc::KnotConstants<double> C;
  std::memcpy(&C, consts, sizeof(C));
  const auto a = ffmpc::diff_args<double>(xs, us, refs, refs_T, outs, B, N);
  for (int b = 0; b < B; ++b)
    for (int t = 0; t <= N; ++t) {
      if (surface)
        ffmpc::diff_knot<double, true>(C, a, b, t);
      else
        ffmpc::diff_knot<double, false>(C, a, b, t);
    }
  return 0;
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
    fn = ctypes.CDLL(str(lib)).knot_diff_host_f64
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn


def host_diff(fn, knot, refs_run, ref_T, xs, us):
    """The header's ``diff_knot`` over every knot, into fresh outputs."""
    Bn, Nn = us.shape[:2]
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, torch.float64)

    def nan(*shape):
        return torch.full(shape, float("nan"), dtype=torch.float64)

    run = KnotDeriv(nan(Bn, Nn, 21), nan(Bn, Nn), nan(Bn, Nn, 21, 21), nan(Bn, Nn, 21, 7),
                    nan(Bn, Nn, 21), nan(Bn, Nn, 7), nan(Bn, Nn, 21, 21),
                    nan(Bn, Nn, 21, 7), nan(Bn, Nn, 7, 7))
    out = dc.KnotDerivs(run, nan(Bn), nan(Bn, 21), nan(Bn, 21, 21))
    p6 = ctypes.c_void_p * 6
    fn(consts.data_ptr(), xs.data_ptr(), us.data_ptr(),
       p6(*(a.data_ptr() for a in refs_run)), p6(*(a.data_ptr() for a in ref_T)),
       (ctypes.c_void_p * 12)(*(a.data_ptr() for a in (*run, *out[1:]))), Bn, Nn,
       int(knot.surface))
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
    mt = panda_model_from_numpy({k: np.asarray(v) for k, v in setup["mj"]._asdict().items()},
                                dtype=torch.float64, device="cuda")
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
