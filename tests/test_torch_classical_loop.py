"""The classical controller's closed loop and ensemble (x = (q, v),
u = tau, nx = 14), float64 on the CPU with the three modes "kernel", so the
plain versions run on these CPU tensors, unless marked:

- the port's episode (``make_episode_fn(EpisodeConfig(controller=
  "classical"))``) == the JAX package's ``make_episode_fn`` on the setup of
  ``tests/test_torch_episode.py`` (``OCPWeights(dt_ocp=0.01,
  w_ee_pos=1.2e3)``, 2 iterations, horizon 4, from the neutral pose), over
  ticks 0-2 from t = 0 and over six ticks from t0 = 0.78 s, where the
  trajectory's surface flag switches at 0.80 s, so both knots run; clean,
  and with the uncertainty protocol's gain and bias (a = 1.03, b = 0.05,
  every sigma 0): equal iterations, and q, tau_cmd, cost and fn_meas within
  rtol 1e-6 / atol 1e-7 of the field's largest magnitude (the whole-solve
  tolerance of ``tests/test_torch_solve.py``: the box QP's argmin ties).
  One JAX compile of a three-tick chunk, with a and b traced, serves every
  case;
- the port's ``run_ensemble(controller="classical")`` == the JAX package's
  at the full width (horizon 36, 10 iterations) and a small batch, at 1e-9
  of each field's scale with the iterations of every tick equal; the JAX
  figures are kept here (``JAX_REFERENCE``);
- a solve given another knot family's kernel constants raises;
- ``cuda``-marked: the classical loop on the card, kernels against plain
  mode at float64 (``chip_smoke.py`` phase ``classical_loop``, case (a), at
  N=4 and 4 ticks); skipped without a card.

The JAX package is imported only inside the comparisons with it (the
``jx`` fixture), which skip where JAX is not installed: on a card's machine
the ``cuda`` tests run with ``python -m pytest --noconftest
tests/test_torch_classical_loop.py -m cuda``.

``python tests/test_torch_classical_loop.py`` prints ``JAX_REFERENCE`` anew
and compares the regularization retries of the two packages' float32
classical solves (each problem's final regularization and iterations; B=64,
N=36, warm starts as ``chip_smoke.py::classical_warm_starts`` builds them).
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

if __name__ == "__main__":      # run as a script: the repo's packages
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ffmpc_tpu_torch.core import KEYFRAMES, make_panda_model
from ffmpc_tpu_torch.ocp.action import make_augmented_knot, make_classical_knot
from ffmpc_tpu_torch.ocp.weights import OCPWeights as TWeights, flagship_weights
from ffmpc_tpu_torch.run.batch_runner import (DeviceUncertainty as TUnc,
                                              EpisodeConfig as TEpisode,
                                              make_episode_fn as t_episode_fn)
from ffmpc_tpu_torch.run.ensemble import run_ensemble
from ffmpc_tpu_torch.sim.device_plant import make_table_params as t_table
from ffmpc_tpu_torch.solver.fddp import FDDPSettings as TSettings, solve as t_solve
from ffmpc_tpu_torch.solver.rollout_cuda import consts_len, pack_knot_consts
from ffmpc_tpu_torch.tasks.trajectories import ApproachCircleTraj as TTraj

CHUNK = 3
FIELDS = ("q", "tau_cmd", "cost", "fn_meas")
RTOL, ATOL = 1e-6, 1e-7
Z_C = 0.342
TRAJ_KW = dict(center=(-0.5, 0.0, Z_C), radius=0.10, omega=1.5, z_contact=Z_C,
               t_approach=0.55, z_pre=Z_C + 0.05, t_pre=0.25,
               ee_start=(-0.3, 0.0, 0.633), t_stabilize=0.2)
EP_KW = dict(controller="classical", horizon=4, n_ticks=CHUNK)
CASES = {"start": (0.0, 1), "switch": (0.78, 2)}      # t0, chunks of CHUNK ticks
GAIN_BIAS = (1.03, 0.05)

ENSEMBLE_ARGS = dict(controller="classical", scenario="flat", batch=2, ticks=2, horizon=36,
                     max_iters=10, seed=0, perturb_q=0.01, dtype_name="float64")
ENSEMBLE_RTOL = 1e-9

# printed by `JAX_PLATFORMS=cpu python tests/test_torch_classical_loop.py`
# (the JAX package's run_ensemble on ENSEMBLE_ARGS)
JAX_REFERENCE = {'rms_tan_mean': 0.00394227722654562,
                 'rms_tan_p95': 0.004886656673638792,
                 'fn_final_mean': 0.0,
                 'iters': [[10, 3], [9, 3]],
                 'err_tan_last': [0.002417681792166011, 0.004907386226457842],
                 'q_last': [[0.000625340457070645,
                             -0.7589261357521909,
                             0.006628545180717035,
                             -2.2233147311330383,
                             -0.005022916361388782,
                             1.4384561125769015,
                             0.017220291600270013],
                            [0.008892350427914242,
                             -0.7643716454066003,
                             -0.012286041475933145,
                             -2.2301486067539757,
                             0.0007899654253491131,
                             1.4117709298776209,
                             0.0021741155310402963]],
                 'tau_cmd_last': [[-4.351131641089686,
                                   58.510734570156565,
                                   -0.814804708436157,
                                   -42.968580188022955,
                                   -0.9424702275353682,
                                   6.372419995409236,
                                   5.323543430583517],
                                  [-2.300330731510023,
                                   60.34386640124729,
                                   2.20632950428153,
                                   -39.34667274721903,
                                   -0.6240050080286241,
                                   7.117567528247172,
                                   5.578441037756447]]}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's model, and the port's model built from its arrays;
    skipped where JAX is not installed."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.core import make_panda_model as j_make_model
    from ffmpc_tpu_torch.core import panda_model_from_numpy
    mj = j_make_model("plant", jnp.float64)
    mt = panda_model_from_numpy({k: np.asarray(v) for k, v in mj._asdict().items()},
                                dtype=torch.float64, device="cpu")
    return SimpleNamespace(jax=jax, jnp=jnp, mj=mj, mt=mt)


def t_episode(model, **kw):
    return t_episode_fn(model, TWeights(dt_ocp=0.01, w_ee_pos=1.2e3), TSettings(max_iters=2),
                        TTraj(**TRAJ_KW), t_table(0.0, dtype=torch.float64, device="cpu"),
                        TEpisode(**EP_KW), np.asarray(KEYFRAMES["neutral"]),
                        dtype=torch.float64, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_runs(jx):
    """The JAX classical episode's init and one CHUNK-tick chunk compiled
    once at LLVM -O0 with the uncertainty protocol's gain a and bias b
    traced and every sigma 0 (at a = 1, b = 0 each of its operations is
    exact, so it is the clean episode), run on every case."""
    from ffmpc_tpu.ocp.weights import OCPWeights as JWeights
    from ffmpc_tpu.run.batch_runner import (DeviceUncertainty as JUnc,
                                            EpisodeConfig as JEpisode,
                                            make_episode_fn as j_episode_fn)
    from ffmpc_tpu.sim.device_plant import make_table_params as j_table
    from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings
    from ffmpc_tpu.tasks.trajectories import ApproachCircleTraj as JTraj
    jnp = jx.jnp

    def episode(**kw):
        return j_episode_fn(jx.mj, JWeights(dt_ocp=0.01, w_ee_pos=1.2e3),
                            JSettings(max_iters=2, use_box=True), JTraj(**TRAJ_KW),
                            j_table(0.0, dtype=jnp.float64), JEpisode(**EP_KW),
                            np.asarray(KEYFRAMES["neutral"]), dtype=jnp.float64, **kw)

    init = episode().init
    carry = init(jnp.asarray(KEYFRAMES["neutral"]))
    f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    chunk = jx.jax.jit(
        lambda c, t, a, b: episode(uncertainty=JUnc(a=a, b=b, seed=15)).chunk(c, t, CHUNK)
    ).lower(carry, f64(0.0), f64(1.0), f64(0.0)).compile(
        {"xla_backend_optimization_level": 0})

    def run(t0, n_chunks, a, b):
        c, parts = init(jnp.asarray(KEYFRAMES["neutral"])), []
        for i in range(n_chunks):
            c, tl = chunk(c, f64(t0 + i * CHUNK * 0.005), f64(a), f64(b))
            parts.append({k: np.asarray(v) for k, v in tl.items()})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    return {(case, unc): run(*CASES[case], *((1.0, 0.0) if unc == "clean" else GAIN_BIAS))
            for case in CASES for unc in ("clean", "gain_bias")}


def t_run(episode, t0, n_chunks):
    carry = episode.init(torch.as_tensor(np.asarray(KEYFRAMES["neutral"])[None]))
    parts = []
    for i in range(n_chunks):
        carry, tl = episode.chunk(carry, t0 + i * CHUNK * 0.005, CHUNK)
        parts.append({k: v[0].numpy() for k, v in tl.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def assert_close(got, want, rtol=RTOL, atol=ATOL, fields=FIELDS):
    np.testing.assert_array_equal(got["iters"], want["iters"])
    for name in fields:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        scale = float(np.abs(w).max())
        assert err <= atol + rtol * scale, f"{name}: err {err:.3e}, scale {scale:.3e}"


@pytest.mark.parametrize("unc", ["clean", "gain_bias"])
@pytest.mark.parametrize("case", list(CASES))
def test_classical_episode_equals_jax(jx, jax_runs, case, unc):
    """Ticks 0-2 from t = 0 ("start") and six ticks from t0 = 0.78 s over
    the knot switch ("switch"), clean and with the gain and bias on the
    command (the classical controller reads no torque estimate)."""
    kw = {} if unc == "clean" else dict(uncertainty=TUnc(*GAIN_BIAS, seed=15))
    got = t_run(t_episode(jx.mt, **kw), *CASES[case])
    want = jax_runs[(case, unc)]
    assert_close(got, want)
    np.testing.assert_allclose(got["t"], want["t"], rtol=0, atol=1e-15)
    assert got["tau_cmd"].shape == (CHUNK * CASES[case][1], 7)
    assert not got["fallback"].any()
    if case == "switch":
        ts = want["t"] - 0.005
        assert (ts < 0.8 - 1e-9).any() and (ts >= 0.8 - 1e-9).any()
    if unc == "gain_bias":
        clean = jax_runs[(case, "clean")]
        assert not np.allclose(got["q"], clean["q"], rtol=0, atol=1e-12)


def summarize(out, telem):
    """The figures compared: the ensemble's three quality figures and, per
    episode, every tick's iterations and the last tick's err_tan, q and
    tau_cmd."""
    return {"rms_tan_mean": float(out["rms_tan_mean"]),
            "rms_tan_p95": float(out["rms_tan_p95"]),
            "fn_final_mean": float(out["fn_final_mean"]),
            "iters": np.asarray(telem["iters"]).astype(int).tolist(),
            "err_tan_last": np.asarray(telem["err_tan"])[:, -1].tolist(),
            "q_last": np.asarray(telem["q"])[:, -1].tolist(),
            "tau_cmd_last": np.asarray(telem["tau_cmd"])[:, -1].tolist()}


def test_classical_ensemble_equals_jax_run_ensemble():
    got = summarize(*run_ensemble(**ENSEMBLE_ARGS, verbose=False, device="cpu"))
    want = JAX_REFERENCE
    assert got["iters"] == want["iters"]
    for key in ("rms_tan_mean", "rms_tan_p95", "fn_final_mean", "err_tan_last", "q_last",
                "tau_cmd_last"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= ENSEMBLE_RTOL * scale, f"{key}: err {err:.3e}, scale {scale:.3e}"
    assert np.isfinite(got["rms_tan_mean"]) and got["rms_tan_mean"] > 0.0


@pytest.mark.parametrize("knot_family,consts_family", [("classical", "augmented"),
                                                        ("augmented", "classical")])
def test_solve_refuses_another_familys_constants(knot_family, consts_family):
    """``fddp.solve`` given kernel constants packed for the other knot
    family raises on every device, before any kernel could read them; the
    episode packs each knot's own."""
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    W = flagship_weights()
    make = make_classical_knot if knot_family == "classical" else make_augmented_knot
    knot = make(model, W, surface=True)
    consts = pack_knot_consts(model, W, True, torch.float64, family=consts_family)
    assert consts.numel() == consts_len(consts_family) != consts_len(knot_family)
    N, nx = 2, knot.nx
    x0 = torch.zeros(1, nx, dtype=torch.float64)
    with pytest.raises(ValueError, match="consts"):
        t_solve(knot, None, None, x0, x0[:, None].repeat(1, N + 1, 1),
                torch.zeros(1, N, 7, dtype=torch.float64), TSettings(), consts=consts)


# ---------------------------------------------------------------------------
# the classical loop on the card (python -m pytest --noconftest -m cuda)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_classical_loop_kernels_match_plain_mode():
    """The classical flagship episode at float64, E=2, N=4, 3 iterations,
    4 ticks from t0 = 0.79 s (two ticks on each knot), on the kernels
    against plain mode: the same iterations and fallback ticks, every
    telemetry field within ``chip_smoke.CL_F64_RTOL`` or within
    ``CL_LOOP_TIE_FACTOR`` times plain mode's own parting under a
    rounding-level change of the initial states (the box QP's ties), each
    kernel launched every tick and none in plain mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the classical kernels have no CPU build")
    import chip_smoke as cs
    rec = cs.loop_kernel_vs_plain("classical", 4, 4, 0.79, "classical closed loop",
                                  tie_factor=cs.CL_LOOP_TIE_FACTOR)
    assert rec["ok"], rec


if __name__ == "__main__":
    import pprint
    import time
    import jax
    import jax.numpy as jnp
    from chip_smoke import classical_warm_starts
    from ffmpc_tpu.core import make_panda_model as j_make_model
    from ffmpc_tpu.ocp.weights import (flagship_trajectory as j_traj,
                                       flagship_weights as j_weights)
    from ffmpc_tpu.run.batch_runner import (EpisodeConfig as JEpisode,
                                            make_batched_solve_fn as j_make_solve)
    from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings
    from ffmpc_tpu_torch.core import gravity_torque
    from ffmpc_tpu_torch.ocp.weights import flagship_trajectory
    from ffmpc_tpu_torch.run.batch_runner import make_batched_solve_fn

    # the regularization retries: each problem's final xreg (a retry
    # multiplies it by 10) and iterations, float32, both packages, the same
    # inputs; beside, the port's plain float64 solve of those inputs (the
    # tie's yardstick: how far float32 parts from float64 within one package)
    B, N = 64, 36
    q0 = np.asarray(KEYFRAMES["neutral"])
    model = make_panda_model("plant", dtype=torch.float32, device="cpu")
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=torch.float32)).numpy()
    args = classical_warm_starts(B, q0, tau_g, np.random.default_rng(0))
    ep = TEpisode(controller="classical", horizon=N)
    plain = TSettings(max_iters=10, backward_mode="plain", rollout_mode="plain",
                      diff_mode="plain")

    def port_solve(dtype):
        return make_batched_solve_fn(
            make_panda_model("plant", dtype=dtype, device="cpu"), flagship_weights(), plain,
            flagship_trajectory(), ep, q0, surface=True, dtype=dtype, device="cpu")(*args)
    t0 = time.perf_counter()
    rt = port_solve(torch.float32)
    t_port = time.perf_counter() - t0
    rt64 = port_solve(torch.float64)
    t0 = time.perf_counter()
    j_args = [jnp.asarray(a) for a in args]
    rj = jax.jit(j_make_solve(
        j_make_model("plant", jnp.float32), j_weights(), JSettings(max_iters=10), j_traj(),
        JEpisode(controller="classical", horizon=N, deriv_mode="analytic"), q0,
        surface=True, dtype=jnp.float32, calc_mode="vector", solve_impl="vmap"))(*j_args)
    t_jax = time.perf_counter() - t0
    xreg = {"port": rt.xreg.double().numpy(), "jax": np.asarray(rj.xreg, np.float64),
            "port_float64": rt64.xreg.numpy()}
    iters = {"port": rt.iters.numpy(), "jax": np.asarray(rj.iters),
             "port_float64": rt64.iters.numpy()}
    decades = {k: np.round(np.log10(x)).astype(int) for k, x in xreg.items()}
    pairs = (("port", "jax"), ("port", "port_float64"), ("jax", "port_float64"))
    print("retries (B=64, N=36, float32 unless marked, contact knot, 10 iterations):")
    pprint.pprint({
        "same_iters_share": {f"{a}_vs_{b}": float((iters[a] == iters[b]).mean())
                             for a, b in pairs},
        "same_xreg_decade_share": {f"{a}_vs_{b}": float((decades[a] == decades[b]).mean())
                                   for a, b in pairs},
        "mean_iters": {k: float(v.mean()) for k, v in iters.items()},
        "mean_log10_xreg": {k: float(np.log10(x).mean()) for k, x in xreg.items()},
        "xreg_decades_from_1e-12": {k: np.bincount(d + 12).tolist()
                                    for k, d in decades.items()},
        "seconds": {"port_plain_float32": t_port, "jax_compile_and_run": t_jax}},
        width=100, sort_dicts=False)

    jax.config.update("jax_enable_x64", True)
    from ffmpc_tpu.run.ensemble import run_ensemble as j_run_ensemble
    pprint.pprint(summarize(*j_run_ensemble(**ENSEMBLE_ARGS, verbose=False)), width=100,
                  sort_dicts=False)
