"""The closed loop: the port's on-device episode
(``ffmpc_tpu_torch.run.batch_runner.make_episode_fn``, CPU, float64, the
three modes "kernel", so the plain versions on these CPU tensors) == the JAX
package's ``make_episode_fn``, and the port's ensemble == its own episode.

Setup of ``tests/test_batch_runner.py``: ``OCPWeights(dt_ocp=0.01,
w_ee_pos=1.2e3)``, ``max_iters=2``, horizon 4, force feedback, from the
neutral pose.  Compared over ticks 0-2 from t = 0 and over six ticks from
t0 = 0.78 s, where the trajectory's surface flag switches at 0.80 s, so
both knot families run.  Each tick's solve is held to the whole-solve
tolerance of ``tests/test_torch_solve.py`` (rtol 1e-6 / atol 1e-7 against
the field's largest magnitude: the box QP's argmin ties), here on the
closed-loop telemetry q, tau_cmd, cost and fn_meas; iterations must be
equal.  One JAX compile of a three-tick chunk, with the uncertainty gain and
bias traced, serves every JAX comparison here; the torque scale's, which
needs another program, is in ``tests/test_torch_episode_scale.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ffmpc_tpu.core import make_panda_model as j_make_model, KEYFRAMES
from ffmpc_tpu.ocp.weights import OCPWeights as JWeights
from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings
from ffmpc_tpu.sim.device_plant import make_table_params as j_table
from ffmpc_tpu.tasks.trajectories import ApproachCircleTraj as JTraj
from ffmpc_tpu.run.batch_runner import (make_episode_fn as j_episode_fn,
                                        EpisodeConfig as JEpisode,
                                        DeviceUncertainty as JUnc)
from ffmpc_tpu_torch.core import panda_model_from_numpy
from ffmpc_tpu_torch.ocp.weights import OCPWeights as TWeights
from ffmpc_tpu_torch.solver.fddp import FDDPSettings as TSettings
from ffmpc_tpu_torch.sim.device_plant import make_table_params as t_table
from ffmpc_tpu_torch.tasks.trajectories import ApproachCircleTraj as TTraj
from ffmpc_tpu_torch.run.batch_runner import (make_episode_fn as t_episode_fn,
                                              EpisodeConfig as TEpisode,
                                              DeviceUncertainty as TUnc)
from ffmpc_tpu_torch.run.ensemble import run_ensemble

CHUNK = 3
FIELDS = ("q", "tau_cmd", "cost", "fn_meas")
RTOL, ATOL = 1e-6, 1e-7
Z_C = 0.342
TRAJ_KW = dict(center=(-0.5, 0.0, Z_C), radius=0.10, omega=1.5, z_contact=Z_C,
               t_approach=0.55, z_pre=Z_C + 0.05, t_pre=0.25,
               ee_start=(-0.3, 0.0, 0.633), t_stabilize=0.2)
EP_KW = dict(controller="force_feedback", horizon=4, n_ticks=CHUNK, ff_alpha_ctrl=0.45)


@pytest.fixture(scope="module")
def setup():
    mj = j_make_model("plant", jnp.float64)
    mt = panda_model_from_numpy({k: np.asarray(v) for k, v in mj._asdict().items()},
                                dtype=torch.float64, device="cpu")
    return dict(mj=mj, mt=mt, q0=np.asarray(KEYFRAMES["neutral"]))


def j_compile(fn, *args):
    """Compile ``fn`` for ``args`` with LLVM at -O0: the episode's XLA:CPU
    trace and compile are the cost of this file (-O0 shortens the compile
    by about a third), and its run is instant."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})


def j_episode(setup, **kw):
    return j_episode_fn(setup["mj"], JWeights(dt_ocp=0.01, w_ee_pos=1.2e3),
                        JSettings(max_iters=2, use_box=True), JTraj(**TRAJ_KW),
                        j_table(0.0, dtype=jnp.float64), JEpisode(**EP_KW), setup["q0"],
                        dtype=jnp.float64, **kw)


def j_chunk_fn(setup, make_kw, params):
    """The JAX episode's init and one compiled CHUNK-tick chunk whose
    episode is built from traced ``params`` (``make_kw(*params)`` gives the
    keyword arguments of ``make_episode_fn``), so one compile serves every
    value of them."""
    init = j_episode(setup).init
    carry = init(jnp.asarray(setup["q0"]))

    def chunk(c, t, *p):
        return j_episode(setup, **make_kw(*p)).chunk(c, t, CHUNK)

    comp = j_compile(chunk, carry, jnp.asarray(0.0, jnp.float64),
                     *(jnp.asarray(p, jnp.float64) for p in params))
    return init, lambda c, t, *p: comp(c, t, *(jnp.asarray(x, jnp.float64) for x in p))


def t_episode(setup, **kw):
    return t_episode_fn(setup["mt"], TWeights(dt_ocp=0.01, w_ee_pos=1.2e3),
                        TSettings(max_iters=2), TTraj(**TRAJ_KW),
                        t_table(0.0, dtype=torch.float64, device="cpu"), TEpisode(**EP_KW),
                        setup["q0"], dtype=torch.float64, device="cpu", **kw)


def j_run(init, chunk, q0, t0, n_chunks, *params):
    carry = init(jnp.asarray(q0))
    parts = []
    for c in range(n_chunks):
        carry, tl = chunk(carry, jnp.asarray(t0 + c * CHUNK * 0.005, jnp.float64), *params)
        parts.append({k: np.asarray(v) for k, v in tl.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def t_run(episode, q0, t0, n_chunks):
    carry = episode.init(torch.as_tensor(q0[None]))
    parts = []
    for c in range(n_chunks):
        carry, tl = episode.chunk(carry, t0 + c * CHUNK * 0.005, CHUNK)
        parts.append({k: v[0].numpy() for k, v in tl.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def assert_close(got, want, fields=FIELDS):
    np.testing.assert_array_equal(got["iters"], want["iters"])
    for name in fields:
        g, w = got[name], want[name]
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        scale = float(np.abs(w).max())
        assert err <= ATOL + RTOL * scale, f"{name}: err {err:.3e}, scale {scale:.3e}"


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX episodes with the uncertainty protocol's gain a and bias b traced
    and every sigma at 0: at a = 1, b = 0 each of its operations is exact
    (1 * x + 0 + 0 * n == x), so it is the clean episode; at a = 1.03,
    b = 0.05 the gain / bias case."""
    init, chunk = j_chunk_fn(setup, lambda a, b: dict(uncertainty=JUnc(a=a, b=b, seed=15)),
                             (1.0, 0.0))
    q0 = setup["q0"]
    return {"start": j_run(init, chunk, q0, 0.0, 1, 1.0, 0.0),
            "switch": j_run(init, chunk, q0, 0.78, 2, 1.0, 0.0),
            "gain_bias": j_run(init, chunk, q0, 0.0, 1, 1.03, 0.05)}


@pytest.mark.parametrize("case,t0,n_chunks", [("start", 0.0, 1), ("switch", 0.78, 2)])
def test_episode_equals_jax(setup, jax_runs, case, t0, n_chunks):
    want = jax_runs[case]
    got = t_run(t_episode(setup), setup["q0"], t0, n_chunks)
    assert_close(got, want)
    np.testing.assert_allclose(got["t"], want["t"], rtol=0, atol=1e-15)
    assert not got["fallback"].any()
    if case == "switch":
        # both knot families ran: the free knot before t = 0.80 s, the
        # contact knot from there on
        ts = want["t"] - 0.005
        assert (ts < 0.8 - 1e-9).any() and (ts >= 0.8 - 1e-9).any()


def test_whole_episode_equals_chunks(setup, jax_runs):
    """``episode(q0s)`` from t = 0 equals its first chunk."""
    ep = t_episode(setup)
    whole = ep(torch.as_tensor(setup["q0"][None]))
    assert all(v.shape[:2] == (1, CHUNK) for v in whole.values())
    assert_close({k: v[0].numpy() for k, v in whole.items()}, jax_runs["start"])


def test_uncertainty_gain_bias_with_zero_sigmas_equals_jax(setup, jax_runs):
    """Gain and bias on the command and the torque estimate, every sigma at
    0 (the noise streams differ by design): the same closed loop as JAX's."""
    got = t_run(t_episode(setup, uncertainty=TUnc(a=1.03, b=0.05, seed=15)),
                setup["q0"], 0.0, 1)
    assert_close(got, jax_runs["gain_bias"])
    assert not np.allclose(got["q"], jax_runs["start"]["q"], rtol=0, atol=1e-12)


def test_noise_is_reproducible_and_chunked_equals_single(setup):
    unc = TUnc(a=1.03, b=0.05, sigma_q=5e-4, sigma_dq=2e-3, sigma_tau=5e-2, seed=15)
    q0s = torch.as_tensor(np.stack([setup["q0"], setup["q0"] + 0.01]))
    ep = t_episode(setup, uncertainty=unc)
    carry = ep.init(q0s)
    carry, a = ep.chunk(carry, 0.0, 2)
    _, b = ep.chunk(carry, 0.010, 2)
    _, whole = ep.chunk(ep.init(q0s), 0.0, 4)
    _, again = ep.chunk(ep.init(q0s), 0.0, 4)
    clean = t_episode(setup).chunk(ep.init(q0s), 0.0, 4)[1]
    for k in ("q", "tau_cmd", "err_3d", "fn_meas", "cost"):
        torch.testing.assert_close(torch.cat([a[k], b[k]], dim=1), whole[k], rtol=0, atol=1e-12)
        assert torch.equal(whole[k], again[k]), k
    assert not torch.allclose(whole["q"], clean["q"], rtol=0, atol=1e-9)


def test_classical_controller_raises(setup):
    """Both controllers run in the closed loop (the classical one:
    ``tests/test_torch_classical_loop.py``); a controller that is neither
    raises, naming the two."""
    with pytest.raises(ValueError, match="classical.*force_feedback"):
        t_episode_fn(setup["mt"], TWeights(), TSettings(), TTraj(**TRAJ_KW),
                     t_table(0.0, dtype=torch.float64, device="cpu"),
                     TEpisode(controller="impedance", horizon=4), setup["q0"],
                     dtype=torch.float64, device="cpu")


def test_ensemble_equals_its_episode():
    """``run_ensemble`` at batch 2, 3 ticks, horizon 4 (flagship weights
    and trajectory, the ensemble's q0 draw) == the port's own episode on the
    same perturbed states."""
    from ffmpc_tpu_torch.core import make_panda_model
    from ffmpc_tpu_torch.ocp.weights import (flagship_weights, flagship_trajectory,
                                             flagship_ff_alpha, FLAGSHIP_DT_MPC)
    out, telem = run_ensemble(batch=2, ticks=3, horizon=4, max_iters=2,
                              dtype_name="float64", verbose=False, device="cpu")
    assert telem["err_tan"].shape == (2, 3)
    for key in ("rms_tan_mean", "rms_tan_p95", "fn_final_mean", "solves_per_s",
                "episodes_per_s", "wall_s"):
        assert np.isfinite(out[key]), key
    q0 = np.asarray(KEYFRAMES["neutral"])
    q0s = q0[None] + 0.01 * np.random.default_rng(0).normal(size=(2, 7))
    W = flagship_weights()
    ep = t_episode_fn(make_panda_model("plant", dtype=torch.float64, device="cpu"), W,
                      TSettings(max_iters=2), flagship_trajectory(),
                      t_table(0.0, dtype=torch.float64, device="cpu"),
                      TEpisode(horizon=4, n_ticks=3,
                               ff_alpha_ctrl=flagship_ff_alpha(FLAGSHIP_DT_MPC)),
                      q0, dtype=torch.float64, device="cpu")
    want = ep(torch.as_tensor(q0s))
    for k, v in want.items():
        np.testing.assert_array_equal(telem[k], v.numpy(), err_msg=k)
    err = want["err_tan"].numpy()
    assert out["rms_tan_mean"] == float(np.sqrt((err ** 2).mean()))
