"""The device plant: ``ffmpc_tpu_torch.sim.device_plant`` (CPU) == the JAX
package's ``ffmpc_tpu/sim/device_plant.py``.

- ``plant_step`` at float64 against JAX's, every state and observation field
  to 1e-12 (absolute, against max(|field|, 1): the same arithmetic in another
  framework, five 1 kHz substeps): free motion, a pressed contact with
  fn > 0, the 2 mm margin zone, a 10 degree tilted table, and a batch of 3.
- ``make_table_params`` equal to JAX's.
- The framework-free replay fixture ``tests/fixtures/host_ff_flat_replay.npz``
  (a recorded host MuJoCo force-feedback episode) replayed at float64 and
  float32, held to the bounds of ``tests/test_device_plant_fidelity.py``:
  ee within 1 mm and q within 0.01 rad at 1 s, mean contact-phase |dfn|
  < 2 N, whole-episode ee < 5 mm.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ffmpc_tpu.core import make_panda_model as j_make_model, KEYFRAMES, fk as j_fk
from ffmpc_tpu.core import gravity_torque as j_gravity, ee_jacobian as j_jacobian
from ffmpc_tpu.sim import device_plant as jdp
from ffmpc_tpu_torch.core import panda_model_from_numpy, make_panda_model
from ffmpc_tpu_torch.core.panda import TOOL_SPHERE_RADIUS
from ffmpc_tpu_torch.sim import device_plant as tdp

FIXTURE = Path(__file__).parent / "fixtures" / "host_ff_flat_replay.npz"
TOL = 1e-12


@pytest.fixture(scope="module")
def models():
    mj = j_make_model("plant", jnp.float64)
    mt = panda_model_from_numpy({k: np.asarray(v) for k, v in mj._asdict().items()},
                                dtype=torch.float64, device="cpu")
    return mj, mt


def table_body_for_gap(mj, q, gap, tilt_deg):
    """The table body position that puts the tool sphere's surface ``gap``
    metres from the (tilted) plane at configuration q (negative: pressed)."""
    a = np.deg2rad(tilt_deg)
    R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                  [-np.sin(a), 0.0, np.cos(a)]])
    n = R @ np.array([0.0, 0.0, 1.0])
    ee = np.asarray(j_fk(mj, jnp.asarray(q)).ee_p)
    point = ee - n * (TOOL_SPHERE_RADIUS + gap)
    return tuple(point - R @ np.array([0.0, 0.0, 0.02]))


def step_inputs(mj, q, seed):
    """A state near rest at q and a command of gravity torque plus a 25 N
    push down along the tool (through J^T) with a little noise."""
    rng = np.random.default_rng(seed)
    q = np.asarray(q, np.float64)
    v = 0.05 * rng.normal(size=q.shape)
    tmf, tmaf = rng.normal(size=q.shape), rng.normal(size=q.shape)
    Jp = np.asarray(j_jacobian(mj, jnp.asarray(q))[0])
    tau = (np.asarray(j_gravity(mj, jnp.asarray(q)))
           + np.einsum("...ij,i->...j", Jp, np.array([0.0, 0.0, -25.0]))
           + 0.3 * rng.normal(size=q.shape))
    return v, tmf, tmaf, tau


@pytest.fixture(scope="module")
def j_step(models):
    """JAX's plant_step, jitted once per input shape (the table is an
    argument, so the cases share a compile)."""
    mj = models[0]
    return jax.jit(lambda s, u, tbl: jdp.plant_step(mj, tbl, s, u, timestep=0.001,
                                                     n_substeps=5))


CASES = {
    "free": dict(gap=0.05, tilt=0.0),
    "pressed": dict(gap=-5e-4, tilt=0.0),
    "margin_zone": dict(gap=1.0e-3, tilt=0.0),
    "tilted_10": dict(gap=-5e-4, tilt=10.0),
}


def run_both(models, j_step, q, gap, tilt, seed):
    mj, mt = models
    q_ref = np.asarray(q).reshape(-1, 7)[0]
    body = table_body_for_gap(mj, q_ref, gap, tilt)
    v, tmf, tmaf, tau = step_inputs(mj, q, seed)
    tj = jdp.make_table_params(tilt, dtype=jnp.float64, table_body_pos=body)
    tt = tdp.make_table_params(tilt, dtype=torch.float64, device="cpu", table_body_pos=body)
    sj = jdp.PlantState(*(jnp.asarray(a) for a in (q, v, tmf, tmaf)))
    st = tdp.PlantState(*(torch.as_tensor(np.asarray(a, np.float64)) for a in (q, v, tmf, tmaf)))
    out_j = j_step(sj, jnp.asarray(tau), tj)
    out_t = tdp.plant_step(mt, tt, st, torch.as_tensor(tau), timestep=0.001, n_substeps=5)
    return out_j, out_t


def assert_step_equal(out_j, out_t):
    (sj, oj), (st, ot) = out_j, out_t
    for name, a, b in list(zip(sj._fields, sj, st)) + list(zip(oj._fields, oj, ot)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        if a.dtype == bool:
            assert np.array_equal(a, b), name
            continue
        scale = max(float(np.abs(a).max()), 1.0)
        assert float(np.abs(a - b).max()) <= TOL * scale, (name, float(np.abs(a - b).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_plant_step_equals_jax(models, j_step, case):
    q = np.asarray(KEYFRAMES["neutral"])
    out_j, out_t = run_both(models, j_step, q, seed=1, **CASES[case])
    assert_step_equal(out_j, out_t)
    fn, active = float(out_j[1].f_contact_normal), bool(out_j[1].contact)
    if case == "free":
        assert fn == 0.0 and not active
    else:
        assert fn > 0.0 and active, (case, fn)


def test_plant_step_batch_of_three_equals_jax(models, j_step):
    """Three plants at once, each at its own configuration (the table placed
    for a press at the first)."""
    q0 = np.asarray(KEYFRAMES["neutral"])
    q = q0[None] + 0.02 * np.random.default_rng(3).normal(size=(3, 7))
    out_j, out_t = run_both(models, j_step, q, gap=-5e-4, tilt=0.0, seed=2)
    assert_step_equal(out_j, out_t)
    assert out_t[1].f_contact_normal.shape == (3,)


@pytest.mark.parametrize("tilt", [0.0, 10.0])
def test_table_params_equal_jax(tilt):
    tj = jdp.make_table_params(tilt, dtype=jnp.float64)
    tt = tdp.make_table_params(tilt, dtype=torch.float64, device="cpu")
    assert tt._fields == tj._fields
    for name, a, b in zip(tj._fields, tj, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert float(tt.diag_approx) == 0.1235373 and float(tt.margin) == 2.0e-3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_replay_fixture_meets_fidelity_bounds(dtype):
    rec = {k: np.asarray(v) for k, v in np.load(FIXTURE).items()}
    model = make_panda_model("plant", dtype=dtype, device="cpu")
    table = tdp.make_table_params(0.0, dtype=dtype, device="cpu")
    state = tdp.init_plant_state(np.asarray(KEYFRAMES["neutral"]), dtype=dtype, device="cpu")
    taus = torch.as_tensor(rec["tau"], dtype=dtype)
    qs, ees, fns = [], [], []
    for tau in taus:
        state, obs = tdp.plant_step(model, table, state, tau, timestep=0.001, n_substeps=5)
        qs.append(obs.q)
        ees.append(obs.ee_pos)
        fns.append(obs.f_contact_normal)
    qs, ees, fns = (torch.stack(a).double().numpy() for a in (qs, ees, fns))
    dee = np.linalg.norm(ees - rec["ee"], axis=1)
    dq = np.abs(qs - rec["q"]).max(axis=1)
    i1 = min(int(1.0 / 0.005), len(dee) - 1)
    assert dee[i1] < 1.0e-3, dee[i1]
    assert dq[i1] < 0.01, dq[i1]
    dfn = np.abs(fns - rec["fn"])[rec["t"] >= 0.9]
    assert dfn.mean() < 2.0, dfn.mean()
    assert dee.max() < 5.0e-3, dee.max()
