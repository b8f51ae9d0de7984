"""PyTorch port of core/ == the JAX package, float64, on the CPU.

Inputs come from a numpy seed and go to both sides.  Tolerance for every
comparison here: rtol 1e-10 / atol 1e-12, scaled by the reference's largest
magnitude (the two sides run the same float64 arithmetic in a different
summation order: einsum vs matmul, 1/d*s vs s/d in the Cholesky), so only
reassociation noise separates them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ffmpc_tpu.core import panda as jpanda, dynamics as jdyn, kinematics as jkin
from ffmpc_tpu.core import smallchol as jchol, spatial as jsp
from ffmpc_tpu_torch.core import panda as tpanda, dynamics as tdyn, kinematics as tkin
from ffmpc_tpu_torch.core import smallchol as tchol, spatial as tsp

BATCH = (3, 2)
KP, KD = 145.0, 85.0


def T(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def close(got, want, rtol=1e-10, atol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale + rtol * scale)


def flat(a):
    a = np.asarray(a)
    return a.reshape((-1,) + a.shape[len(BATCH):])


@pytest.fixture(scope="module")
def models():
    mj = jpanda.make_panda_model("plant", jnp.float64)
    fields = {k: np.asarray(v) for k, v in mj._asdict().items()}
    mt = tpanda.panda_model_from_numpy(fields, dtype=torch.float64, device="cpu")
    return mj, mt


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return dict(q=rng.normal(size=BATCH + (7,)), v=rng.normal(size=BATCH + (7,)),
                a=rng.normal(size=BATCH + (7,)),
                tau=5.0 * rng.normal(size=BATCH + (7,)),
                z=0.3 + 0.1 * rng.normal(size=BATCH),
                p3=0.3 * rng.normal(size=BATCH + (3,)))


@pytest.mark.parametrize("variant", ["plant", "parity"])
def test_make_panda_model_equals_jax(variant):
    mj = jpanda.make_panda_model(variant, jnp.float64)
    mt = tpanda.make_panda_model(variant, dtype=torch.float64, device="cpu")
    assert mt._fields == mj._fields
    for name in mj._fields:
        # same constants through the same numpy arithmetic: bitwise equal
        assert np.array_equal(np.asarray(getattr(mj, name)),
                              getattr(mt, name).numpy()), name
    for name, val in jpanda.KEYFRAMES.items():
        assert np.array_equal(val, tpanda.KEYFRAMES[name])


def test_fk(models, data):
    mj, mt = models
    fj, ft = jkin.fk(mj, data["q"]), tkin.fk(mt, T(data["q"]))
    for name in fj._fields:
        close(getattr(ft, name), getattr(fj, name))


def test_ee_jacobian_and_velocity(models, data):
    mj, mt = models
    for gj, gt in zip(jkin.ee_jacobian(mj, data["q"]),
                      tkin.ee_jacobian(mt, T(data["q"]))):
        close(gt, gj)
    for gj, gt in zip(jkin.ee_velocity(mj, data["q"], data["v"]),
                      tkin.ee_velocity(mt, T(data["q"]), T(data["v"]))):
        close(gt, gj)


def test_rnea(models, data):
    mj, mt = models
    close(tdyn.rnea(mt, T(data["q"]), T(data["v"]), T(data["a"])),
          jdyn.rnea(mj, data["q"], data["v"], data["a"]))
    close(tdyn.bias_forces(mt, T(data["q"]), T(data["v"])),
          jdyn.bias_forces(mj, data["q"], data["v"]))


def test_gravity_torque(models, data):
    mj, mt = models
    close(tdyn.gravity_torque(mt, T(data["q"])), jdyn.gravity_torque(mj, data["q"]))


def test_mass_matrix(models, data):
    mj, mt = models
    Mj = jdyn.mass_matrix(mj, data["q"])
    close(tdyn.mass_matrix(mt, T(data["q"])), Mj)
    close(tdyn.mass_matrix_fk(mt, T(data["q"])), jdyn.mass_matrix_fk(mj, data["q"]))
    # the two formulations agree with each other inside the port as well
    close(tdyn.mass_matrix_fk(mt, T(data["q"])), Mj)


def test_fwd_dynamics_free(models, data):
    mj, mt = models
    close(tdyn.fwd_dynamics_free(mt, T(data["q"]), T(data["v"]), T(data["tau"])),
          jdyn.fwd_dynamics_free(mj, data["q"], data["v"], data["tau"]))


@pytest.mark.parametrize("nc1", [True, False], ids=["normal_1d", "point3d"])
def test_fwd_dynamics_contact(models, data, nc1):
    mj, mt = models
    ref = data["z"] if nc1 else data["p3"]
    oj = jdyn.fwd_dynamics_contact(mj, data["q"], data["v"], data["tau"],
                                   ref_pos=ref, nc1=nc1, baumgarte_kp=KP,
                                   baumgarte_kd=KD)
    ot = tdyn.fwd_dynamics_contact(mt, T(data["q"]), T(data["v"]), T(data["tau"]),
                                   ref_pos=T(ref), nc1=nc1, baumgarte_kp=KP,
                                   baumgarte_kd=KD)
    close(ot.acc, oj.acc)
    close(ot.force, oj.force)


def test_free_dynamics_derivs(models, data):
    mj, mt = models
    oj = jax.vmap(lambda q, v, tau: jdyn.free_dynamics_derivs(mj, q, v, tau))(
        flat(data["q"]), flat(data["v"]), flat(data["tau"]))
    ot = tdyn.free_dynamics_derivs(mt, T(data["q"]), T(data["v"]), T(data["tau"]))
    for name in ("acc", "da_dx", "da_du"):
        close(flat(getattr(ot, name).numpy()), getattr(oj, name))


@pytest.mark.parametrize("nc1", [True, False], ids=["normal_1d", "point3d"])
def test_contact_dynamics_derivs(models, data, nc1):
    mj, mt = models
    ref = data["z"] if nc1 else data["p3"]
    oj = jax.vmap(lambda q, v, tau, r: jdyn.contact_dynamics_derivs(
        mj, q, v, tau, ref_pos=r, nc1=nc1, baumgarte_kp=KP, baumgarte_kd=KD))(
        flat(data["q"]), flat(data["v"]), flat(data["tau"]), flat(ref))
    ot = tdyn.contact_dynamics_derivs(
        mt, T(data["q"]), T(data["v"]), T(data["tau"]), ref_pos=T(ref), nc1=nc1,
        baumgarte_kp=KP, baumgarte_kd=KD)
    for name in ("acc", "force", "da_dx", "df_dx", "da_du", "df_du"):
        close(flat(getattr(ot, name).numpy()), getattr(oj, name))


def test_contact_derivs_match_finite_difference(models, data):
    """The port's own implicit-function derivatives against a central
    difference of its own forward dynamics.  Tolerance 1e-6 relative to the
    Jacobian's scale: step 1e-6 on O(1e3) second derivatives."""
    _, mt = models
    q, v, tau, z = (T(data[k]) for k in ("q", "v", "tau", "z"))
    dd = tdyn.contact_dynamics_derivs(mt, q, v, tau, ref_pos=z,
                                      baumgarte_kp=KP, baumgarte_kd=KD)
    h = 1e-6

    def acc_of(x, u):
        return tdyn.fwd_dynamics_contact(mt, x[..., :7], x[..., 7:], u, ref_pos=z,
                                         baumgarte_kp=KP, baumgarte_kd=KD).acc
    x = torch.cat([q, v], dim=-1)
    cols = []
    for j in range(14):
        e = torch.zeros(14, dtype=torch.float64)
        e[j] = h
        cols.append((acc_of(x + e, tau) - acc_of(x - e, tau)) / (2 * h))
    fd = torch.stack(cols, dim=-1)
    scale = float(dd.da_dx.abs().max())
    assert float((fd - dd.da_dx).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("n", [1, 3, 7])
def test_chol_factor_and_solve(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=BATCH + (n, n))
    A = A @ np.swapaxes(A, -1, -2) + n * np.eye(n)
    b1 = rng.normal(size=BATCH + (n,))
    b2 = rng.normal(size=BATCH + (n, 4))
    Lj = jchol.chol_factor(jnp.asarray(A))
    Lt = tchol.chol_factor(T(A))
    close(Lt, Lj)
    close(tchol.chol_solve(Lt, T(b1)), jchol.chol_solve(Lj, jnp.asarray(b1)))
    close(tchol.chol_solve(Lt, T(b2)), jchol.chol_solve(Lj, jnp.asarray(b2)))
    close(tchol.spd_solve(T(A), T(b1)), jchol.spd_solve(jnp.asarray(A), jnp.asarray(b1)))
    close(Lt @ Lt.transpose(-1, -2), A)


def test_chol_indefinite_gives_nan_not_error():
    """The solver's regularization retry keys on non-finite output."""
    A = np.diag([1.0, -2.0, 3.0])
    Lt = tchol.chol_factor(T(A))
    Lj = jchol.chol_factor(jnp.asarray(A))
    assert not bool(torch.isfinite(Lt).all())
    assert not bool(jnp.isfinite(Lj).all())
    x = tchol.spd_solve(T(A), T(np.ones(3)))
    assert not bool(torch.isfinite(x).all())


def test_log3_and_rotation_helpers():
    rng = np.random.default_rng(3)
    w = rng.normal(size=BATCH + (3,))
    w[0, 0] = 1e-7 * w[0, 0]          # inside the Taylor branch
    w[0, 1] = 0.0                     # exactly the identity
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    K = np.asarray(jsp.hat(jnp.asarray(w)))
    with np.errstate(invalid="ignore", divide="ignore"):
        a = np.where(th > 1e-12, np.sin(th) / th, 1.0)[..., None]
        b = np.where(th > 1e-12, (1 - np.cos(th)) / th ** 2, 0.5)[..., None]
    R = np.eye(3) + a * K + b * (K @ K)
    close(tsp.hat(T(w)), K)
    close(tsp.log3(T(R)), jsp.log3(jnp.asarray(R)))
    close(tsp.rot_z(T(w[..., 0])), jsp.rot_z(jnp.asarray(w[..., 0])))
    qj = jsp.rot_to_quat_wxyz(jnp.asarray(R))
    close(tsp.rot_to_quat_wxyz(T(R)), qj)
    close(tsp.quat_wxyz_to_rot(T(np.asarray(qj))), jsp.quat_wxyz_to_rot(qj))
