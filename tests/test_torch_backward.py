"""BoxFDDP backward sweep of the PyTorch port (the module that holds the CUDA
kernel) == the JAX package's fused Pallas kernel (interpret mode on the CPU)
and its sequential reference.

On the CPU ``backward_box`` runs its plain version,
``backward_box_reference``; the CUDA kernel itself runs only on a card (the
``cuda``-marked test, skipped here).

Tolerance: rtol 5e-9 / atol 5e-10 at float64, the bar of the JAX package's
own kernel-vs-sequential test: the implementations reassociate the same sums.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ffmpc_tpu.solver.backward_pallas import make_backward_box, _backward_seq
from ffmpc_tpu_torch.solver.backward_cuda import (backward_box,
                                                  backward_box_reference)
from ffmpc_tpu_torch.solver import boxqp as tboxqp
from ffmpc_tpu.solver import boxqp as jboxqp

NX, NU, N, B = 21, 7, 4, 3
NAMES = ("K", "kff", "qu2", "dg", "dq", "bad", "w_all")


def _rand_problem(rng, tight_bounds=False, n=N):
    """Seeded well-conditioned problem, numpy float64 (same recipe as the JAX
    package's backward-kernel test)."""
    def r(*s):
        return rng.normal(size=s)

    Fx = np.eye(NX)[None] + 0.1 * r(n, NX, NX)
    Fu = 0.2 * r(n, NX, NU)
    Lx = r(n, NX)
    Lu = r(n, NU)
    A = 0.3 * r(n, NX, NX)
    Lxx = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(NX)[None]
    Lxu = 0.1 * r(n, NX, NU)
    Bm = 0.3 * r(n, NU, NU)
    Luu = Bm @ np.swapaxes(Bm, -1, -2) + 0.8 * np.eye(NU)[None]
    fs = 0.3 * r(n + 1, NX)
    LxT = r(NX)
    At = 0.3 * r(NX, NX)
    LxxT = At @ At.T + 0.5 * np.eye(NX)
    width = 0.05 if tight_bounds else 50.0
    lb = -width * np.abs(r(n, NU)) - 1e-3
    ub = width * np.abs(r(n, NU)) + 1e-3
    xreg = np.asarray(10.0 ** rng.uniform(-6, -2))
    return (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, lb, ub, xreg, xreg)


def _batch(probs):
    return [np.stack([p[i] for p in probs]) for i in range(len(probs[0]))]


def _check(got, want, b, rtol=5e-9, atol=5e-10):
    for i, name in enumerate(NAMES):
        g = np.asarray(got[i][b])
        w = np.asarray(want[i])
        if name == "bad":
            assert bool(g) == bool(w), name
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"problem {b} field {name}")


@pytest.mark.parametrize("tight", [False, True],
                         ids=["bounds_inactive", "bounds_active"])
def test_reference_matches_jax_sequential(tight):
    rng = np.random.default_rng(0 if tight else 1)
    probs = [_rand_problem(rng, tight) for _ in range(B)]
    out = backward_box_reference(*[torch.as_tensor(a) for a in _batch(probs)])
    for b in range(B):
        ref = _backward_seq(*[jnp.asarray(a) for a in probs[b]],
                            boxqp_iters=8, kgain_reg=1e-12)
        _check([o.numpy() for o in out], ref, b)


@pytest.mark.parametrize("tight", [False, True],
                         ids=["bounds_inactive", "bounds_active"])
def test_reference_matches_jax_pallas_interpret(tight):
    rng = np.random.default_rng(0 if tight else 1)
    probs = [_rand_problem(rng, tight) for _ in range(B)]
    batched = _batch(probs)
    out_j = jax.vmap(make_backward_box(NX, NU, boxqp_iters=8))(
        *[jnp.asarray(a) for a in batched])
    out_t = backward_box_reference(*[torch.as_tensor(a) for a in batched])
    if tight:
        # some bound must really be active for this case to mean anything
        assert bool((out_t[0].abs().sum(-1) == 0).any())
    for b in range(B):
        _check([o.numpy() for o in out_t], [o[b] for o in out_j], b)


def test_indefinite_luu_flags_bad_on_both_sides():
    rng = np.random.default_rng(7)
    probs = [_rand_problem(rng) for _ in range(B)]
    bad_prob = list(probs[1])
    Luu = bad_prob[6].copy()
    Luu[2] = -5.0 * np.eye(NU)                # indefinite Quu at knot 2
    bad_prob[6] = Luu
    probs[1] = tuple(bad_prob)
    out_t = backward_box_reference(*[torch.as_tensor(a) for a in _batch(probs)])
    want = [bool(_backward_seq(*[jnp.asarray(a) for a in p], boxqp_iters=8,
                               kgain_reg=1e-12)[5]) for p in probs]
    assert want == [False, True, False]
    assert out_t[5].tolist() == want
    # the healthy problems are untouched by their neighbour's NaNs
    for b in (0, 2):
        ref = _backward_seq(*[jnp.asarray(a) for a in probs[b]],
                            boxqp_iters=8, kgain_reg=1e-12)
        _check([o.numpy() for o in out_t], ref, b)


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(3)
    args = [torch.as_tensor(a) for a in _batch([_rand_problem(rng) for _ in range(2)])]
    before = backward_box.launches
    out_w = backward_box(*args)
    out_r = backward_box_reference(*args)
    assert backward_box.launches == before
    for a, b in zip(out_w, out_r):
        assert torch.equal(a, b)


def test_wrapper_rejects_wrong_shapes_and_types():
    rng = np.random.default_rng(4)
    args = [torch.as_tensor(a) for a in _batch([_rand_problem(rng) for _ in range(2)])]
    bad = list(args)
    bad[2] = bad[2][:, :-1]                    # Lx with a knot missing
    with pytest.raises(ValueError, match="Lx"):
        backward_box(*bad)
    bad = list(args)
    bad[10] = bad[10].to(torch.float32)        # lb in another dtype
    with pytest.raises(ValueError, match="lb"):
        backward_box(*bad)


@pytest.mark.parametrize("tight", [False, True], ids=["interior", "clamped"])
def test_boxqp_and_masked_solve_equal_jax(tight):
    rng = np.random.default_rng(11)
    n, nb = 7, 5
    A = rng.normal(size=(nb, n, n))
    Q = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(n)
    q = 3.0 * rng.normal(size=(nb, n))
    w = 0.1 if tight else 100.0
    lb = -w * np.abs(rng.normal(size=(nb, n)))
    ub = w * np.abs(rng.normal(size=(nb, n)))
    sol_t = tboxqp.boxqp(*[torch.as_tensor(a) for a in (Q, q, lb, ub)],
                         torch.zeros(nb, n, dtype=torch.float64))
    sol_j = jax.vmap(lambda Q, q, lb, ub: jboxqp.boxqp(Q, q, lb, ub, jnp.zeros(n)))(
        Q, q, lb, ub)
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=5e-9, atol=5e-10)
    assert np.array_equal(sol_t.free.numpy(), np.asarray(sol_j.free))
    if tight:
        assert not bool(sol_t.free.all())
    rhs = rng.normal(size=(nb, n, 3))
    ms_t = tboxqp._masked_solve(torch.as_tensor(Q), torch.as_tensor(rhs), sol_t.free, 1e-12)
    ms_j = jax.vmap(lambda Q, r, f: jboxqp._masked_solve(Q, r, f, 1e-12))(
        Q, rhs, np.asarray(sol_j.free))
    np.testing.assert_allclose(ms_t.numpy(), np.asarray(ms_j), rtol=5e-9, atol=5e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("tight", [False, True],
                         ids=["bounds_inactive", "bounds_active"])
def test_cuda_kernel_matches_plain_version(tight):
    """The hand-written kernel against its plain version on the card,
    float64, same tolerance as above.  `python3 chip_smoke.py` runs the same
    comparison at the flagship shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward-sweep kernel has no CPU build")
    rng = np.random.default_rng(0 if tight else 1)
    args = [torch.as_tensor(a, device="cuda").contiguous()
            for a in _batch([_rand_problem(rng, tight) for _ in range(B)])]
    before = backward_box.launches
    out_k = backward_box(*args)
    torch.cuda.synchronize()
    assert backward_box.launches == before + 1
    out_r = backward_box_reference(*args)
    for b in range(B):
        _check([o.cpu().numpy() for o in out_k], [o[b].cpu().numpy() for o in out_r], b)
