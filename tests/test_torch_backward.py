"""BoxFDDP backward sweep of the PyTorch port (the module that holds the CUDA
kernel) == the JAX package's fused Pallas kernel (interpret mode on the CPU)
and its sequential reference.

On the CPU ``backward_box`` runs its plain version,
``backward_box_reference``; the CUDA kernel itself runs only on a card (the
``cuda``-marked tests, skipped here).  Without a card the wrapper's kernel
path is still reached with tensors on the ``meta`` device: its checks must
raise before any launch.

Tolerance: rtol 5e-9 / atol 5e-10 at float64, the bar of the JAX package's
own kernel-vs-sequential test: the implementations reassociate the same sums.
The kernel against its plain version on the card: the tolerances of
``chip_smoke.py`` (below).

The JAX package is imported where it is installed; a card's machine may lack
it, and there only the ``cuda``-marked tests, which need no JAX, run
(``python -m pytest --noconftest tests/test_torch_backward.py -m cuda``).
"""

import ctypes

import numpy as np
import pytest
import torch

from ffmpc_tpu_torch.solver import _cuda_build
from ffmpc_tpu_torch.solver.backward_cuda import (backward_box,
                                                  backward_box_reference)
from ffmpc_tpu_torch.solver import boxqp as tboxqp

try:
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.solver import boxqp as jboxqp
    from ffmpc_tpu.solver.backward_pallas import make_backward_box, _backward_seq
except ImportError:
    jax = None

NX, NU, N, B = 21, 7, 4, 3
NAMES = ("K", "kff", "qu2", "dg", "dq", "bad", "w_all")

# The kernel against its plain version on the card: chip_smoke.py's bars
# (see the reasons there).  float64: K and w_all at TOL_F64, the fields that
# follow the box QP's minimizer at TOL_F64_QP, against each field's largest
# magnitude.  float32: per problem and field, the kernel's distance from the
# plain float32 version against the plain float32 version's own distance
# from float64 on the same inputs.
TOL_F64 = dict(rtol=5e-9, atol=5e-10)
TOL_F64_QP = dict(rtol=1e-4, atol=1e-9)
QP_FIELDS = ("kff", "qu2", "dg", "dq")
F32_FACTOR, F32_MEDIAN_FLOOR, F32_FLOOR = 4.0, 1e-6, 1e-5
MIN_AGREE_F32 = 0.85
F32_SAME_FREE_RTOL = 1e-3
POOL = 96   # problems run as launches of B=1 and B=3 (a share needs many)


def _needs_jax():
    if jax is None:
        pytest.skip("needs the JAX package, the reference of this comparison")


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
    _needs_jax()
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
    _needs_jax()
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
    _needs_jax()
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
    _needs_jax()
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


def test_bind_resolves_and_types_a_symbol_once():
    """The launch path's binding: a C function is looked up, and its
    argtypes / restype set, at its first use only; later calls get the same
    object from the cache.  A stub stands in for the library."""
    class Fn:
        def __init__(self):
            self.typed = 0

        def __setattr__(self, key, value):
            if key == "argtypes":
                object.__setattr__(self, "typed", self.typed + 1)
            object.__setattr__(self, key, value)

    class Lib:
        def __init__(self):
            self.lookups = []
            self.fns = {"ffmpc_a": Fn(), "ffmpc_b": Fn()}

        def __getattr__(self, name):
            self.lookups.append(name)
            return self.fns[name]

    lib = Lib()
    args = [ctypes.c_void_p, ctypes.c_int]
    first = _cuda_build.bind(lib, "ffmpc_a", args)
    for _ in range(3):
        assert _cuda_build.bind(lib, "ffmpc_a", args) is first
    other = _cuda_build.bind(lib, "ffmpc_b", [ctypes.c_double])
    assert lib.lookups == ["ffmpc_a", "ffmpc_b"]
    assert first.typed == 1 and other.typed == 1
    assert first.argtypes == args and first.restype is ctypes.c_int
    assert other.argtypes == [ctypes.c_double]
    # another library with the same symbol is bound on its own
    lib2 = Lib()
    assert _cuda_build.bind(lib2, "ffmpc_a", args) is not first
    assert lib2.lookups == ["ffmpc_a"]


@pytest.mark.cuda
def test_cuda_launch_passes_the_current_streams_handle():
    """``launch`` takes the stream from ``current_stream_handle`` (the raw
    lookup where PyTorch has it): the handle
    ``torch.cuda.current_stream(device).cuda_stream`` gives, on the default
    stream and under another one, and the one the C function receives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    seen = []

    def stub(*args):
        seen.append(args[-1])
        return 0
    default = torch.cuda.current_stream(dev).cuda_stream
    assert _cuda_build.current_stream_handle(dev.index) == default
    _cuda_build.launch("stub", stub, dev, 1, 2)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert _cuda_build.current_stream_handle(dev.index) == side.cuda_stream
        assert torch.cuda.current_stream(dev).cuda_stream == side.cuda_stream
        _cuda_build.launch("stub", stub, dev, 1, 2)
    assert seen == [default, side.cuda_stream] and side.cuda_stream != default


def test_kernel_path_rejects_what_the_kernel_does_not_take():
    """The CUDA path's checks, reached without a card through tensors on the
    meta device: a wrong shape, dtype or a non-contiguous input raises
    ValueError, and so does a device other than CUDA; nothing launches."""
    shapes = dict(Fx=(2, 3, NX, NX), Fu=(2, 3, NX, NU), Lx=(2, 3, NX), Lu=(2, 3, NU),
                  Lxx=(2, 3, NX, NX), Lxu=(2, 3, NX, NU), Luu=(2, 3, NU, NU),
                  fs=(2, 4, NX), LxT=(2, NX), LxxT=(2, NX, NX), lb=(2, 3, NU),
                  ub=(2, 3, NU), xreg=(2,), ureg=(2,))

    def meta(dtype=torch.float32):
        return [torch.empty(s, dtype=dtype, device="meta") for s in shapes.values()]

    before = backward_box.launches
    args = meta()
    args[2] = args[2][:, :-1]                  # Lx with a knot missing
    with pytest.raises(ValueError, match="Lx"):
        backward_box(*args)
    with pytest.raises(ValueError, match="dtype"):
        backward_box(*meta(torch.float16))
    args = meta()
    args[4] = torch.empty((2, 3, NX, NX), device="meta").transpose(-1, -2)
    with pytest.raises(ValueError, match="Lxx must be contiguous"):
        backward_box(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        backward_box(*meta())
    assert backward_box.launches == before


def _batch_on_card(B_total, n, tight, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
            for a in _batch([_rand_problem(rng, tight, n) for _ in range(B_total)])]


def _launches_of(k, args):
    """The batch as consecutive kernel launches of k problems, outputs
    concatenated."""
    outs = [backward_box(*(a[i:i + k] for a in args))
            for i in range(0, args[0].shape[0], k)]
    return tuple(torch.cat(f) for f in zip(*outs))


def _hold_to_plain(args, out_k):
    """chip_smoke.py's gates of the kernel's outputs against the plain
    version on the same inputs."""
    out_r = backward_box_reference(*args)
    Bn = out_r[0].shape[0]
    assert torch.equal(out_k[5], out_r[5]), "bad flags differ"

    def per_problem(a, b):
        err = (a.double() - b.double()).abs().reshape(Bn, -1).amax(dim=1)
        return err, b.double().abs().reshape(Bn, -1).amax(dim=1)

    errs = {n: per_problem(a, b) for n, a, b in zip(NAMES, out_k, out_r) if n != "bad"}
    if args[0].dtype == torch.float64:
        for n, (e, sc) in errs.items():
            tol = TOL_F64_QP if n in QP_FIELDS else TOL_F64
            assert float(e.max()) <= tol["atol"] + tol["rtol"] * float(sc.max()), n
        return
    out_64 = backward_box_reference(*[a.double() for a in args])
    agree = out_k[5] == out_r[5]
    rel = {}
    for n, a, b in zip(NAMES, out_r, out_64):
        if n == "bad":
            continue
        e, sc = errs[n]
        sc = sc.clamp_min(1e-30)
        rel[n] = e / sc
        rel_p = per_problem(a, b)[0] / sc
        agree &= rel[n] <= F32_FACTOR * rel_p + F32_FLOOR
        assert float(rel[n].median()) <= F32_FACTOR * float(rel_p.median()) + F32_MEDIAN_FLOOR, n
    assert float(agree.double().mean()) >= MIN_AGREE_F32
    free_k, free_r = (o[0].abs().sum(-1) != 0 for o in (out_k, out_r))
    same_free = (free_k == free_r).all(dim=2).all(dim=1) & ~out_k[5] & ~out_r[5]
    assert bool(same_free.any())
    for n in ("K", "w_all"):
        assert not bool((same_free & ~(rel[n] <= F32_SAME_FREE_RTOL)).any()), n


@pytest.mark.cuda
@pytest.mark.parametrize("tight", [False, True], ids=["bounds_inactive", "bounds_active"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_kernel_matches_plain_version(dtype, tight):
    """The hand-written kernel against its plain version on the card, at
    chip_smoke.py's tolerances, for B in (1, 3, 1024) and N in (1, 40).
    B=1 and B=3 are launches of 1 and 3 problems over a batch of POOL (the
    float32 gate is a share of problems), each equal bit for bit to one
    launch over the whole batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward-sweep kernel has no CPU build")
    for b in (1, 3, 1024):
        for n in (1, 40):
            args = _batch_on_card(b if b > 3 else POOL, n, tight, dtype,
                                  seed=7 * n + (1 if tight else 0))
            before = backward_box.launches
            if b > 3:
                out_k = backward_box(*args)
                assert backward_box.launches == before + 1
            else:
                out_k = _launches_of(b, args)
                assert backward_box.launches == before + POOL // b
                whole = backward_box(*args)
                for x, y in zip(out_k, whole):
                    assert bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()), (b, n)
            torch.cuda.synchronize()
            _hold_to_plain(args, out_k)


@pytest.mark.cuda
def test_cuda_kernel_flags_indefinite_luu_like_plain():
    """An indefinite Quu at one knot of one problem: the kernel flags that
    problem bad, as the plain version does; its neighbours stay finite, and
    at float64 are held to the plain version at TOL_F64 / TOL_F64_QP (two
    problems are too few for float32's share of agreeing problems)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward-sweep kernel has no CPU build")
    rng = np.random.default_rng(7)
    probs = [_rand_problem(rng) for _ in range(B)]
    bad_prob = list(probs[1])
    Luu = bad_prob[6].copy()
    Luu[2] = -5.0 * np.eye(NU)
    bad_prob[6] = Luu
    probs[1] = tuple(bad_prob)
    for dtype in (torch.float64, torch.float32):
        args = [torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
                for a in _batch(probs)]
        out_k = backward_box(*args)
        out_r = backward_box_reference(*args)
        assert out_k[5].tolist() == out_r[5].tolist() == [False, True, False]
        for o in out_k:
            assert bool(torch.isfinite(o[[0, 2]].double()).all())
        if dtype == torch.float64:
            healthy = [a[[0, 2]].contiguous() for a in args]
            _hold_to_plain(healthy, tuple(o[[0, 2]] for o in out_k))
