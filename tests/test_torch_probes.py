"""The probes of ``ffmpc_tpu_torch/tools/`` (counterparts of the TPU probe
kernels of ``tools/probe_mosaic.py``, ``tools/probe_mosaic2.py`` and
``tools/probe_dma_roundtrip.py``): each plain version, at float64 on the CPU,
against what the TPU probe's body computes.

- The stream stages against the JAX composition of each TPU kernel body
  (``kernel`` stages 1-4, ``kernel5``, ``kernel6``), built from the plain
  ``jnp`` helpers of ``ffmpc_tpu/solver/backward_pallas.py`` (``_mm``,
  ``_mmT``, ``_mv``, ``_mvT``, ``_chol``, ``_chol_solve_vec`` / ``_mat``,
  ``_diag_mask``, ``_masked_spd``, ``_boxqp_channels``) with the TPU
  probe's own slices, run op by op: 1e-12 of each output's scale, and the
  same non-finite entries (stage 3 is NaN in every lane on the probe's
  random knots, whose Quu is indefinite; so stage 3 is also held on
  ``spd_knots``, where every output is finite).
- The math ops and the round trip against numpy.
- The wrappers on CPU tensors run the plain versions and count no launch;
  the entry points asked for "cuda" raise without a card; the kernels
  themselves are held against the plain versions on the card (``cuda``
  marker), as ``chip_smoke.py`` phase ``probes`` does.
- ``math_op``'s, ``stream_stage``'s and ``roundtrip``'s kernel paths,
  reached without a card through tensors on the ``meta`` device, raise on
  what the kernels do not take.
- The stream kernel's arithmetic (``csrc/probe_stream.cuh``: the step
  stages' phases run thread by thread in turn, as the kernel's lane group
  runs them between barriers, and the copy stages' per-element functions),
  built with g++ for the host, against ``stream_reference`` at
  ``STREAM_TOL`` with the same non-finite entries.
- On the card (``cuda`` marker): the stream stages and the round trip on
  grids with ragged edges (lanes and channels that do not fill a block, one
  knot, seven knots, one lane tile).

The JAX package is imported where it is installed; on a card's machine
without it only the ``cuda``-marked test runs
(``python -m pytest --noconftest tests/test_torch_probes.py -m cuda``).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ffmpc_tpu_torch.solver import _cuda_build

from ffmpc_tpu_torch.tools import probe_dma_roundtrip as prt
from ffmpc_tpu_torch.tools import probe_mosaic as pmath
from ffmpc_tpu_torch.tools import probe_mosaic2 as pstream

try:
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.solver.backward_pallas import (_boxqp_channels, _chol, _chol_solve_mat,
                                                  _chol_solve_vec, _diag_mask, _masked_spd,
                                                  _mm, _mmT, _mv, _mvT)
except ImportError:
    jax = None

LANES = 16          # a slice of the probe's 128 lanes keeps the op-by-op JAX side quick
TOL = 1e-12


def jax_stage(knots, stage, term=None):
    """The TPU probe's kernel body for ``stage`` (tools/probe_mosaic2.py),
    its fori_loop over knots written as a Python loop, on (N, C, Bt) knots in
    the channel-major layout.  Returns the probe's outputs as numpy."""
    nx, nu = 21, 7
    n_knots, _, Bt = knots.shape
    dtype = knots.dtype
    acc = jnp.zeros((8, Bt), dtype)
    big = np.zeros((n_knots, 448, Bt))
    k_out = np.zeros((n_knots, 152, Bt))
    kff_out = np.zeros((n_knots, 8, Bt))

    def pad8rows(v):
        return jnp.concatenate([v, jnp.zeros((8 - v.shape[0],) + v.shape[1:], dtype)])

    if stage == 5:
        Vxx = jnp.broadcast_to(_diag_mask(nx, dtype), (nx, nx, Bt))
        Vx = jnp.zeros((nx, Bt), dtype)
    if stage == 6:
        base = term[0:nx, :]
    for t in range(n_knots - 1, -1, -1):
        scr = knots[t]
        if stage == 6:
            Fu = scr[nx * nx:nx * nx + nx * nu, :].reshape(nx, nu, Bt) * 0.1
            v = _mvT(Fu, scr[0:nx, :] + base)
            big[t, 0:nx * nx] = scr[0:nx * nx]
            k_out[t, 0:nu * nx] = scr[0:nu * nx]
            kff_out[t, 0:nu] = v
            acc = acc + v[0:1, :] * 0.0 + scr[0:8, :]
            continue
        if stage == 5:
            Fx = scr[0:nx * nx, :].reshape(nx, nx, Bt) * 0.05 + _diag_mask(nx, dtype) * 0.9
            Fu = scr[nx * nx:nx * nx + nx * nu, :].reshape(nx, nu, Bt) * 0.1
            Lxx = _diag_mask(nx, dtype) * 0.7
            W = _mm(Vxx, Fx)
            U = _mm(Vxx, Fu)
            Qxx = Lxx + _mmT(Fx, W)
            Qxu = _mmT(Fx, U)
            Quu = _mmT(Fu, U) + _diag_mask(nu, dtype)
            Qx = _mvT(Fx, Vx)
            Qu = _mvT(Fu, Vx) + scr[8:8 + nu, :]
            free = (Qu < 1e9).astype(dtype)
            QxuT = jnp.concatenate([jax.lax.slice_in_dim(Qxu, u, u + 1, axis=1).reshape(
                1, nx, Bt) for u in range(nu)])
            Qm = _masked_spd(Quu, free, 1e-9)
            K = _chol_solve_mat(_chol(Qm), QxuT * free[:, None, :])
            kff = -_chol_solve_vec(_chol(Qm), Qu * free)
            Quuk = _mv(Quu, kff)
            Vx = Qx + _mvT(K, Quuk - 2.0 * Qu)
            Vxx_new = Qxx - _mm(Qxu, K)
            Vxx_newT = jnp.concatenate([jax.lax.slice_in_dim(Vxx_new, i, i + 1, axis=1).reshape(
                1, nx, Bt) for i in range(nx)])
            Vxx = 0.5 * (Vxx_new + Vxx_newT) + _diag_mask(nx, dtype) * 1e-6
            big[t, 0:nx * nx] = Vxx.reshape(nx * nx, Bt)
            continue
        if stage >= 4:
            big[t, 0:nx * nx] = scr[0:nx * nx]
        Fx = scr[0:nx * nx, :].reshape(nx, nx, Bt)
        Fu = scr[nx * nx:nx * nx + nx * nu, :].reshape(nx, nu, Bt)
        Lu = scr[1000:1000 + nu, :]
        if stage in (1, 4):
            acc = acc + scr[0:8, :]
            continue
        Vxx = Fx
        U = _mm(Vxx, Fu)
        Quu = _mmT(Fu, U) + _diag_mask(nu, dtype) * 0.5
        Qu = Lu + _mvT(Fu, _mv(Vxx, scr[8:8 + nx, :]))
        if stage == 2:
            acc = acc + pad8rows(Quu[0]) * 0.0 + pad8rows(Qu)
            continue
        x, _ = _boxqp_channels(Quu, Qu, -Lu - 5.0, -Lu + 5.0, 4, 1e-9)
        K = _chol_solve_mat(_chol(Quu + _diag_mask(nu, dtype)), _mm(Vxx, Fu)[0:nu])
        acc = acc + pad8rows(x) + pad8rows(K[0]) * 0.0
    out = {"out": np.asarray(Vxx.reshape(nx * nx, Bt)[0:8] if stage == 5 else acc), "big": big}
    if stage == 6:
        out.update(k=k_out, kff=kff_out)
    return out


@pytest.fixture(scope="module")
def stream_inputs():
    knots, term = pstream.probe_inputs("cpu")
    return knots[:, :, :LANES].double().contiguous(), term[:, :LANES].double().contiguous()


def assert_stage_equals_jax(knots, stage, term):
    if jax is None:
        pytest.skip("needs the JAX package, the reference of this comparison")
    got = pstream.stream_reference(knots, stage, term if stage == 6 else None)
    want = jax_stage(jnp.asarray(knots.numpy()), stage, jnp.asarray(term.numpy()))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, name
        assert np.array_equal(np.isfinite(g), np.isfinite(w)), name
        fin = np.isfinite(w)
        scale = max(float(np.abs(w[fin]).max()) if fin.any() else 1.0, 1.0)
        err = float(np.abs(g[fin] - w[fin]).max()) if fin.any() else 0.0
        assert err <= TOL * scale, (name, err, scale)
    return want


@pytest.mark.parametrize("stage", pstream.STAGES)
def test_stream_stage_plain_equals_jax_body(stream_inputs, stage):
    knots, term = stream_inputs
    want = assert_stage_equals_jax(knots, stage, term)
    if stage == 3:
        assert not np.isfinite(want["out"][:7]).any()


def test_stream_stage3_plain_equals_jax_body_on_spd_knots(stream_inputs):
    """Stage 3's box QP and Cholesky gain solve on finite numbers: with Fx
    conditioned, Quu is SPD and every output of the JAX body is finite."""
    knots, term = stream_inputs
    spd = pstream.spd_knots(knots)
    assert torch.equal(spd[:, 441:], knots[:, 441:])
    want = assert_stage_equals_jax(spd, 3, term)
    assert all(np.isfinite(w).all() for w in want.values())
    assert np.abs(want["out"][:7]).min() > 0.0


def test_stream_wrapper_on_cpu_runs_the_plain_version(stream_inputs):
    knots, term = stream_inputs
    n0 = dict(pstream.stream_stage.launches)
    for stage in (1, 5, 6):
        got = pstream.stream_stage(knots, stage, term if stage == 6 else None)
        want = pstream.stream_reference(knots, stage, term if stage == 6 else None)
        for k in want:
            assert torch.equal(got[k], want[k]), (stage, k)
    assert pstream.stream_stage.launches == n0
    with pytest.raises(ValueError, match="term"):
        pstream.stream_stage(knots, 6)
    with pytest.raises(ValueError, match="stage"):
        pstream.stream_stage(knots, 7)
    with pytest.raises(ValueError, match="knots"):
        pstream.stream_stage(knots[:, :500], 1)


@pytest.mark.parametrize("op", pmath.OPS)
def test_math_plain_equals_numpy(op):
    x = pmath.probe_input("cpu", torch.float64)
    got = pmath.math_op(x, op).numpy()
    xn = x.numpy()
    want = {"sin": np.sin(xn), "cos": np.cos(xn), "sqrt": np.sqrt(np.abs(xn)),
            "arccos": np.arccos(xn), "arctan2": np.arctan2(xn, 1.0 + xn * xn),
            "arctan": np.arctan(xn), "exp": np.exp(xn)}[op]
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    assert x.shape == (2, 128)
    assert float(x.min()) == float(np.float32(-0.9)) and float(x.max()) == float(np.float32(0.9))


def test_math_ulp_helpers():
    """The host reference and the ulp count the gate reads: a float32 value
    is 0 ulp from itself, a neighbour 1; atan2's second argument is rounded
    in float32 as the kernel forms it."""
    a = np.float32([1.0, -2.5, 0.3])
    assert pmath.ulp_distance(a, a).tolist() == [0, 0, 0]
    assert pmath.ulp_distance(a, np.nextafter(a, np.float32(np.inf))).tolist() == [1, 1, 1]
    assert pmath.ulp_distance(np.float32([-0.0]), np.float32([0.0])).tolist() == [0]
    x32 = pmath.probe_input("cpu").numpy()
    ref = pmath.host_reference(x32, "arctan2")
    y32 = (x32 * x32 + np.float32(1)).astype(np.float32)
    np.testing.assert_array_equal(ref, np.arctan2(x32.astype(np.float64), y32.astype(np.float64)))
    assert set(pmath.ULP_BOUND) == set(pmath.OPS)


def test_backward_probe_inputs_are_the_tpu_probes():
    """The probe's construction (default_rng(0), its formulas and draw
    order), at both state widths the kernel is built for (the TPU probe's
    PROBE_NX), and any other refused."""
    args = pmath.backward_probe_inputs(device="cpu")
    rng = np.random.default_rng(0)
    Fx = np.eye(21, dtype=np.float32) + np.float32(0.05) * rng.normal(size=(128, 4, 21, 21)).astype(np.float32)
    np.testing.assert_array_equal(args[0].numpy(), Fx)
    assert [tuple(a.shape) for a in args[:2]] == [(128, 4, 21, 21), (128, 4, 21, 7)]
    assert float(args[12][0]) == pytest.approx(1e-4)
    args14 = pmath.backward_probe_inputs(nx=14, device="cpu")
    assert [tuple(a.shape) for a in args14[:2]] == [(128, 4, 14, 14), (128, 4, 14, 7)]
    with pytest.raises(ValueError, match="nx in"):
        pmath.backward_probe_inputs(nx=10, device="cpu")


def test_roundtrip_plain_equals_numpy():
    knots = prt.probe_inputs("cpu").double()
    n0 = prt.roundtrip.launches
    out, acc = prt.roundtrip(knots)
    assert prt.roundtrip.launches == n0
    k = knots.numpy()
    np.testing.assert_array_equal(out.numpy(), 2.0 * k)
    np.testing.assert_allclose(acc.numpy(), k[:, 0:8].sum(axis=0), rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match="multiple"):
        prt.roundtrip(knots[:, :, :200])


def test_math_op_kernel_path_rejects_what_the_kernel_does_not_take():
    """The kernel path's one check each of dtype, contiguity and device,
    reached without a card through tensors on the meta device; an unknown
    op raises on any device.  Nothing launches."""
    n0 = pmath.math_op.launches
    with pytest.raises(ValueError, match="unknown op"):
        pmath.math_op(pmath.probe_input("cpu"), "tan")
    with pytest.raises(ValueError, match="dtype"):
        pmath.math_op(torch.empty(2, 128, dtype=torch.float64, device="meta"), "sin")
    with pytest.raises(ValueError, match="contiguous"):
        pmath.math_op(torch.empty(128, 2, device="meta").t(), "sin")
    with pytest.raises(ValueError, match="unsupported device"):
        pmath.math_op(torch.empty(2, 128, device="meta"), "sin")
    assert pmath.math_op.launches == n0


def test_probe_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request for 'cuda' is honoured")
    for fn in (pmath.probe_math, pstream.probe_stream, prt.probe_roundtrip):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()


@pytest.mark.cuda
def test_probe_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe kernels have no CPU build")
    assert pmath.probe_math()["ok"]
    assert pstream.probe_stream()["ok"]
    assert prt.probe_roundtrip()["ok"]


def test_stream_and_roundtrip_kernel_paths_reject_what_the_kernels_do_not_take():
    """The kernel paths' checks of dtype, contiguity, device and size, reached
    without a card through tensors on the meta device.  Nothing launches."""
    n_stream, n_rt = dict(pstream.stream_stage.launches), prt.roundtrip.launches
    shape = (4, 1288, 128)
    term = torch.empty(64, 128, device="meta")
    with pytest.raises(ValueError, match="dtype"):
        pstream.stream_stage(torch.empty(shape, dtype=torch.float64, device="meta"), 1)
    with pytest.raises(ValueError, match="contiguous"):
        pstream.stream_stage(torch.empty(4, 128, 1288, device="meta").transpose(1, 2), 5)
    with pytest.raises(ValueError, match="unsupported device"):
        pstream.stream_stage(torch.empty(shape, device="meta"), 6, term)
    with pytest.raises(ValueError, match="elements"):
        pstream.stream_stage(torch.empty(2, 1288, 900_000, device="meta"), 2)
    with pytest.raises(ValueError, match="dtype"):
        prt.roundtrip(torch.empty(4, 64, 256, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        prt.roundtrip(torch.empty(4, 256, 64, device="meta").transpose(1, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        prt.roundtrip(torch.empty(4, 64, 256, device="meta"))
    assert pstream.stream_stage.launches == n_stream
    assert prt.roundtrip.launches == n_rt


# ---------------------------------------------------------------------------
# the stream kernel's arithmetic, compiled for the host
# ---------------------------------------------------------------------------

_STREAM_HARNESS = r"""
#include <cmath>
#include <vector>
#include "probe_stream.cuh"

using namespace probe_stream;

// One stage for every lane, as the kernel computes it: the step stages'
// lane groups (stream_group_serial), the copy stages element by element.
// Every output row is written here, as the kernel writes it.
extern "C" int stream_host_f32(const float* knots, const float* term, float* out, float* big,
                               float* k, float* kff, int N, int C, int Bt, int stage) {
  StreamArgs a{knots, term, out, big, k, kff, N, C, Bt};
  if (stage == 2 || stage == 3 || stage == 5) {
    // shared memory starts NaN, so a read of an unwritten entry shows
    std::vector<float> g(Layout<5>::kSize > Layout<2>::kSize ? Layout<5>::kSize
                                                              : Layout<2>::kSize);
    for (int b = 0; b < Bt; ++b) {
      for (float& v : g) v = NAN;
      if (stage == 5) stream_group_serial<5>(a, b, g.data());
      else if (stage == 3) stream_group_serial<3>(a, b, g.data());
      else stream_group_serial<2>(a, b, g.data());
    }
  } else {
    for (int j = 0; j < 8 * Bt; ++j) out[j] = out_acc(a, stage == 6, j);
  }
  const int copy = (stage == 4 || stage == 6) ? NX * NX : 0;
  for (int t = 0; t < N && stage != 5; ++t)
    for (int e = 0; e < NXXP * Bt; ++e)
      big[(size_t)t * NXXP * Bt + e] = e < copy * Bt ? knots[(size_t)t * C * Bt + e] : 0.0f;
  if (stage == 6)
    for (int t = 0; t < N; ++t)
      for (int r = 0; r < NK; ++r)
        for (int b = 0; b < Bt; ++b) {
          const size_t o = ((size_t)t * NK + r) * Bt + b;
          k[o] = r < NU * NX ? knots[((size_t)t * C + r) * Bt + b] : 0.0f;
          if (r < NKFF)
            kff[((size_t)t * NKFF + r) * Bt + b] = r < NU ? kff_value(a, t, r, b) : 0.0f;
        }
  return 0;
}
"""


@pytest.fixture(scope="module")
def stream_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the device code cannot be built for the host")
    d = tmp_path_factory.mktemp("stream_host")
    src, lib = d / "harness.cpp", d / "libstream_host.so"
    src.write_text(_STREAM_HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(_cuda_build.CSRC_DIR), "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).stream_host_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


def host_kernel(fn):
    """``run_stage``'s kernel argument: the host build, into outputs that
    start NaN (the kernel's are uninitialized)."""
    def run(knots, stage, term=None):
        n_knots, n_ch, Bt = knots.shape
        shapes = {"out": (8, Bt), "big": (n_knots, pstream.NXXP, Bt)}
        if stage == 6:
            shapes.update(k=(n_knots, pstream.NK, Bt), kff=(n_knots, pstream.NKFF, Bt))
        res = {n: torch.full(s, float("nan"), dtype=torch.float32) for n, s in shapes.items()}
        ptr = [res[n].data_ptr() if n in res else None for n in ("out", "big", "k", "kff")]
        assert fn(knots.data_ptr(), term.data_ptr() if stage == 6 else None, *ptr,
                  n_knots, n_ch, Bt, stage) == 0
        return res
    return run


def seeded_stream_inputs(n_knots, lanes, seed):
    rng = np.random.default_rng(seed)
    knots = rng.normal(size=(n_knots, pstream.C, lanes)).astype(np.float32)
    term = rng.normal(size=(pstream.TERM_ROWS, lanes)).astype(np.float32)
    return torch.as_tensor(knots), torch.as_tensor(term)


@pytest.mark.parametrize("stage", pstream.STAGES)
def test_stream_host_build_matches_plain_version(stream_host, stage):
    knots, term = pstream.probe_inputs("cpu")
    knots, term = knots[:, :, :LANES].contiguous(), term[:, :LANES].contiguous()
    res = pstream.run_stage(knots, stage, term if stage == 6 else None,
                            kernel=host_kernel(stream_host))
    assert res["ok"], res["outputs"]
    if stage == 3:   # the probe's knots make Quu indefinite: NaN in every lane
        assert res["outputs"]["out"]["nonfinite"] == pstream.NU * LANES


def test_stream_host_build_stage3_on_spd_knots(stream_host):
    knots, _ = pstream.probe_inputs("cpu")
    spd = pstream.spd_knots(knots[:, :, :LANES].contiguous())
    res = pstream.run_stage(spd, 3, finite=True, kernel=host_kernel(stream_host))
    assert res["ok"], res["outputs"]


@pytest.mark.parametrize("n_knots,lanes", [(1, 5), (7, 3)])
def test_stream_host_build_other_horizons(stream_host, n_knots, lanes):
    """One knot and seven (the ring's two stages used once, and in turn over
    an odd count), every stage; stage 3 also on SPD knots."""
    knots, term = seeded_stream_inputs(n_knots, lanes, seed=n_knots)
    kern = host_kernel(stream_host)
    for stage in pstream.STAGES:
        res = pstream.run_stage(knots, stage, term if stage == 6 else None, kernel=kern)
        assert res["ok"], (stage, res["outputs"])
    res = pstream.run_stage(pstream.spd_knots(knots), 3, finite=True, kernel=kern)
    assert res["ok"], res["outputs"]


# ---------------------------------------------------------------------------
# the kernels on the card, on ragged grids (python -m pytest --noconftest -m cuda)
# ---------------------------------------------------------------------------

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe kernels have no CPU build")


def assert_stage3_on_spd_knots(knots):
    """Stage 3 on ``spd_knots(knots)``, where every output is finite: ``big``
    equal to the plain version's, and ``out`` equal bit for bit to the
    kernel's own on the same lanes in reverse order (other blocks, other
    edges) and to the knots run one at a time, summed in the kernel's order
    t = N-1 .. 0 (so across its rounds of four knots).

    Against the plain version, stage 3's finite arithmetic is held at
    STREAM_TOL on the probe's own SPD knots (the test above, and
    ``chip_smoke.py``) and on seeded knots in the host build.  On seeded
    knots on the card it does not hold lane for lane: the 4-iteration box QP
    factors Quu's lower triangle while its objective reads all of the
    unsymmetric Quu, so x still moves at the last steps, and 1-9% of the
    lanes meet two candidates whose objectives agree within 1e-7; two
    float32 versions may pick differently there (seed 101, lane 100, knot 3:
    -0.531397774 against -0.531397741 in float64, the other order in
    float32; the plain float32 version is then 2.0e-4 from float64)."""
    spd = pstream.spd_knots(knots)
    got = pstream.stream_stage(spd, 3)
    assert torch.equal(got["big"], pstream.stream_reference(spd, 3)["big"])
    out = got["out"]
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, pstream.stream_stage(spd.flip(2).contiguous(), 3)["out"].flip(1))
    acc = torch.zeros_like(out)
    for t in range(spd.shape[0] - 1, -1, -1):
        acc = acc + pstream.stream_stage(spd[t:t + 1].contiguous(), 3)["out"]
    assert torch.equal(out, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("n_knots,lanes", [(4, 100), (4, 101), (1, 128), (7, 128)])
def test_stream_kernel_on_ragged_grids_matches_plain_version(n_knots, lanes):
    """Lanes that do not fill a lane block or a copy block (100; 101, whose
    odd knot stride also takes the copies' unaligned path), one knot and
    seven (stages 2 and 3 take knots in rounds of four); every stage, stage 3
    also on SPD knots."""
    need_card()
    knots, term = (a.cuda() for a in seeded_stream_inputs(n_knots, lanes, seed=lanes))
    for stage in pstream.STAGES:
        res = pstream.run_stage(knots, stage, term if stage == 6 else None)
        assert res["ok"], (stage, res["outputs"])
    assert_stage3_on_spd_knots(knots)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bt", [((4, 64, 128), 128), ((3, 60, 256), 128),
                                      ((5, 12, 64), 32), ((2, 8, 8), 4)])
def test_roundtrip_kernel_on_ragged_grids_matches_plain_version(shape, bt):
    """One lane tile; a channel count that leaves the last 8-channel chunk
    part-full (60, 12); an odd knot count (the ring's stages in turn); fewer
    lanes than the 32 threads that start the bulk copies (Bt = 4)."""
    need_card()
    rng = np.random.default_rng(sum(shape))
    knots = torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
    out, acc = prt.roundtrip(knots, bt)
    out_p, acc_p = prt.roundtrip_reference(knots, bt)
    torch.cuda.synchronize()
    assert torch.equal(out, out_p)
    assert float((acc - acc_p).abs().max()) < prt.ACC_TOL
