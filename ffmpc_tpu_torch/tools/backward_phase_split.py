"""Where one knot of the backward-sweep kernel spends its cycles.

Builds a backward-sweep source (``backward_sweep.cu`` of a ``csrc/``
directory, this package's by default) with ``-DFFMPC_BACKWARD_PHASE_CLOCK``:
``clock64()`` stamps on block 0's thread 0 sum the cycles of each phase of a
knot over the sweep (``PHASES``; thread 0 runs the box QP, so a phase's
cycles include its barrier waits), handed back by
``ffmpc_backward_phase_cycles``.  Runs the kernel at N=40 (``--horizon``)
on seeded inputs (bounds active and inactive, the recipe of the package's
CPU tests) at each batch size, and prints per-knot cycles by phase (the
terminal phase once a sweep) and the launch's time (CUDA events, median of
7 rounds of 5 launches; the stamps add a few cycles a phase).  With
``--no-clock`` the sources are built as the package builds them and only
the launches are timed, several ``--source`` directories (another
revision's ``csrc/``, taken with ``git archive``) in turns in this one
process.  ``--sass`` also counts each kernel's SASS instructions and
LDL/STL.  Needs a card and nvcc.

Usage: python -m ffmpc_tpu_torch.tools.backward_phase_split
           [--source CSRC_DIR ...] [--no-clock] [--sass] [--batch 1 256]
           [--horizon 40] [--json OUT]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..solver import _cuda_build, backward_cuda
from . import _phase_split

PHASES = ("input_wait", "w_products", "quu_qu", "box_qp_and_gain_factor", "gains",
          "value_update", "w_and_accumulators", "terminal")
NX, NU = 21, 7


def seeded_args(B, N, tight, seed, device="cuda"):
    """Well-conditioned float32 backward-sweep inputs (the package's test
    recipe), made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.normal(size=s)

    eye_x, eye_u = np.eye(NX), np.eye(NU)
    A = 0.3 * r(B, N, NX, NX)
    Bm = 0.3 * r(B, N, NU, NU)
    At = 0.3 * r(B, NX, NX)
    width = 0.05 if tight else 50.0
    arrays = (eye_x + 0.1 * r(B, N, NX, NX), 0.2 * r(B, N, NX, NU), r(B, N, NX), r(B, N, NU),
              A @ np.swapaxes(A, -1, -2) + 0.5 * eye_x, 0.1 * r(B, N, NX, NU),
              Bm @ np.swapaxes(Bm, -1, -2) + 0.8 * eye_u, 0.3 * r(B, N + 1, NX), r(B, NX),
              At @ np.swapaxes(At, -1, -2) + 0.5 * eye_x,
              -width * np.abs(r(B, N, NU)) - 1e-3, width * np.abs(r(B, N, NU)) + 1e-3)
    xreg = 10.0 ** rng.uniform(-6, -2, size=B)
    return [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in (*arrays, xreg, xreg)]


def launcher(lib, case, args):
    """The float32 kernel of ``lib`` at (batch, bounds active) ``case`` on
    the seeded inputs."""
    B, tight = case
    N = args.horizon
    fn = _cuda_build.bind(lib, "ffmpc_backward_sweep_f32", backward_cuda._ARGTYPES)
    inputs = seeded_args(B, N, tight, seed=1 if tight else 0)
    f = torch.float32
    outs = [torch.empty(B, N, NU, NX, dtype=f, device="cuda"),
            torch.empty(B, N, NU, dtype=f, device="cuda"),
            *(torch.empty(B, dtype=f, device="cuda") for _ in range(3)),
            torch.empty(B, dtype=torch.bool, device="cuda"),
            torch.empty(B, N + 1, NX, dtype=f, device="cuda")]
    ptrs = [a.data_ptr() for a in (*inputs, *outs)]

    def run():
        _cuda_build.launch("backward_sweep", fn, inputs[0].device, *ptrs, B, N, 8, 1e-12)

    return _phase_split.Launch(
        run, N, {"B": B, "N": N, "bounds": "active" if tight else "inactive"},
        lambda: {"bad": int(outs[5].sum())}, once=("terminal",))


def occupancy(lib):
    occ = _cuda_build.bind(lib, "ffmpc_backward_sweep_occupancy_f32",
                           [ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    if occ(ctypes.byref(n)) != 0:
        raise RuntimeError("occupancy query failed")
    return n.value


def main(argv=None):
    ap = _phase_split.parser(__doc__, default_batch=(1, 256))
    ap.add_argument("--horizon", type=int, default=40)
    args = ap.parse_args(argv)
    return _phase_split.main(args, name="backward_phase_split", source="backward_sweep.cu",
                             define="-DFFMPC_BACKWARD_PHASE_CLOCK",
                             cycles="ffmpc_backward_phase_cycles", launcher=launcher,
                             phases=PHASES, occupancy=occupancy,
                             cases=[(B, tight) for B in args.batch for tight in (False, True)])


if __name__ == "__main__":
    raise SystemExit(main())
