"""Where one rollout of the line-search kernel spends its cycles, and the
kernel's time beside another revision's.

Builds a rollout source (``rollout.cu`` of a ``csrc/`` directory, this
package's by default) with ``-DFFMPC_ROLLOUT_PHASE_CLOCK``: ``clock64()``
stamps on block 0's thread 0 (lane 0 of a lane group, whose path waits at
each of the group's barriers for the slowest lane) sum the cycles of each
phase of its path over the knots it runs.  The library names its phases
(``ffmpc_rollout_phase_names``) and hands the sums back
(``ffmpc_rollout_phase_cycles``); the figures printed are cycles a knot
evaluation (the N running knots and the terminal one).  Runs the kernel,
float32, on the main path's first-iteration inputs
(``chip_smoke.py::main_path_rollout_args``: N=40, 10 step lengths) at each
batch size, and prints the cycles by phase and the launch's time (CUDA
events, median of 7 rounds of 5 launches; the stamps add a few cycles a
phase).  With ``--no-clock`` the sources are built as the package builds
them and only the launches are timed, several ``--source`` directories
(another revision's ``csrc/``, taken with ``git archive``, with this
package's C interface) in turns in this one process.  ``--sass`` also
counts each kernel's SASS instructions and LDL/STL, and in a stamped build
the instructions between one stamp and the next.  Needs a card and nvcc;
run it from the repository's root.

Usage: python -m ffmpc_tpu_torch.tools.rollout_phase_split
           [--source CSRC_DIR ...] [--no-clock] [--sass] [--batch 1 256 1024]
           [--json OUT]
"""

from __future__ import annotations

import ctypes

import torch

from ..solver import _cuda_build
from ..solver import rollout_cuda
from . import _phase_split


def phases(lib):
    return _cuda_build.bind(lib, "ffmpc_rollout_phase_names", [],
                            ctypes.c_char_p)().decode().split(",")


def occupancy(lib):
    occ = _cuda_build.bind(lib, "ffmpc_rollout_occupancy_f32",
                           [ctypes.POINTER(ctypes.c_int), ctypes.c_int])
    n = ctypes.c_int(0)
    if occ(ctypes.byref(n), 10) != 0:
        raise RuntimeError("occupancy query failed")
    return n.value


def launcher(lib, B, args):
    """The float32 kernel of ``lib`` on the main path's first-iteration
    inputs at batch ``B``."""
    import chip_smoke  # the main path's inputs; the script sits at the repository's root
    knot, consts, arrays = chip_smoke.main_path_rollout_args(B)
    fn = _cuda_build.bind(lib, "ffmpc_rollout_f32", rollout_cuda.ARGTYPES)
    outs, c_args = rollout_cuda.kernel_args(knot, consts, *arrays, chip_smoke.N_ALPHAS)
    device = arrays[1].device
    N = int(arrays[2].shape[1])

    def run():
        _cuda_build.launch("rollout", fn, device, *c_args)

    return _phase_split.Launch(
        run, N + 1, {"B": B, "N": N},
        lambda: {"finite_cost_share": float(torch.isfinite(outs[2]).double().mean())})


def main(argv=None):
    args = _phase_split.parser(__doc__).parse_args(argv)
    return _phase_split.main(args, name="rollout_phase_split", source="rollout.cu",
                             define="-DFFMPC_ROLLOUT_PHASE_CLOCK",
                             cycles="ffmpc_rollout_phase_cycles", launcher=launcher,
                             phases=phases, occupancy=occupancy)


if __name__ == "__main__":
    raise SystemExit(main())
