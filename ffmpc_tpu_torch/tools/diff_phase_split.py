"""Where one knot of the knot-derivative kernel spends its cycles.

Builds a derivative source (``knot_diff.cu`` of a ``csrc/`` directory, this
package's by default) with ``-DFFMPC_DIFF_PHASE_CLOCK``: ``clock64()`` stamps
on block 0's thread 0 sum the cycles of each phase of the knot it runs
(``PHASES``), handed back by ``ffmpc_knot_diff_phase_cycles``.  Block 0's
thread 0 runs one knot's share of the kernel: in this layout the primal
chain of its knot and of 31 others (warp 0), then the columns 0, 7 and 14,
then three Lxx columns; the residuals run on warp 1 beside the primal chain,
so "residuals_and_cost" is the time thread 0 waits for them after its chain,
and the phases sum to its whole path.  Runs the kernel, float32, on the main
path's first-iteration inputs (``chip_smoke.py::main_path_diff_args``) at
each batch size, and prints the cycles by phase and the launch's time (CUDA
events, median of 7 rounds of 5 launches; the stamps add a few cycles a
phase).  With ``--no-clock`` the sources are built as the package builds
them and only the launches are timed, several ``--source`` directories
(another revision's ``csrc/``, taken with ``git archive``) in turns in this
one process.  ``--sass`` also counts each kernel's SASS instructions and
its local-memory loads and stores (``LDL`` / ``STL``).  Needs a card and
nvcc; run it from the repository's root.

Usage: python -m ffmpc_tpu_torch.tools.diff_phase_split
           [--source CSRC_DIR ...] [--no-clock] [--sass] [--batch 1 256 1024]
           [--json OUT]
"""

from __future__ import annotations

import ctypes

import torch

from ..solver import _cuda_build
from ..solver.diff_cuda import ARGTYPES, kernel_args
from . import _phase_split

PHASES = ("loads_and_primal", "q_passes", "v_passes", "control_columns",
          "fx_fu_stores", "residuals_and_cost", "lx_lxx_assembly_and_stores")


def occupancy(lib):
    occ = _cuda_build.bind(lib, "ffmpc_knot_diff_occupancy_f32",
                           [ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    if occ(ctypes.byref(n)) != 0:
        raise RuntimeError("occupancy query failed")
    return n.value


def launcher(lib, B, args):
    """The float32 kernel of ``lib`` on the main path's first-iteration
    inputs at batch ``B``."""
    import chip_smoke  # the main path's inputs; the script sits at the repository's root
    knot, consts, (xs, us, refs_run, ref_T) = chip_smoke.main_path_diff_args(B)
    fn = _cuda_build.bind(lib, "ffmpc_knot_diff_f32", ARGTYPES)
    out, c_args = kernel_args(knot, consts, refs_run, ref_T, xs, us)

    def run():
        _cuda_build.launch("knot_diff", fn, xs.device, *c_args)

    return _phase_split.Launch(
        run, 1, {"B": B, "N": int(us.shape[1])},
        lambda: {"finite_Fx_share": float(torch.isfinite(out.run.Fx).double().mean())})


def main(argv=None):
    args = _phase_split.parser(__doc__).parse_args(argv)
    return _phase_split.main(args, name="diff_phase_split", source="knot_diff.cu",
                             define="-DFFMPC_DIFF_PHASE_CLOCK",
                             cycles="ffmpc_knot_diff_phase_cycles", launcher=launcher,
                             phases=PHASES, occupancy=occupancy)


if __name__ == "__main__":
    raise SystemExit(main())
