"""Where one knot of the knot-derivative kernel spends its cycles.

Builds a derivative source (``knot_diff.cu`` of a ``csrc/`` directory, this
package's by default) with ``-DFFMPC_DIFF_PHASE_CLOCK``: ``clock64()`` stamps
on block 0's thread 0 sum the cycles of each phase of the knot it runs
(``PHASES``).  The build goes to ``ffmpc_tpu_torch/_build/`` beside the
package's own libraries and exports the same C interface plus
``ffmpc_knot_diff_phase_cycles``.  Block 0's thread 0 runs one knot's
share of the kernel: in this layout the primal chain of its knot and of 31
others (warp 0), then the columns 0, 7 and 14, then three Lxx columns; the
residuals run on warp 1 beside the primal chain, so "residuals_and_cost" is
the time thread 0 waits for them after its chain, and the phases sum to its
whole path.  Runs the kernel, float32, on the main
path's first-iteration inputs (``chip_smoke.py::main_path_diff_args``) at
each batch size, and prints the cycles by phase and the launch's time (CUDA
events, median of 7 rounds of 5 launches; the stamps add a few cycles a
phase).  With ``--no-clock`` the source is built as the package builds it
and only the launch is timed: that times another revision's kernel beside
this one on the same card (its ``csrc/`` taken with ``git archive``).  With
``--sass`` it also counts the local-memory loads and stores (``LDL`` /
``STL``) in each kernel's SASS (``cuobjdump -sass``).  Needs a card and
nvcc; run it from the repository's root.

Usage: python -m ffmpc_tpu_torch.tools.diff_phase_split
           [--source CSRC_DIR] [--no-clock] [--sass] [--batch 1 256 1024]
           [--json OUT]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..solver import _cuda_build
from ..solver.diff_cuda import ARGTYPES, kernel_args

PHASES = ("loads_and_primal", "q_passes", "v_passes", "control_columns",
          "fx_fu_stores", "residuals_and_cost", "lx_lxx_assembly_and_stores")


def build(csrc: Path, clock: bool = True) -> Path:
    """The library built from ``csrc/knot_diff.cu``, with the phase clock or
    without (cached by content and flags)."""
    return _cuda_build.build_variant(
        Path(csrc) / "knot_diff.cu", ("-DFFMPC_DIFF_PHASE_CLOCK",) if clock else (),
        "knot_diff_phase" if clock else "knot_diff_variant")


def sass_local_memory(lib: Path):
    """Per kernel function of ``lib``: the number of LDL and STL
    instructions in its SASS."""
    cuobjdump = Path(_cuda_build._find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    res = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        res[name] = {"LDL": len(re.findall(r"\bLDL\b", block)),
                     "STL": len(re.findall(r"\bSTL\b", block))}
    return res


def split(lib, B, reps=5, rounds=7):
    """Cycles by phase of block 0's thread 0 for its knot (mean over the
    timed launches; a build with the phase clock only) and the median
    launch time in ms."""
    import chip_smoke  # the main path's inputs; the script sits at the repository's root

    fn = _cuda_build.bind(lib, "ffmpc_knot_diff_f32", ARGTYPES)
    clock = hasattr(lib, "ffmpc_knot_diff_phase_cycles")
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    if clock:
        read = _cuda_build.bind(lib, "ffmpc_knot_diff_phase_cycles",
                                [ctypes.POINTER(ctypes.c_ulonglong)])
    knot, consts, (xs, us, refs_run, ref_T) = chip_smoke.main_path_diff_args(B)
    out, args = kernel_args(knot, consts, refs_run, ref_T, xs, us)

    def run():
        _cuda_build.launch("knot_diff", fn, xs.device, *args)

    run()
    torch.cuda.synchronize()
    if clock and read(cycles) != 0:  # drop the warm-up's sums
        raise RuntimeError("reading the phase cycles failed")
    times = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            run()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    res = {"B": B, "N": int(us.shape[1]), "launch_ms": float(np.median(times)),
           "launch_ms_rounds": times,
           "finite_Fx_share": float(torch.isfinite(out.run.Fx).double().mean())}
    if clock:
        if read(cycles) != 0:
            raise RuntimeError("reading the phase cycles failed")
        per_knot = {p: cycles[i] / (reps * rounds) for i, p in enumerate(PHASES)}
        knot_cycles = sum(per_knot.values())
        res.update(cycles_per_knot=per_knot, knot_cycles=knot_cycles,
                   share={p: v / knot_cycles for p, v in per_knot.items()})
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", type=Path, default=_cuda_build.CSRC_DIR,
                    help="a csrc/ directory holding knot_diff.cu and its headers")
    ap.add_argument("--no-clock", dest="clock", action="store_false",
                    help="build without the phase clock; time the launches only")
    ap.add_argument("--sass", action="store_true",
                    help="count LDL/STL in each kernel's SASS")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 256, 1024])
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("diff_phase_split: needs a CUDA device")
    path = build(a.source, a.clock)
    lib = ctypes.CDLL(str(path))
    res = {"source": str(a.source), "clock": a.clock,
           "device": torch.cuda.get_device_name(0),
           "ptxas": path.with_suffix(".log").read_text()}
    if hasattr(lib, "ffmpc_knot_diff_occupancy_f32"):
        occ = _cuda_build.bind(lib, "ffmpc_knot_diff_occupancy_f32",
                               [ctypes.POINTER(ctypes.c_int)])
        n = ctypes.c_int(0)
        if occ(ctypes.byref(n)) != 0:
            raise RuntimeError("occupancy query failed")
        res["resident_blocks_per_sm_f32"] = n.value
    if a.sass:
        res["sass_local_memory"] = sass_local_memory(path)
    res["runs"] = [split(lib, B) for B in a.batch]
    for r in res["runs"]:
        line = f"B={r['B']}: {r['launch_ms']:.4f} ms a launch"
        if "knot_cycles" in r:
            line += (f"; {r['knot_cycles']:.0f} cycles a knot: "
                     + ", ".join(f"{p} {r['cycles_per_knot'][p]:.0f}" for p in PHASES))
        print(line, flush=True)
    print(json.dumps(res))
    if a.json:
        a.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
