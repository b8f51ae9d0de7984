"""What the phase-split tools (``backward_phase_split``, ``diff_phase_split``,
``rollout_phase_split``) share: the command line, the builds, the SASS
counts, the launch timing, the phase clock's sums and the runs in turns.

A tool names its kernel's source file and phase-clock define and supplies a
``launcher(lib, case, args)``: the inputs of one case (a batch size, or a
batch size and a variant) set up for ``lib``, returned as a ``Launch``.
``main`` builds every ``--source`` directory's copy of the kernel, with the
phase clock or without (``--no-clock``), and either splits the cycles of
each case by phase or, without the clock, times every source's launches in
turns (first to last and back: parent, change, change, parent for two).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..solver import _cuda_build


class Launch(NamedTuple):
    """One case of a tool, ready to launch."""
    run: Callable[[], None]            # one launch on the current stream
    knots: int                         # knot evaluations of the stamped thread a launch
    record: dict                       # what identifies the case (B, N, ...)
    extras: Callable[[], dict] = dict  # figures read from the outputs after the runs
    once: Sequence[str] = ()           # phases run once a launch, not once a knot


def parser(doc: str, default_batch=(1, 256, 1024)) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", type=Path, nargs="+", default=[_cuda_build.CSRC_DIR],
                    help="csrc/ directories holding the kernel's source and its headers")
    ap.add_argument("--no-clock", dest="clock", action="store_false",
                    help="build without the phase clock; time the launches only, in "
                         "turns over the sources")
    ap.add_argument("--sass", action="store_true",
                    help="count each kernel's SASS instructions and LDL/STL")
    ap.add_argument("--batch", type=int, nargs="+", default=list(default_batch))
    ap.add_argument("--json", type=Path, default=None)
    return ap


def sass_counts(lib: Path, clock: bool):
    """Per kernel function of ``lib``: its LDL, STL and all its SASS
    instructions, and in a stamped build the instructions between one clock
    read and the next, in program order."""
    cuobjdump = Path(_cuda_build._find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    res = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        lines = re.findall(r"/\*[0-9a-f]{4,}\*/ +([^;]*);", block)
        rec = {"LDL": len(re.findall(r"\bLDL\b", block)),
               "STL": len(re.findall(r"\bSTL\b", block)),
               "instructions": len(lines)}
        if clock:
            counts = [0]
            for line in lines:
                if "SR_CLOCKLO" in line:
                    counts.append(0)
                else:
                    counts[-1] += 1
            rec["between_clocks"] = counts
        res[name] = rec
    return res


def time_ms(run, reps=5, rounds=7):
    """Per round the mean of ``reps`` back-to-back launches (CUDA events);
    the caller has warmed up."""
    times = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            run()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return times


def phase_reader(lib, symbol: str, phases: Sequence[str]):
    """A function that returns the phase clock's sums since its last call
    (and clears them), or None for a build without the clock."""
    if not hasattr(lib, symbol):
        return None
    read = _cuda_build.bind(lib, symbol, [ctypes.POINTER(ctypes.c_ulonglong)])
    cycles = (ctypes.c_ulonglong * len(phases))()

    def sums():
        if read(cycles) != 0:
            raise RuntimeError(f"{symbol} failed")
        return list(cycles)
    return sums


def split(launch: Launch, read, phases, reps=5, rounds=7):
    """The median launch time in ms and, for a stamped build (``read``), the
    cycles by phase of the stamped thread a knot evaluation (a launch for the
    ``once`` phases), over the timed launches."""
    launch.run()
    torch.cuda.synchronize()
    if read is not None:
        read()  # drop the warm-up's sums
    times = time_ms(launch.run, reps, rounds)
    res = {**launch.record, "launch_ms": float(np.median(times)), "launch_ms_rounds": times}
    if read is not None:
        calls = reps * rounds
        per_knot = {p: c / calls / (1 if p in launch.once else launch.knots)
                    for p, c in zip(phases, read())}
        knot_cycles = sum(v for p, v in per_knot.items() if p not in launch.once)
        res.update(cycles_per_knot=per_knot, knot_cycles=knot_cycles,
                   share={p: v / knot_cycles for p, v in per_knot.items()
                          if p not in launch.once})
    res.update(launch.extras())
    return res


def in_turns(libs, cases, launcher, args):
    """The launch times of every library at every case, the libraries in
    turns: first to last, then last to first."""
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    res = []
    for case in cases:
        launches = [launcher(lib, case, args) for _, lib in libs]
        for launch in launches:
            launch.run()
        torch.cuda.synchronize()
        for i in order:
            times = time_ms(launches[i].run)
            res.append({"source": libs[i][0], **launches[i].record,
                        "launch_ms": float(np.median(times)), "launch_ms_rounds": times})
            print(f"{libs[i][0]} {label(launches[i].record)}: {res[-1]['launch_ms']:.4f} ms "
                  "a launch", flush=True)
    return res


def label(record: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in record.items())


def main(args, *, name: str, source: str, define: str, cycles: str, launcher, phases,
         cases=None, occupancy=None):
    """Build, split or time in turns, print (and with ``--json`` write) one
    JSON object.  ``source``: the kernel's file in each ``--source``
    directory, built with ``define`` for the phase clock, whose sums the
    library hands back through ``cycles``; ``phases``: the phase names, or a
    function of the library that reads them; ``cases``: the cases to run
    (the batch sizes by default); ``occupancy(lib)``: resident blocks an SM
    of the float32 build."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: needs a CUDA device")
    cases = list(args.batch) if cases is None else cases
    res = {"clock": args.clock, "device": torch.cuda.get_device_name(0), "sources": {}}
    libs = []
    for src in args.source:
        path = _cuda_build.build_variant(Path(src) / source, (define,) if args.clock else (),
                                         f"{name}_{'clock' if args.clock else 'variant'}")
        lib = ctypes.CDLL(str(path))
        info = {"ptxas": path.with_suffix(".log").read_text()}
        if occupancy is not None:
            info["resident_blocks_per_sm_f32"] = occupancy(lib)
        if args.sass:
            info["sass"] = sass_counts(path, args.clock)
        res["sources"][str(src)] = info
        libs.append((str(src), lib))
    if args.clock:
        res["runs"] = {}
        for src, lib in libs:
            names = phases(lib) if callable(phases) else list(phases)
            read = phase_reader(lib, cycles, names)
            res["runs"][src] = []
            for c in cases:
                launch = launcher(lib, c, args)
                r = split(launch, read, names)
                res["runs"][src].append(r)
                print(f"{src} {label(launch.record)}: {r['launch_ms']:.4f} ms a launch; "
                      f"{r['knot_cycles']:.0f} cycles a knot: "
                      + ", ".join(f"{p} {v:.0f}" for p, v in r["cycles_per_knot"].items()),
                      flush=True)
    else:
        res["in_turns"] = in_turns(libs, cases, launcher, args)
    print(json.dumps(res))
    if args.json:
        args.json.write_text(json.dumps(res, indent=1))
    return 0
