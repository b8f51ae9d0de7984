"""Kernel-alone times of the stream and round-trip probe kernels, for one or
more builds of ``csrc/probes.cu``, in turns.

Each ``--source`` directory's ``probes.cu`` (this package's ``csrc/``, or
another revision's copy with the same C interface, e.g. the parent's from
``git archive HEAD ffmpc_tpu_torch/csrc``) is built and driven through the C interface (``ffmpc_probe_stream_f32``,
``ffmpc_probe_roundtrip_f32``) on the probes' inputs, with outputs allocated
once (zeroed, since an older build may leave rows unwritten).  For each stream
stage and for the round trip, every build is timed in turns, first to last
and back: ``device_ms``, the device time of one launch (20 launches captured
in one CUDA graph, the replay timed with CUDA events), and ``launch_ms``, the
host's launch interval (CUDA events around 5 back-to-back launches).  Each
build's outputs are held against the first build's (the largest difference
over the entries finite in both, and whether the same entries are
non-finite), and ptxas' registers, stack frame and spills are printed for
each kernel of each build.

Usage (from the repo root: the timers are chip_smoke.py's):
  python -m ffmpc_tpu_torch.tools.probe_timing \\
      --source _archive_check/parent/ffmpc_tpu_torch/csrc ffmpc_tpu_torch/csrc \\
      --json chiprun_out/probe_timing.json
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..solver import _cuda_build
from . import probe_dma_roundtrip as prt
from . import probe_mosaic2 as pstream

STREAM_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
ROUNDTRIP_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def build(source: str):
    """(library path, loaded library) of ``source/probes.cu``."""
    path = _cuda_build.build_variant(Path(source) / "probes.cu", (), "probes_timing")
    return path, ctypes.CDLL(str(path))


def cases(lib, device):
    """{case: (one launch, its outputs)} of one build on the probes' inputs."""
    stream = _cuda_build.bind(lib, "ffmpc_probe_stream_f32", STREAM_ARGTYPES)
    roundtrip = _cuda_build.bind(lib, "ffmpc_probe_roundtrip_f32", ROUNDTRIP_ARGTYPES)
    knots, term = pstream.probe_inputs(device)
    n_knots, n_ch, Bt = knots.shape
    zeros = dict(dtype=torch.float32, device=knots.device)
    res = {}
    for st in pstream.STAGES:
        outs = {"out": torch.zeros(8, Bt, **zeros),
                "big": torch.zeros(n_knots, pstream.NXXP, Bt, **zeros)}
        if st == 6:
            outs.update(k=torch.zeros(n_knots, pstream.NK, Bt, **zeros),
                        kff=torch.zeros(n_knots, pstream.NKFF, Bt, **zeros))
        ptrs = [outs[n].data_ptr() if n in outs else None for n in ("out", "big", "k", "kff")]
        args = (knots.data_ptr(), term.data_ptr() if st == 6 else None, *ptrs,
                n_knots, n_ch, Bt, st)
        res[f"stream_{st}"] = (
            lambda args=args: _cuda_build.launch("probe stream", stream, knots.device, *args),
            outs)
    rk = prt.probe_inputs(device)
    out, acc = torch.zeros_like(rk), torch.zeros(8, rk.shape[2], **zeros)
    args = (rk.data_ptr(), out.data_ptr(), acc.data_ptr(), *rk.shape, prt.BT)
    res["roundtrip"] = (
        lambda: _cuda_build.launch("probe roundtrip", roundtrip, rk.device, *args),
        {"out": out, "acc": acc})
    return res


def measured(timer, run):
    """``timer(run)``, or the error it raised (a figure, not a gate: an older
    build may do what a graph capture refuses)."""
    try:
        return timer(run)
    except Exception as e:  # recorded, not gated
        return f"not measured: {type(e).__name__}: {e}"


def mean_of(values):
    values = list(values)
    if all(isinstance(v, float) for v in values):
        return float(np.mean(values))
    return "not measured"


def agreement(outs, first):
    """Per output: max |a - b| over the entries finite in both, and whether
    the same entries are non-finite."""
    rec = {}
    for name, a in outs.items():
        b = first[name]
        both = torch.isfinite(a) & torch.isfinite(b)
        rec[name] = {"max_abs_diff": float((a - b)[both].abs().max()) if bool(both.any()) else 0.0,
                     "nonfinite_equal": bool(torch.equal(~torch.isfinite(a), ~torch.isfinite(b)))}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", nargs="+", default=[str(_cuda_build.CSRC_DIR)],
                    help="csrc/ directories holding probes.cu and its headers")
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_timing: needs a CUDA device")
    from chip_smoke import cuda_time_ms, graph_time_ms, ptxas_usage

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(a.source)) as ex:   # one nvcc a build, all at once
        built = list(ex.map(build, a.source))
    builds = []
    for label, (path, lib) in zip(a.source, built):
        usage = [r for r in ptxas_usage(path.with_suffix(".log").read_text())
                 if "stream_kernel" in r["function"] or "roundtrip_kernel" in r["function"]]
        for r in usage:
            print(f"{label} {r['function']}: {r.get('registers')} registers, "
                  f"{r.get('stack_frame_bytes')} B stack, "
                  f"{r.get('spill_store_bytes')} B spill stores, "
                  f"{r.get('spill_load_bytes')} B spill loads", flush=True)
        builds.append({"label": label, "ptxas": usage, "cases": cases(lib, "cuda")})
    order = list(range(len(builds))) + list(reversed(range(len(builds))))
    runs = []
    for case in builds[0]["cases"]:
        for i in order:
            run = builds[i]["cases"][case][0]
            runs.append({"case": case, "build": builds[i]["label"],
                         "device_ms": measured(graph_time_ms, run),
                         "launch_ms": measured(cuda_time_ms, run)})
            print(f"{case} {builds[i]['label']}: device {runs[-1]['device_ms']} ms, "
                  f"launch interval {runs[-1]['launch_ms']} ms", flush=True)
    torch.cuda.synchronize()
    summary = {}
    for case in builds[0]["cases"]:
        first = builds[0]["cases"][case][1]
        for bld in builds:
            turns = [r for r in runs if r["case"] == case and r["build"] == bld["label"]]
            summary.setdefault(case, {})[bld["label"]] = {
                "device_ms": mean_of(r["device_ms"] for r in turns),
                "launch_ms": mean_of(r["launch_ms"] for r in turns),
                "vs_first_build": agreement(bld["cases"][case][1], first)}
    res = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
           "builds": [{"label": b["label"], "ptxas": b["ptxas"]} for b in builds],
           "in_turns": runs, "summary": summary}
    print(json.dumps(res), flush=True)
    if a.json:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
