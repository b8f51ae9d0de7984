"""Where one knot of the backward-sweep kernel spends its cycles.

Builds a backward-sweep source (default ``csrc/backward_sweep.cu``) with
``-DFFMPC_BACKWARD_PHASE_CLOCK``: ``clock64()`` stamps on block 0's thread 0
sum the cycles of each phase of a knot over the sweep (``PHASES``; thread 0
runs the box QP, so a phase's cycles include its barrier waits).  The build
goes to ``ffmpc_tpu_torch/_build/`` beside the package's own libraries and
exports the same C interface plus ``ffmpc_backward_phase_cycles``.  Runs the
kernel at N=40 on seeded inputs (bounds active and inactive, the recipe of
the package's CPU tests) at each batch size, and prints per-knot cycles by
phase and the launch's time (CUDA events; the stamps add a few cycles a
phase).  With ``--no-clock`` the source is built as the package builds it
and only the launch is timed: that times another revision's kernel beside
this one on the same card (e.g. a source taken with ``git archive``).
Needs a card and nvcc.

Usage: python -m ffmpc_tpu_torch.tools.backward_phase_split
           [--source FILE] [--no-clock] [--batch 1 256] [--horizon 40]
           [--json OUT]
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from ..solver import _cuda_build

PHASES = ("input_wait", "w_products", "quu_qu", "box_qp_and_gain_factor", "gains",
          "value_update", "w_and_accumulators", "terminal")
NX, NU = 21, 7


def build(source: Path, clock: bool = True) -> Path:
    """The library built from ``source``, with the phase clock or without
    (cached by content and flags)."""
    return _cuda_build.build_variant(
        source, ("-DFFMPC_BACKWARD_PHASE_CLOCK",) if clock else (), "backward_phase")


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


def split(lib, B, N, tight, reps=5):
    """Per-knot cycles by phase of block 0 (mean over ``reps`` launches; a
    build with the phase clock only) and the mean launch time in ms."""
    fn = lib.ffmpc_backward_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 3 + [ctypes.c_double,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    clock = hasattr(lib, "ffmpc_backward_phase_cycles")
    if clock:
        read = lib.ffmpc_backward_phase_cycles
        read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        read.restype = ctypes.c_int
    else:
        def read(_):
            return 0
    args = seeded_args(B, N, tight, seed=1 if tight else 0)
    f = torch.float32
    outs = [torch.empty(B, N, NU, NX, dtype=f, device="cuda"),
            torch.empty(B, N, NU, dtype=f, device="cuda"),
            *(torch.empty(B, dtype=f, device="cuda") for _ in range(3)),
            torch.empty(B, dtype=torch.bool, device="cuda"),
            torch.empty(B, N + 1, NX, dtype=f, device="cuda")]
    stream = torch.cuda.current_stream().cuda_stream
    cycles = (ctypes.c_ulonglong * 8)()

    def run():
        err = fn(*(a.data_ptr() for a in args), *(o.data_ptr() for o in outs), B, N, 8,
                 1e-12, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")

    run()
    torch.cuda.synchronize()
    read(cycles)  # drop the warm-up's sums
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    torch.cuda.synchronize()
    if read(cycles) != 0:
        raise RuntimeError("reading the phase cycles failed")
    res = {"B": B, "N": N, "bounds": "active" if tight else "inactive",
           "launch_ms": e0.elapsed_time(e1) / reps, "bad": int(outs[5].sum())}
    if clock:
        per_knot = {p: cycles[i] / reps / (1 if p == "terminal" else N)
                    for i, p in enumerate(PHASES)}
        knot = sum(v for p, v in per_knot.items() if p != "terminal")
        res.update(cycles_per_knot=per_knot, knot_cycles=knot,
                   share={p: per_knot[p] / knot for p in PHASES if p != "terminal"})
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", type=Path, default=_cuda_build.CSRC_DIR / "backward_sweep.cu")
    ap.add_argument("--no-clock", dest="clock", action="store_false",
                    help="build without the phase clock; time the launches only")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 256])
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("backward_phase_split: needs a CUDA device")
    lib = ctypes.CDLL(str(build(a.source.resolve(), a.clock)))
    res = {"source": str(a.source), "device": torch.cuda.get_device_name(0),
           "runs": [split(lib, B, a.horizon, tight) for B in a.batch for tight in (False, True)]}
    for r in res["runs"]:
        split_ = ""
        if "knot_cycles" in r:
            split_ = (f"; {r['knot_cycles']:.0f} cycles a knot: "
                      + ", ".join(f"{p} {r['cycles_per_knot'][p]:.0f}" for p in PHASES))
        print(f"B={r['B']} bounds {r['bounds']}: {r['launch_ms']:.4f} ms a launch{split_}",
              flush=True)
    print(json.dumps(res))
    if a.json:
        a.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
