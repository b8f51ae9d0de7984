"""Probe of this card's device math, and of the backward kernel at a small
shape.

Counterpart of ``tools/probe_mosaic.py``: where the TPU probe asked whether
its compiler lowered each transcendental the knot chain needs, this one
records what the card's single-precision math gives for them under the
package's flags (no fast-math), in the kernel ``csrc/probes.cu::math_kernel``
(one elementwise launch per op over x = linspace(-0.9, 0.9, 256) as
(2, 128)).  Each op's error is measured against float64 on the host, in ulps
of the correctly rounded float32 result, and gated at the CUDA Math API's
documented maximum ulp error for that function; its distance from the
float32 plain version (PyTorch's own op on the same card) is reported.  The
second half runs the port's backward kernel at N=4, B=128 on the probe's
own seeded inputs and holds it against its plain version.

Usage: python -m ffmpc_tpu_torch.tools.probe_mosaic [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from ..solver.backward_cuda import KERNEL_NX, backward_box, backward_box_reference
from ._probe_lib import launch, probe_fn

OPS = ("sin", "cos", "sqrt", "arccos", "arctan2", "arctan", "exp")

# Maximum ulp error of the single-precision device functions, from the CUDA
# Math API's documentation (CUDA C++ Programming Guide, appendix
# "Mathematical Functions"), for code built without fast-math and with
# -prec-sqrt=true (nvcc's defaults): sinf 2, cosf 2, sqrtf 0 (correctly
# rounded), acosf 2, atan2f 3, atanf 2, expf 2.
ULP_BOUND = {"sin": 2, "cos": 2, "sqrt": 0, "arccos": 2, "arctan2": 3,
             "arctan": 2, "exp": 2}


def probe_input(device="cuda", dtype=torch.float32):
    """The TPU probe's input: linspace(-0.9, 0.9, 256) as (2, 128)."""
    return torch.linspace(-0.9, 0.9, 256, dtype=torch.float32).reshape(2, 128).to(
        device=resolve_device(device), dtype=dtype)


def math_reference(x, op: str):
    """Plain PyTorch version of the math kernel, in ``x``'s dtype."""
    f = {"sin": torch.sin, "cos": torch.cos,
         "sqrt": lambda v: torch.sqrt(torch.abs(v)), "arccos": torch.acos,
         "arctan2": lambda v: torch.atan2(v, 1.0 + v * v), "arctan": torch.atan,
         "exp": torch.exp}[op]
    return f(x)


_OP_INDEX = {op: i for i, op in enumerate(OPS)}


def math_op(x, op: str):
    """One op over ``x`` on the kernel (CUDA float32 tensors) or, for a CPU
    tensor, the plain version.  ``math_op.launches`` counts kernel launches.
    The kernel's path is kept to one check each of dtype, contiguity and
    device, the output's allocation and one ctypes call."""
    k = _OP_INDEX.get(op)
    if k is None:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    if x.device.type == "cpu":
        return math_reference(x, op)
    if x.dtype != torch.float32:
        raise ValueError(f"math_op: x has dtype {x.dtype}; the kernel is float32")
    if not x.is_contiguous():
        raise ValueError("math_op: x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"math_op: x on unsupported device {x.device}")
    out = torch.empty_like(x)
    launch("probe math", probe_fn("math", 2, 2), x.device, x.data_ptr(), out.data_ptr(),
           x.numel(), k)
    math_op.launches += 1
    return out


math_op.launches = 0


def host_reference(x32: np.ndarray, op: str) -> np.ndarray:
    """float64 reference on the host for float32 inputs.  atan2's second
    argument is 1 + x*x formed in float32 as the kernel forms it, so only the
    function's own error is measured."""
    x64 = x32.astype(np.float64)
    if op == "arctan2":
        y32 = (x32 * x32 + np.float32(1.0)).astype(np.float32)
        return np.arctan2(x64, y32.astype(np.float64))
    f = {"sin": np.sin, "cos": np.cos, "sqrt": lambda v: np.sqrt(np.abs(v)),
         "arccos": np.arccos, "arctan": np.arctan, "exp": np.exp}[op]
    return f(x64)


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Number of float32 values between a and b (both float32)."""
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def backward_probe_inputs(nx: int = 21, dtype=torch.float32, device="cuda"):
    """The TPU probe's backward inputs (``default_rng(0)``, the same draws and
    formulas), N=4, B=128, at float32 as there, then cast to ``dtype``."""
    if nx not in KERNEL_NX:
        raise ValueError(f"the backward kernel is built for nx in {KERNEL_NX} only; got {nx}")
    NX, NU, N, B = nx, 7, 4, 128
    rng = np.random.default_rng(0)

    def r(*s):
        return rng.normal(size=s).astype(np.float32)

    def sym(M):
        return M @ np.swapaxes(M, -1, -2)

    eye_x, eye_u = np.eye(NX, dtype=np.float32), np.eye(NU, dtype=np.float32)
    Fx = eye_x[None, None] * np.ones((B, N, 1, 1), np.float32) + np.float32(0.05) * r(B, N, NX, NX)
    Fu = np.float32(0.1) * r(B, N, NX, NU)
    Lx, Lu = r(B, N, NX), r(B, N, NU)
    Lxx = sym(np.float32(0.2) * r(B, N, NX, NX)) + np.float32(0.5) * eye_x
    Lxu = np.float32(0.05) * r(B, N, NX, NU)
    Luu = sym(np.float32(0.2) * r(B, N, NU, NU)) + np.float32(0.8) * eye_u
    fs = np.float32(0.1) * r(B, N + 1, NX)
    LxT = r(B, NX)
    LxxT = sym(np.float32(0.2) * r(B, NX, NX)) + np.float32(0.5) * eye_x
    lb = np.float32(-50.0) * np.abs(r(B, N, NU)) - np.float32(1e-3)
    ub = np.float32(50.0) * np.abs(r(B, N, NU)) + np.float32(1e-3)
    regs = np.full((B,), 1e-4, np.float32)
    dev = resolve_device(device)
    return [torch.as_tensor(a, device=dev).to(dtype).contiguous()
            for a in (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, lb, ub, regs, regs)]


# backward kernel vs plain, per field against the field's largest magnitude:
# float64 at the bar of chip_smoke.py's backward check (K, w_all 5e-9; the
# fields that follow the box QP's minimizer 1e-4, its argmin sits on ties);
# float32 the gains and gap products at 1e-3 (chip_smoke.py's
# same-free-set bar; the recursion here is 4 knots, well conditioned).
BACKWARD_RTOL = {torch.float64: dict(K=5e-9, w_all=5e-9, kff=1e-4, dg=1e-4, dq=1e-4, qu2=1e-4),
                 torch.float32: dict(K=1e-3, w_all=1e-3)}
BACKWARD_FIELDS = ("K", "kff", "qu2", "dg", "dq", "bad", "w_all")


def backward_check(nx: int = 21, device="cuda"):
    """The backward kernel (``backward_box``) against ``backward_box_reference``
    on the probe's inputs, float64 and float32; per field the largest error
    relative to the field's scale, and K[0,0,0,0]."""
    res = {}
    for dtype in (torch.float64, torch.float32):
        args = backward_probe_inputs(nx, dtype, device)
        out_k = backward_box(*args, boxqp_iters=8)
        out_r = backward_box_reference(*args, boxqp_iters=8)
        rel = {}
        for name, a, b in zip(BACKWARD_FIELDS, out_k, out_r):
            if name == "bad":
                continue
            scale = max(float(b.abs().max()), 1e-30)
            rel[name] = float((a.double() - b.double()).abs().max()) / scale
        ok = bool(torch.equal(out_k[5], out_r[5])) and all(
            rel[n] <= tol for n, tol in BACKWARD_RTOL[dtype].items())
        res[str(dtype).replace("torch.", "")] = {
            "K0000": float(out_k[0][0, 0, 0, 0]), "K0000_plain": float(out_r[0][0, 0, 0, 0]),
            "max_rel_err": rel, "bad": int(out_k[5].sum()), "ok": ok}
    return res


def probe_math(device="cuda", nx: int = 21):
    """Run the probe: every op on the kernel, its ulp error against float64
    on the host (gated at ULP_BOUND), its distance from the float32 plain
    version, then the backward check.  Returns a dict; ``ok`` is the gate."""
    dev = resolve_device(device)
    x = probe_input(dev)
    x32 = x.cpu().numpy()
    ops = {}
    for op in OPS:
        out = math_op(x, op).cpu().numpy()
        plain = math_reference(x, op).cpu().numpy()
        ref64 = host_reference(x32, op)
        ulps = ulp_distance(out, ref64.astype(np.float32))
        ops[op] = {"max_ulp": int(ulps.max()), "ulp_bound": ULP_BOUND[op],
                   "max_abs_err_vs_float64": float(np.abs(out.astype(np.float64) - ref64).max()),
                   "max_ulp_vs_plain32": int(ulp_distance(out, plain).max()),
                   "max_abs_diff_vs_plain32": float(np.abs(out - plain).max()),
                   "ok": bool(ulps.max() <= ULP_BOUND[op])}
    bw = backward_check(nx, dev)
    ok = all(v["ok"] for v in ops.values()) and all(v["ok"] for v in bw.values())
    return {"ops": ops, "backward_N4_B128": bw, "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=21)
    a = ap.parse_args(argv)
    res = probe_math(a.device, a.nx)
    for op, r in res["ops"].items():
        print(f"{op}: {'OK' if r['ok'] else 'FAIL'} max {r['max_ulp']} ulp "
              f"(bound {r['ulp_bound']}), maxerr vs float64 {r['max_abs_err_vs_float64']:.2e}, "
              f"vs plain float32 {r['max_ulp_vs_plain32']} ulp", flush=True)
    for dt, r in res["backward_N4_B128"].items():
        print(f"backward kernel N=4 B=128 {dt}: {'OK' if r['ok'] else 'FAIL'} "
              f"K00={r['K0000']:.4f}", flush=True)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
