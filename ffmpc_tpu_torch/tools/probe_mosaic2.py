"""Probe of per-lane knot streaming with the backward step's compute body,
in six stages.

Counterpart of ``tools/probe_mosaic2.py`` (its two ``pallas_call`` sites:
line 202 runs stages 1-5, line 171 stage 6).  Each stage computes what its
TPU body computes, on the same shapes (nx=21, nu=7, N=4, Bt=128 lanes,
C=1288 channels a knot, float32, knots drawn from ``default_rng(0)``):

  1  stream the knots backward (t = N-1 .. 0), accumulate rows 0:8;
  2  + Quu / Qu assembly with Vxx = Fx;
  3  + the 4-iteration box QP on [-Lu-5, -Lu+5] and the Cholesky gain solve;
  4  stage 1 plus the per-knot copy of rows 0:441 to ``big``;
  5  the backward step with a carried 21x21 Vxx (from I), the masked SPD
     gain and kff solves, the symmetrized Vxx_new + 1e-6 I written to ``big``
     per knot, out = Vxx rows 0:8;
  6  the full I/O signature: a second (64, Bt) input, three per-knot outputs
     (``big``, ``k``, ``kff``).

Layouts are the TPU probe's (channel-major, lane fastest): knots (N, C, Bt),
out (8, Bt), big (N, 448, Bt), k (N, 152, Bt), kff (N, 8, Bt).  Rows a stage
does not write are zero.  The kernel is ``csrc/probes.cu::stream_kernel``
(the backward-step stages 2, 3 and 5 on 128 threads a lane, their arithmetic
in ``csrc/probe_stream.cuh``; the copies and zero rows spread over the card;
every output row written, so a call is one launch); ``stream_reference`` is
its plain version.  Stage 5 starts from Vx = 0, Vxx = I (the TPU body
multiplied its uninitialized scratch by 0).

On the probe's random knots stage 3 is NaN in every lane (Fx is far from
SPD, so Quu is indefinite and the Cholesky fails), as on the TPU.  So stage 3
also runs on a second input, ``spd_knots``: the same knots with each Fx
conditioned as stage 5 conditions it, where every output is finite.

Usage: python -m ffmpc_tpu_torch.tools.probe_mosaic2 [stage ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from ..core.smallchol import spd_solve
from ..solver.boxqp import _masked_solve, boxqp
from ._probe_lib import check_cuda_f32, launch, probe_fn

NX, NU, N, BT, C = 21, 7, 4, 128, 1288
NXXP, NK, NKFF, TERM_ROWS = 448, 152, 8, 64
OFF_FU, OFF_LU = NX * NX, 1000
STAGES = (1, 2, 3, 4, 5, 6)
MAX_ELEMENTS = 2**31 - 1    # the kernel's element offsets are 32-bit


def probe_inputs(device="cuda", seed: int = 0):
    """(knots (N, C, Bt), term (64, Bt)) float32, drawn in the TPU probe's
    order from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    knots = rng.normal(size=(N, C, BT)).astype(np.float32)
    term = rng.normal(size=(TERM_ROWS, BT)).astype(np.float32)
    dev = resolve_device(device)
    return torch.as_tensor(knots, device=dev), torch.as_tensor(term, device=dev)


def spd_knots(knots):
    """``knots`` with each knot's Fx block replaced by 0.05 Fx + 0.9 I (stage
    5's conditioning).  Its symmetric part is then positive definite, so
    stage 3's Quu = Fu^T Fx Fu + 0.5 I is SPD and its box QP and Cholesky
    gain solve are finite in every lane."""
    n_knots, _, Bt = knots.shape
    out = knots.clone()
    fx = knots[:, :NX * NX].reshape(n_knots, NX, NX, Bt)
    eye = torch.eye(NX, dtype=knots.dtype, device=knots.device)[None, :, :, None]
    out[:, :NX * NX] = (0.05 * fx + 0.9 * eye).reshape(n_knots, NX * NX, Bt)
    return out


def stream_reference(knots, stage: int, term=None):
    """Plain PyTorch version of stage ``stage``, in ``knots``' dtype.
    Returns dict(out, big) and, for stage 6, k and kff."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage}: one of {STAGES}")
    n_knots, _, Bt = knots.shape
    kw = dict(dtype=knots.dtype, device=knots.device)
    X = knots.transpose(1, 2)                          # (N, Bt, C): lane-leading
    eye_x, eye_u = torch.eye(NX, **kw), torch.eye(NU, **kw)
    acc = torch.zeros(Bt, 8, **kw)
    big = torch.zeros(n_knots, Bt, NXXP, **kw)
    k_out = torch.zeros(n_knots, Bt, NK, **kw)
    kff_out = torch.zeros(n_knots, Bt, NKFF, **kw)
    Vxx = eye_x.expand(Bt, NX, NX)
    Vx = torch.zeros(Bt, NX, **kw)
    base = term[:NX].T if stage == 6 else None
    zeros_u = torch.zeros(Bt, NU, **kw)

    def mT(a):
        return a.transpose(-1, -2)

    def mv(A, x):
        return (A @ x[..., None])[..., 0]

    for t in range(n_knots - 1, -1, -1):
        s = X[t]
        Fx = s[:, :NX * NX].reshape(Bt, NX, NX)
        Fu = s[:, OFF_FU:OFF_FU + NX * NU].reshape(Bt, NX, NU)
        if stage == 6:
            v = mv(mT(Fu * 0.1), s[:, :NX] + base)
            big[t, :, :NX * NX] = s[:, :NX * NX]
            k_out[t, :, :NU * NX] = s[:, :NU * NX]
            kff_out[t, :, :NU] = v
            acc = acc + v[:, :1] * 0.0 + s[:, :8]
            continue
        if stage == 5:
            Fx = Fx * 0.05 + 0.9 * eye_x
            Fu = Fu * 0.1
            W, U = Vxx @ Fx, Vxx @ Fu
            Qxx = 0.7 * eye_x + mT(Fx) @ W
            Qxu = mT(Fx) @ U
            Quu = mT(Fu) @ U + eye_u
            Qx = mv(mT(Fx), Vx)
            Qu = mv(mT(Fu), Vx) + s[:, 8:8 + NU]
            free = Qu < 1e9
            fm = free.to(knots.dtype)
            K = _masked_solve(Quu, mT(Qxu) * fm[..., None], free, 1e-9)
            kff = -_masked_solve(Quu, Qu * fm, free, 1e-9)
            Quuk = mv(Quu, kff)
            Vx = Qx + mv(mT(K), Quuk - 2.0 * Qu)
            Vn = Qxx - Qxu @ K
            Vxx = 0.5 * (Vn + mT(Vn)) + 1e-6 * eye_x
            big[t, :, :NX * NX] = Vxx.reshape(Bt, NX * NX)
            continue
        if stage >= 4:
            big[t, :, :NX * NX] = s[:, :NX * NX]
        if stage in (1, 4):
            acc = acc + s[:, :8]
            continue
        Lu = s[:, OFF_LU:OFF_LU + NU]
        U = Fx @ Fu
        Quu = mT(Fu) @ U + 0.5 * eye_u
        Qu = Lu + mv(mT(Fu), mv(Fx, s[:, 8:8 + NX]))
        if stage == 2:
            acc[:, :NU] = acc[:, :NU] + Quu[:, 0, :] * 0.0 + Qu
            continue
        x = boxqp(Quu, Qu, -Lu - 5.0, -Lu + 5.0, zeros_u, iters=4, reg=1e-9).x
        Kx = spd_solve(Quu + eye_u, U[:, :NU, :])
        acc[:, :NU] = acc[:, :NU] + x + Kx[:, 0, :] * 0.0

    if stage == 5:
        acc = Vxx.reshape(Bt, NX * NX)[:, :8]
    res = {"out": acc.T.contiguous(), "big": big.transpose(1, 2).contiguous()}
    if stage == 6:
        res["k"] = k_out.transpose(1, 2).contiguous()
        res["kff"] = kff_out.transpose(1, 2).contiguous()
    return res


def stream_stage(knots, stage: int, term=None):
    """Stage ``stage`` on the kernel (CUDA float32 tensors) or, for CPU
    tensors, the plain version.  ``stream_stage.launches[stage]`` counts
    the kernel launches of each stage."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage}: one of {STAGES}")
    if stage == 6 and term is None:
        raise ValueError("stage 6 takes the (64, Bt) second input `term`")
    if knots.dim() != 3 or knots.shape[1] < OFF_LU + NU:
        raise ValueError(f"knots must be (N, C >= {OFF_LU + NU}, Bt); got {tuple(knots.shape)}")
    n_knots, n_ch, Bt = knots.shape
    if term is not None and tuple(term.shape) != (TERM_ROWS, Bt):
        raise ValueError(f"term must be ({TERM_ROWS}, {Bt}); got {tuple(term.shape)}")
    if knots.device.type == "cpu":
        return stream_reference(knots, stage, term)
    if knots.numel() > MAX_ELEMENTS:
        raise ValueError(f"stream_stage: knots has {knots.numel()} elements; the kernel "
                         f"indexes at most {MAX_ELEMENTS} elements with 32-bit offsets")
    tensors = dict(knots=knots) if stage != 6 else dict(knots=knots, term=term)
    dev = check_cuda_f32("stream_stage", **tensors)
    kw = dict(dtype=torch.float32, device=dev)
    # the kernel writes every row, the zero rows too
    res = {"out": torch.empty(8, Bt, **kw), "big": torch.empty(n_knots, NXXP, Bt, **kw)}
    if stage == 6:
        res["k"] = torch.empty(n_knots, NK, Bt, **kw)
        res["kff"] = torch.empty(n_knots, NKFF, Bt, **kw)

    def ptr(name):
        return res[name].data_ptr() if name in res else None

    launch("probe stream", probe_fn("stream", 6, 4), dev, knots.data_ptr(),
           term.data_ptr() if stage == 6 else None, ptr("out"), ptr("big"), ptr("k"),
           ptr("kff"), n_knots, n_ch, Bt, stage)
    stream_stage.launches[stage] += 1
    return res


stream_stage.launches = dict.fromkeys(STAGES, 0)

# Kernel vs plain version, per output, max|kernel - plain| over the entries
# finite in both against max(max|plain float64|, 1), with the same entries
# non-finite in both.  Stages 1, 4 and 6 copy values and sum them in the
# plain version's order: exact, except stage 6's kff (21-term dot products,
# another summation order: 1e-6).  Stages 2, 3 and 5 chain 21-term products
# and 7x7 Cholesky solves at float32: 1e-5, about 20x the plain float32
# version's own distance from float64 on these inputs (at most 5.7e-7, stage
# 5), which is printed beside.  Stage 3 is NaN in every lane on the probe's
# input (random Fx makes Quu indefinite, so the Cholesky fails), as on the
# TPU: there it holds the kernel to the plain version's NaN pattern only.  On
# ``spd_knots`` every output must be finite in both versions and within
# STREAM_TOL[3].
STREAM_TOL = {1: 0.0, 2: 1e-5, 3: 1e-5, 4: 0.0, 5: 1e-5, 6: 1e-6}


def compare(res_k, res_p, res_64):
    """Per output: (max|k - p| / scale, max|p - p64| / scale, non-finite sets
    equal)."""
    rec = {}
    for name, p64 in res_64.items():
        k, p = res_k[name].double(), res_p[name].double()
        both = torch.isfinite(k) & torch.isfinite(p)
        fin = torch.isfinite(p64)
        scale = max(float(p64[fin].abs().max()) if bool(fin.any()) else 1.0, 1.0)
        err = float((k - p)[both].abs().max()) if bool(both.any()) else 0.0
        yard_m = torch.isfinite(p) & fin
        yard = float((p - p64)[yard_m].abs().max()) if bool(yard_m.any()) else 0.0
        rec[name] = {"max_abs_err": err, "rel_err": err / scale,
                     "plain32_vs_plain64": yard / scale,
                     "nonfinite_equal": bool(torch.equal(~torch.isfinite(k), ~torch.isfinite(p))),
                     "nonfinite": int((~torch.isfinite(p)).sum())}
    return rec


def run_stage(knots, stage: int, term=None, finite: bool = False, kernel=None):
    """One stage on the kernel (``kernel(knots, stage, term)``, by default
    ``stream_stage``) against the plain version (float32, and float64 as the
    yardstick).  ``finite`` also requires every output of both versions to be
    finite."""
    res_k = (kernel or stream_stage)(knots, stage, term)
    res_p = stream_reference(knots, stage, term)
    res_64 = stream_reference(knots.double(), stage, None if term is None else term.double())
    cmp = compare(res_k, res_p, res_64)
    ok = all(c["nonfinite_equal"] and c["rel_err"] <= STREAM_TOL[stage]
             and (c["nonfinite"] == 0 or not finite) for c in cmp.values())
    return {"sum": float(res_k["out"].double().sum()), "big0": float(res_k["big"][0, 0, 0]),
            "tol": STREAM_TOL[stage], "outputs": cmp, "ok": ok}


def probe_stream(stages=STAGES, device="cuda", seed: int = 0):
    """Run the given stages on the kernel and hold each against the plain
    version on the probe's inputs; stage 3 also on ``spd_knots`` (under
    ``"spd"``, finite outputs required).  Returns a dict per stage; ``ok``
    is the gate."""
    knots, term = probe_inputs(device, seed)
    out = {}
    for st in stages:
        out[st] = run_stage(knots, st, term if st == 6 else None)
        if st == 3:
            out[st]["spd"] = spd = run_stage(spd_knots(knots), 3, finite=True)
            out[st]["ok"] = out[st]["ok"] and spd["ok"]
    return {"stages": out, "ok": all(v["ok"] for v in out.values())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("stages", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    res = probe_stream(tuple(a.stages) or STAGES, a.device)
    for st, r in res["stages"].items():
        for name, rr in (("", r), (" (spd knots)", r.get("spd"))):
            if rr is None:
                continue
            worst = max(c["rel_err"] for c in rr["outputs"].values())
            print(f"stage {st}{name}: {'OK' if rr['ok'] else 'FAIL'} sum={rr['sum']:.3f} "
                  f"big0={rr['big0']:.3f} max rel err vs plain {worst:.2e} (tol {rr['tol']})",
                  flush=True)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
