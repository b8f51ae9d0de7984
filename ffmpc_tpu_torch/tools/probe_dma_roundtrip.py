"""Probe of the bulk asynchronous copy path: a per-knot round trip through
shared memory, checked byte for byte.

Counterpart of ``tools/probe_dma_roundtrip.py``: the TPU probe copied each
knot's (C, Bt) tile from device memory into VMEM with an async copy, wrote
2 x tile back with another, accumulated rows 0:8, and compared on the host.
Here the kernel ``csrc/probes.cu::roundtrip_kernel`` does the same with
Hopper's bulk asynchronous copy (``cp.async.bulk``, one 512-byte row a copy,
started by up to 32 threads and completing on an ``mbarrier``; the stores as
bulk groups), pipelined over a two-stage ring so that the next knots' loads
are in flight while a knot is doubled and stored, with blocks over lane tiles
and 8-channel chunks: the pattern a streaming backward kernel would use.
Shapes N=4, C=64, B=256, Bt=128, float32, knots from ``default_rng(0)``.  The pass criterion is the TPU
probe's own: the round trip byte-exact (``err == 0.0``) and ``acc`` within
1e-5.

Usage: python -m ffmpc_tpu_torch.tools.probe_dma_roundtrip [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from ._probe_lib import check_cuda_f32, launch, probe_fn

N, C, B, BT = 4, 64, 256, 128
ACC_TOL = 1e-5


def probe_inputs(device="cuda", seed: int = 0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(N, C, B)).astype(np.float32),
                           device=resolve_device(device))


def roundtrip_reference(knots, bt: int = BT):
    """Plain PyTorch version: (2 x knots, the sum over knots N-1 .. 0 of
    rows 0:8)."""
    acc = torch.zeros(8, knots.shape[2], dtype=knots.dtype, device=knots.device)
    for t in range(knots.shape[0] - 1, -1, -1):
        acc = acc + knots[t, :8]
    return knots * 2.0, acc


def roundtrip(knots, bt: int = BT):
    """The round trip on the kernel (CUDA float32 tensors; B a multiple of
    ``bt``, rows of ``bt`` floats a multiple of 16 bytes) or, for a CPU
    tensor, the plain version.  ``roundtrip.launches`` counts kernel
    launches."""
    if knots.dim() != 3 or knots.shape[1] < 8:
        raise ValueError(f"knots must be (N, C >= 8, B); got {tuple(knots.shape)}")
    n_knots, n_ch, nb = knots.shape
    if nb % bt or (bt * 4) % 16 or not 0 < bt <= 1024:
        raise ValueError(f"B={nb} must be a multiple of Bt={bt}, Bt*4 bytes of 16, Bt <= 1024")
    if knots.device.type == "cpu":
        return roundtrip_reference(knots, bt)
    dev = check_cuda_f32("roundtrip", knots=knots)
    out = torch.empty_like(knots)
    acc = torch.empty(8, nb, dtype=torch.float32, device=dev)
    launch("probe roundtrip", probe_fn("roundtrip", 3, 4), dev, knots.data_ptr(),
           out.data_ptr(), acc.data_ptr(), n_knots, n_ch, nb, bt)
    roundtrip.launches += 1
    return out, acc


roundtrip.launches = 0


def probe_roundtrip(device="cuda", seed: int = 0):
    """Run the probe: the kernel's round trip against 2 x knots (exact) and
    its accumulator against the host's float32 sum (ACC_TOL), and the
    distance from the plain version.  ``ok`` is the gate."""
    knots = probe_inputs(device, seed)
    out, acc = roundtrip(knots)
    out_p, acc_p = roundtrip_reference(knots)
    k = knots.cpu().numpy()
    err = float(np.abs(out.cpu().numpy() - 2.0 * k).max())
    acc_err = float(np.abs(acc.cpu().numpy() - k[:, 0:8, :].sum(axis=0)).max())
    return {"roundtrip_maxerr": err, "acc_maxerr": acc_err,
            "vs_plain": {"out": float((out - out_p).abs().max()),
                         "acc": float((acc - acc_p).abs().max())},
            "ok": err == 0.0 and acc_err < ACC_TOL}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    res = probe_roundtrip(a.device)
    print(f"roundtrip maxerr: {res['roundtrip_maxerr']:.3e}   acc maxerr: {res['acc_maxerr']:.3e}")
    print(json.dumps(res))
    print("PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
