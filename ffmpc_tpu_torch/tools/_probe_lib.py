"""The probes' CUDA library (``csrc/probes.cu``) and the checks its wrappers
share."""

from __future__ import annotations

import ctypes

import torch

from ..solver._cuda_build import load_library

_fns = {}


def probe_fn(name: str, n_ptrs: int, n_ints: int):
    """``ffmpc_probe_<name>_f32`` of the probes library: ``n_ptrs`` device
    pointers, ``n_ints`` ints, then the stream; returns a cudaError code."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load_library("probes"), f"ffmpc_probe_{name}_f32")
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check_cuda_f32(name: str, **tensors):
    """Every tensor a contiguous float32 CUDA tensor on one device."""
    dev = None
    for k, a in tensors.items():
        if a.device.type != "cuda":
            raise ValueError(f"{name}: {k} on unsupported device {a.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name}: {k} has dtype {a.dtype}; the kernel is float32")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if dev is not None and a.device != dev:
            raise ValueError(f"{name}: {k} on {a.device}, others on {dev}")
        dev = a.device
    return dev


def launch(name: str, fn, dev, *args):
    """Call ``fn(*args, stream)`` on ``dev``'s current stream; raise on a
    refused launch."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
