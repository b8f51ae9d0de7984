"""The probes' CUDA library (``csrc/probes.cu``) and the checks its wrappers
share.  The launch path itself is ``solver/_cuda_build.py::launch``."""

from __future__ import annotations

import ctypes

import torch

from ..solver._cuda_build import bind, launch, load_library

__all__ = ["check_cuda_f32", "launch", "probe_fn"]


def probe_fn(name: str, n_ptrs: int, n_ints: int):
    """``ffmpc_probe_<name>_f32`` of the probes library: ``n_ptrs`` device
    pointers, ``n_ints`` ints, then the stream; returns a cudaError code."""
    return bind(load_library("probes"), f"ffmpc_probe_{name}_f32",
                [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p])


def check_cuda_f32(name: str, **tensors):
    """Every tensor a contiguous float32 CUDA tensor on one device."""
    dev = None
    for k, a in tensors.items():
        if a.dtype != torch.float32:
            raise ValueError(f"{name}: {k} has dtype {a.dtype}; the kernel is float32")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if a.device.type != "cuda":
            raise ValueError(f"{name}: {k} on unsupported device {a.device}")
        if dev is not None and a.device != dev:
            raise ValueError(f"{name}: {k} on {a.device}, others on {dev}")
        dev = a.device
    return dev
