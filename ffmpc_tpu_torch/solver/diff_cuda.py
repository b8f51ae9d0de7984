"""FDDP derivative pass: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of ``ffmpc_tpu/solver/diff_pallas.py``.  Both functions here
give, for every problem of a batch, the Gauss-Newton derivatives of its N
running knots and of its terminal knot:

    inputs   xs (B,N+1,nx)  us (B,N,nu)
             refs_run: ProblemRefs with leading dims (B,N); ref_T: leading (B,)
    outputs  KnotDerivs(run=KnotDeriv with leading dims (B,N),
                        cost_T (B,), LxT (B,nx), LxxT (B,nx,nx))

``diff_all`` launches the hand-written kernel ``csrc/knot_diff.cu`` (the
augmented knot, nx = 21) or ``csrc/knot_diff_classical.cu`` (the classical
knot, nx = 14), and for the point contact (``contact_model="point3d"``)
``csrc/knot_diff_point3d.cu`` or ``csrc/knot_diff_classical_point3d.cu``,
all ``csrc/knot_diff.cuh`` with device code
``csrc/knot_chain.cuh::diff_primal``, ``diff_column`` and
``diff_lxx_column``, for CUDA tensors, or raises, and
uses ``diff_reference`` only for CPU tensors.  ``diff_reference`` is the
knot's own ``diff`` over the (B, N) running knots and ``term_diff`` over the
B terminal ones: what the kernel is held against, and what
``diff_mode="plain"`` runs.  Every output of ``diff_all`` is a new contiguous
tensor in the layout the backward sweep reads.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ocp.action import KnotDeriv, KnotModel
from ..ocp.weights import ProblemRefs
from ._cuda_build import bind, launch, load_library
from .rollout_cuda import (FAMILY_NX, KERNEL_NU, check_refs, consts_len, contact_of,
                           family_of, kernel_library, library_stem)


class KnotDerivs(NamedTuple):
    run: KnotDeriv          # running knots, leading dims (B, N)
    cost_T: torch.Tensor    # (B,) terminal cost
    LxT: torch.Tensor       # (B, nx)
    LxxT: torch.Tensor      # (B, nx, nx)


def _check_args(refs_run, ref_T, xs, us):
    if xs.dim() != 3 or us.dim() != 3:
        raise ValueError("xs must be (B,N+1,nx) and us (B,N,nu)")
    B, N, nu = us.shape
    nx = xs.shape[2]
    if tuple(xs.shape) != (B, N + 1, nx):
        raise ValueError(f"xs: shape {tuple(xs.shape)}, expected {(B, N + 1, nx)}")
    if us.dtype != xs.dtype or us.device != xs.device:
        raise ValueError(f"us: dtype/device {us.dtype}/{us.device} differ from "
                         f"xs's {xs.dtype}/{xs.device}")
    check_refs(refs_run, ref_T, B, N, xs)
    return B, N, nx, nu


def diff_reference(knot: KnotModel, refs_run: ProblemRefs, ref_T: ProblemRefs,
                   xs, us) -> KnotDerivs:
    """Plain PyTorch derivative pass (see the module docstring for shapes)."""
    derivs = knot.diff(refs_run, xs[:, :-1], us)
    cost_T, LxT, LxxT = knot.term_diff(ref_T, xs[:, -1])
    return KnotDerivs(derivs, cost_T, LxT, LxxT)


KNOTS_PER_BLOCK = 32   # csrc/knot_diff.cu: a block's knots, running or terminal

# the C function's arguments: consts, n_consts, xs, us, refs, refs_T, outs,
# B, N, surface, stream
ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _kernel_fn(dtype, family="augmented", contact="normal_1d"):
    lib, prefix = kernel_library("knot_diff", family, dtype, contact)
    return bind(lib, f"{prefix}_{_SUFFIX[dtype]}", ARGTYPES)


def resident_blocks_per_sm(dtype=torch.float32, family: str = "augmented",
                           contact: str = "normal_1d") -> int:
    """Blocks of the kernel (224 threads, 32 knots each) that one SM holds
    at once, as launched (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    with its shared memory); needs a card."""
    stem = library_stem("knot_diff", family, contact)
    fn = bind(load_library(stem), f"ffmpc_{stem}_occupancy_{_SUFFIX[dtype]}",
              [ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    err = fn(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"knot_diff occupancy query failed: cudaError {err}")
    return n.value


def kernel_args(knot: KnotModel, consts: torch.Tensor, refs_run: ProblemRefs,
                ref_T: ProblemRefs, xs, us):
    """Checks CUDA inputs as the kernel takes them and allocates the outputs.
    Returns (outputs, the C function's arguments before the stream): what
    ``diff_all`` launches, and what a measurement build of the kernel
    (``tools/diff_phase_split.py``) is called with."""
    B, N, nx, nu = _check_args(refs_run, ref_T, xs, us)
    if xs.device.type != "cuda":
        raise ValueError(f"diff_all: unsupported device {xs.device}")
    family, contact = family_of(knot), contact_of(knot)
    if (nx, nu) != (FAMILY_NX[family], KERNEL_NU):
        raise ValueError(f"diff_all: the kernel is built for nx={FAMILY_NX[family]}, "
                         f"nu={KERNEL_NU} ({family} knot); got nx={nx}, nu={nu}")
    dtype = xs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"diff_all: unsupported dtype {dtype}")
    if B < 1 or N < 1:
        raise ValueError(f"diff_all: empty batch or horizon (B={B}, N={N})")
    if consts.dtype != dtype or consts.device.type != "cpu" \
            or consts.numel() != consts_len(family, contact) or not consts.is_contiguous():
        raise ValueError(f"diff_all: consts must be pack_knot_consts(..., family={family!r}) "
                         f"of the {contact} contact in the states' dtype {dtype}")
    tensors = dict(xs=xs, us=us)
    for f in ProblemRefs._fields:
        tensors[f"refs_run.{f}"] = getattr(refs_run, f)
        tensors[f"ref_T.{f}"] = getattr(ref_T, f)
    for name, a in tensors.items():
        if not a.is_contiguous():
            raise ValueError(f"diff_all: {name} must be contiguous")

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=xs.device)

    run = KnotDeriv(xnext=empty(B, N, nx), cost=empty(B, N), Fx=empty(B, N, nx, nx),
                    Fu=empty(B, N, nx, nu), Lx=empty(B, N, nx), Lu=empty(B, N, nu),
                    Lxx=empty(B, N, nx, nx), Lxu=empty(B, N, nx, nu),
                    Luu=empty(B, N, nu, nu))
    out = KnotDerivs(run, empty(B), empty(B, nx), empty(B, nx, nx))
    ptrs6 = ctypes.c_void_p * 6
    refs_p = ptrs6(*(getattr(refs_run, f).data_ptr() for f in ProblemRefs._fields))
    refT_p = ptrs6(*(getattr(ref_T, f).data_ptr() for f in ProblemRefs._fields))
    outs_p = (ctypes.c_void_p * 12)(*(a.data_ptr() for a in (*run, *out[1:])))
    return out, (consts.data_ptr(), consts_len(family, contact), xs.data_ptr(), us.data_ptr(),
                 refs_p, refT_p, outs_p, B, N, int(bool(knot.surface)))


def diff_all(knot: KnotModel, consts: torch.Tensor, refs_run: ProblemRefs,
             ref_T: ProblemRefs, xs, us) -> KnotDerivs:
    """Derivative pass on the hand-written CUDA kernel (see the module
    docstring for shapes).  CUDA tensors go to the kernel or raise; only CPU
    tensors go to ``diff_reference``.  ``consts`` is
    ``pack_knot_consts(knot.model, knot.W, knot.surface, dtype, knot.family)``.  Launches
    on the current stream and does not synchronize.  ``diff_all.launches``
    counts the kernel launches (a plain integer, incremented here and
    nowhere else)."""
    if xs.device.type == "cpu":
        _check_args(refs_run, ref_T, xs, us)
        return diff_reference(knot, refs_run, ref_T, xs, us)
    out, args = kernel_args(knot, consts, refs_run, ref_T, xs, us)
    launch("diff", _kernel_fn(xs.dtype, knot.family, knot.W.contact_model), xs.device, *args)
    diff_all.launches += 1
    return out


diff_all.launches = 0
