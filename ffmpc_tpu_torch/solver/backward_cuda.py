"""BoxFDDP backward sweep: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of ``ffmpc_tpu/solver/backward_pallas.py``.  Both functions here
compute ``fddp.backward_store`` with the box path for a batch of problems,
gap rows pre-scaled by the infeasibility weight:

    inputs   Fx (B,N,nx,nx)  Fu (B,N,nx,nu)  Lx (B,N,nx)  Lu (B,N,nu)
             Lxx (B,N,nx,nx) Lxu (B,N,nx,nu) Luu (B,N,nu,nu)
             fs_scaled (B,N+1,nx)  LxT (B,nx)  LxxT (B,nx,nx)
             lb, ub (B,N,nu)  [bounds relative to the current controls]
             xreg, ureg (B,)
    outputs  K (B,N,nu,nx)  kff (B,N,nu)  qu2 (B,)  dg (B,)  dq (B,)
             bad (B,) bool  w_all (B,N+1,nx)  with w_all[t] = Vxx[t] @ fs_scaled[t]

``backward_box`` launches the hand-written kernel ``csrc/backward_sweep.cuh``
(built for nx = 21 in ``csrc/backward_sweep.cu`` and for nx = 14 in
``csrc/backward_sweep_nx14.cu``, nu = 7) for CUDA tensors (or raises) and
uses ``backward_box_reference`` only for CPU tensors.
``backward_box_reference`` is a Python loop over the knots of batched tensor
ops: it is what the kernel is held against, and what
``backward_mode="plain"`` runs.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.smallchol import matvec as _mv
from .boxqp import boxqp, _masked_solve
from ._cuda_build import bind, launch, load_library

# the library built for each state width (csrc/<stem>.cu; C functions ffmpc_<stem>_*)
_LIBRARY = {21: "backward_sweep", 14: "backward_sweep_nx14"}
KERNEL_NX, KERNEL_NU = tuple(sorted(_LIBRARY)), 7   # the shapes the kernel is built for

_ARG_NAMES = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu", "fs_scaled", "LxT",
              "LxxT", "lb", "ub", "xreg", "ureg")


def _expected_shapes(B, N, nx, nu):
    return dict(
        Fx=(B, N, nx, nx), Fu=(B, N, nx, nu), Lx=(B, N, nx), Lu=(B, N, nu),
        Lxx=(B, N, nx, nx), Lxu=(B, N, nx, nu), Luu=(B, N, nu, nu),
        fs_scaled=(B, N + 1, nx), LxT=(B, nx), LxxT=(B, nx, nx),
        lb=(B, N, nu), ub=(B, N, nu), xreg=(B,), ureg=(B,))


def _check_args(args):
    Fx, Fu = args[0], args[1]
    if Fx.dim() != 4 or Fu.dim() != 4:
        raise ValueError("Fx must be (B,N,nx,nx) and Fu (B,N,nx,nu)")
    B, N, nx, _ = Fx.shape
    nu = Fu.shape[3]
    want = _expected_shapes(B, N, nx, nu)
    for name, a in zip(_ARG_NAMES, args):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {want[name]}")
        if a.dtype != Fx.dtype or a.device != Fx.device:
            raise ValueError(
                f"{name}: dtype/device {a.dtype}/{a.device} differ from Fx's "
                f"{Fx.dtype}/{Fx.device}")
    return B, N, nx, nu


def backward_box_reference(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs_scaled, LxT, LxxT,
                           lb, ub, xreg, ureg, *, boxqp_iters: int = 8,
                           kgain_reg: float = 1e-12):
    """Plain PyTorch backward sweep (see the module docstring for shapes)."""
    B, N, nx, nu = _check_args((Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs_scaled, LxT,
                                LxxT, lb, ub, xreg, ureg))
    dtype, device = Fx.dtype, Fx.device
    eye_x = torch.eye(nx, dtype=dtype, device=device)
    eye_u = torch.eye(nu, dtype=dtype, device=device)
    xr = xreg[:, None, None]
    ur = ureg[:, None, None]

    Vxx = LxxT + xr * eye_x
    wT = _mv(Vxx, fs_scaled[:, N])
    Vx = LxT + wT
    dg = -torch.sum(Vx * fs_scaled[:, N], dim=-1)
    dq = torch.sum(fs_scaled[:, N] * wT, dim=-1)
    qu2 = torch.zeros_like(dg)
    bad = torch.zeros(B, dtype=torch.bool, device=device)
    Ks, kffs, ws = [None] * N, [None] * N, [None] * N
    zeros_u = torch.zeros(B, nu, dtype=dtype, device=device)

    for t in range(N - 1, -1, -1):
        fx, fu = Fx[:, t], Fu[:, t]
        fxT, fuT = fx.transpose(-1, -2), fu.transpose(-1, -2)
        fs_t = fs_scaled[:, t]
        Qxx = Lxx[:, t] + fxT @ Vxx @ fx
        Qxu = Lxu[:, t] + fxT @ Vxx @ fu
        Quu = Luu[:, t] + fuT @ Vxx @ fu + ur * eye_u
        Qx = Lx[:, t] + _mv(fxT, Vx)
        Qu = Lu[:, t] + _mv(fuT, Vx)

        sol = boxqp(Quu, Qu, lb[:, t], ub[:, t], zeros_u, iters=boxqp_iters)
        kff = -sol.x
        K = _masked_solve(
            Quu, Qxu.transpose(-1, -2) * sol.free.to(dtype)[..., None],
            sol.free, kgain_reg)
        bad = bad | (~torch.isfinite(kff)).any(-1) | (~torch.isfinite(K)).any(-1).any(-1)

        Quuk = _mv(Quu, kff)
        Vx = Qx + _mv(K.transpose(-1, -2), Quuk - 2.0 * Qu)
        Vxx = Qxx - Qxu @ K
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2)) + xr * eye_x
        w_t = _mv(Vxx, fs_t)
        Vx = Vx + w_t

        dg = dg + torch.sum(Qu * kff, dim=-1) - torch.sum(Vx * fs_t, dim=-1)
        dq = dq - torch.sum(kff * Quuk, dim=-1) + torch.sum(fs_t * w_t, dim=-1)
        qu2 = qu2 + torch.sum(Qu * Qu, dim=-1)
        Ks[t], kffs[t], ws[t] = K, kff, w_t

    w_all = torch.stack(ws + [wT], dim=1)
    return (torch.stack(Ks, dim=1), torch.stack(kffs, dim=1), qu2, dg, dq, bad,
            w_all)


_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 3 + [ctypes.c_double,
                                                           ctypes.c_void_p]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _kernel_fn(dtype, nx=21):
    stem = _LIBRARY[nx]
    return bind(load_library(stem), f"ffmpc_{stem}_{_SUFFIX[dtype]}", _ARGTYPES)


def resident_blocks_per_sm(dtype=torch.float32, nx: int = 21) -> int:
    """Blocks of the kernel (state width ``nx``) that one SM holds at once,
    as launched (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs a
    card."""
    stem = _LIBRARY[nx]
    fn = bind(load_library(stem), f"ffmpc_{stem}_occupancy_{_SUFFIX[dtype]}",
              [ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    err = fn(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"backward_sweep occupancy query failed: cudaError {err}")
    return n.value


def backward_box(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs_scaled, LxT, LxxT, lb, ub,
                 xreg, ureg, *, boxqp_iters: int = 8, kgain_reg: float = 1e-12):
    """Backward sweep on the hand-written CUDA kernel (see the module
    docstring for shapes).  CUDA tensors go to the kernel or raise; only CPU
    tensors go to ``backward_box_reference``.  Launches on the current
    stream and does not synchronize.  ``backward_box.launches`` counts the
    kernel launches (a plain integer, incremented here and nowhere else)."""
    args = (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs_scaled, LxT, LxxT, lb, ub, xreg,
            ureg)
    if Fx.device.type == "cpu":
        return backward_box_reference(*args, boxqp_iters=boxqp_iters,
                                      kgain_reg=kgain_reg)
    B, N, nx, nu = _check_args(args)
    if nx not in KERNEL_NX or nu != KERNEL_NU:
        raise ValueError(
            f"backward_box: the kernel is built for nx in {KERNEL_NX}, "
            f"nu={KERNEL_NU}; got nx={nx}, nu={nu}")
    if Fx.dtype not in _SUFFIX:
        raise ValueError(f"backward_box: unsupported dtype {Fx.dtype}")
    if B < 1 or N < 1:
        raise ValueError(f"backward_box: empty batch or horizon (B={B}, N={N})")
    for name, a in zip(_ARG_NAMES, args):
        if not a.is_contiguous():
            raise ValueError(f"backward_box: {name} must be contiguous")
    if Fx.device.type != "cuda":
        raise ValueError(f"backward_box: unsupported device {Fx.device}")

    dtype, device = Fx.dtype, Fx.device
    K = torch.empty(B, N, nu, nx, dtype=dtype, device=device)
    kff = torch.empty(B, N, nu, dtype=dtype, device=device)
    qu2 = torch.empty(B, dtype=dtype, device=device)
    dg = torch.empty(B, dtype=dtype, device=device)
    dq = torch.empty(B, dtype=dtype, device=device)
    bad = torch.empty(B, dtype=torch.bool, device=device)
    w_all = torch.empty(B, N + 1, nx, dtype=dtype, device=device)
    outs = (K, kff, qu2, dg, dq, bad, w_all)

    launch("backward_sweep", _kernel_fn(dtype, nx), device,
           *(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
           B, N, int(boxqp_iters), float(kgain_reg))
    backward_box.launches += 1
    return outs


backward_box.launches = 0
