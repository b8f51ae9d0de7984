"""FDDP line-search rollout: CUDA kernel wrapper, its plain PyTorch version
and the kernel's constant packer.

Counterpart of ``ffmpc_tpu/solver/rollout_pallas.py``.  Both functions here
roll out every problem of a batch for all step lengths alpha = 2^-a, a < A,
at once: for each knot t the policy update
``u = clip(u_nom - alpha kff - K (x - x_nom))``, the knot's dynamics and cost,
and the gap-keeping update ``x+ = f(x, u) + (alpha - 1)(1 - feasible) fs[t+1]``,
then the terminal cost; and, for the acceptance, the gap sum of every step
length, ``dv_try = -sum_{t,i} w_all[t,i] (xs[t,i] - xs_try[t,i])``
(``ffmpc_tpu/solver/fddp.py``'s ``dv``):

    inputs   x0 (B,nx)  xs (B,N+1,nx)  us (B,N,nu)  K (B,N,nu,nx)  kff (B,N,nu)
             fs (B,N+1,nx)  w_all (B,N+1,nx)  feasible (B,) bool
             refs_run: ProblemRefs with leading dims (B,N); ref_T: leading (B,)
    outputs  xs_try (B,A,N+1,nx)  us_try (B,A,N,nu)  cost_try (B,A)  dv_try (B,A)

``rollout`` launches the hand-written kernel ``csrc/rollout.cu`` (the
augmented knot, nx = 21) or ``csrc/rollout_classical.cu`` (the classical
knot, nx = 14), and for the point contact (``contact_model="point3d"``)
``csrc/rollout_point3d.cu`` or ``csrc/rollout_classical_point3d.cu``, all
``csrc/rollout.cuh`` with device code in ``csrc/knot_chain.cuh``, for CUDA
tensors, or raises, and uses
``rollout_reference`` only for CPU tensors.  ``rollout_reference`` is the
solver's alpha-batched forward pass, a Python loop over the knots of batched
``knot.calc`` calls: what the kernel is held against, and what
``rollout_mode="plain"`` runs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ocp.action import (CONTACT_MODELS, KnotModel, _build_q_soft_barrier, _make_spec,
                          augmented_spec, lpf_coefficients)
from ..ocp.weights import ProblemRefs
from ._cuda_build import bind, launch, load_library

# The knot families the kernels are instantiated for, with their state widths
# (all with nu = 7): csrc/knot_chain.cuh::Augmented and ::Classical; each
# also for the point contact (::AugmentedPoint3d, ::ClassicalPoint3d).
FAMILY_NX = {"augmented": 21, "classical": 14}
KERNEL_NU = 7
# The libraries of the rollout and derivative kernels for each family and
# contact model (csrc/<stem>.cu; its C functions are ffmpc_<stem>_*).
_LIBRARY_SUFFIX = {"augmented": "", "classical": "_classical"}
_CONTACT_SUFFIX = {"normal_1d": "", "point3d": "_point3d"}


def _cost_slots(contact: str):
    """The cost slots of csrc/knot_chain.cuh (enum Slot; CostLayout<3> for
    the point contact), in summation order, with their residual widths.  A
    knot's spec must list its terms in this order.  tau_reg and
    tau_soft_limits act on the inner knot's torque: the augmented knot's
    torque state, the classical knot's control."""
    force = ((("unilateral", 1), ("fn_track", 1)) if contact == "normal_1d" else
             (("friction_cone", 4), ("unilateral", 3), ("fn_track", 3)))
    return ((("posture", 14), ("v_damp", 14), ("q_soft_limits", 14),
             ("ee_ori", 3), ("w_damp", 6), ("tau_reg", 7),
             ("tau_soft_limits", 7), ("ee_pos", 3), ("ee_xy", 3),
             ("ee_vxy", 6), ("plane_z", 3), ("vz_damp", 6))
            + force + (("y_reg", 21), ("w_reg", 7), ("w_soft", 7)))


def _const_fields(contact: str):
    """Fields of csrc/knot_chain.cuh::KnotConstants in declaration order,
    with their sizes in elements (the point contact's friction coefficient
    mu, its base, first)."""
    slots = _cost_slots(contact)
    n_rows = sum(n for _, n in slots)
    return ((("mu", 1),) if contact == "point3d" else ()) + (
        ("base_rot", 9), ("base_pos", 3), ("j_pos", 21), ("j_rot", 63),
        ("ee_pos", 3), ("ee_rot", 9), ("mass", 7), ("com", 21), ("inertia", 63),
        ("armature", 7), ("damping", 7), ("gravity", 3),
        ("dt", 1), ("lpf_alpha", 1), ("lpf_beta", 1), ("z_press", 1), ("kp", 1),
        ("kd", 1), ("damping_c", 1), ("fn_des", 1),
        ("u_lb", 7), ("u_ub", 7), ("q_soft_ref", 14),
        ("slot_scale", len(slots)), ("slot_barrier", len(slots)),
        ("slot_terminal", len(slots)),
        ("row_w", n_rows), ("row_lb", n_rows), ("row_ub", n_rows))


# The normal contact's layout.
COST_SLOTS = _cost_slots("normal_1d")
N_ROWS = sum(n for _, n in COST_SLOTS)
CONST_FIELDS = _const_fields("normal_1d")
N_CONSTS = sum(n for _, n in CONST_FIELDS)


def family_of(knot: KnotModel) -> str:
    """The knot's family, one the kernels are built for, or raise."""
    if knot.family not in FAMILY_NX:
        raise ValueError(f"the kernels are built for the knot families {sorted(FAMILY_NX)}; "
                         f"this knot's is {knot.family!r}")
    return knot.family


def contact_of(knot: KnotModel) -> str:
    """The knot's contact model, one the kernels are built for, or raise."""
    contact = getattr(knot.W, "contact_model", None)
    if contact not in _CONTACT_SUFFIX:
        raise ValueError(f"the kernels are built for the contact models {CONTACT_MODELS}; "
                         f"this knot's is {contact!r}")
    return contact


def library_stem(kernel: str, family: str, contact: str = "normal_1d") -> str:
    """The CUDA source (csrc/<stem>.cu) of ``kernel`` ("rollout" or
    "knot_diff") for ``family`` and ``contact``."""
    return kernel + _LIBRARY_SUFFIX[family] + _CONTACT_SUFFIX[contact]


def consts_len(family: str, contact: str = "normal_1d") -> int:
    """Values of ``pack_knot_consts`` for ``family`` and ``contact``: one
    set of ``KnotConstants``, or (classical) two, the running knots' and
    the terminal knot's."""
    n = sum(n for _, n in _const_fields(contact))
    return n * (2 if family == "classical" else 1)


def cost_table(model, W, surface: bool, family: str = "augmented",
               terminal: bool = False):
    """The knot's cost terms laid out on the kernel's slots: per slot
    (scale = weight x dt scale, 0 if the term is absent; barrier flag;
    terminal flag) and per row (weight, lower bound, upper bound).  quad is
    written as a weighted quadratic with unit weights (the same value).
    ``terminal``: the classical terminal knot's table, its terms unscaled
    (the augmented terminal knot keeps the running table's dt scale)."""
    slots = _cost_slots(W.contact_model)
    n_rows = sum(n for _, n in slots)
    if family == "classical":
        spec = _make_spec(model, W, surface)
        # the derivative kernel forms a classical terminal knot's costs as
        # the running table's over dt (knot_chain.cuh::classical_terminal_unscale)
        if not all(t.dt_scaled for t in spec.values()):
            raise ValueError("kernels: a classical cost term without the dt scale")
    else:
        spec, _ = augmented_spec(model, W, surface)
    dt_scale = 1.0 if (family == "classical" and terminal) else float(W.dt_ocp)
    names = [n for n, _ in slots]
    order = [names.index(n) if n in names else -1 for n in spec]
    if -1 in order or order != sorted(order):
        raise ValueError(
            f"rollout kernel: cost terms {list(spec)} are not a subsequence "
            f"of the kernel's slots {names}")
    n_s = len(slots)
    scale, barrier, terminal = np.zeros(n_s), np.zeros(n_s), np.zeros(n_s)
    row_w = np.zeros(n_rows)
    row_lb = np.full(n_rows, -np.inf)
    row_ub = np.full(n_rows, np.inf)
    row0 = 0
    for s, (name, nr) in enumerate(slots):
        term = spec.get(name)
        if term is not None:
            scale[s] = term.weight * (dt_scale if term.dt_scaled else 1.0)
            terminal[s] = 1.0 if term.terminal else 0.0
            a = term.activation
            rows = slice(row0, row0 + nr)
            if a.kind == "quad":
                row_w[rows] = 1.0
            elif a.kind == "wquad":
                if len(a.weights) != nr:
                    raise ValueError(f"rollout kernel: {name} has {len(a.weights)} "
                                     f"row weights, the kernel {nr}")
                row_w[rows] = a.weights
            elif a.kind == "barrier":
                if len(a.lb) != nr or len(a.ub) != nr:
                    raise ValueError(f"rollout kernel: {name} has bounds of "
                                     f"another width than the kernel's {nr}")
                barrier[s] = 1.0
                row_lb[rows] = a.lb
                row_ub[rows] = a.ub
            else:
                raise ValueError(f"rollout kernel: activation {a.kind!r} of {name}")
        row0 += nr
    return dict(slot_scale=scale, slot_barrier=barrier, slot_terminal=terminal,
                row_w=row_w, row_lb=row_lb, row_ub=row_ub)


def pack_knot_consts(model, W, surface: bool, dtype,
                     family: str = "augmented") -> torch.Tensor:
    """Flatten the model constants, the knot's scalars and its cost table
    into the kernel's ``KnotConstants`` layout for ``W.contact_model``: a
    flat CPU tensor in ``dtype``.  For the classical family, two such sets,
    the running knots' then the terminal knot's (``consts_len``).  Raises
    for a knot the kernel does not compute (another family or contact
    model, a missing model)."""
    if model is None or W is None or surface is None:
        raise ValueError("rollout kernel: the knot carries no model / weights "
                         "(only the knots of ocp/action.py are ported)")
    if family not in FAMILY_NX:
        raise ValueError(f"rollout kernel: knot family {family!r}; the kernels are "
                         f"built for {sorted(FAMILY_NX)}")
    if W.contact_model not in _CONTACT_SUFFIX:
        raise ValueError(f"rollout kernel: contact_model {W.contact_model!r}; "
                         f"the kernels are built for {CONTACT_MODELS}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"rollout kernel: unsupported dtype {dtype}")
    # the classical knot has no torque filter
    alpha, beta = lpf_coefficients(W) if family == "augmented" else (0.0, 0.0)
    x_ref, _, _ = _build_q_soft_barrier(model, W.q_soft_limit_margin)
    lim = np.asarray(W.tau_limits, dtype=np.float64)
    fields = {name: getattr(model, name).detach().cpu().double().numpy()
              for name in ("base_rot", "base_pos", "j_pos", "j_rot", "ee_pos",
                           "ee_rot", "mass", "com", "inertia", "armature",
                           "damping", "gravity")}
    fields.update(
        dt=float(W.dt_ocp), lpf_alpha=alpha, lpf_beta=beta,
        z_press=float(W.z_press), kp=float(W.contact_gains[0]),
        kd=float(W.contact_gains[1]), damping_c=float(W.contact_inv_damping),
        fn_des=float(W.fn_des), u_lb=-lim, u_ub=lim, q_soft_ref=x_ref, mu=float(W.mu))
    parts = []
    for terminal in ((False, True) if family == "classical" else (False,)):
        fields.update(cost_table(model, W, surface, family, terminal))
        for name, n in _const_fields(W.contact_model):
            a = np.asarray(fields[name], dtype=np.float64).reshape(-1)
            if a.size != n:
                raise ValueError(f"rollout kernel: constant {name} has {a.size} values, "
                                 f"expected {n}")
            parts.append(a)
    return torch.tensor(np.concatenate(parts), dtype=dtype)


def _expected_shapes(B, N, nx, nu):
    return dict(x0=(B, nx), xs=(B, N + 1, nx), us=(B, N, nu), K=(B, N, nu, nx),
                kff=(B, N, nu), fs=(B, N + 1, nx), w_all=(B, N + 1, nx))


_REF_SHAPES = dict(p_ref=(3,), v_ref=(3,), x_reg_ref=(14,), tau_ref=(7,),
                   R_des=(3, 3), y_ref=(21,))


def _same_kind(name, a, xs):
    if a.dtype != xs.dtype or a.device != xs.device:
        raise ValueError(f"{name}: dtype/device {a.dtype}/{a.device} differ "
                         f"from xs's {xs.dtype}/{xs.device}")


def check_refs(refs_run: ProblemRefs, ref_T: ProblemRefs, B: int, N: int, xs):
    """Raise unless the references have leading dims (B, N) / (B,) and the
    dtype and device of ``xs``."""
    for f in ProblemRefs._fields:
        for name, lead, ref in (("refs_run", (B, N), refs_run), ("ref_T", (B,), ref_T)):
            a = getattr(ref, f)
            _same_kind(f"{name}.{f}", a, xs)
            if tuple(a.shape) != lead + _REF_SHAPES[f]:
                raise ValueError(f"{f}: shape {tuple(a.shape)}, expected "
                                 f"{lead + _REF_SHAPES[f]}")


def _check_args(x0, xs, us, K, kff, fs, w_all, feasible, refs_run, ref_T):
    if xs.dim() != 3 or us.dim() != 3:
        raise ValueError("xs must be (B,N+1,nx) and us (B,N,nu)")
    B, N, nu = us.shape
    nx = xs.shape[2]
    want = _expected_shapes(B, N, nx, nu)
    named = dict(x0=x0, xs=xs, us=us, K=K, kff=kff, fs=fs, w_all=w_all)
    for name, a in named.items():
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {want[name]}")
        _same_kind(name, a, xs)
    check_refs(refs_run, ref_T, B, N, xs)
    if tuple(feasible.shape) != (B,) or feasible.dtype != torch.bool:
        raise ValueError(f"feasible: {tuple(feasible.shape)} {feasible.dtype}, "
                         f"expected ({B},) bool")
    if feasible.device != xs.device:
        raise ValueError(f"feasible lives on {feasible.device}, xs on {xs.device}")
    return B, N, nx, nu


def rollout_reference(knot: KnotModel, x0, xs, us, K, kff, fs, w_all, feasible,
                      refs_run: ProblemRefs, ref_T: ProblemRefs, n_alphas: int):
    """Plain PyTorch rollout (see the module docstring for shapes)."""
    B, N, nx, nu = _check_args(x0, xs, us, K, kff, fs, w_all, feasible, refs_run, ref_T)
    A = n_alphas
    kw = dict(dtype=xs.dtype, device=xs.device)
    dtype = xs.dtype
    u_lb = torch.tensor(knot.u_lb, **kw)
    u_ub = torch.tensor(knot.u_ub, **kw)
    alphas = 0.5 ** torch.arange(A, **kw)                       # (A,)

    def expand_ref(ref, t):
        """Knot t's refs for every step length: leading dims (B, A)."""
        return ProblemRefs(*(a[:, t, None].expand((B, A) + a.shape[2:])
                             for a in ref))

    gap_scale = torch.where(feasible[:, None], 0.0, alphas[None, :] - 1.0).to(dtype)
    # (forward-mode AD inside the knot refuses overlapping memory)
    x = x0[:, None, :].expand(B, A, nx).contiguous()
    xs_run, us_try, costs = [], [], []
    for t in range(N):
        dx = x - xs[:, t, None]
        u = (us[:, t, None] - alphas[None, :, None] * kff[:, t, None]
             - (K[:, t, None] @ dx[..., None])[..., 0])
        u = torch.minimum(torch.maximum(u, u_lb), u_ub)
        xnext, cost = knot.calc(expand_ref(refs_run, t), x, u)
        xs_run.append(x)
        us_try.append(u)
        costs.append(cost)
        x = xnext + gap_scale[..., None] * fs[:, t + 1, None]
    ref_TA = ProblemRefs(*(a[:, None].expand((B, A) + a.shape[1:])
                           for a in ref_T))
    cost_T = knot.term_calc(ref_TA, x)
    xs_try = torch.stack(xs_run + [x], dim=2)               # (B, A, N+1, nx)
    us_try = torch.stack(us_try, dim=2)                     # (B, A, N, nu)
    cost_try = torch.sum(torch.stack(costs, dim=-1), dim=-1) + cost_T
    return xs_try, us_try, cost_try, gap_sum(xs, xs_try, w_all)


def gap_sum(xs, xs_try, w_all):
    """The gap-aware expected improvement's gap sums (fddp.py's dv), (B, A):
    ``-sum_{t,i} w_all (xs - xs_try)`` through the (B, A, N+1, nx)
    difference, as the plain version forms them.  The gap weight and Vxx are
    folded into w_all = gapw * Vxx @ fs by the backward sweep."""
    dx_all = xs[:, None] - xs_try
    return -torch.sum(w_all[:, None] * dx_all, dim=(2, 3))


# the C function's arguments: consts (device), n_consts, x0, xs, us, K, kff,
# fs, w_all, feasible, refs, refs_T, xs_try, us_try, cost_try, dv_try, B, N,
# A, surface, stream
ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 14
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_consts_len_checked = set()


def _suffix(dtype):
    return {torch.float32: "f32", torch.float64: "f64"}[dtype]


def kernel_library(kernel: str, family: str, dtype, contact: str = "normal_1d"):
    """The loaded library of ``kernel`` ("rollout" or "knot_diff") for
    ``family`` and ``contact``, and its C functions' prefix; at its first
    use for a dtype, checks that the library's constants are as long as the
    packer's."""
    stem = library_stem(kernel, family, contact)
    lib = load_library(stem)
    prefix = f"ffmpc_{stem}"
    if (stem, dtype) not in _consts_len_checked:
        n = getattr(lib, f"{prefix}_consts_len_{_suffix(dtype)}")
        n.restype = ctypes.c_int
        if n() != consts_len(family, contact):
            raise RuntimeError(f"{stem} kernel: its constants hold {n()} values, "
                               f"the packer writes {consts_len(family, contact)}")
        _consts_len_checked.add((stem, dtype))
    return lib, prefix


def _kernel_fn(dtype, family="augmented", contact="normal_1d"):
    lib, prefix = kernel_library("rollout", family, dtype, contact)
    return bind(lib, f"{prefix}_{_suffix(dtype)}", ARGTYPES)


def resident_blocks_per_sm(dtype=torch.float32, n_alphas: int = 10,
                           family: str = "augmented", contact: str = "normal_1d") -> int:
    """Blocks of the kernel (contact instantiation) that one SM holds at
    once at ``n_alphas`` step lengths, as launched
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` with its shared
    memory); needs a card."""
    stem = library_stem("rollout", family, contact)
    fn = bind(load_library(stem), f"ffmpc_{stem}_occupancy_{_suffix(dtype)}",
              [ctypes.POINTER(ctypes.c_int), ctypes.c_int])
    n = ctypes.c_int(0)
    err = fn(ctypes.byref(n), int(n_alphas))
    if err != 0:
        raise RuntimeError(f"rollout occupancy query failed: cudaError {err}")
    return n.value


def max_alphas() -> int:
    """The most step lengths the kernel takes (csrc/rollout.cu: a block's
    lane groups, one a step length); needs the built library."""
    return bind(load_library("rollout"), "ffmpc_rollout_max_alphas", [])()


def problems_per_block(n_alphas: int) -> int:
    """The problems a block of the kernel holds at ``n_alphas`` step lengths,
    as csrc/rollout.cu launches it; needs the built library."""
    n = bind(load_library("rollout"), "ffmpc_rollout_problems_per_block",
             [ctypes.c_int])(int(n_alphas))
    if n < 1:
        raise ValueError(f"rollout: {n_alphas} step lengths, the kernel takes "
                         f"1..{max_alphas()}")
    return n


def kernel_args(knot: KnotModel, consts: torch.Tensor, x0, xs, us, K, kff, fs, w_all,
                feasible, refs_run: ProblemRefs, ref_T: ProblemRefs, n_alphas: int):
    """Checks CUDA inputs as the kernel takes them and allocates the outputs.
    Returns (outputs, the C function's arguments before the stream): what
    ``rollout`` launches, and what a measurement build of the kernel
    (``tools/rollout_phase_split.py``) is called with."""
    B, N, nx, nu = _check_args(x0, xs, us, K, kff, fs, w_all, feasible, refs_run, ref_T)
    if xs.device.type != "cuda":
        raise ValueError(f"rollout: unsupported device {xs.device}")
    family, contact = family_of(knot), contact_of(knot)
    if (nx, nu) != (FAMILY_NX[family], KERNEL_NU):
        raise ValueError(f"rollout: the kernel is built for nx={FAMILY_NX[family]}, "
                         f"nu={KERNEL_NU} ({family} knot); got nx={nx}, nu={nu}")
    dtype = xs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"rollout: unsupported dtype {dtype}")
    if B < 1 or N < 1 or not 1 <= n_alphas <= max_alphas():
        raise ValueError(f"rollout: empty batch or horizon, or step lengths outside "
                         f"1..{max_alphas()} (B={B}, N={N}, A={n_alphas})")
    if consts.dtype != dtype or consts.device != xs.device \
            or consts.numel() != consts_len(family, contact) or not consts.is_contiguous():
        raise ValueError(f"rollout: consts must be pack_knot_consts(..., family={family!r}) "
                         f"of the {contact} contact in the rollout's dtype {dtype}, copied "
                         f"to {xs.device}")
    tensors = dict(x0=x0, xs=xs, us=us, K=K, kff=kff, fs=fs, w_all=w_all, feasible=feasible)
    for f in ProblemRefs._fields:
        tensors[f"refs_run.{f}"] = getattr(refs_run, f)
        tensors[f"ref_T.{f}"] = getattr(ref_T, f)
    for name, a in tensors.items():
        if not a.is_contiguous():
            raise ValueError(f"rollout: {name} must be contiguous")

    A = int(n_alphas)
    outs = (torch.empty(B, A, N + 1, nx, dtype=dtype, device=xs.device),
            torch.empty(B, A, N, nu, dtype=dtype, device=xs.device),
            torch.empty(B, A, dtype=dtype, device=xs.device),
            torch.empty(B, A, dtype=dtype, device=xs.device))
    ptrs = ctypes.c_void_p * 6
    refs_p = ptrs(*(getattr(refs_run, f).data_ptr() for f in ProblemRefs._fields))
    refT_p = ptrs(*(getattr(ref_T, f).data_ptr() for f in ProblemRefs._fields))
    return outs, (consts.data_ptr(), consts_len(family, contact),
                  *(a.data_ptr() for a in (x0, xs, us, K, kff, fs, w_all, feasible)),
                  refs_p, refT_p, *(o.data_ptr() for o in outs), B, N, A,
                  int(bool(knot.surface)))


def rollout(knot: KnotModel, consts: torch.Tensor, x0, xs, us, K, kff, fs, w_all,
            feasible, refs_run: ProblemRefs, ref_T: ProblemRefs, n_alphas: int):
    """Line-search rollout on the hand-written CUDA kernel (see the module
    docstring for shapes).  CUDA tensors go to the kernel or raise; only CPU
    tensors go to ``rollout_reference``.  ``consts`` is
    ``pack_knot_consts(knot.model, knot.W, knot.surface, dtype, knot.family)``
    on the device of ``xs`` (the caller copies it there once, ``fddp.solve`` once a
    solve; a launch copies nothing from the host).  Launches on the current
    stream and does not synchronize.  ``rollout.launches``
    counts the kernel launches (a plain integer, incremented here and
    nowhere else)."""
    if xs.device.type == "cpu":
        return rollout_reference(knot, x0, xs, us, K, kff, fs, w_all, feasible,
                                 refs_run, ref_T, n_alphas)
    outs, args = kernel_args(knot, consts, x0, xs, us, K, kff, fs, w_all, feasible,
                             refs_run, ref_T, n_alphas)
    launch("rollout", _kernel_fn(xs.dtype, knot.family, knot.W.contact_model), xs.device,
           *args)
    rollout.launches += 1
    return outs


rollout.launches = 0
