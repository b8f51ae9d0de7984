"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives the port's main path (a batch of warm-started, full-horizon BoxFDDP
solves of the flagship force-feedback contact problem: nx=21, nu=7, N=40,
10 iterations, 10 step lengths, float32, B=256 and B=1024, the derivative
pass, the backward sweep and the line-search rollout on their CUDA kernels)
through
`ffmpc_tpu_torch.run.batch_runner.make_batched_solve_fn`, and the closed
loop on the same three kernels (`make_episode_fn`: the flagship episode at
E=1 over 180 ticks through first contact, and `run/ensemble.py::
run_ensemble`, 512 perturbed episodes of 100 ticks), after building every
CUDA kernel from `ffmpc_tpu_torch/csrc/` and holding each against its plain
PyTorch version on the card (the backward sweep and the rollout also run as
launches of 1 and of 3 problems; the three solver kernels timed at B=1, 256
and 1024, their resident blocks an SM and ptxas' registers and spills
printed: no float32 build may spill; the rollout's gap sums dv_try held
with its trajectories).
Phases: device, build, kernels,
small_reference, golden (the framework-free solver fixture), solve, classical
(the classical controller's batched solve, x = (q, v), u = tau, nx = 14,
N = 36, on the classical instantiations of the three kernels: each held
against its plain version, timed and its ptxas read; the fixture's classical
cases; B=256 and 1024 solves against plain mode), stages
(where one iteration's time goes), probes (the four probe kernels of
`csrc/probes.cu` through their entry points `ffmpc_tpu_torch/tools/`),
plant (float32 against float64; the framework-free replay fixture),
closed_loop, b1 (the B=1 replan, RTI and closed-loop tick against the 5 ms
budget), ensemble, classical_loop (the classical controller's closed loop
and ensemble on the classical instantiations: kernels against plain mode at
float64 over the knot switch, 120 float32 ticks at E=1 and N=36, the
512 x 100 classical ensemble against the JAX package's figures), point3d
(the point contact, nc = 3 with the friction cone, in both controllers'
knots on the point3d instantiations of the derivative and rollout kernels:
each held against its plain version, timed and its ptxas read; both
controllers' point3d solves at B=256/1024 against plain mode; their closed
loops).  Each phase prints JSON lines; any failure raises, so the
exit code is non-zero and the final line is not printed.

The last line is `{"ok": true, "device": {...}}`; the line before it is
`{"kernels": [...]}` with, for every kernel (backward_sweep, rollout,
knot_diff, and the probes probe_math, probe_stream, probe_stream_io,
probe_roundtrip), its launches (the solver kernels' on the main path, with
the closed loop's, the ensemble's and the classical solve's beside; the
probes' on their entry points; the solver kernels' classical instantiations
under "classical", with the classical closed loop's and ensemble's
launches, and their point3d instantiations under "point3d", with the
point3d solves' and episodes' launches), its error against the plain
version, its time, the plain version's
time and the card's bound for the same work.  Times are CUDA events around
back-to-back calls, so for a launch-bound call they are the host's launch
interval; the probes are also timed as device time (20 calls captured in
one CUDA graph: `ms_device`, and `library_ms_device` for `torch.sin`), with
the kernels one wrapper call launches (1) and, for the stream and round-trip
kernels, ptxas' stack and spills (gated: no float32 spill, a stack frame
under 256 B).  Needs
a CUDA device: without one it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ffmpc_tpu_torch.core import KEYFRAMES, gravity_torque, make_panda_model
from ffmpc_tpu_torch.core.dynamics import fwd_dynamics_contact
from ffmpc_tpu_torch.core.kinematics import fk
from ffmpc_tpu_torch.core.spatial import log3
from ffmpc_tpu_torch.ocp.action import (KnotDeriv, _friction_cone_A, make_augmented_knot,
                                        make_classical_knot)
from ffmpc_tpu_torch.ocp.problem import build_problem_refs
from ffmpc_tpu_torch.ocp.weights import flagship_trajectory, flagship_weights
from ffmpc_tpu_torch.mpc.controllers import make_vertical_down_R
from ffmpc_tpu_torch.run.batch_runner import EpisodeConfig, make_batched_solve_fn
from ffmpc_tpu_torch.ocp.weights import ProblemRefs
from ffmpc_tpu_torch.solver import _cuda_build
from ffmpc_tpu_torch.solver.backward_cuda import (backward_box,
                                                  backward_box_reference,
                                                  resident_blocks_per_sm)
from ffmpc_tpu_torch.solver.diff_cuda import (KNOTS_PER_BLOCK as DIFF_KNOTS_PER_BLOCK,
                                              diff_all, diff_reference)
from ffmpc_tpu_torch.solver.diff_cuda import resident_blocks_per_sm as diff_resident_blocks_per_sm
from ffmpc_tpu_torch.solver.fddp import (FDDPSettings, KGAIN_REG, accept_step,
                                         backward_inputs, control_bounds,
                                         solve as fddp_solve)
from ffmpc_tpu_torch.solver.rollout_cuda import (gap_sum, pack_knot_consts, rollout,
                                                 rollout_reference)
from ffmpc_tpu_torch.solver.rollout_cuda import (
    problems_per_block as rollout_problems_per_block,
    resident_blocks_per_sm as rollout_resident_blocks_per_sm)

NX, NU, HORIZON, ITERS, BOXQP_ITERS, N_ALPHAS = 21, 7, 40, 10, 8, 10
BATCHES = (256, 1024)
SMALL_BATCHES = (1, 3)     # extra backward-kernel checks and timing at small grids
FIELDS = ("K", "kff", "qu2", "dg", "dq", "bad", "w_all")

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# float32 rate outside the tensor cores (the kernel uses none).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# Kernel-vs-plain tolerances.  Errors are taken per output field against the
# field's largest magnitude (max|kernel - plain| <= atol + rtol * max|plain|),
# not element by element.
#
# float64, K and w_all: rtol 5e-9 / atol 5e-10, the bar of the JAX package's
# kernel-vs-sequential test.  Gains and the value Hessian do not depend on the
# box QP's minimizer, so only reassociated sums separate the two versions.
TOL_F64 = dict(rtol=5e-9, atol=5e-10)
# float64, kff / qu2 / dg / dq: these follow the box QP's minimizer.  Once
# Newton has converged, its 4-candidate argmin sits on an exact tie (the
# candidates' objectives differ by O(reg^2)), two summation orders break the
# tie differently, and kff moves by one regularized Newton step: about
# reg / lambda_min(Quu) relative (1e-9 / 6e-4 on the flagship problem), which
# the 40-knot recursion then carries into Vx.  1e-4 of the field's scale
# bounds that and is still far below any real fault (a wrong index or sign
# gives O(1)).
TOL_F64_QP = dict(rtol=1e-4, atol=1e-9)
# float32: the recursion is ill-conditioned at single precision (Vxx reaches
# 1e4 against Quu of 6e-4, and reg=1e-9 is below float32 resolution, so the
# box QP's candidates tie within rounding), so two float32 evaluations cannot
# agree better than either agrees with the exact result.  The yardstick is
# therefore measured, per problem and field, on the same inputs: the plain
# float32 version's own relative distance from the plain float64 version.
#  (a) typical error: for every field, the median over problems of the
#      kernel's relative distance from the plain float32 version is at most
#      F32_FACTOR times the median of that yardstick, plus F32_MEDIAN_FLOOR;
#  (b) tails: a control within rounding of its bound, or a gradient within
#      rounding of zero, flips the free set and changes that knot's gain rows
#      discretely in one version only.  Such problems are counted, not
#      hidden: at least MIN_AGREE_F32 of the batch must individually be
#      within F32_FACTOR times their own yardstick plus F32_FLOOR.  (Measured
#      on an H100: 0.92 to 0.995 of the problems; a wrong index or sign
#      leaves none.)
#  (c) no escape where nothing discrete differs: the gains K and the gap
#      products w_all do not depend on the box QP's minimizer, only on the
#      final free set of every knot (a clamped control has a zero gain row).
#      On EVERY problem whose free sets come out equal in both versions (and
#      whose sweep is finite), K and w_all agree to F32_SAME_FREE_RTOL of the
#      problem's largest magnitude in that field: only the recursion's
#      condition number (about 1e7 on the flagship problem) separates them
#      (measured on an H100: at most 4.4e-4 for K, 3.4e-5 for w_all).  The
#      share of such problems is printed (measured: 0.999 to 1.0).
F32_FACTOR, F32_MEDIAN_FLOOR, F32_FLOOR = 4.0, 1e-6, 1e-5
MIN_AGREE_F32 = 0.85
F32_SAME_FREE_RTOL = 1e-3
# The classical knot's checks (phase classical) add one yardstick, the plain
# version's own distance when each of its inputs is multiplied by 1 + eps z
# (z standard normal, seeded; eps the dtype's machine epsilon): a rounding-
# level perturbation.  The classical contact problem's first iteration sits
# on ties: its Quu has eigenvalues from 1e-5 (the torque weight times dt)
# to 3.5 (along the contact force), so the box QP's minimizer can jump
# between bound configurations on a rounding, and a rollout at a large step
# length can diverge: under such a perturbation the plain float64 backward
# sweep changes the free sets of a few problems in a thousand (K, kff and
# the box width with them) and moves kff, dg and dq on the others far more
# than TOL_F64_QP; the records print the counts.  So there a problem agrees
# where each field is within its bar above OR within TIE_FACTOR times that
# yardstick; at float64 at least MIN_AGREE_TIES of the problems must agree
# and have the same free sets, and on those K and w_all keep the TOL_F64 bar
# (they depend on the free set only); at float32 the yardstick is the larger
# of the two.  Rollout rows whose plain float64 states pass ROLLOUT_DIVERGED
# have diverged: at least MIN_AGREE_TIES of the rows must be diverged in both
# versions or in neither, and the bars apply to the rows diverged in neither.
TIE_FACTOR = 4.0
MIN_AGREE_TIES = 0.99
ROLLOUT_DIVERGED = 1e6
# At float32 the classical contact problem's first iteration is not resolved
# at all: under a one-ulp perturbation of its inputs the plain backward sweep
# changes the free sets of about half the problems (the records print it).
# Per-problem shares then measure which problems the
# random draw hit; so there (`ties`, float32) the kernel's distance from the
# plain version is held, field by field, at the median, 90th and 99th
# percentiles over problems, to F32_FACTOR times the same percentile of the
# yardstick, and its problems with other free sets to twice the perturbed
# plain version's count plus TIES_FREE_SLACK of the batch.
TIES_QUANTILES = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64)
TIES_FREE_SLACK = 0.01
# Whole solves, kernel mode vs plain mode at float32: decisions (iterations,
# converged/diverged/feasible flags, and the first iteration's accepted step
# length) must agree on at least this share.
MIN_AGREE_SOLVE = 0.99
LEADING_SLACK = 1.0
SOLVE_REPEATS = 3          # timed solves of the main path (kernel modes)
PLAIN_REPEATS = 1          # timed solves of the slower yardstick modes
QP_FIELDS = ("kff", "qu2", "dg", "dq")

# Rollout kernel vs its plain version, errors per output field against the
# field's largest finite magnitude.
# float64: rtol 5e-9 / atol 1e-10, the bar of the JAX package's kernel-vs-scan
# test (tests/test_rollout_pallas.py): both evaluate the same formulas, summed
# in another order, through 40 knots of stiff contact dynamics (Baumgarte
# gains 145 / 85, inverse damping 1e-8).  The (problem, step length) rows with
# a non-finite cost must be the same set exactly.
ROLLOUT_TOL_F64 = dict(rtol=5e-9, atol=1e-10)
# float32: two float32 evaluations of 40 stiff knots cannot agree better than
# either agrees with the exact result, so the yardstick is measured per
# problem on the same inputs: the plain float32 version's relative distance
# from the plain float64 version.  The median over problems of the kernel's
# distance from plain float32 is gated at ROLLOUT_F32_FACTOR times the median
# yardstick (+ ROLLOUT_F32_FLOOR); the problems outside that factor of their
# own yardstick are counted and printed, and must stay under
# 1 - ROLLOUT_MIN_AGREE_F32 of the batch (a wrong index or sign leaves none
# inside).  Non-finite cost rows must agree on ROLLOUT_NONFINITE_AGREE of the
# (problem, step length) rows: a step length on the edge of blowing up may go
# over in one float32 evaluation only.
ROLLOUT_F32_FACTOR, ROLLOUT_F32_FLOOR = 4.0, 1e-6
ROLLOUT_MIN_AGREE_F32 = 0.9
ROLLOUT_NONFINITE_AGREE = 0.99
ROLLOUT_FIELDS = ("xs_try", "us_try", "cost_try", "dv_try")

# Diff kernel vs its plain version, errors per output field, with a field's
# scale = max(max|plain| over the batch, 1) (tests/test_diff_pallas.py's).
# float64: every field within DIFF_TOL_F64 of its scale on the entries finite
# in both, and the same (knot, field) pairs non-finite (per knot, not per
# entry: the plain version's dense products spread a NaN over a Jacobian's
# structural zeros, the kernel multiplies live columns only).  Both evaluate
# the same derivatives; nvcc contracts a*b+c into FMAs, hence 1e-11 and not
# the JAX suite's 1e-12.
DIFF_TOL_F64 = 1e-11
# float32, per knot and field, against the plain float64 version on the same
# inputs: the kernel's largest error at the knot is at most DIFF_F32_FACTOR
# times the plain float32 version's own largest error there, plus
# DIFF_F32_FLOOR of the field's scale; on EVERY knot but those where a
# barrier's active side can differ between two float32 evaluations.  The only
# barrier on a computed residual is the unilateral one on the contact force
# (the others act on states and controls, which both versions read alike);
# a knot is on its edge when the float64 force lies within
# UNILATERAL_EDGE_N newtons of the bound, about 100x the float32 rounding of
# the force.  Such knots are counted, may be at most DIFF_MAX_EDGE_SHARE of
# the knots, and their largest error is printed.  Knots whose orientation
# error lies within HALF_TURN_BAND of a half turn (where float32 log3 breaks
# down, ROADMAP queue 3) are counted, not exempted.
DIFF_F32_FACTOR, DIFF_F32_FLOOR = 4.0, 1e-6
UNILATERAL_EDGE_N = 1e-2
DIFF_MAX_EDGE_SHARE = 1e-3
HALF_TURN_BAND = 1e-3

# the solver golden fixture (tests/test_solver_golden.py) and its weights
GOLDEN_FIXTURE = "tests/fixtures/solver_golden.npz"
GOLDEN_W = dict(dt_ocp=0.01, w_ee_pos=1.2e3, w_q_soft_limits=8.0,
                w_tau_soft_limits=2.0, w_plane_z=1.2e3, w_vz=5.0e2,
                contact_gains=(140.0, 80.0), fn_des=22.0, w_fn=28.0,
                ff_alpha=float(np.exp(-2 * np.pi * 25.0 * 0.01)),
                w_w=6.0e-4, w_w_soft_limits=2.0, w_y=8.0e-4)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps=5, rounds=7):
    """Median over `rounds` of the mean time of `reps` calls, CUDA events, warm."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


def graph_time_ms(fn, n=20, rounds=7):
    """Device time of one call: `n` calls captured in one CUDA graph, its
    replay timed with CUDA events and divided by `n`; median of `rounds`.
    The host's launch cost is left out (the replay is one launch)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return float(np.median(times))


def kernel_launches(fn, attempts=3):
    """The operations one call of `fn` runs on the card (kernels, copies),
    as torch.profiler's CUDA activity records them.  A profile that records
    no device activity at all is taken again, up to `attempts` times: the
    profiler has come back empty for a call whose kernel ran (stream stage
    6, once in two runs of the same tree on an H100)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            break
    return n


def device_figures(fn):
    """A host-bound function's device side: its device time a call
    (`graph_time_ms`) and its kernel launches (`kernel_launches`).  A
    figure the profiler or the graph capture cannot give is recorded as the
    error it raised (a measurement, not a gate)."""
    rec = {}
    for key, measure in (("ms_device", graph_time_ms), ("launches", kernel_launches)):
        try:
            rec[key] = measure(fn)
        except Exception as e:  # recorded, not gated
            rec[key] = f"not measured: {type(e).__name__}: {e}"
    return rec


def random_backward_args(B, N, tight, dtype, seed, nx=NX):
    """Seeded well-conditioned backward-sweep inputs (the recipe of the
    package's CPU tests) at state width `nx`, numpy float64 cast to `dtype`
    on the card."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.normal(size=s)

    eye_x, eye_u = np.eye(nx), np.eye(NU)
    Fx = eye_x + 0.1 * r(B, N, nx, nx)
    Fu = 0.2 * r(B, N, nx, NU)
    Lx, Lu = r(B, N, nx), r(B, N, NU)
    A = 0.3 * r(B, N, nx, nx)
    Lxx = A @ np.swapaxes(A, -1, -2) + 0.5 * eye_x
    Lxu = 0.1 * r(B, N, nx, NU)
    Bm = 0.3 * r(B, N, NU, NU)
    Luu = Bm @ np.swapaxes(Bm, -1, -2) + 0.8 * eye_u
    fs = 0.3 * r(B, N + 1, nx)
    LxT = r(B, nx)
    At = 0.3 * r(B, nx, nx)
    LxxT = At @ np.swapaxes(At, -1, -2) + 0.5 * eye_x
    width = 0.05 if tight else 50.0
    lb = -width * np.abs(r(B, N, NU)) - 1e-3
    ub = width * np.abs(r(B, N, NU)) + 1e-3
    xreg = 10.0 ** rng.uniform(-6, -2, size=B)
    return [torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
            for a in (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, lb, ub,
                      xreg, xreg)]


def field_errors(out_a, out_b):
    """Per field: (per-problem max|a - b|, per-problem max|b|), float64 (B,)."""
    B = out_b[0].shape[0]
    res = {}
    for name, a, b in zip(FIELDS, out_a, out_b):
        if name == "bad":
            continue
        err = (a.double() - b.double()).abs().reshape(B, -1).amax(dim=1)
        res[name] = (err, b.double().abs().reshape(B, -1).amax(dim=1))
    return res


def backward_flops(B, N, iters, nx=NX):
    """Floating-point operations the sweep does on inputs of this shape (the
    box QP runs a fixed iteration count, so the work does not depend on the
    data)."""
    nu, nz = NU, nx + NU
    chol = nu ** 3 / 3 + 2 * nu ** 2            # factor + one solve
    qp_iter = 2 * nu * nu + chol + 4 * (2 * nu * nu + 2 * nu)
    knot = (2 * nx * nx * nz                    # Vxx [Fx|Fu]
            + 2 * nx * (nz * nz - nu * nx)      # F^T W, Qux skipped
            + 2 * nx * nz                       # F^T Vx
            + iters * qp_iter + 2 * nu * nu     # box QP + final free set
            + nu ** 3 / 3 + nx * 2 * nu * nu    # gain factor + 21 solves
            + 2 * nx * nx * nu + 2 * nx * nx    # Qxx - Qxu K, symmetrize
            + 2 * nx * nx + 4 * nx + 6 * nu)    # Vxx fs, accumulators
    return B * (N * knot + 2 * nx * nx)


def backward_bytes(args, outs):
    return sum(a.numel() * a.element_size() for a in list(args) + list(outs))


def point_contact_flops(nq=7):
    """What the point contact (nc = 3) adds to a knot evaluation, counted
    from csrc/knot_chain.cuh's point-contact parts: two more solves against
    M's factor, the 3 x 3 Schur complement's other five entries, two more
    rows of the drift, the contact's right-hand side and the acceleration,
    the 3 x 3 factor and solve, and the cost rows of the friction cone (4)
    and of unilateral and fn_track (2 more each)."""
    return float(2 * 2 * nq * nq + 5 * 2 * nq + 2 * 6 + 2 * 4 * nq + 2 * 2 * nq + 40
                 + 4 * 9 + 4 * 5)


def knot_calc_flops(nx=NX, nu=NU, nq=7, nc=1):
    """One knot evaluation (forward kinematics, frame Jacobian, bias forces,
    mass matrix, Cholesky, 1-row contact KKT, Euler step, residuals and
    activations): the count of the JAX package's utils/flops.py::
    knot_calc_flops, copied so this script imports nothing of it; with
    nc = 3, the point contact's additions (point_contact_flops)."""
    chain = (70 * nq + 120 * nq + 130 * nq + 30 * nq * nq
             + (nq ** 3 // 3 + nq * nq) + (4 * nq * nq + 1 + 2 * nq * nq) + 8 * nq)
    costs = 12 * 30 + 150 + 2 * nx + 2 * nu
    return float(chain + costs) + (point_contact_flops(nq) if nc == 3 else 0.0)


def rollout_flops(B, N, A, nx=NX, nc=1):
    """Operations of the rollout on these shapes: per (problem, step length)
    N knots of policy update (2 nu nx), clip and knot evaluation, plus the
    terminal evaluation.  The work does not depend on the data."""
    knot = 2 * NU * nx + 2 * NU + knot_calc_flops(nx, nc=nc)
    return B * A * (N * knot + knot_calc_flops(nx, nc=nc))


def rollout_bytes(args, outs):
    """Each input read once (the gap products w_all too), each output
    written once (the gap sums dv_try too)."""
    *arrays, refs_run, ref_T = args
    tensors = [*arrays, *refs_run, *ref_T, *outs]
    return sum(a.numel() * a.element_size() for a in tensors)


def knot_diff_flops(terminal=False, family="augmented", nc=1):
    """Operations of one knot's derivatives, counted from the parts of
    csrc/knot_chain.cuh (diff_primal's stages, diff_column, diff_lxx_column):
    each multiply, add and subtract counts 1 (a fused multiply-add 2); sin,
    cos, sqrt, acos and each division 1.  A tangent pass forms only the
    links at and after its joint (4 of 7 on average over the directions).
    A classical knot runs the same parts (its residuals without the y / w
    terms, counted as the augmented knot's); its terminal knot's outputs
    take the state's 14 columns, so its control columns are not counted.
    With nc = 3 the point contact's additions: the primal part's
    (point_contact_flops, and folding the cone into the force rows' 3 x 3
    Hessian, 60), a q-pass's two more h2 rows and dJc^T f (tool_acc_rows
    and 4 a joint, 100), a v-pass's (20), a column's solve's (the 3 x 3
    solve, two more dots and M^-1 Jc^T df, 80), and the assembly's force
    rows (3 Jacobian rows read and a 3 x 3 product a column, 6 an upper
    entry).  The work does not depend on the data."""
    cross, joint_rot = 9, 18
    rnea = 18 + 707 + 51 + 1042      # gravity seed, forward, tool acceleration, backward
    primal = (14 + 3241 + 84 + 147   # sin/cos, FK with mass matrix, frame Jacobian, Cholesky
              + rnea                 # bias and drift at a = 0
              + 2 * 98 + 183 + 35    # two solves, contact solve and acceleration, xnext
              + rnea - 51            # link states at the acceleration
              + 191 + 740)           # tool velocity and log3, residuals, activations, costs
    fwd_link, bwd_link = 104 + joint_rot, 147
    back_all = 6 * (joint_rot + 2 * 15 + cross + 6) + 7
    ee_acc = 7 * cross + 30
    q_pass = (4 * 17 + 3 * 53                    # frame Jacobian's tangent (closed form)
              + 3 * cross + 90 + 140 + 9         # orientation error's tangent, dR6
              + 4 * fwd_link + 72 + ee_acc       # RNEA's tangent, forward, joint's own rotation
              + 4 * bwd_link + 42 + back_all     # backward
              + 20)                              # g1, h2
    v_pass = 4 * fwd_link + 12 + ee_acc + 4 * bwd_link + back_all + 3
    solve = 130                                  # implicit-function column
    fx_cols = 0 if terminal else 7 * 56 + 7 * 56 + 7 * 28
    assembly = 294 + 756 + 1155 + 378 + 210      # Lx; Lxx over the groups' live rows
    n_cols = 14 if (terminal and family == "classical") else 21
    if nc == 3:
        primal += point_contact_flops() + 60
        q_pass, v_pass, solve = q_pass + 100, v_pass + 20, solve + 80
        assembly += 21 * 18 + 6 * 21 * 22 / 2
    assembly *= (n_cols * (n_cols + 1) / 2) / (21 * 22 / 2)   # the upper entries a <= c
    return float(primal + 7 * q_pass + 7 * v_pass + n_cols * solve + fx_cols + assembly)


def diff_flops(B, N, family="augmented", nc=1):
    return B * (N * knot_diff_flops(family=family, nc=nc)
                + knot_diff_flops(terminal=True, family=family, nc=nc))


def diff_bytes(inputs, out):
    """Each input read once, each output written once."""
    xs, us, refs_run, ref_T = inputs
    tensors = [xs, us, *refs_run, *ref_T, *out.run, *out[1:]]
    return sum(a.numel() * a.element_size() for a in tensors)


def flagship(dtype, device="cuda"):
    model = make_panda_model("plant", dtype=dtype, device=device)
    W = flagship_weights()
    ep = EpisodeConfig(controller="force_feedback", horizon=HORIZON)
    q0 = np.asarray(KEYFRAMES["neutral"])
    return model, W, flagship_trajectory(), ep, q0


def warm_start_args(B, q0, tau_g, rng, horizon=HORIZON, dtype=np.float32):
    """Perturbed-state warm starts: x0 around the neutral pose with gravity
    torques, trajectory initialized at x0, controls at gravity torque."""
    y0 = np.concatenate([q0, np.zeros(7), tau_g]).astype(dtype)
    y0s = y0[None] + 0.02 * rng.normal(size=(B, 21)).astype(dtype)
    ts = np.full((B,), 1.2, dtype)
    xs = np.tile(y0s[:, None, :], (1, horizon + 1, 1))
    us = np.tile(tau_g.astype(dtype)[None, None], (B, horizon, 1))
    return ts, y0s, xs, us


def main_path_first_iteration(B, dtype=torch.float32):
    """The flagship solve's first iteration at batch B, as the main path
    builds it: warm starts as `bench.py` builds them (seed 0), the problem
    references, and the derivative pass's backward-sweep inputs."""
    model, W, traj, ep, q0 = flagship(dtype)
    knot = make_augmented_knot(model, W, surface=True)
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=dtype, device="cuda")).cpu().numpy()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    ts, y0s, xs, us = (torch.as_tensor(a, device="cuda") for a in
                       warm_start_args(B, q0, tau_g, np.random.default_rng(0), dtype=np_dtype))
    q_nom = torch.as_tensor(q0, dtype=dtype, device="cuda")
    x_reg = torch.cat([q_nom, torch.zeros(7, dtype=dtype, device="cuda")])
    refs_run, ref_T = build_problem_refs(
        traj, ts, HORIZON, W.dt_ocp, x_reg, gravity_torque(model, y0s[:, :7]),
        make_vertical_down_R(), y_ref=y0s, dtype=dtype, device="cuda")
    refs_run = ProblemRefs(*(a.contiguous() for a in refs_run))
    ref_T = ProblemRefs(*(a.contiguous() for a in ref_T))
    feasible = torch.zeros(B, dtype=torch.bool, device="cuda")
    bounds = control_bounds(knot, dtype, "cuda")
    bi = backward_inputs(diff_reference(knot, refs_run, ref_T, xs, us), y0s, xs, us,
                         feasible, *bounds)
    return dict(knot=knot, bi=bi, refs_run=refs_run, ref_T=ref_T, x0=y0s,
                xs=xs, us=us, cost_cur=bi.cost_cur, bounds=bounds)


def main_path_backward_args(B):
    """The backward sweep's inputs exactly as the first iteration of the
    flagship float32 solve produces them."""
    it = main_path_first_iteration(B)
    reg = torch.full((B,), 1e-9, dtype=torch.float32, device="cuda")
    return list(it["bi"].args) + [reg, reg]


def main_path_rollout_args(B, dtype=torch.float32):
    """The rollout's inputs as the first iteration of the flagship solve
    produces them: K, kff and the gap products w_all from the backward
    kernel.  Returns (knot, consts, args), the constants on the card."""
    it = main_path_first_iteration(B, dtype)
    reg = torch.full((B,), 1e-9, dtype=dtype, device="cuda")
    out = backward_box(*it["bi"].args, reg, reg, boxqp_iters=BOXQP_ITERS,
                       kgain_reg=KGAIN_REG)
    knot = it["knot"]
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype).cuda()
    args = (it["x0"], it["xs"], it["us"], out[0], out[1], it["bi"].fs, out[6],
            it["bi"].feasible, it["refs_run"], it["ref_T"])
    return knot, consts, args


def seeded_rollout_args(B, N, dtype, seed):
    """Seeded rollout inputs, the recipe of the JAX package's fused-rollout
    test (tests/test_rollout_pallas.py) at the flagship knot and horizon:
    states around the neutral pose, controls around gravity torque, random
    gains, feed-forwards, gaps and gap products, every other problem
    feasible.  Returns (knot, consts, args), the constants on the card."""
    model, W, traj, ep, q0 = flagship(dtype)
    knot = make_augmented_knot(model, W, surface=True)
    rng = np.random.default_rng(seed)

    def T(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()

    q = torch.as_tensor(q0, dtype=dtype, device="cuda")
    tau_g = gravity_torque(model, q)
    y0 = torch.cat([q, torch.zeros(7, dtype=dtype, device="cuda"), tau_g])
    x0 = (y0[None] + 0.05 * T(rng.normal(size=(B, NX)))).contiguous()
    xs = (x0[:, None].repeat(1, N + 1, 1) + 0.02 * T(rng.normal(size=(B, N + 1, NX)))).contiguous()
    us = (tau_g.repeat(B, N, 1) + 2.0 * T(rng.normal(size=(B, N, NU)))).contiguous()
    K = 0.1 * T(rng.normal(size=(B, N, NU, NX)))
    kff = T(rng.normal(size=(B, N, NU)))
    fs = 0.1 * T(rng.normal(size=(B, N + 1, NX)))
    w_all = 0.3 * T(rng.normal(size=(B, N + 1, NX)))
    feasible = torch.arange(B, device="cuda") % 2 == 1
    x_reg = torch.cat([q, torch.zeros(7, dtype=dtype, device="cuda")])
    refs_run, ref_T = build_problem_refs(
        traj, torch.full((B,), 1.2, dtype=dtype, device="cuda"), N, W.dt_ocp, x_reg,
        tau_g, make_vertical_down_R(), y_ref=x0, dtype=dtype, device="cuda")
    refs_run = ProblemRefs(*(a.contiguous() for a in refs_run))
    ref_T = ProblemRefs(*(a.contiguous() for a in ref_T))
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype).cuda()
    return knot, consts, (x0, xs, us, K, kff, fs, w_all, feasible, refs_run, ref_T)


def to_double(args):
    x0, xs, us, K, kff, fs, w_all, feasible, refs_run, ref_T = args
    return ((x0.double(), xs.double(), us.double(), K.double(), kff.double(),
             fs.double(), w_all.double(), feasible, ProblemRefs(*(a.double() for a in refs_run)),
             ProblemRefs(*(a.double() for a in ref_T))))


def rollout_slice(args, i, j):
    """The rollout's inputs of problems i..j-1 (contiguous copies)."""
    *arrays, refs_run, ref_T = args
    return (*(a[i:j].contiguous() for a in arrays),
            ProblemRefs(*(a[i:j].contiguous() for a in refs_run)),
            ProblemRefs(*(a[i:j].contiguous() for a in ref_T)))


def flagship_knot(dtype):
    return make_augmented_knot(flagship(dtype)[0], flagship_weights(), surface=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def ptxas_usage(log):
    """Per compiled kernel: registers, shared memory, stack frame and spill
    bytes, as `nvcc -Xptxas -v` reports them; `spill_bytes_with_callees`
    adds the spills of the out-of-line device functions compiled with it."""
    usage = []
    for block in re.split(r"Compiling entry function '", log)[1:]:
        name = block.split("'", 1)[0]
        rec = {"function": name}
        props = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                           r"(\d+) bytes spill loads", block)
        if props:
            rec.update(stack_frame_bytes=int(props[0][0]),
                       spill_store_bytes=int(props[0][1]),
                       spill_load_bytes=int(props[0][2]),
                       spill_bytes_with_callees=sum(int(st) + int(ld)
                                                    for _, st, ld in props))
        m = re.search(r"Used (\d+) registers", block)
        if m:
            rec["registers"] = int(m[1])
        m = re.search(r"Used \d+ registers[^\n]*?(\d+) bytes smem", block)
        rec["smem_bytes"] = int(m[1]) if m else 0
        usage.append(rec)
    return usage


def phase_build():
    t0 = time.perf_counter()
    built = _cuda_build.build_all()
    for stem in built.paths:
        _cuda_build.load_library(stem)
    # read from the log kept beside each library, so also on a cached build
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": sorted(p.name for p in built.paths.values()),
          "ptxas": {stem: ptxas_usage(log) for stem, log in built.logs.items()}})


def perturbed(tensors, seed=0):
    """Each tensor times 1 + eps z (z standard normal, seeded; eps its
    dtype's machine epsilon): the rounding-level perturbation of the
    classical checks' yardstick."""
    out = []
    for a in tensors:
        g = torch.Generator(device=a.device)
        g.manual_seed(seed + len(out))
        eps = torch.finfo(a.dtype).eps
        out.append((a * (1 + eps * torch.randn(a.shape, generator=g, dtype=a.dtype,
                                               device=a.device))).contiguous())
    return out


def free_sets(out):
    """Per problem and knot, the controls the gains keep (a clamped control
    has a zero gain row)."""
    return out[0].abs().sum(-1) != 0


def backward_gate(args, out_k=None, ties=False):
    """The backward kernel's outputs `out_k` on `args` (launched here if not
    given) against the plain version's, at the gates below: float64 within
    TOL_F64 (K, w_all) and TOL_F64_QP (the fields that follow the box QP's
    minimizer) with equal `bad` flags; float32 against the plain float64
    version's yardstick (F32_*), the same-free-set bar and MIN_AGREE_F32.
    `ties`: the classical checks' gates (TIE_FACTOR).  Returns the record,
    with "ok"."""
    f64 = args[0].dtype == torch.float64
    if out_k is None:
        out_k = backward_box(*args, boxqp_iters=BOXQP_ITERS)
    torch.cuda.synchronize()
    out_r = backward_box_reference(*args, boxqp_iters=BOXQP_ITERS)
    torch.cuda.synchronize()
    kp = field_errors(out_k, out_r)
    rec = {"B": int(args[0].shape[0]), "N": int(args[0].shape[1]),
           "dtype": str(args[0].dtype).replace("torch.", ""),
           "bad_flags": int(out_r[5].sum()),
           "bad_equal": bool((out_k[5] == out_r[5]).all()),
           "max_abs_err": {n: float(e.max()) for n, (e, _) in kp.items()},
           "scale": {n: float(sc.max()) for n, (_, sc) in kp.items()}}
    ok = rec["bad_equal"]
    if ties:
        out_y = backward_box_reference(*perturbed(args[:12]), *args[12:],
                                       boxqp_iters=BOXQP_ITERS)
        yard = field_errors(out_y, out_r)
        free_k, free_r, free_y = (free_sets(o) for o in (out_k, out_r, out_y))
        same_free = (free_k == free_r).all(dim=2).all(dim=1) & ~out_k[5] & ~out_r[5]
        rec["free_sets_differ"] = int((~same_free).sum())
        rec["free_sets_differ_plain_perturbed"] = int(
            (~(free_y == free_r).all(dim=2).all(dim=1)).sum())
    if f64 and ties:
        rec["same_free_set_share"] = float(same_free.double().mean())
        ok = ok and rec["same_free_set_share"] >= MIN_AGREE_TIES
        agree = torch.ones_like(same_free)
        rec["same_free_set_max_abs_err"] = {}
        for n, (e, sc) in kp.items():
            tol = TOL_F64_QP if n in QP_FIELDS else TOL_F64
            bar = tol["atol"] + tol["rtol"] * float(sc.max())
            agree &= (e <= bar) | (e <= TIE_FACTOR * yard[n][0])
            rec["same_free_set_max_abs_err"][n] = float(
                torch.where(same_free, e, torch.zeros_like(e)).max())
            if n in ("K", "w_all"):
                ok = ok and not bool((same_free & ~(e <= bar)).any())
        rec["agree_share"] = float(agree.double().mean())
        ok = ok and rec["agree_share"] >= MIN_AGREE_TIES
    elif f64:
        for n, (e, sc) in kp.items():
            tol = TOL_F64_QP if n in QP_FIELDS else TOL_F64
            ok = ok and float(e.max()) <= tol["atol"] + tol["rtol"] * float(sc.max())
    else:
        out_64 = backward_box_reference(*[a.double() for a in args],
                                        boxqp_iters=BOXQP_ITERS)
        p64 = field_errors(out_r, out_64)
        agree = out_k[5] == out_r[5]
        rel = {}
        yard_rel = {}
        for n, (e, sc) in kp.items():
            sc = sc.clamp_min(1e-30)
            rel_k, rel_p = e / sc, p64[n][0] / sc
            if ties:
                rel_p = torch.maximum(rel_p, yard[n][0] / sc)
            yard_rel[n] = rel_p
            agree &= rel_k <= F32_FACTOR * rel_p + F32_FLOOR
            rel[n] = [float(rel_k.median()), float(rel_p.median())]
            ok = ok and rel[n][0] <= F32_FACTOR * rel[n][1] + F32_MEDIAN_FLOOR
        rec["agree_share"] = float(agree.double().mean())
        free_k, free_r = (o[0].abs().sum(-1) != 0 for o in (out_k, out_r))
        same_free = ((free_k == free_r).all(dim=2).all(dim=1)
                     & ~out_k[5] & ~out_r[5])
        rec["same_free_set_share"] = float(same_free.double().mean())
        rec["same_free_set_max_rel_err"] = {}
        rec["same_free_set_violations"] = {}
        for n in ("K", "w_all"):
            sc = kp[n][1].clamp_min(1e-30)
            rel_k = kp[n][0] / sc
            over = same_free & ~(rel_k <= F32_SAME_FREE_RTOL)
            rec["same_free_set_max_rel_err"][n] = float(
                torch.where(same_free, rel_k, torch.zeros_like(rel_k)).max())
            rec["same_free_set_violations"][n] = int(over.sum())
            ok = ok and (ties or not bool(over.any()))
        rec["median_rel_err_kernel_vs_plain32__plain32_vs_plain64"] = rel
        if ties:
            # the tails against the yardstick's, and the free sets that
            # differ against the perturbed plain version's (TIES_QUANTILES)
            rec["quantiles_kernel__yardstick"] = {}
            for n, (e, sc) in kp.items():
                rel_k = e / sc.clamp_min(1e-30)
                q = TIES_QUANTILES.to(rel_k.device)
                qk = torch.quantile(rel_k.double(), q)
                qy = torch.quantile(yard_rel[n].double(), q)
                rec["quantiles_kernel__yardstick"][n] = [qk.tolist(), qy.tolist()]
                ok = ok and bool((qk <= F32_FACTOR * qy + F32_FLOOR).all())
            ok = ok and (rec["free_sets_differ"] <= 2 * rec["free_sets_differ_plain_perturbed"]
                         + TIES_FREE_SLACK * rec["B"])
        else:
            ok = ok and bool(same_free.any())
            ok = ok and rec["agree_share"] >= MIN_AGREE_F32
    rec["ok"] = bool(ok)
    return rec


def phase_kernels():
    """Kernel vs plain version on the card, then timings.  Returns the
    backward_sweep entry of the `kernels` line (launches filled in later)."""
    checks = []
    failures = []

    def check(label, args, out_k=None):
        rec = {"case": label, **backward_gate(args, out_k)}
        checks.append(rec)
        if not rec["ok"]:
            failures.append(label + "/" + rec["dtype"])
        return rec

    def launches_of(k, args):
        """The batch as consecutive launches of k problems (the last n % k
        problems left out), outputs concatenated."""
        n = args[0].shape[0] // k * k
        outs = [backward_box(*(a[i:i + k] for a in args), boxqp_iters=BOXQP_ITERS)
                for i in range(0, n, k)]
        return [a[:n] for a in args], tuple(torch.cat(f) for f in zip(*outs))

    def same_bits(out_small, out_full):
        n = out_small[0].shape[0]
        return all(bool(((a == b[:n]) | (torch.isnan(a) & torch.isnan(b[:n]))).all())
                   for a, b in zip(out_small, out_full))

    # Small grids (B=1 and B=3): the batch run as launches of 1 and of 3
    # problems.  Each launch's results must equal the whole batch's launch
    # bit for bit (blocks are independent), and the pooled outputs pass the
    # same gates as the whole batch: float32's agree_share is a share of
    # problems, which one launch of 1 or 3 cannot measure (one tie-flipped
    # problem of 3 is 0.67).
    B = BATCHES[-1]
    for tight in (False, True):
        tag = "bounds_active" if tight else "bounds_inactive"
        for dtype in (torch.float64, torch.float32):
            args = random_backward_args(B, HORIZON, tight, dtype, 1)
            check(f"random_{tag}", args)
            out_full = backward_box(*args, boxqp_iters=BOXQP_ITERS)
            for k in SMALL_BATCHES:
                args_k, out_k = launches_of(k, args)
                rec = check(f"random_{tag}_launches_of_{k}", args_k, out_k)
                rec["launch_B"] = k
                rec["same_bits_as_full_batch"] = same_bits(out_k, out_full)
                if not rec["same_bits_as_full_batch"]:
                    rec["ok"] = False
                    failures.append(rec["case"] + "/" + rec["dtype"] + "/bits")
    main_args = {b: main_path_backward_args(b) for b in (1,) + BATCHES}
    main_rec = check("main_path_first_iteration", main_args[B])
    check("main_path_first_iteration", [a.double() for a in main_args[B]])

    # registers, shared memory and spills as ptxas reports them, and the
    # residency they allow; the float32 build must not spill
    usage = {}
    for rec in ptxas_usage(_cuda_build.build_all().logs["backward_sweep"]):
        if "backward_sweep_kernel" in rec["function"]:
            usage["float32" if "IfE" in rec["function"] else "float64"] = rec
    resident = {"float32": resident_blocks_per_sm(torch.float32),
                "float64": resident_blocks_per_sm(torch.float64)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    spill32 = (usage.get("float32", {}).get("spill_store_bytes", 1)
               + usage.get("float32", {}).get("spill_load_bytes", 1))
    residency = {"ptxas": usage, "resident_blocks_per_sm": resident, "sms": sms,
                 "resident_problems_float32": resident["float32"] * sms,
                 "float32_spill_bytes": spill32}

    # timings at the main path's shapes and data (float32).  The inputs of
    # one launch (60 MB at B=256, 240 MB at B=1024) exceed the 50 MB L2, so
    # repeated launches find it cold as the solver's launches do.
    timing = {}
    for b in (1,) + BATCHES:
        args = main_args[b]
        outs = backward_box(*args, boxqp_iters=BOXQP_ITERS)
        ms = cuda_time_ms(lambda: backward_box(*args, boxqp_iters=BOXQP_ITERS))
        plain_ms = cuda_time_ms(
            lambda: backward_box_reference(*args, boxqp_iters=BOXQP_ITERS),
            reps=1, rounds=1)
        byte_ms = backward_bytes(args, outs) / PEAK_BYTES_PER_S * 1e3
        flop_ms = backward_flops(b, HORIZON, BOXQP_ITERS) / PEAK_FP32_FLOPS * 1e3
        timing[b] = {"ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(byte_ms, flop_ms),
                     "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
                     "bytes_ms": byte_ms, "operations_ms": flop_ms}
    emit({"phase": "kernels", "checks": checks, "timing_float32": timing, **residency})
    if failures:
        raise RuntimeError(f"kernel disagrees with its plain version: {failures}")
    if spill32 != 0:
        raise RuntimeError(f"backward kernel: the float32 build spills ({usage})")

    t = timing[B]
    return {"name": "backward_sweep", "route": "cuda",
            "source": "ffmpc_tpu_torch/csrc/backward_sweep.cu",
            "replaces": "ffmpc_tpu/solver/backward_pallas.py:237",
            "max_abs_err": max(main_rec["max_abs_err"].values()),
            "max_abs_err_by_field": main_rec["max_abs_err"],
            "max_rel_err_by_field": {n: e / main_rec["scale"][n]
                                     for n, e in main_rec["max_abs_err"].items()},
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": {"B": B, "N": HORIZON, "nx": NX, "nu": NU, "dtype": "float32"},
            "by_batch": {str(b): timing[b] for b in (1,) + BATCHES},
            "resident_blocks_per_sm": resident, "ptxas": usage}


def rollout_errors(out_a, out_b):
    """Per field: (per-problem max|a - b| over entries finite in both,
    per-problem max|b| over its finite entries), float64 (B,)."""
    B = out_b[0].shape[0]
    res = {}
    for name, a, b in zip(ROLLOUT_FIELDS, out_a, out_b):
        a, b = a.double().reshape(B, -1), b.double().reshape(B, -1)
        both = torch.isfinite(a) & torch.isfinite(b)
        zero = torch.zeros_like(b)
        err = torch.where(both, (a - b).abs(), zero).amax(dim=1)
        scale = torch.where(torch.isfinite(b), b.abs(), zero).amax(dim=1)
        res[name] = (err, scale)
    return res


def diverged_rows(out):
    """(B, A): the rollout rows whose states pass ROLLOUT_DIVERGED or whose
    cost is not finite."""
    xmax = out[0].abs().amax(dim=(2, 3))
    return ~(xmax <= ROLLOUT_DIVERGED) | ~torch.isfinite(out[2])


def without_rows(out, rows):
    """The rollout's outputs with the (B, A) `rows` set to NaN (left out of
    rollout_errors' errors and scales)."""
    nan = float("nan")
    xs, us, cost, dv = (a.clone() for a in out)
    xs[rows], us[rows], cost[rows], dv[rows] = nan, nan, nan, nan
    return xs, us, cost, dv


def rollout_gate(knot, args, out_k, knot64, out_r=None, ties=False, tie_rows=False):
    """The rollout kernel's outputs `out_k` on `args` against the plain
    version's (`out_r`, computed here if not given), at the gates above:
    float64 within ROLLOUT_TOL_F64 of every field's scale with equal
    non-finite sets; float32 against the plain float64 version's yardstick.
    `ties` (the classical checks): at float64 the rows diverged in either
    version are left out and counted (ROLLOUT_DIVERGED, MIN_AGREE_TIES).
    `tie_rows` (the point contact's classical checks): at float64 a problem
    agrees where each field is within its bar OR within TIE_FACTOR times
    the plain version's own distance under the rounding-level perturbation
    of its inputs (`perturbed`), on at least MIN_AGREE_TIES of the problems:
    rows on the edge of diverging amplify a rounding by their own growth.
    Returns the record, with "ok"."""
    f64 = args[1].dtype == torch.float64
    if out_r is None:
        out_r = rollout_reference(knot, *args, N_ALPHAS)
    div_ok = True
    if ties and f64:
        div_k, div_r = diverged_rows(out_k), diverged_rows(out_r)
        div_share = float((div_k == div_r).double().mean())
        div_ok = div_share >= MIN_AGREE_TIES
        out_k, out_r = without_rows(out_k, div_k | div_r), without_rows(out_r, div_k | div_r)
    errs = rollout_errors(out_k, out_r)
    nf_k, nf_r = (~torch.isfinite(o[2]) for o in (out_k, out_r))
    rec = {"B": int(args[1].shape[0]), "N": int(args[2].shape[1]),
           "A": N_ALPHAS, "dtype": "float64" if f64 else "float32",
           "nonfinite_cost_rows": int(nf_r.sum()),
           "nonfinite_rows_agree_share": float((nf_k == nf_r).double().mean()),
           "max_abs_err": {n: float(e.max()) for n, (e, _) in errs.items()},
           "scale": {n: float(sc.max()) for n, (_, sc) in errs.items()}}
    if ties and f64:
        rec.update(diverged_rows=int(div_r.sum()), diverged_rows_agree_share=div_share)
    if f64:
        ok = all(bool((torch.isfinite(a) == torch.isfinite(b)).all())
                 for a, b in zip(out_k, out_r))
        rec["nonfinite_sets_equal"] = ok
        ok = ok and div_ok
        if tie_rows:
            out_y = rollout_reference(knot, *perturbed(args[:7]), *args[7:], N_ALPHAS)
            if ties:
                out_y = without_rows(out_y, div_k | div_r)
            yard = rollout_errors(out_y, out_r)
            agree = torch.ones(rec["B"], dtype=torch.bool, device=args[1].device)
            for n, (e, sc) in errs.items():
                bar = ROLLOUT_TOL_F64["atol"] + ROLLOUT_TOL_F64["rtol"] * float(sc.max())
                agree &= (e <= bar) | (e <= TIE_FACTOR * yard[n][0])
            rec["max_abs_err_perturbed_plain_vs_plain"] = {
                n: float(e.max()) for n, (e, _) in yard.items()}
            rec["agree_share"] = float(agree.double().mean())
            ok = ok and rec["agree_share"] >= MIN_AGREE_TIES
        else:
            for n, (e, sc) in errs.items():
                ok = ok and (float(e.max()) <= ROLLOUT_TOL_F64["atol"]
                             + ROLLOUT_TOL_F64["rtol"] * float(sc.max()))
    else:
        out_64 = rollout_reference(knot64, *to_double(args), N_ALPHAS)
        yard = rollout_errors(out_r, out_64)
        ok = rec["nonfinite_rows_agree_share"] >= ROLLOUT_NONFINITE_AGREE
        agree = torch.ones(rec["B"], dtype=torch.bool, device=args[1].device)
        rel = {}
        for n, (e, sc) in errs.items():
            sc = sc.clamp_min(1e-30)
            rel_k, rel_p = e / sc, yard[n][0] / sc
            agree &= rel_k <= ROLLOUT_F32_FACTOR * rel_p + ROLLOUT_F32_FLOOR
            rel[n] = [float(rel_k.median()), float(rel_p.median()),
                      float(rel_k.max()), float(rel_p.max())]
            ok = ok and (rel[n][0] <= ROLLOUT_F32_FACTOR * rel[n][1]
                         + ROLLOUT_F32_FLOOR)
        rec["rel_err_median_kernel_vs_plain32__plain32_vs_plain64__max_max"] = rel
        rec["agree_share"] = float(agree.double().mean())
        ok = ok and rec["agree_share"] >= ROLLOUT_MIN_AGREE_F32
    rec["ok"] = bool(ok)
    return rec


def phase_rollout_kernel():
    """The rollout kernel against its plain version on the card at N=40,
    A=10, B=1024, all four outputs (xs_try, us_try, cost_try and the gap sums
    dv_try): seeded inputs and the main path's own first-iteration inputs,
    float64 and float32, and the free-space instantiation at float64; the
    seeded batch also as launches of 1 and of 3 problems (each launch's
    results equal to the whole batch's bit for bit, the pooled outputs held
    to the same gates); then ptxas' registers, stack and spills (the float32
    build must not spill), the resident blocks an SM and the waves they make,
    and its time against the plain version's at B=1, 256 and 1024.  Returns
    the rollout entry of the `kernels` line."""
    B = BATCHES[-1]
    checks, failures = [], []
    knot64 = flagship_knot(torch.float64)

    def check(label, knot, consts, args, out_k=None):
        if out_k is None:
            out_k = rollout(knot, consts, *args, N_ALPHAS)
        torch.cuda.synchronize()
        rec = {"case": label, **rollout_gate(knot, args, out_k, knot64)}
        checks.append(rec)
        if not rec["ok"]:
            failures.append(label + "/" + rec["dtype"])
        return rec

    def same_bits(out_small, out_full):
        n = out_small[0].shape[0]
        return all(bool(((a == b[:n]) | (torch.isnan(a) & torch.isnan(b[:n]))).all())
                   for a, b in zip(out_small, out_full))

    for dtype in (torch.float64, torch.float32):
        knot, consts, args = seeded_rollout_args(B, HORIZON, dtype, 7)
        out_full = rollout(knot, consts, *args, N_ALPHAS)
        check("seeded", knot, consts, args, out_full)
        for k in SMALL_BATCHES:
            n = B // k * k
            outs = [rollout(knot, consts, *rollout_slice(args, i, i + k), N_ALPHAS)
                    for i in range(0, n, k)]
            out_k = tuple(torch.cat(f) for f in zip(*outs))
            rec = check(f"seeded_launches_of_{k}", knot, consts, rollout_slice(args, 0, n),
                        out_k)
            rec["launch_B"] = k
            rec["same_bits_as_full_batch"] = same_bits(out_k, out_full)
            if not rec["same_bits_as_full_batch"]:
                rec["ok"] = False
                failures.append(rec["case"] + "/" + rec["dtype"] + "/bits")
    knot, consts, args = seeded_rollout_args(B, HORIZON, torch.float64, 7)
    free = make_augmented_knot(knot.model, flagship_weights(), surface=False)
    check("seeded_free_space", free,
          pack_knot_consts(free.model, free.W, free.surface, torch.float64).cuda(), args)
    main_rec = None
    for dtype in (torch.float64, torch.float32):
        knot, consts, args = main_path_rollout_args(B, dtype)
        rec = check("main_path_first_iteration", knot, consts, args)
        if dtype == torch.float32:
            main_rec = rec

    # registers, stack and spills as ptxas reports them, and the residency
    # they and the shared memory allow; the float32 build must not spill
    usage = {}
    for rec in ptxas_usage(_cuda_build.build_all().logs["rollout"]):
        if "rollout_kernel" in rec["function"]:
            key = ("float32" if "IfL" in rec["function"] else "float64") + (
                "_contact" if "Lb1E" in rec["function"] else "_free")
            usage[key] = rec
    resident = {"float32": rollout_resident_blocks_per_sm(torch.float32, N_ALPHAS),
                "float64": rollout_resident_blocks_per_sm(torch.float64, N_ALPHAS)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    spill32 = sum(usage.get(k, {}).get("spill_bytes_with_callees", 1)
                  for k in ("float32_contact", "float32_free"))
    per_block = rollout_problems_per_block(N_ALPHAS)
    blocks = {b: -(-b // per_block) for b in (1,) + BATCHES}
    residency = {"ptxas": usage, "resident_blocks_per_sm": resident, "sms": sms,
                 "problems_per_block": per_block, "blocks": blocks,
                 "waves_float32": {b: n / (resident["float32"] * sms)
                                   for b, n in blocks.items()},
                 "float32_spill_bytes": spill32}

    timing = {}
    for b in (1,) + BATCHES:
        knot, consts, args = main_path_rollout_args(b)
        outs = rollout(knot, consts, *args, N_ALPHAS)
        ms = cuda_time_ms(lambda: rollout(knot, consts, *args, N_ALPHAS))
        plain_ms = cuda_time_ms(lambda: rollout_reference(knot, *args, N_ALPHAS),
                                reps=1, rounds=1)
        byte_ms = rollout_bytes(args, outs) / PEAK_BYTES_PER_S * 1e3
        flop_ms = rollout_flops(b, HORIZON, N_ALPHAS) / PEAK_FP32_FLOPS * 1e3
        timing[b] = {"ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(byte_ms, flop_ms),
                     "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
                     "bytes_ms": byte_ms, "operations_ms": flop_ms}
    emit({"phase": "kernels", "kernel": "rollout", "checks": checks,
          "timing_float32": timing, **residency})
    if failures:
        raise RuntimeError(f"rollout kernel disagrees with its plain version: {failures}")
    if spill32 != 0:
        raise RuntimeError(f"rollout kernel: the float32 build spills ({usage})")
    t = timing[B]
    return {"name": "rollout", "route": "cuda",
            "source": "ffmpc_tpu_torch/csrc/rollout.cu",
            "replaces": "ffmpc_tpu/solver/rollout_pallas.py:63",
            "max_abs_err": max(main_rec["max_abs_err"].values()),
            "max_abs_err_by_field": main_rec["max_abs_err"],
            "max_rel_err_by_field": {n: e / max(main_rec["scale"][n], 1e-30)
                                     for n, e in main_rec["max_abs_err"].items()},
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": {"B": B, "N": HORIZON, "A": N_ALPHAS, "nx": NX, "nu": NU,
                      "dtype": "float32"},
            "by_batch": {str(b): timing[b] for b in (1,) + BATCHES},
            "resident_blocks_per_sm": resident, "ptxas": usage,
            "waves_float32": residency["waves_float32"][B]}


DIFF_TERM_FIELDS = ("cost_T", "LxT", "LxxT")


def diff_fields(d):
    """(name, tensor, number of leading knot dims) of every output field."""
    return ([(f"run.{n}", getattr(d.run, n), 2) for n in KnotDeriv._fields]
            + [(n, t, 1) for n, t in zip(DIFF_TERM_FIELDS, d[1:])])


def per_knot(a, lead):
    """(knots...) view of a field: one row of entries per knot."""
    return a.reshape(a.shape[:lead] + (-1,))


def to_double_refs(refs):
    return ProblemRefs(*(a.double() for a in refs))


def unilateral_edge(knot64, refs_run, ref_T, xs, us):
    """Running (B, N) and terminal (B,) masks of the knots whose float64
    contact force lies within UNILATERAL_EDGE_N of the unilateral barrier's
    bound (the knots where two float32 evaluations may take different sides);
    for the point contact, its normal force, or one of the friction cone's
    rows A f within UNILATERAL_EDGE_N of the cone's bound.  The torque: the
    augmented knot's torque state, the classical knot's control (0 at the
    terminal knot).  Free-space knots have no force."""
    B, N = us.shape[:2]
    if not knot64.surface:
        return (torch.zeros(B, N, dtype=torch.bool, device=xs.device),
                torch.zeros(B, dtype=torch.bool, device=xs.device))
    W = knot64.W
    point = W.contact_model == "point3d"

    def edge(x, tau, ref):
        z = ref.p_ref[..., 2] - W.z_press
        dyn = fwd_dynamics_contact(
            knot64.model, x[..., :7], x[..., 7:14], tau, nc1=not point,
            ref_pos=torch.cat([ref.p_ref[..., :2], z[..., None]], dim=-1) if point else z,
            baumgarte_kp=W.contact_gains[0], baumgarte_kd=W.contact_gains[1],
            damping_c=W.contact_inv_damping)
        near = (dyn.force[..., -1] - W.friction_margin).abs() <= UNILATERAL_EDGE_N
        if point:
            A = torch.tensor(_friction_cone_A(W.mu), dtype=x.dtype, device=x.device)
            cone = (A @ dyn.force[..., None])[..., 0]
            near |= ((cone - max(W.friction_margin, 0.0)).abs() <= UNILATERAL_EDGE_N).any(-1)
        return near
    xs, us = xs.double(), us.double()
    if knot64.family == "classical":
        tau_run, tau_T = us, torch.zeros_like(us[:, 0])
    else:
        tau_run, tau_T = xs[:, :-1, 14:], xs[:, -1, 14:]
    return (edge(xs[:, :-1], tau_run, to_double_refs(refs_run)),
            edge(xs[:, -1], tau_T, to_double_refs(ref_T)))


def half_turn_knots(model64, refs_run, ref_T, xs):
    """Knots whose tool orientation error lies within HALF_TURN_BAND of pi."""
    xs = xs.double()
    n = 0
    for y, ref in ((xs[:, :-1], refs_run), (xs[:, -1], ref_T)):
        R = fk(model64, y[..., :7]).ee_R
        err = log3(ref.R_des.double().transpose(-1, -2) @ R).norm(dim=-1)
        n += int((err > np.pi - HALF_TURN_BAND).sum())
    return n


def seeded_diff_args(B, N, dtype, seed):
    """Seeded derivative-pass inputs: the states, controls and references of
    the seeded rollout inputs (states around the neutral pose, controls around
    gravity torque, 2 Nm apart)."""
    knot, _, args = seeded_rollout_args(B, N, dtype, seed)
    _, xs, us, _, _, _, _, _, refs_run, ref_T = args
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype)
    return knot, consts, (xs, us, refs_run, ref_T)


def main_path_diff_args(B, dtype=torch.float32):
    """The derivative pass's inputs in the first iteration of the flagship
    solve."""
    it = main_path_first_iteration(B, dtype)
    knot = it["knot"]
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype)
    return knot, consts, (it["xs"], it["us"], it["refs_run"], it["ref_T"])


def diff_gate(knot, consts, inputs, knot64, out_k=None):
    """The derivative kernel against its plain version on `inputs` (xs, us,
    refs_run, ref_T), running and terminal knots, at the gates above:
    float64 within DIFF_TOL_F64 of every field's scale with the same
    non-finite (knot, field) pairs; float32 against the plain float64
    version (`knot64`, the same knot in float64) per knot, the unilateral
    edge's knots counted.  `out_k`: the kernel's outputs, launched here
    where not given.  Returns the record, with "ok"."""
    xs, us, refs_run, ref_T = inputs
    f64 = xs.dtype == torch.float64
    if out_k is None:
        out_k = diff_all(knot, consts, refs_run, ref_T, xs, us)
    torch.cuda.synchronize()
    out_p = diff_reference(knot, refs_run, ref_T, xs, us)
    torch.cuda.synchronize()
    rec = {"B": int(xs.shape[0]), "N": int(us.shape[1]),
           "dtype": "float64" if f64 else "float32",
           "nonfinite_knots_plain": {}, "max_abs_err": {}, "scale": {}}
    ok = True
    if f64:
        rec["max_rel_err"] = {}
        for (name, k, lead), (_, p, _) in zip(diff_fields(out_k), diff_fields(out_p)):
            bad_k, bad_p = ((~torch.isfinite(per_knot(a, lead))).any(-1) for a in (k, p))
            same = torch.equal(bad_k, bad_p)
            both = torch.isfinite(k) & torch.isfinite(p)
            fin = torch.isfinite(p)
            scale = max(float(p[fin].abs().max()), 1.0) if bool(fin.any()) else 1.0
            err = float((k - p)[both].abs().max()) if bool(both.any()) else 0.0
            rec["nonfinite_knots_plain"][name] = int(bad_p.sum())
            rec["max_abs_err"][name] = err
            rec["scale"][name] = scale
            rec["max_rel_err"][name] = err / scale
            if not same:
                rec.setdefault("nonfinite_knots_differ", []).append(name)
            ok = ok and same and err <= DIFF_TOL_F64 * scale
    else:
        in64 = (xs.double(), us.double(), to_double_refs(refs_run), to_double_refs(ref_T))
        out_64 = diff_reference(knot64, in64[2], in64[3], in64[0], in64[1])
        edge_run, edge_T = unilateral_edge(knot64, refs_run, ref_T, xs, us)
        n_knots = edge_run.numel() + edge_T.numel()
        n_edge = int(edge_run.sum() + edge_T.sum())
        rec.update(knots=n_knots, unilateral_edge_knots=n_edge,
                   half_turn_knots=half_turn_knots(knot64.model, refs_run, ref_T, xs),
                   violations={}, edge_knot_max_rel_err={}, max_abs_err_vs_plain64={},
                   max_rel_err_kernel32__plain32={}, worst_ratio_over_floor={})
        ok = n_edge <= DIFF_MAX_EDGE_SHARE * n_knots
        for (name, k, lead), (_, p, _), (_, r, _) in zip(
                diff_fields(out_k), diff_fields(out_p), diff_fields(out_64)):
            edge = edge_run if lead == 2 else edge_T
            scale = max(float(r.abs().max()), 1.0)
            ek = per_knot((k.double() - r).abs(), lead).amax(-1)
            ep = per_knot((p.double() - r).abs(), lead).amax(-1)
            floor = DIFF_F32_FLOOR * scale
            over = ~(ek <= DIFF_F32_FACTOR * ep + floor)    # NaN counts as over
            rec["max_abs_err"][name] = float(per_knot((k - p).abs(), lead).max())
            rec["max_abs_err_vs_plain64"][name] = float(ek.max())
            rec["scale"][name] = scale
            rec["nonfinite_knots_plain"][name] = int((~torch.isfinite(ep)).sum())
            rec["max_rel_err_kernel32__plain32"][name] = [float(ek.max()) / scale,
                                                          float(ep.max()) / scale]
            rec["worst_ratio_over_floor"][name] = float(
                ((ek - floor) / ep.clamp_min(1e-300)).max())
            rec["violations"][name] = int((over & ~edge).sum())
            rec["edge_knot_max_rel_err"][name] = (
                float(ek[edge].max()) / scale if bool(edge.any()) else None)
            ok = ok and not bool((over & ~edge).any())
    rec["ok"] = bool(ok)
    return rec


def phase_diff_kernel():
    """The knot-derivative kernel against its plain version on the card at
    N=40, B=1024, running and terminal knots: seeded inputs and the main
    path's own first-iteration inputs, float64 and float32, and the
    free-space instantiation on the seeded inputs at float64; then ptxas'
    registers, stack and spills (the float32 build must not spill), the
    resident blocks an SM and the waves they make, and its time against the
    plain version's at B=1, 256 and 1024.  Returns the knot_diff entry of the
    `kernels` line."""
    B = BATCHES[-1]
    W = flagship_weights()
    model64 = flagship(torch.float64)[0]
    knot64 = make_augmented_knot(model64, W, surface=True)
    checks, failures = [], []

    def check(label, knot, consts, inputs):
        rec = {"case": label, **diff_gate(knot, consts, inputs, knot64)}
        checks.append(rec)
        if not rec["ok"]:
            failures.append(label + "/" + rec["dtype"])
        return rec

    main_rec = None
    knot, consts, inputs = seeded_diff_args(B, HORIZON, torch.float64, 11)
    free = make_augmented_knot(knot.model, W, surface=False)
    check("seeded_free_space", free,
          pack_knot_consts(free.model, W, free.surface, torch.float64), inputs)
    for dtype in (torch.float64, torch.float32):
        check("seeded", *seeded_diff_args(B, HORIZON, dtype, 11))
        rec = check("main_path_first_iteration", *main_path_diff_args(B, dtype))
        if dtype == torch.float32:
            main_rec = rec

    # registers, stack and spills as ptxas reports them, and the residency
    # they and the shared memory allow; the float32 build must not spill
    usage = {}
    for rec in ptxas_usage(_cuda_build.build_all().logs["knot_diff"]):
        if "knot_diff_kernel" in rec["function"]:
            key = ("float32" if "IfL" in rec["function"] else "float64") + (
                "_contact" if "Lb1E" in rec["function"] else "_free")
            usage[key] = rec
    resident = {"float32": diff_resident_blocks_per_sm(torch.float32),
                "float64": diff_resident_blocks_per_sm(torch.float64)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    spill32 = sum(usage.get(k, {}).get("spill_bytes_with_callees", 1)
                  for k in ("float32_contact", "float32_free"))
    blocks = {b: -(-b * HORIZON // DIFF_KNOTS_PER_BLOCK) + -(-b // DIFF_KNOTS_PER_BLOCK)
              for b in (1,) + BATCHES}
    residency = {"ptxas": usage, "resident_blocks_per_sm": resident, "sms": sms,
                 "blocks": blocks,
                 "waves_float32": {b: n / (resident["float32"] * sms)
                                   for b, n in blocks.items()},
                 "float32_spill_bytes": spill32}

    timing = {}
    for b in (1,) + BATCHES:
        knot, consts, (xs, us, refs_run, ref_T) = main_path_diff_args(b)
        out = diff_all(knot, consts, refs_run, ref_T, xs, us)
        ms = cuda_time_ms(lambda: diff_all(knot, consts, refs_run, ref_T, xs, us))
        plain_ms = cuda_time_ms(lambda: diff_reference(knot, refs_run, ref_T, xs, us),
                                reps=1, rounds=1)
        byte_ms = diff_bytes((xs, us, refs_run, ref_T), out) / PEAK_BYTES_PER_S * 1e3
        flop_ms = diff_flops(b, HORIZON) / PEAK_FP32_FLOPS * 1e3
        timing[b] = {"ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(byte_ms, flop_ms),
                     "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
                     "bytes_ms": byte_ms, "operations_ms": flop_ms}
    emit({"phase": "kernels", "kernel": "knot_diff", "checks": checks,
          "timing_float32": timing, **residency})
    if failures:
        raise RuntimeError(f"diff kernel disagrees with its plain version: {failures}")
    if spill32 != 0:
        raise RuntimeError(f"knot_diff kernel: the float32 build spills ({usage})")
    t = timing[B]
    return {"name": "knot_diff", "route": "cuda",
            "source": "ffmpc_tpu_torch/csrc/knot_diff.cu",
            "replaces": "ffmpc_tpu/solver/diff_pallas.py:159",
            "also_replaces": "ffmpc_tpu/solver/diff_pallas.py:55",
            "max_abs_err": max(main_rec["max_abs_err"].values()),
            "max_abs_err_by_field": main_rec["max_abs_err"],
            "max_rel_err_by_field": {n: e / main_rec["scale"][n]
                                     for n, e in main_rec["max_abs_err"].items()},
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": {"B": B, "N": HORIZON, "nx": NX, "nu": NU, "dtype": "float32"},
            "by_batch": {str(b): timing[b] for b in (1,) + BATCHES},
            "resident_blocks_per_sm": resident, "ptxas": usage,
            "waves_float32": residency["waves_float32"][B]}


def assert_result_ok(res, B, N):
    shapes = dict(xs=(B, N + 1, NX), us=(B, N, NU), K=(B, N, NU, NX), k=(B, N, NU),
                  cost=(B,), stop=(B,), iters=(B,), converged=(B,), diverged=(B,),
                  feasible=(B,), xreg=(B,))
    for name, shape in shapes.items():
        t = getattr(res, name)
        if tuple(t.shape) != shape:
            raise RuntimeError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{name}: non-finite values")


def phase_small_reference():
    """Correctness on a small input: float64, B=4, N=5, the three kernels on
    (backward, rollout and diff mode "kernel") against the plain versions on
    the card.  rtol 1e-6 / atol 1e-7 scaled by each field's largest magnitude
    (reassociated sums; the bar of the CPU tests)."""
    dtype = torch.float64
    model, W, traj, ep, q0 = flagship(dtype)
    ep = EpisodeConfig(controller="force_feedback", horizon=5)
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=dtype, device="cuda")).cpu().numpy()
    rng = np.random.default_rng(5)
    ts, y0s, xs, us = warm_start_args(4, q0, tau_g, rng, horizon=5, dtype=np.float64)
    us[0] += 30.0 * rng.normal(size=(5, 7))       # bounds go active
    res = {}
    for mode in ("kernel", "plain"):
        solve = make_batched_solve_fn(
            model, W, FDDPSettings(max_iters=3, backward_mode=mode, rollout_mode=mode,
                                   diff_mode=mode),
            traj, ep, q0, dtype=dtype, device="cuda")
        res[mode] = solve(ts, y0s, xs, us)
    torch.cuda.synchronize()
    assert_result_ok(res["kernel"], 4, 5)
    worst = 0.0
    for name in ("xs", "us", "K", "k", "cost", "stop"):
        a, b = getattr(res["kernel"], name), getattr(res["plain"], name)
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        worst = max(worst, err / scale)
        if err > 1e-7 + 1e-6 * scale:
            raise RuntimeError(f"small f64 solve: {name} differs by {err} (scale {scale})")
    for name in ("iters", "converged", "diverged", "feasible"):
        if not torch.equal(getattr(res["kernel"], name), getattr(res["plain"], name)):
            raise RuntimeError(f"small f64 solve: {name} differs")
    emit({"phase": "small_reference", "dtype": "float64", "B": 4, "N": 5,
          "max_rel_err": worst, "iters": res["kernel"].iters.tolist()})


def phase_golden():
    """The force-feedback contact case of the framework-free solver fixture
    (tests/test_solver_golden.py: float64, N=12, 10 iterations, its own
    weights), solved on the card with the three kernels (the default
    settings), at that test's bar: us atol 1e-6, cost rtol 1e-8.  The
    measured distance is printed."""
    from ffmpc_tpu_torch.ocp.weights import OCPWeights
    dtype = torch.float64
    model = make_panda_model("plant", dtype=dtype, device="cuda")
    q0 = torch.as_tensor(KEYFRAMES["neutral"], dtype=dtype, device="cuda")
    tau_g = gravity_torque(model, q0)
    W = OCPWeights(**GOLDEN_W)
    N = 12
    x0 = torch.cat([q0, torch.zeros(7, dtype=dtype, device="cuda"), tau_g])
    refs_run, ref_T = build_problem_refs(
        flagship_trajectory(), torch.tensor([1.2], dtype=dtype, device="cuda"), N,
        W.dt_ocp, torch.cat([q0, torch.zeros(7, dtype=dtype, device="cuda")]), tau_g,
        make_vertical_down_R(), y_ref=x0, dtype=dtype, device="cuda")
    knot = make_augmented_knot(model, W, surface=True)
    launches = (backward_box.launches, rollout.launches, diff_all.launches)
    res = fddp_solve(knot, refs_run, ref_T, x0[None], x0.repeat(1, N + 1, 1),
                     tau_g.repeat(1, N, 1), FDDPSettings(max_iters=10))
    torch.cuda.synchronize()
    with np.load(Path(__file__).resolve().parent / GOLDEN_FIXTURE) as z:
        us_ref = z["ff_contact_vector_us"]
        cost_ref = float(z["ff_contact_vector_cost"])
    du = float(np.abs(res.us[0].cpu().numpy() - us_ref).max())
    dcost = abs(float(res.cost[0]) - cost_ref) / abs(cost_ref)
    rec = {"phase": "golden", "dtype": "float64", "N": N,
           "iters": int(res.iters[0]), "alpha_hist": res.alpha_hist[0].tolist(),
           "max_abs_du": du, "rel_dcost": dcost,
           "launches": {"backward_sweep": backward_box.launches - launches[0],
                        "rollout": rollout.launches - launches[1],
                        "knot_diff": diff_all.launches - launches[2]}}
    emit(rec)
    if not (du <= 1e-6 and dcost <= 1e-8):
        raise RuntimeError(f"golden fixture: max|du| {du}, relative cost {dcost}")
    if min(rec["launches"].values()) < rec["iters"]:
        raise RuntimeError(f"golden fixture: kernels not launched: {rec['launches']}")


def decisions_and_distance(a, b):
    """Share of problems on which two results took the same decisions, and
    how far apart their trajectories ended (per problem: max|du|, relative
    cost difference).  Decisions: iterations run, converged / diverged /
    feasible flags, and the step length accepted at each iteration."""
    B = a.us.shape[0]
    same = a.iters == b.iters
    for name in ("converged", "diverged", "feasible"):
        same &= getattr(a, name) == getattr(b, name)
    same_step = a.alpha_hist.double() == b.alpha_hist.double()       # (B, iters)
    leading = same_step.long().cumprod(dim=1).sum(dim=1).double()    # equal so far
    du = (a.us.double() - b.us.double()).abs().reshape(B, -1).amax(dim=1)
    dcost = (a.cost.double() - b.cost.double()).abs() / b.cost.double().abs()
    return {"same_decisions_share": float(same.double().mean()),
            "same_step_share_by_iteration": same_step.double().mean(dim=0).tolist(),
            "mean_leading_iterations_with_same_step": float(leading.mean()),
            "median_abs_du": float(du.median()), "max_abs_du": float(du.max()),
            "median_rel_dcost": float(dcost.median())}


def timed_solves(solve, args, n=SOLVE_REPEATS):
    """`n` solves of the same inputs, each ended by a synchronize: the result
    of the first and every wall time in ms."""
    first, times = None, []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = res
    return first, times


def rate_record(B, times):
    med = float(np.median(times))
    return {"ms_per_batch": med, "solves_per_s": B / med * 1e3,
            "ms_per_batch_min": min(times), "ms_per_batch_max": max(times),
            "solves_timed": len(times)}


def phase_solve():
    """The main path at full width: the three kernels (backward, rollout and
    diff mode "kernel") at B=256 and B=1024, with the launch counts read
    around its first timed solve; then the yardstick, the three plain
    versions, on the same inputs; and at B=256 two more paths, the backward
    and rollout kernels with the plain derivative pass, and the backward
    kernel alone.  Each mode first runs one untimed
    one-iteration solve (first uses of the libraries and of `torch.func`),
    then timed solves of the same inputs (SOLVE_REPEATS for the main path,
    PLAIN_REPEATS for the slower modes); the median and the range are
    printed.

    What the comparison can hold: the flagship problem barely penalizes the
    unfiltered torque w (weight 6e-4), so from these cold warm starts its
    minimizer is far from unique in `us`: rounding-level differences decide
    discrete events (a clamped control, the accepted step length) and two
    runs end up to the full box width (174 Nm) apart in `us` at nearly the
    same cost.  That holds between float32 and float64 runs of the SAME plain
    code, which is measured here at the smaller batch as the yardstick.  So
    the gates, for each kernel path against the plain one, are:
      - same iterations and flags on MIN_AGREE_SOLVE of the problems;
      - the same accepted step length in the first iteration (where both
        modes start from identical inputs) on MIN_AGREE_SOLVE of them;
      - at the smaller batch, the kernel path follows plain mode's step
        lengths at least as long as plain float32 follows plain float64,
        less LEADING_SLACK iterations (mean over problems of the number of
        leading iterations with equal step lengths);
      - at the smaller batch, a median relative cost difference between the
        kernel path and plain mode of at most twice that between plain
        float32 and plain float64, plus 1e-3.
    max|du| is stated, not gated.  Returns the main path's launch counts per
    batch size."""
    dtype = torch.float32
    model, W, traj, ep, q0 = flagship(dtype)
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=dtype, device="cuda")).cpu().numpy()

    def solver(modes, dt=dtype, mdl=model, iters=ITERS):
        bw, ro, df = modes
        return make_batched_solve_fn(
            mdl, W, FDDPSettings(max_iters=iters, backward_mode=bw, rollout_mode=ro,
                                 diff_mode=df),
            traj, ep, q0, surface=True, dtype=dt, device="cuda")

    def run_mode(modes, args, repeats):
        """Warm-up, then timed solves; launch counts of the first timed
        solve, set to 0 just before it and read just after."""
        solver(modes, iters=1)(*args)
        solve = solver(modes)
        backward_box.launches = 0
        rollout.launches = 0
        diff_all.launches = 0
        res, ms = timed_solves(solve, args, 1)
        counts = {"backward_sweep": backward_box.launches, "rollout": rollout.launches,
                  "knot_diff": diff_all.launches}
        ms += timed_solves(solve, args, repeats - 1)[1]
        assert_result_ok(res, args[1].shape[0], HORIZON)
        return res, ms, counts

    def gate(name, rec, kp, p64):
        ok = (kp["same_decisions_share"] >= MIN_AGREE_SOLVE
              and kp["same_step_share_by_iteration"][0] >= MIN_AGREE_SOLVE)
        if p64 is not None:
            ok = ok and (kp["median_rel_dcost"]
                         <= 2.0 * p64["median_rel_dcost"] + 1e-3)
            ok = ok and (kp["mean_leading_iterations_with_same_step"]
                         >= p64["mean_leading_iterations_with_same_step"]
                         - LEADING_SLACK)
        if not ok:
            raise RuntimeError(f"B={rec['B']}: {name} and plain mode disagree: {rec}")

    KERNELS, PLAIN = ("kernel",) * 3, ("plain",) * 3
    DIFF_PLAIN, BACKWARD_ONLY = ("kernel", "kernel", "plain"), ("kernel", "plain", "plain")

    def launched(counts, res, expect):
        """Each kernel of the path launched once an iteration, the others
        never."""
        iters_run = max(int(res.iters.max()), 1)
        for name, mode in zip(("backward_sweep", "rollout", "knot_diff"), expect):
            if (counts[name] < iters_run) if mode == "kernel" else counts[name]:
                raise RuntimeError(f"B={res.us.shape[0]}: launches {counts} for "
                                   f"{iters_run} iterations of modes {expect}")

    solve_plain64 = solver(PLAIN, torch.float64, flagship(torch.float64)[0])
    rng = np.random.default_rng(0)
    launches = {}
    for B in BATCHES:
        args = warm_start_args(B, q0, tau_g, rng)
        res_k, ms_k, counts = run_mode(KERNELS, args, SOLVE_REPEATS)
        launches[B] = counts
        launched(counts, res_k, KERNELS)
        res_p, ms_p, counts_p = run_mode(PLAIN, args, PLAIN_REPEATS)
        if any(counts_p.values()):
            raise RuntimeError(f"B={B}: plain mode launched kernels: {counts_p}")
        kp = decisions_and_distance(res_k, res_p)
        rec = {"phase": "solve", "B": B, "N": HORIZON, "max_iters": ITERS,
               "dtype": "float32", "kernel_launches": counts,
               "mean_iters": float(res_k.iters.double().mean()),
               "converged": int(res_k.converged.sum()),
               "diverged": int(res_k.diverged.sum()),
               "feasible": int(res_k.feasible.sum()),
               "mean_cost": float(res_k.cost.mean()),
               "kernel_mode": rate_record(B, ms_k),
               "plain_mode": rate_record(B, ms_p),
               "kernel32_vs_plain32": kp,
               "min_same_decisions_share": MIN_AGREE_SOLVE}
        p64 = None
        if B == BATCHES[0]:
            p64 = decisions_and_distance(res_p, solve_plain64(*args))
            rec["plain32_vs_plain64"] = p64
            for key, modes in (("plain_diff", DIFF_PLAIN),
                               ("backward_kernel_only", BACKWARD_ONLY)):
                res_b, ms_b, counts_b = run_mode(modes, args, PLAIN_REPEATS)
                launched(counts_b, res_b, modes)
                kb = decisions_and_distance(res_b, res_p)
                rec[key] = {"launches": counts_b, "rate": rate_record(B, ms_b),
                            "vs_plain32": kb}
                gate(key, rec, kb, p64)
        emit(rec)
        gate("kernel mode", rec, kp, p64)
    return launches


# ---------------------------------------------------------------------------
# phase classical: the classical controller's batched solve (x = (q, v),
# u = tau, nx = 14, N = 36) on the classical instantiations of the kernels
# ---------------------------------------------------------------------------

CL_NX, CL_HORIZON = 14, 36
# csrc sources of the classical instantiations (one nvcc each)
CL_LIBRARIES = {"backward_sweep": "backward_sweep_nx14", "rollout": "rollout_classical",
                "knot_diff": "knot_diff_classical"}
# the fixture's classical contact case: the step lengths the JAX package's
# solver accepts at its 10 iterations (tests/test_torch_classical.py, which
# prints them anew when run as a script)
GOLDEN_CONTACT_ALPHAS = (1.0, 1.0, 1.0, 1.0, 0.25, 0.25, 1.0, 0.5, 0.5, 0.25)


def classical_knot(dtype, surface=True):
    return make_classical_knot(flagship(dtype)[0], flagship_weights(), surface)


def classical_warm_starts(B, q0, tau_g, rng, dtype=np.float32, horizon=CL_HORIZON):
    """Warm starts as the main path's are built, on x = (q, v): x0 around the
    neutral pose at rest, trajectory held at x0, controls at gravity torque."""
    x0 = np.concatenate([q0, np.zeros(7)]).astype(dtype)
    x0s = x0[None] + 0.02 * rng.normal(size=(B, CL_NX)).astype(dtype)
    ts = np.full((B,), 1.2, dtype)
    xs = np.tile(x0s[:, None, :], (1, horizon + 1, 1))
    us = np.tile(tau_g.astype(dtype)[None, None], (B, horizon, 1))
    return ts, x0s, xs, us


def classical_first_iteration(B, dtype=torch.float32, surface=True):
    """The classical solve's first iteration at batch B, as its main path
    builds it (warm starts, seed 0; the references without a state
    reference), for the contact or the free-space knot."""
    model, W, traj, _, q0 = flagship(dtype)
    knot = make_classical_knot(model, W, surface=surface)
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=dtype, device="cuda")).cpu().numpy()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    ts, x0s, xs, us = (torch.as_tensor(a, device="cuda") for a in classical_warm_starts(
        B, q0, tau_g, np.random.default_rng(0), dtype=np_dtype))
    x_reg = torch.cat([torch.as_tensor(q0, dtype=dtype, device="cuda"),
                       torch.zeros(7, dtype=dtype, device="cuda")])
    refs_run, ref_T = build_problem_refs(
        traj, ts, CL_HORIZON, W.dt_ocp, x_reg, gravity_torque(model, x0s[:, :7]),
        make_vertical_down_R(), dtype=dtype, device="cuda")
    refs_run = ProblemRefs(*(a.contiguous() for a in refs_run))
    ref_T = ProblemRefs(*(a.contiguous() for a in ref_T))
    feasible = torch.zeros(B, dtype=torch.bool, device="cuda")
    bi = backward_inputs(diff_reference(knot, refs_run, ref_T, xs, us), x0s, xs, us,
                         feasible, *control_bounds(knot, dtype, "cuda"))
    return dict(knot=knot, bi=bi, refs_run=refs_run, ref_T=ref_T, x0=x0s, xs=xs, us=us)


def classical_rollout_args(it):
    """The rollout's inputs from a classical first iteration (`it`): K, kff
    and the gap products from the backward kernel.  (knot, consts on the
    card, args)."""
    knot, dtype = it["knot"], it["xs"].dtype
    reg = torch.full((it["xs"].shape[0],), 1e-9, dtype=dtype, device="cuda")
    out = backward_box(*it["bi"].args, reg, reg, boxqp_iters=BOXQP_ITERS, kgain_reg=KGAIN_REG)
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype, knot.family).cuda()
    return knot, consts, (it["x0"], it["xs"], it["us"], out[0], out[1], it["bi"].fs, out[6],
                          it["bi"].feasible, it["refs_run"], it["ref_T"])


def classical_seeded_rollout_args(B, N, dtype, seed, surface=True):
    """Seeded classical rollout inputs (seeded_rollout_args' recipe at
    nx = 14).  (knot, consts on the card, args)."""
    model, W, traj, _, q0 = flagship(dtype)
    knot = make_classical_knot(model, W, surface=surface)
    rng = np.random.default_rng(seed)

    def T(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()

    q = torch.as_tensor(q0, dtype=dtype, device="cuda")
    tau_g = gravity_torque(model, q)
    x_reg = torch.cat([q, torch.zeros(7, dtype=dtype, device="cuda")])
    x0 = (x_reg[None] + 0.05 * T(rng.normal(size=(B, CL_NX)))).contiguous()
    xs = (x0[:, None].repeat(1, N + 1, 1)
          + 0.02 * T(rng.normal(size=(B, N + 1, CL_NX)))).contiguous()
    us = (tau_g.repeat(B, N, 1) + 2.0 * T(rng.normal(size=(B, N, NU)))).contiguous()
    K = 0.1 * T(rng.normal(size=(B, N, NU, CL_NX)))
    kff = T(rng.normal(size=(B, N, NU)))
    fs = 0.1 * T(rng.normal(size=(B, N + 1, CL_NX)))
    w_all = 0.3 * T(rng.normal(size=(B, N + 1, CL_NX)))
    feasible = torch.arange(B, device="cuda") % 2 == 1
    refs_run, ref_T = build_problem_refs(
        traj, torch.full((B,), 1.2, dtype=dtype, device="cuda"), N, W.dt_ocp, x_reg,
        tau_g, make_vertical_down_R(), dtype=dtype, device="cuda")
    refs_run = ProblemRefs(*(a.contiguous() for a in refs_run))
    ref_T = ProblemRefs(*(a.contiguous() for a in ref_T))
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype, knot.family).cuda()
    return knot, consts, (x0, xs, us, K, kff, fs, w_all, feasible, refs_run, ref_T)


def classical_kernel_checks(kernel, dtype, surface, B=None, N=CL_HORIZON):
    """One classical instantiation against its plain version on the card at
    N=36, batch B (1,024 by default), at the gates of the augmented
    instantiation's phase: on seeded inputs and on the classical main path's
    first-iteration inputs, for the contact (`surface`) or the free-space
    knot.  The backward sweep, which has no knot, takes the seeded recipe
    with the bounds inactive beside the contact knot and active beside the
    free one.  Returns the records, each with "ok"."""
    B = B or BATCHES[-1]
    it = classical_first_iteration(B, dtype, surface)
    tag = "contact" if surface else "free"
    knot64 = classical_knot(torch.float64, surface)
    recs = []
    if kernel == "backward_sweep":
        tight = not surface
        reg = torch.full((B,), 1e-9, dtype=dtype, device="cuda")
        cases = ((f"seeded_bounds_{'active' if tight else 'inactive'}",
                  random_backward_args(B, N, tight, dtype, 1, nx=CL_NX)),
                 (f"main_path_first_iteration_{tag}", list(it["bi"].args) + [reg, reg]))
        for label, args in cases:
            recs.append({"case": label, **backward_gate(args, ties=True)})
    elif kernel == "knot_diff":
        seeded = classical_seeded_rollout_args(B, N, dtype, 11, surface)
        cases = (("seeded_" + tag, seeded[0], seeded[2][1:3] + seeded[2][8:10]),
                 ("main_path_first_iteration_" + tag, it["knot"],
                  (it["xs"], it["us"], it["refs_run"], it["ref_T"])))
        for label, kn, inputs in cases:
            consts = pack_knot_consts(kn.model, kn.W, kn.surface, dtype, kn.family)
            recs.append({"case": label, **diff_gate(kn, consts, inputs, knot64)})
    else:
        for label, (kn, consts, args) in (
                ("seeded_" + tag, classical_seeded_rollout_args(B, N, dtype, 7, surface)),
                ("main_path_first_iteration_" + tag, classical_rollout_args(it))):
            out_k = rollout(kn, consts, *args, N_ALPHAS)
            torch.cuda.synchronize()
            recs.append({"case": label, **rollout_gate(kn, args, out_k, knot64, ties=True)})
    for rec in recs:
        rec.update(kernel=kernel, family="classical")
    return recs


def classical_timing(kernel, b):
    """The classical instantiation's time on the classical main path's
    first-iteration inputs (float32, contact) at batch b and its bound; the
    plain version's time at the largest batch only (one timed call: the
    plain versions are Python loops over the knots, about as slow at every
    batch, and their timing is this phase's largest cost)."""
    it = classical_first_iteration(b)
    if kernel == "backward_sweep":
        reg = torch.full((b,), 1e-9, dtype=torch.float32, device="cuda")
        args = list(it["bi"].args) + [reg, reg]
        outs = backward_box(*args, boxqp_iters=BOXQP_ITERS)
        run = lambda: backward_box(*args, boxqp_iters=BOXQP_ITERS)  # noqa: E731
        plain = lambda: backward_box_reference(*args, boxqp_iters=BOXQP_ITERS)  # noqa: E731
        nbytes = backward_bytes(args, outs)
        flops = backward_flops(b, CL_HORIZON, BOXQP_ITERS, nx=CL_NX)
    elif kernel == "knot_diff":
        knot = it["knot"]
        consts = pack_knot_consts(knot.model, knot.W, knot.surface, torch.float32, knot.family)
        xs, us, refs_run, ref_T = inputs = (it["xs"], it["us"], it["refs_run"], it["ref_T"])
        out = diff_all(knot, consts, refs_run, ref_T, xs, us)
        run = lambda: diff_all(knot, consts, refs_run, ref_T, xs, us)  # noqa: E731
        plain = lambda: diff_reference(knot, refs_run, ref_T, xs, us)  # noqa: E731
        nbytes = diff_bytes(inputs, out)
        flops = diff_flops(b, CL_HORIZON, family="classical")
    else:
        knot, consts, args = classical_rollout_args(it)
        outs = rollout(knot, consts, *args, N_ALPHAS)
        run = lambda: rollout(knot, consts, *args, N_ALPHAS)  # noqa: E731
        plain = lambda: rollout_reference(knot, *args, N_ALPHAS)  # noqa: E731
        nbytes = rollout_bytes(args, outs)
        flops = rollout_flops(b, CL_HORIZON, N_ALPHAS, nx=CL_NX)
    ms = cuda_time_ms(run)
    plain_ms = cuda_time_ms(plain, reps=1, rounds=1) if b == BATCHES[-1] else None
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
            "bytes_ms": byte_ms, "operations_ms": flop_ms}


def classical_residency(kernel):
    """ptxas' registers, stack and spills of the classical instantiation's
    kernels, and the resident blocks an SM of its float32 and float64
    builds."""
    usage = {}
    for rec in ptxas_usage(_cuda_build.build_all().logs[CL_LIBRARIES[kernel]]):
        if kernel + "_kernel" not in rec["function"]:
            continue
        key = "float32" if re.search(r"_kernelIf[LE]", rec["function"]) else "float64"
        if kernel != "backward_sweep":
            key += "_contact" if "Lb1E" in rec["function"] else "_free"
        usage[key] = rec
    resident = {}
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        if kernel == "backward_sweep":
            resident[name] = resident_blocks_per_sm(dt, nx=CL_NX)
        elif kernel == "knot_diff":
            resident[name] = diff_resident_blocks_per_sm(dt, family="classical")
        else:
            resident[name] = rollout_resident_blocks_per_sm(dt, N_ALPHAS, family="classical")
    spill32 = sum(v.get("spill_bytes_with_callees", 1)
                  for k, v in usage.items() if k.startswith("float32"))
    return {"ptxas": usage, "resident_blocks_per_sm": resident, "float32_spill_bytes": spill32,
            "float32_builds": sum(k.startswith("float32") for k in usage)}


def classical_golden(case):
    """The fixture's classical case (tests/test_torch_classical.py's
    gates) solved on the card with the three kernels."""
    from ffmpc_tpu_torch.ocp.weights import OCPWeights
    dtype = torch.float64
    model = make_panda_model("plant", dtype=dtype, device="cuda")
    q0 = np.asarray(KEYFRAMES["neutral"])
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=dtype, device="cuda")).cpu().numpy()
    Ng, surface = 12, case == "classical_contact"
    solve = make_batched_solve_fn(
        model, OCPWeights(**GOLDEN_W), FDDPSettings(max_iters=10), flagship_trajectory(),
        EpisodeConfig(controller="classical", horizon=Ng), q0, surface=surface,
        dtype=dtype, device="cuda")
    x0 = np.concatenate([q0, np.zeros(7)])
    reset_launches()
    res = solve(np.array([1.2 if surface else 0.3]), x0[None], np.tile(x0, (1, Ng + 1, 1)),
                np.tile(tau_g, (1, Ng, 1)))
    torch.cuda.synchronize()
    counts = read_launches()
    with np.load(Path(__file__).resolve().parent / GOLDEN_FIXTURE) as z:
        us_ref = z[f"{case}_vector_us"]
        cost_ref = float(z[f"{case}_vector_cost"])
        cost_other = float(z[f"{case}_scalar_cost"])
    du = float(np.abs(res.us[0].cpu().numpy() - us_ref).max())
    dcost = abs(float(res.cost[0]) - cost_ref) / abs(cost_ref)
    rec = {"phase": "classical", "case": "golden_" + case, "dtype": "float64", "N": Ng,
           "iters": int(res.iters[0]), "alpha_hist": res.alpha_hist[0].tolist(),
           "max_abs_du": du, "rel_dcost": dcost, "launches": counts}
    if surface:
        spread = abs(cost_other - cost_ref) / abs(cost_ref)
        rec.update(fixture_rel_cost_spread=spread, gate="decisions and cost")
        ok = (rec["iters"] == len(GOLDEN_CONTACT_ALPHAS)
              and tuple(rec["alpha_hist"]) == GOLDEN_CONTACT_ALPHAS and dcost <= 2.0 * spread)
    else:
        rec["gate"] = "us atol 1e-6, cost rtol 1e-8"
        ok = du <= 1e-6 and dcost <= 1e-8
    ok = ok and min(counts.values()) >= rec["iters"]
    rec["ok"] = bool(ok)
    emit(rec)
    return rec


def phase_classical():
    """The classical controller's batched solve on the classical
    instantiations of the three kernels (backward sweep at nx = 14, the
    derivative and rollout kernels on the classical knot family):
    (1) each instantiation against its plain version at N=36, B=1024, on
    seeded inputs and on the classical main path's first-iteration inputs,
    float64 and float32, contact and free, at the gates of the augmented
    instantiations' phases; ptxas' registers, stack and spills (no float32
    build may spill) and the resident blocks an SM; each one's time, plain
    time and bound at B=1 / 256 / 1024 (float32, contact);
    (2) the golden fixture's classical_free and classical_contact cases on
    the card with the kernels (float64, N=12);
    (3) the main path: `make_batched_solve_fn(controller="classical",
    horizon=36)` on the flagship weights and trajectory, the contact knot,
    float32, 10 iterations, B=256 and 1024, the three kernels, timed (host
    clock, the median of SOLVE_REPEATS solves), its launches read around
    its first timed solve; at B=256 against plain mode on the same inputs
    (PLAIN_REPEATS solve).  The classical contact solve from these warm
    starts sits on the box QP's ties at float32 (the first iteration's
    free sets change on half the problems under a one-ulp perturbation), so
    decisions are gated at float64, at B=256: the kernels and plain mode
    take the same decisions on MIN_AGREE_SOLVE of the problems; at float32
    the kernel path stays as close to plain mode as plain float32 to plain
    float64 (phase solve's yardstick gates), and its share of equal
    decisions is printed.  Returns (the classical figures of each kernel,
    the launch counts of the B=1024 solve)."""
    failures = []
    checks = {}
    for kernel in ("backward_sweep", "knot_diff", "rollout"):
        checks[kernel] = []
        for dtype in (torch.float64, torch.float32):
            for surface in (True, False):
                for rec in classical_kernel_checks(kernel, dtype, surface):
                    checks[kernel].append(rec)
                    if not rec["ok"]:
                        failures.append(f"{kernel}/{rec['case']}/{rec['dtype']}")
        emit({"phase": "classical", "kernel": kernel, "checks": checks[kernel]})
    figures = {}
    for kernel in ("backward_sweep", "knot_diff", "rollout"):
        res = classical_residency(kernel)
        res["by_batch"] = {str(b): classical_timing(kernel, b) for b in (1,) + BATCHES}
        # the error on the main path's inputs at float64, where the contact
        # problem is resolved (the backward sweep's over the problems with
        # the same free sets, the rollout's over the rows not diverged); at
        # float32 the first iteration's ties make it a draw (the checks)
        main = [r for r in checks[kernel]
                if r["dtype"] == "float64" and r["case"] == "main_path_first_iteration_contact"]
        res["max_abs_err"] = max(main[0].get("same_free_set_max_abs_err",
                                             main[0]["max_abs_err"]).values())
        res["max_abs_err_dtype"] = "float64"
        figures[kernel] = res
        emit({"phase": "classical", "kernel": kernel, **res})
        if res["float32_spill_bytes"] != 0 or res["float32_builds"] == 0:
            failures.append(f"{kernel}: float32 spill or no float32 build {res['ptxas']}")
    for case in ("classical_free", "classical_contact"):
        if not classical_golden(case)["ok"]:
            failures.append("golden_" + case)
    if failures:
        raise RuntimeError(f"classical instantiations: {failures}")
    return figures, classical_solves()


def classical_solves():
    """Phase classical's (3): the classical main path's solves; returns the
    launch counts of the B=1024 solve."""
    dtype = torch.float32
    model, W, traj, _, q0 = flagship(dtype)
    model64 = flagship(torch.float64)[0]
    ep = EpisodeConfig(controller="classical", horizon=CL_HORIZON)
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=dtype, device="cuda")).cpu().numpy()

    def solver(mode, iters=ITERS, dt=dtype, mdl=model):
        return make_batched_solve_fn(
            mdl, W, FDDPSettings(max_iters=iters, backward_mode=mode, rollout_mode=mode,
                                 diff_mode=mode),
            traj, ep, q0, surface=True, dtype=dt, device="cuda")

    def run(mode, args, repeats, dt=dtype, mdl=model):
        """Warm-up, then timed solves; the launch counts of the first."""
        solver(mode, 1, dt, mdl)(*args)
        solve = solver(mode, ITERS, dt, mdl)
        reset_launches()
        res, ms = timed_solves(solve, args, 1)
        counts = read_launches()
        ms += timed_solves(solve, args, repeats - 1)[1]
        return res, ms, counts

    rng = np.random.default_rng(0)
    launches = {}
    for B in BATCHES:
        args = classical_warm_starts(B, q0, tau_g, rng)
        res_k, ms_k, counts = run("kernel", args, SOLVE_REPEATS)
        launches[B] = counts
        iters_run = max(int(res_k.iters.max()), 1)
        rec = {"phase": "classical", "case": "solve", "B": B, "N": CL_HORIZON,
               "max_iters": ITERS, "dtype": "float32", "kernel_launches": counts,
               "launches_a_solve": sum(counts.values()),
               "mean_iters": float(res_k.iters.double().mean()),
               "converged": int(res_k.converged.sum()), "diverged": int(res_k.diverged.sum()),
               "feasible": int(res_k.feasible.sum()), "mean_cost": float(res_k.cost.mean()),
               "kernel_mode": rate_record(B, ms_k), "min_same_decisions_share": MIN_AGREE_SOLVE}
        res_shape = (tuple(res_k.xs.shape), tuple(res_k.us.shape))
        if res_shape != ((B, CL_HORIZON + 1, CL_NX), (B, CL_HORIZON, NU)) or not all(
                bool(torch.isfinite(t).all()) for t in (res_k.xs, res_k.us, res_k.cost)):
            emit(rec)
            raise RuntimeError(f"classical solve B={B}: shapes {res_shape} or non-finite")
        if min(counts.values()) < iters_run:
            emit(rec)
            raise RuntimeError(f"classical solve B={B}: launches {counts} for {iters_run} "
                               "iterations")
        if B != BATCHES[0]:
            # the plain comparisons, at the smaller batch only (each plain
            # solve takes 20-40 s of host time)
            emit(rec)
            continue
        res_p, ms_p, counts_p = run("plain", args, PLAIN_REPEATS)
        kp = decisions_and_distance(res_k, res_p)
        # the yardstick, plain float32 against plain float64, and the
        # float64 gate: the kernels against plain mode at float64
        args64 = tuple(np.asarray(a, np.float64) for a in args)
        res_p64 = run("plain", args64, 1, torch.float64, model64)[0]
        res_k64, _, counts64 = run("kernel", args64, 1, torch.float64, model64)
        yard = decisions_and_distance(res_p, res_p64)
        k64 = decisions_and_distance(res_k64, res_p64)
        rec.update(plain_mode=rate_record(B, ms_p), kernel32_vs_plain32=kp,
                   plain32_vs_plain64=yard, kernel64_vs_plain64=k64,
                   kernel64_launches=counts64)
        emit(rec)
        if (k64["same_decisions_share"] < MIN_AGREE_SOLVE
                or k64["same_step_share_by_iteration"][0] < MIN_AGREE_SOLVE):
            raise RuntimeError(f"classical solve B={B}, float64: kernel and plain mode "
                               f"disagree: {k64}")
        if any(counts_p.values()):
            raise RuntimeError(f"classical solve B={B}: plain mode launched kernels: {counts_p}")
        # float32 against the yardstick (phase solve's second-tier gates)
        if (kp["mean_leading_iterations_with_same_step"]
                < yard["mean_leading_iterations_with_same_step"] - LEADING_SLACK
                or kp["median_rel_dcost"] > 2.0 * yard["median_rel_dcost"] + 1e-3):
            raise RuntimeError(f"classical solve B={B}: kernel and plain mode further apart "
                               f"than plain float32 and float64: {kp} against {yard}")
    return launches[BATCHES[-1]]


def phase_stages():
    """Where one iteration's time goes on the main path: the first
    iteration's inputs at B=1024, float32, each module-level function that
    `fddp.solve` calls timed on the host clock around the call, ended by
    `torch.cuda.synchronize()` (the solve is host-bound, so kernel-only
    events would hide the launch cost).  The derivative pass is split into
    the knot derivatives (the kernel, or the plain version's running and
    terminal calls timed apart) and the glue `backward_inputs` (cost, gaps,
    bounds); the final cost of the returned trajectory (`knot.calc` +
    `knot.term_calc`, once per solve) is timed too.  Median of 3 calls each
    after one warm-up, in ms."""
    B = BATCHES[-1]
    it = main_path_first_iteration(B)
    knot, bi = it["knot"], it["bi"]
    rr, rT, xs, us = it["refs_run"], it["ref_T"], it["xs"], it["us"]
    reg = torch.full((B,), 1e-9, dtype=torch.float32, device="cuda")
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, torch.float32)
    consts_card = consts.cuda()  # the rollout's, as fddp.solve copies them
    state = {}

    def diff_kernel():
        state["d"] = diff_all(knot, consts, rr, rT, xs, us)

    def diff_running():
        knot.diff(rr, xs[:, :-1], us)

    def diff_terminal():
        knot.term_diff(rT, xs[:, -1])

    def glue():
        backward_inputs(state["d"], it["x0"], xs, us, bi.feasible, *it["bounds"])

    def bw():
        state["out"] = backward_box(*bi.args, reg, reg, boxqp_iters=BOXQP_ITERS,
                                    kgain_reg=KGAIN_REG)

    def bw_plain():
        backward_box_reference(*bi.args, reg, reg, boxqp_iters=BOXQP_ITERS,
                               kgain_reg=KGAIN_REG)

    diff_kernel()
    bw()
    K, kff, _, dg, dq, _, w_all = state["out"]
    r_args = (it["x0"], xs, us, K, kff, bi.fs, w_all, bi.feasible, rr, rT)

    def ro_kernel():
        state["try"] = rollout(knot, consts_card, *r_args, N_ALPHAS)

    def ro_plain():
        rollout_reference(knot, *r_args, N_ALPHAS)

    def accept():
        xs_try, us_try, cost_try, dv = state["try"]
        accept_step(FDDPSettings(), xs, us, bi.cost_cur, xs_try, us_try, cost_try, dv, dg, dq)

    def gap_sum_plain():
        gap_sum(xs, state["try"][0], w_all)

    def final_cost():
        _, costs = knot.calc(rr, xs[:, :-1], us)
        torch.sum(costs, dim=1) + knot.term_calc(rT, xs[:, -1])

    def host_ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    stages = {"knot_diff": host_ms(diff_kernel),
              "diff_reference_running": host_ms(diff_running),
              "diff_reference_terminal": host_ms(diff_terminal),
              "backward_inputs": host_ms(glue),
              "backward_box": host_ms(bw), "backward_box_reference": host_ms(bw_plain),
              "rollout": host_ms(ro_kernel), "rollout_reference": host_ms(ro_plain),
              "accept_step": host_ms(accept), "gap_sum_reference": host_ms(gap_sum_plain),
              "final_cost_per_solve": host_ms(final_cost)}
    plain_diff = stages["diff_reference_running"] + stages["diff_reference_terminal"]
    per_iter = {
        "kernel": stages["knot_diff"] + stages["backward_box"] + stages["rollout"],
        "plain_diff": plain_diff + stages["backward_box"] + stages["rollout"],
        "plain": plain_diff + stages["backward_box_reference"] + stages["rollout_reference"]}
    for k in per_iter:
        per_iter[k] += stages["backward_inputs"] + stages["accept_step"]
    kernel_stages = ("knot_diff", "backward_inputs", "backward_box", "rollout",
                     "accept_step")
    emit({"phase": "stages", "B": B, "N": HORIZON, "dtype": "float32",
          "ms": stages, "iteration_ms_by_mode": per_iter,
          "device": {"accept_step": device_figures(accept),
                     "gap_sum_reference": device_figures(gap_sum_plain)},
          "share_of_kernel_mode_iteration": {
              k: stages[k] / per_iter["kernel"] for k in kernel_stages},
          "final_cost_share_of_kernel_mode_solve": stages["final_cost_per_solve"] / (
              ITERS * per_iter["kernel"] + stages["final_cost_per_solve"])})


# ---------------------------------------------------------------------------
# The probes (csrc/probes.cu) and the closed loop: plant, episode, B=1 legs,
# ensemble.
# ---------------------------------------------------------------------------

def stream_bytes_flops(stage, n_knots=4, lanes=128):
    """Bytes a probe stream stage must move (the knot rows it reads, the
    second input, the outputs it writes; float32) and the operations it does,
    counted from the loops of csrc/probes.cu per lane and knot."""
    rows_read = {1: 8, 2: 595, 3: 595, 4: 441, 5: 588, 6: 588}[stage]
    rows_out = 8 / n_knots + (448 if stage >= 4 else 0) + (160 if stage == 6 else 0)
    term = 21 * lanes if stage == 6 else 0
    nbytes = 4 * (n_knots * lanes * (rows_read + rows_out) + term)
    per_knot = {1: 8, 4: 8,
                2: 9443,            # U, Quu, Fx s, Qu, accumulate
                3: 14822,           # stage 2 + 4 box-QP iterations + gain solves
                5: 63928,           # W, U, Qxx, Qxu, Quu, solves, Vxx_new, symmetrize
                6: 612}[stage]      # v = Fu^T (s + base), accumulate
    return nbytes, n_knots * lanes * per_knot


def bound_record(nbytes, flops):
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
            "bytes_ms": byte_ms, "operations_ms": flop_ms}


def math_probe_times(pmath, x):
    """Per op, the kernel (`math_op`) and its plain version (the PyTorch op)
    timed two ways, in turns plain, kernel, kernel, plain: the host's launch
    interval (`cuda_time_ms`) and the device time (`graph_time_ms`: the
    ctypes launch runs on the current stream, so a CUDA graph captures it).
    Returns ({op: times}, the device-time source)."""
    by_op = {}
    for op in pmath.OPS:
        kern = lambda: pmath.math_op(x, op)  # noqa: E731
        plain = lambda: pmath.math_reference(x, op)  # noqa: E731
        h = [cuda_time_ms(plain), cuda_time_ms(kern), cuda_time_ms(kern), cuda_time_ms(plain)]
        d = [graph_time_ms(plain), graph_time_ms(kern), graph_time_ms(kern),
             graph_time_ms(plain)]
        by_op[op] = {"ms": (h[1] + h[2]) / 2, "plain_ms": (h[0] + h[3]) / 2,
                     "ms_device": (d[1] + d[2]) / 2, "plain_ms_device": (d[0] + d[3]) / 2,
                     "turns_host_ms": h, "turns_device_ms": d}
    return by_op, "cuda_graph"


def math_host_steps_us(pmath, x, n=2000):
    """Host microseconds a call of each step of `math_op`'s launch path (and
    of the whole call, and of torch.sin), enqueue only: perf_counter around
    `n` calls, one synchronize after."""
    from ffmpc_tpu_torch.solver import _cuda_build
    from ffmpc_tpu_torch.tools._probe_lib import probe_fn
    dev = x.device
    fn = probe_fn("math", 2, 2)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    steps = {
        "math_op": lambda: pmath.math_op(x, "sin"),
        "torch.sin": lambda: torch.sin(x),
        "checks": lambda: (x.dtype != torch.float32, x.is_contiguous(), x.device.type),
        "empty_like": lambda: torch.empty_like(x),
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "probe_fn_lookup": lambda: probe_fn("math", 2, 2),
        "ctypes_launch": lambda: fn(x.data_ptr(), out.data_ptr(), x.numel(), 0, stream),
        "launch_helper": lambda: _cuda_build.launch("m", fn, dev, x.data_ptr(), out.data_ptr(),
                                                    x.numel(), 0),
    }
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):   # the same handle, no Stream object
        steps["current_raw_stream"] = lambda: torch._C._cuda_getCurrentRawStream(dev.index)
    res = {}
    for name, f in steps.items():
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        res[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return res


PROBE_STACK_LIMIT = 256   # bytes of stack frame a float32 probe kernel may have


def probe_ptxas_gate():
    """ptxas' registers, stack frame and spills of the stream kernel's six
    instantiations and the round trip (the probes library, float32).  Fails
    if one is missing, spills, or has a stack frame of PROBE_STACK_LIMIT bytes
    or more."""
    usage = [r for r in ptxas_usage(_cuda_build.build_all().logs["probes"])
             if "stream_kernel" in r["function"] or "roundtrip_kernel" in r["function"]]
    n_stream = sum("stream_kernel" in r["function"] for r in usage)
    bad = [r for r in usage if r.get("spill_bytes_with_callees", 1) != 0
           or r.get("stack_frame_bytes", PROBE_STACK_LIMIT) >= PROBE_STACK_LIMIT]
    if n_stream != 6 or len(usage) != 7 or bad:
        raise RuntimeError(f"probe kernels: spills, a stack frame of {PROBE_STACK_LIMIT} B or "
                           f"more, or a kernel missing from ptxas' report: {usage}")
    return usage


def phase_probes():
    """The four probe kernels of csrc/probes.cu through their entry points
    (ffmpc_tpu_torch/tools/probe_*.py), each with its own gate: every math op
    within the CUDA Math API's documented ulp bound of float64; every stream
    stage within its stated tolerance of the plain version (STREAM_TOL) with
    the same non-finite entries, and stage 3 again on spd_knots with every
    output finite; the round trip byte-exact with the accumulator within
    1e-5.  The launch counts are read around each entry point's run, the
    stream kernel's per stage (the probes are no part of the solver's
    path).  Then ptxas' figures of the stream and round-trip kernels (no
    float32 spill, a stack frame under PROBE_STACK_LIMIT), and each kernel's
    time (the host's launch interval and the device time) against its plain
    version's and its bound, with the launches one wrapper call makes (1).
    Returns the four entries of the `kernels` line."""
    from ffmpc_tpu_torch.tools import probe_dma_roundtrip as prt
    from ffmpc_tpu_torch.tools import probe_mosaic as pmath
    from ffmpc_tpu_torch.tools import probe_mosaic2 as pstream

    pmath.math_op.launches = 0
    res_math = pmath.probe_math()
    n_math = pmath.math_op.launches
    pstream.stream_stage.launches = dict.fromkeys(pstream.STAGES, 0)
    res_stream = pstream.probe_stream()
    n_stream = dict(pstream.stream_stage.launches)
    prt.roundtrip.launches = 0
    res_rt = prt.probe_roundtrip()
    n_rt = prt.roundtrip.launches
    emit({"phase": "probes", "math": res_math, "stream": res_stream, "roundtrip": res_rt,
          "launches": {"probe_math": n_math, "probe_stream": n_stream,
                       "probe_roundtrip": n_rt}})
    failed = [n for n, r in (("math", res_math), ("stream", res_stream), ("roundtrip", res_rt))
              if not r["ok"]]
    if failed:
        raise RuntimeError(f"probe kernels disagree with their plain versions: {failed}")
    if n_math < len(pmath.OPS) or min(n_stream.values()) < 1 or n_rt < 1:
        raise RuntimeError(f"probe kernels not launched: {n_math}, {n_stream}, {n_rt}")

    ptxas = probe_ptxas_gate()

    x = pmath.probe_input()
    by_op, device_source = math_probe_times(pmath, x)
    knots, term = pstream.probe_inputs()
    by_stage = {}
    for st in pstream.STAGES:
        tm = term if st == 6 else None
        nbytes, flops = stream_bytes_flops(st)
        call = lambda: pstream.stream_stage(knots, st, tm)  # noqa: E731
        by_stage[st] = {"ms": cuda_time_ms(call), "ms_device": graph_time_ms(call),
                        "launches_per_call": kernel_launches(call),
                        "plain_ms": cuda_time_ms(lambda: pstream.stream_reference(knots, st, tm),
                                                 reps=1, rounds=3),
                        **bound_record(nbytes, flops)}
    rk = prt.probe_inputs()
    rt_call = lambda: prt.roundtrip(rk)  # noqa: E731
    rt = {"ms": cuda_time_ms(rt_call), "ms_device": graph_time_ms(rt_call),
          "launches_per_call": kernel_launches(rt_call),
          "plain_ms": cuda_time_ms(lambda: prt.roundtrip_reference(rk)),
          # the main output alone, as one PyTorch call computes it (no single
          # call computes both outputs, so library_ms stays null)
          "knots_times_2_ms_device": graph_time_ms(lambda: rk * 2.0)}
    emit({"phase": "probes", "timing_float32": {"math_by_op": by_op, "stream_by_stage": by_stage,
                                                "roundtrip": rt},
          "ptxas": ptxas})
    many = {f"stream stage {st}": r["launches_per_call"] for st, r in by_stage.items()
            if r["launches_per_call"] != 1}
    if rt["launches_per_call"] != 1:
        many["roundtrip"] = rt["launches_per_call"]
    if many:
        raise RuntimeError(f"a probe wrapper call runs more than its kernel: {many}")

    def stream_entry(name, stages, replaces):
        runs = [r for st in stages
                for r in (res_stream["stages"][st], res_stream["stages"][st].get("spd")) if r]
        errs = [o["max_abs_err"] for r in runs for o in r["outputs"].values()]
        tot = {k: sum(by_stage[st][k] for st in stages)
               for k in ("ms", "ms_device", "plain_ms", "bytes_ms", "operations_ms")}
        b = max(tot["bytes_ms"], tot["operations_ms"])
        return {"name": name, "route": "cuda", "source": "ffmpc_tpu_torch/csrc/probes.cu",
                "replaces": replaces, "launches": sum(n_stream[st] for st in stages),
                "launches_by_stage": {str(st): n_stream[st] for st in stages},
                "max_abs_err": max(errs),
                "ms": tot["ms"], "ms_device": tot["ms_device"], "plain_ms": tot["plain_ms"],
                "bound_ms": b,
                "bound_by": "bytes" if tot["bytes_ms"] >= tot["operations_ms"] else "operations",
                "library_ms": None, "entry_point": "ffmpc_tpu_torch.tools.probe_mosaic2",
                "note": f"one launch per stage {list(stages)}, times summed; ms: the host's "
                        "launch interval (CUDA events around 5 back-to-back wrapper calls); "
                        "ms_device: device time (20 calls in one CUDA graph)",
                "ptxas": [r for r in ptxas if "stream_kernel" in r["function"]],
                "by_stage": {str(st): by_stage[st] for st in stages}}

    n_bytes_math = 2 * x.numel() * 4
    sin = by_op["sin"]
    host_steps = math_host_steps_us(pmath, x)
    emit({"phase": "probes", "math_host_steps_us": host_steps})
    rt_bytes = 2 * rk.numel() * 4 + 8 * rk.shape[2] * 4
    rt_flops = rk.numel() + 8 * rk.shape[0] * rk.shape[2]
    return [
        {"name": "probe_math", "route": "cuda", "source": "ffmpc_tpu_torch/csrc/probes.cu",
         "replaces": "tools/probe_mosaic.py:34", "launches": n_math,
         "max_abs_err": max(r["max_abs_diff_vs_plain32"] for r in res_math["ops"].values()),
         "ms": sin["ms"], "plain_ms": sin["plain_ms"],
         **bound_record(n_bytes_math, x.numel()),
         "library_ms": sin["plain_ms"], "ms_device": sin["ms_device"],
         "library_ms_device": sin["plain_ms_device"], "device_time_source": device_source,
         "entry_point": "ffmpc_tpu_torch.tools.probe_mosaic",
         "note": "times of the sin launch (torch.sin is the one-call library equivalent "
                 "and the plain version); ms / library_ms: the host's launch interval "
                 "(CUDA events around 5 back-to-back calls); ms_device / library_ms_device: "
                 "device time (20 calls in one CUDA graph); every op in by_op; "
                 "max_ulp in the probes phase",
         "host_steps_us": host_steps, "by_op": by_op},
        stream_entry("probe_stream", (1, 2, 3, 4, 5), "tools/probe_mosaic2.py:202"),
        stream_entry("probe_stream_io", (6,), "tools/probe_mosaic2.py:171"),
        {"name": "probe_roundtrip", "route": "cuda", "source": "ffmpc_tpu_torch/csrc/probes.cu",
         "replaces": "tools/probe_dma_roundtrip.py:48", "launches": n_rt,
         "max_abs_err": max(res_rt["vs_plain"].values()),
         "ms": rt["ms"], "ms_device": rt["ms_device"], "plain_ms": rt["plain_ms"],
         **bound_record(rt_bytes, rt_flops), "library_ms": None,
         "knots_times_2_ms_device": rt["knots_times_2_ms_device"],
         "launches_per_call": rt["launches_per_call"],
         "ptxas": [r for r in ptxas if "roundtrip_kernel" in r["function"]],
         "entry_point": "ffmpc_tpu_torch.tools.probe_dma_roundtrip",
         "note": "ms: the host's launch interval; ms_device: device time (20 calls in one "
                 "CUDA graph); knots_times_2_ms_device: device time of `knots * 2.0` alone, "
                 "the round trip's main output as one PyTorch call computes it"},
    ]


# float32 plant step against float64 on the same inputs, per field, against
# max(max|float64 field|, 1): measured 3.3e-5 at most on an H100 (the contact
# force, whose stiffness turns the tool's float32 position rounding into
# newtons), so 1e-3 leaves 30x.
PLANT_F32_RTOL = 1e-3
PLANT_E = 512
REPLAY_FIXTURE = "tests/fixtures/host_ff_flat_replay.npz"
# the fixture's first 1.05 s (of 1.6 s; contact from 0.84 s): the replay's
# gates read the errors at 1 s and the contact force from 0.9 s
REPLAY_TICKS = 210


def pressed_and_free_states(E, dtype64=torch.float64):
    """E plant states around the neutral pose (seed 3) with a table plane per
    plant placed so that its tool sphere is pressed 0.5 mm or 0.2 mm into
    it, 1 mm inside the 2 mm margin zone, or 5 cm above it (in turn), a
    little velocity, filter states and a command of gravity torque plus a
    25 N push down (through J^T) with noise.  float64 on the card."""
    from ffmpc_tpu_torch.core.kinematics import ee_jacobian
    from ffmpc_tpu_torch.core.panda import TOOL_SPHERE_RADIUS
    rng = np.random.default_rng(3)
    q0 = np.asarray(KEYFRAMES["neutral"])
    model = make_panda_model("plant", dtype=dtype64, device="cuda")

    def T(a):
        return torch.as_tensor(a, dtype=dtype64, device="cuda")

    q = T(q0[None] + 0.02 * rng.normal(size=(E, 7)))
    gaps = T([-5e-4, 1e-3, 0.05, -2e-4])[torch.arange(E, device="cuda") % 4]
    n = T([0.0, 0.0, 1.0])
    point = fk(model, q).ee_p - n * (TOOL_SPHERE_RADIUS + gaps[:, None])
    v, tmf, tmaf = (T(0.05 * rng.normal(size=(E, 7))), T(rng.normal(size=(E, 7))),
                    T(rng.normal(size=(E, 7))))
    tau = (gravity_torque(model, q)
           + torch.einsum("bij,i->bj", ee_jacobian(model, q)[0], T([0.0, 0.0, -25.0]))
           + 0.3 * T(rng.normal(size=(E, 7))))
    return (q, v, tmf, tmaf), point, tau, gaps


def replay_fixture(dtype):
    """The framework-free replay of a recorded host MuJoCo force-feedback
    episode through the plant at `dtype`, its first REPLAY_TICKS ticks: the
    fidelity bounds of tests/test_device_plant_fidelity.py."""
    from ffmpc_tpu_torch.sim.device_plant import init_plant_state, make_table_params, plant_step
    with np.load(Path(__file__).resolve().parent / REPLAY_FIXTURE) as z:
        rec = {k: np.asarray(z[k])[:REPLAY_TICKS] for k in z.files}
    model = make_panda_model("plant", dtype=dtype, device="cuda")
    table = make_table_params(0.0, dtype=dtype, device="cuda")
    state = init_plant_state(np.asarray(KEYFRAMES["neutral"]), dtype=dtype, device="cuda")
    taus = torch.as_tensor(rec["tau"], dtype=dtype, device="cuda")
    qs, ees, fns = [], [], []
    t0 = time.perf_counter()
    for tau in taus:
        state, obs = plant_step(model, table, state, tau, timestep=0.001, n_substeps=5)
        qs.append(obs.q)
        ees.append(obs.ee_pos)
        fns.append(obs.f_contact_normal)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(taus)
    qs, ees, fns = (torch.stack(a).double().cpu().numpy() for a in (qs, ees, fns))
    dee = np.linalg.norm(ees - rec["ee"], axis=1)
    dq = np.abs(qs - rec["q"]).max(axis=1)
    i1 = min(int(1.0 / 0.005), len(dee) - 1)
    dfn = np.abs(fns - rec["fn"])[rec["t"] >= 0.9]
    r = {"dtype": str(dtype).replace("torch.", ""), "ticks": len(taus),
         "ee_err_at_1s_m": float(dee[i1]), "q_err_at_1s_rad": float(dq[i1]),
         "mean_contact_dfn_N": float(dfn.mean()), "max_ee_err_m": float(dee.max()),
         "host_ms_per_plant_step": ms}
    r["ok"] = bool(r["ee_err_at_1s_m"] < 1e-3 and r["q_err_at_1s_rad"] < 0.01
                   and r["mean_contact_dfn_N"] < 2.0 and r["max_ee_err_m"] < 5e-3)
    return r


def phase_plant():
    """plant_step at float32 against float64 on the card at E=512 plants,
    pressed, in the margin zone and free (every state and observation field
    within PLANT_F32_RTOL of its scale, the same contact flags, fn > 0 where
    pressed and 0 where free); then the replay fixture at both dtypes within
    the fidelity bounds."""
    from ffmpc_tpu_torch.sim.device_plant import PlantState, make_table_params, plant_step
    state64, point, tau, gaps = pressed_and_free_states(PLANT_E)
    outs = {}
    for dtype in (torch.float64, torch.float32):
        model = make_panda_model("plant", dtype=dtype, device="cuda")
        table = make_table_params(0.0, dtype=dtype, device="cuda")._replace(point=point.to(dtype))
        st = PlantState(*(a.to(dtype) for a in state64))
        outs[dtype] = plant_step(model, table, st, tau.to(dtype), timestep=0.001, n_substeps=5)
    torch.cuda.synchronize()
    (s64, o64), (s32, o32) = outs[torch.float64], outs[torch.float32]
    rel, ok = {}, True
    for prefix, a64, a32 in (("state.", s64, s32), ("obs.", o64, o32)):
        for name, a, b in zip(a64._fields, a64, a32):
            if a.dtype == torch.bool:
                rel[prefix + name] = int((a != b).sum())
                ok = ok and rel[prefix + name] == 0
                continue
            sc = max(float(a.abs().max()), 1.0)
            rel[prefix + name] = float((b.double() - a).abs().max()) / sc
            ok = ok and rel[prefix + name] <= PLANT_F32_RTOL
    fn = o64.f_contact_normal
    pressed, free = gaps < 0, gaps > 0.01
    ok = ok and bool((fn[pressed] > 0).all()) and bool((fn[free] == 0).all())
    replay = [replay_fixture(dt) for dt in (torch.float64, torch.float32)]
    rec = {"phase": "plant", "E": PLANT_E, "f32_vs_f64_rel_err": rel,
           "f32_rtol": PLANT_F32_RTOL, "pressed": int(pressed.sum()),
           "margin_zone": int(((gaps > 0) & ~free).sum()), "free": int(free.sum()),
           "fn_pressed_min_N": float(fn[pressed].min()), "fn_free_max_N": float(fn[free].max()),
           "replay": replay}
    emit(rec)
    if not ok or not all(r["ok"] for r in replay):
        raise RuntimeError(f"plant: float32 vs float64 or replay fidelity out of bounds: {rec}")


def flagship_episode(dtype, horizon, n_ticks, settings, device="cuda",
                     controller="force_feedback", W=None, traj=None):
    """The flagship episode (weights, trajectory, filter poles of the JAX
    ensemble), flat table, from the neutral pose: the force-feedback
    controller's, or with `controller="classical"` its classical twin (the
    same weights, trajectory and table); `W` and `traj` replace the
    flagship weights and trajectory where given."""
    from ffmpc_tpu_torch.ocp.weights import FLAGSHIP_DT_MPC, flagship_ff_alpha
    from ffmpc_tpu_torch.run.batch_runner import make_episode_fn
    from ffmpc_tpu_torch.sim.device_plant import make_table_params
    W = W or flagship_weights()
    model = make_panda_model("plant", dtype=dtype, device=device)
    ep = EpisodeConfig(controller=controller, horizon=horizon, n_ticks=n_ticks,
                       ff_alpha_ctrl=flagship_ff_alpha(FLAGSHIP_DT_MPC))
    return make_episode_fn(model, W, settings, traj or flagship_trajectory(),
                           make_table_params(0.0, dtype=dtype, device=device), ep,
                           np.asarray(KEYFRAMES["neutral"]), dtype=dtype, device=device)


def reset_launches():
    backward_box.launches = rollout.launches = diff_all.launches = 0


def read_launches():
    return {"backward_sweep": backward_box.launches, "rollout": rollout.launches,
            "knot_diff": diff_all.launches}


def require_launches(path, counts, at_least):
    if min(counts.values()) < at_least:
        raise RuntimeError(f"{path}: kernels not launched {at_least} times: {counts}")


# Closed loop (a): float64, kernel mode vs plain mode on the card, every
# telemetry field within CL_F64_RTOL of its largest magnitude (max with 1).
# The kernels agree with the plain versions to 1e-12 and below in the gains
# and trajectories (PERF.md), and the box QP's argmin ties, which can move
# kff by about reg / lambda_min(Quu) (ROADMAP queue 3), did not show in
# these eight ticks on an H100 (measured at most 6.5e-12, tau_cmd); 1e-8
# leaves room for a tie without hiding a fault (a wrong index or sign
# gives O(1)).
CL_F64_RTOL = 1e-8
# the full-width force-feedback closed loop's ticks from t = 0 (case (b)):
# contact from tick 161, 19 ticks of it (the run's clock)
CL_FF_TICKS = 180
# case (a) of both closed loops: ticks from t0, two on each knot
CL_A_TICKS, CL_A_T0 = 4, 0.79
# case (b)'s last carry (in contact), from which phase point3d's
# force-feedback episode goes on
_CONTACT_CARRY = {}
CL_ENSEMBLE_E = 2
CL_TRACE_EVERY = 20


def telemetry_summary(tl, every=CL_TRACE_EVERY):
    """fn and ee-error trace of episode 0 every `every` ticks."""
    t = tl["t"][0].double().cpu().numpy()
    fn = tl["fn_meas"][0].double().cpu().numpy()
    e3 = tl["err_3d"][0].double().cpu().numpy()
    return [{"t": round(float(t[k]), 4), "fn_N": float(fn[k]), "err_3d_mm": float(e3[k]) * 1e3}
            for k in range(0, len(t), every)] + [
        {"t": round(float(t[-1]), 4), "fn_N": float(fn[-1]), "err_3d_mm": float(e3[-1]) * 1e3}]


def loop_kernel_vs_plain(controller, N, ticks, t0, path, iters=3, E=CL_ENSEMBLE_E,
                         tie_factor=None, W=None):
    """The float64 flagship episode of `controller` at E episodes (the
    neutral pose and the pose + 0.01 rad), horizon N, `iters` iterations,
    `ticks` ticks from t0 over the surface flag's switch at 0.80 s (the free
    knot before it, the contact knot after), on the three kernels against
    plain mode: the same iterations and fallback ticks, every telemetry
    field within CL_F64_RTOL of its largest magnitude (max with 1), and
    both knots run.  With `tie_factor`, plain mode also runs from the
    initial states times 1 + eps z (`perturbed`), and a field may instead
    be within `tie_factor` times that run's distance from plain mode (the
    yardstick).  The kernel run must launch each kernel once a tick; plain
    mode launches none.  `W`: other weights than the flagship's (the point
    contact's).  Returns the record, with "ok"."""
    dtype = torch.float64
    q0s = torch.as_tensor(KEYFRAMES["neutral"], dtype=dtype, device="cuda")[None].repeat(E, 1)
    q0s[1:] += 0.01
    runs = [("kernel", q0s), ("plain", q0s)]
    if tie_factor is not None:
        runs.append(("plain", perturbed([q0s])[0]))
    tl = []
    for mode, q0 in runs:
        S = FDDPSettings(max_iters=iters, backward_mode=mode, rollout_mode=mode,
                         diff_mode=mode)
        ep = flagship_episode(dtype, N, ticks, S, controller=controller, W=W)
        reset_launches()
        tl.append(ep.chunk(ep.init(q0), t0, ticks)[1])
        counts = read_launches()
        if mode == "kernel":
            require_launches(path, counts, ticks)
        elif any(counts.values()):
            raise RuntimeError(f"{path}: plain mode launched kernels: {counts}")
    torch.cuda.synchronize()

    def distance(a, b):
        if a.dtype in (torch.bool, torch.int32):
            return int((a != b).sum())
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
    rel = {k: distance(a, tl[1][k]) for k, a in tl[0].items()}
    ts = tl[0]["t"][0] - 0.005
    rec = {"dtype": "float64", "E": E, "N": N, "max_iters": iters, "t0": t0,
           "ticks": ticks, "rel_err_kernel_vs_plain": rel, "rtol": CL_F64_RTOL,
           "iters": tl[0]["iters"][0].tolist(),
           "contact_knot_ticks": int((ts >= 0.8).sum())}
    bar = {k: CL_F64_RTOL for k in rel}
    if tie_factor is not None:
        yard = {k: distance(a, tl[1][k]) for k, a in tl[2].items()}
        bar = {k: max(CL_F64_RTOL, tie_factor * yard[k]) for k in rel}
        rec.update(rel_err_perturbed_plain_vs_plain=yard, tie_factor=tie_factor)
    ok = all(v == 0 for k, v in rel.items() if k in ("iters", "fallback")) and all(
        v <= bar[k] for k, v in rel.items() if k not in ("iters", "fallback"))
    rec["ok"] = bool(ok and 0 < rec["contact_knot_ticks"] < ticks)
    return rec


def phase_closed_loop():
    """(a) The float64 episode at E=2, N=8, 3 iterations, CL_A_TICKS ticks
    from t0 = CL_A_T0 (the free knot until 0.80 s, the contact knot after),
    on the
    three kernels against plain mode: same iterations on every tick, every
    telemetry field within CL_F64_RTOL (`loop_kernel_vs_plain`).  (b) Full
    width: float32, E=1, N=40, 10 iterations, CL_FF_TICKS ticks from t = 0
    (contact from tick 161), the three kernels: finite telemetry and no tick on the
    divergence fallback, unless a float64 run of the same ticks takes the
    same fallback ticks.  Returns the launch counts of (b)'s run."""
    rec_a = loop_kernel_vs_plain("force_feedback", 8, CL_A_TICKS, CL_A_T0, "closed loop (a)")
    ok = rec_a.pop("ok")
    emit({"phase": "closed_loop", "case": "a", **rec_a})
    if not ok:
        raise RuntimeError(f"closed loop (a): kernel mode and plain mode disagree: {rec_a}")

    # (b) full width
    S = FDDPSettings(max_iters=ITERS)
    ep = flagship_episode(torch.float32, HORIZON, CL_FF_TICKS, S)
    q0 = torch.as_tensor(KEYFRAMES["neutral"], dtype=torch.float32, device="cuda")[None]
    reset_launches()
    t0 = time.perf_counter()
    carry, tl = ep.chunk(ep.init(q0), 0.0, CL_FF_TICKS)
    _CONTACT_CARRY["force_feedback"] = carry
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    require_launches("closed loop (b)", counts, CL_FF_TICKS)
    finite = all(bool(torch.isfinite(v).all()) for v in tl.values() if v.is_floating_point())
    fb = tl["fallback"][0].nonzero().flatten().tolist()
    rec_b = {"dtype": "float32", "E": 1, "N": HORIZON, "max_iters": ITERS,
             "ticks": CL_FF_TICKS, "wall_s": wall, "ms_per_tick": wall / CL_FF_TICKS * 1e3,
             "launches": counts,
             "finite": finite, "fallback_ticks": fb, "n_fallback_ticks": len(fb),
             "mean_iters": float(tl["iters"].double().mean()),
             "contact_ticks": int((tl["fn_meas"][0] > 0).sum()),
             "fn_final_N": float(tl["fn_meas"][0, -1]),
             "err_3d_final_mm": float(tl["err_3d"][0, -1]) * 1e3,
             "trace": telemetry_summary(tl)}
    ok = finite
    if fb:
        ep64 = flagship_episode(torch.float64, HORIZON, CL_FF_TICKS, S)
        tl64 = ep64(q0.double())
        fb64 = tl64["fallback"][0].nonzero().flatten().tolist()
        rec_b["float64_fallback_ticks"] = fb64
        ok = ok and set(fb) <= set(fb64)
    emit({"phase": "closed_loop", "case": "b", **rec_b})
    if not ok:
        raise RuntimeError(f"closed loop (b): non-finite telemetry or fallback ticks {fb}")
    return counts


B1_BUDGET_MS = 5.0
B1_SAMPLES = 50
B1_LOOP_TICKS = 10          # ticks of each closed-loop tick run


def tick_split(episode, carry, k0, n=5):
    """Ticks k0 .. k0 + n - 1 of `episode` (E=1) from `carry`, one at a
    time, each split into solve / plant / policy: the host clock around the
    episode's calls of fddp.solve and plant_step (wrapped at module level),
    each ended by a synchronize; policy is the rest of the tick; with the
    host syncs of the solve counted (bool() of a card tensor)."""
    from ffmpc_tpu_torch.run import batch_runner
    acc = {"solve": 0.0, "plant": 0.0, "syncs_in_solve": 0}
    orig_solve, orig_plant = batch_runner.fddp_solve, batch_runner.plant_step
    orig_bool = torch.Tensor.__bool__

    def counting_bool(t):
        if t.is_cuda:
            acc["syncs_in_solve"] += 1
        return orig_bool(t)

    def timed(fn, key):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if key == "solve":
                torch.Tensor.__bool__ = counting_bool
            try:
                r = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                torch.Tensor.__bool__ = orig_bool
            acc[key] += (time.perf_counter() - t0) * 1e3
            return r
        return wrapper

    split = []
    batch_runner.fddp_solve = timed(orig_solve, "solve")
    batch_runner.plant_step = timed(orig_plant, "plant")
    try:
        for k in range(k0, k0 + n):
            for key in acc:
                acc[key] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, tl = episode.chunk(carry, k * 0.005, 1)
            torch.cuda.synchronize()
            tick = (time.perf_counter() - t0) * 1e3
            split.append({"tick_ms": tick, "solve_ms": acc["solve"], "plant_ms": acc["plant"],
                          "policy_ms": tick - acc["solve"] - acc["plant"],
                          "syncs_in_solve": acc["syncs_in_solve"], "iters": int(tl["iters"][0, 0])})
    finally:
        batch_runner.fddp_solve, batch_runner.plant_step = orig_solve, orig_plant
    return split


def phase_b1():
    """The B=1 legs of bench.py at full width (float32, N=40, the contact
    knot, the three kernels): the replan p50 / p99 of 10 iterations over 50
    distinct warm-start inputs (one untimed first), the RTI p50 at
    max_iters=1, (p50 - rti) / 9 per iteration; the closed-loop tick (the
    episode at E=1, B1_LOOP_TICKS ticks from t = 0, 3 timed runs after a
    warm-up); and
    one B=1 tick split into solve / plant / policy (host clock around the
    episode's calls of fddp.solve and plant_step, each ended by a
    synchronize; policy is the rest of the tick), with the host syncs of the
    solve counted (bool() of a card tensor; `tick_split`).  The 5 ms budget
    is printed beside, not gated."""
    dtype = torch.float32
    model, W, traj, ep, q0 = flagship(dtype)
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=dtype, device="cuda")).cpu().numpy()
    rng = np.random.default_rng(0)
    argsets = [warm_start_args(1, q0, tau_g, rng) for _ in range(B1_SAMPLES + 1)]

    def sample_ms(solve):
        solve(*argsets[0])
        torch.cuda.synchronize()
        out = []
        for a in argsets[1:]:
            t0 = time.perf_counter()
            solve(*a)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(out)

    replan = sample_ms(make_batched_solve_fn(model, W, FDDPSettings(max_iters=ITERS), traj, ep,
                                             q0, surface=True, dtype=dtype, device="cuda"))
    rti = sample_ms(make_batched_solve_fn(model, W, FDDPSettings(max_iters=1), traj, ep, q0,
                                          surface=True, dtype=dtype, device="cuda"))
    p50, p99, rti50 = (float(np.percentile(replan, 50)), float(np.percentile(replan, 99)),
                       float(np.percentile(rti, 50)))

    episode = flagship_episode(dtype, HORIZON, B1_LOOP_TICKS, FDDPSettings(max_iters=ITERS))
    q0b = torch.as_tensor(q0, dtype=dtype, device="cuda")[None]
    episode(q0b)
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        episode(q0b)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / B1_LOOP_TICKS)

    carry = episode.init(q0b)
    carry, _ = episode.chunk(carry, 0.0, 4)            # a warm start, as in a running loop
    split = tick_split(episode, carry, 4)
    med = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    emit({"phase": "b1", "dtype": "float32", "N": HORIZON, "budget_ms": B1_BUDGET_MS,
          "replan_ms_p50": p50, "replan_ms_p99": p99, "replan_samples": len(replan),
          "rti_ms_p50": rti50, "iter_ms_estimate": max(p50 - rti50, 0.0) / 9.0,
          "closed_loop_tick_ms": float(np.median(runs)), "closed_loop_tick_ms_runs": runs,
          "tick_split_median_of_5": med, "tick_split": split,
          "over_budget_factor_replan_p50": p50 / B1_BUDGET_MS})


# The JAX package's ensemble on the same configuration (512 x 100, flat,
# float32, seed 0, perturb_q 0.01), quality figures only (their speed is not
# the port's):
# - ENSEMBLE_JAX: the package as it stands, run on the CPU by its own entry
#   point (`JAX_PLATFORMS=cpu python -m ffmpc_tpu.run.ensemble --batch 512
#   --ticks 100`); the gate's reference.  The port on an H100 came within
#   1.5e-6 of it (relative), float32 against float32 on another machine, so
#   ENSEMBLE_RMS_RTOL = 1e-3 holds the closed loop at full width while
#   leaving float32's parting over 100 ticks room.  At small E and float64
#   the port's run_ensemble equals the package's on the CPU
#   (tests/test_torch_ensemble.py).
# - ENSEMBLE_JAX_RECORD: results_ensemble512.json, taken on a TPU by the
#   package's round-2 revision (ec547c9).  The package has changed since (its
#   solver, knot and episode, in later commits) and no longer reproduces it.
#   Printed beside with its relative distance, not gated: the port does not
#   meet "within 5% of 0.04174".
ENSEMBLE_JAX = {"rms_tan_mean": 0.047054484486579895, "rms_tan_p95": 0.04954278841614723,
                "fn_final_mean": 0.0}
ENSEMBLE_JAX_RECORD = {"rms_tan_mean": 0.04173944517970085,
                       "rms_tan_p95": 0.04451100900769234, "fn_final_mean": 0.0}
ENSEMBLE_RMS_RTOL = 1e-3


def ensemble_against_jax(controller, want, phase, horizon=40):
    """run_ensemble(controller, "flat", batch=512, ticks=100, horizon,
    seed=0, perturb_q=0.01) on the three kernels; rms_tan_mean and
    rms_tan_p95 within ENSEMBLE_RMS_RTOL of the JAX package's on the same
    configuration (`want`), fn_final_mean equal.  Returns (the record, whether
    it passes, the launch counts of its run); `phase` names the run in a
    launch-count failure."""
    from ffmpc_tpu_torch.run.ensemble import run_ensemble
    reset_launches()
    out, telem = run_ensemble(controller, "flat", batch=512, ticks=100, horizon=horizon,
                              seed=0, perturb_q=0.01, verbose=False, device="cuda")
    counts = read_launches()
    require_launches(phase, counts, 100)
    finite = all(np.isfinite(v).all() for v in telem.values() if v.dtype.kind == "f")
    rel = abs(out["rms_tan_mean"] - want["rms_tan_mean"]) / want["rms_tan_mean"]
    rel95 = abs(out["rms_tan_p95"] - want["rms_tan_p95"]) / want["rms_tan_p95"]
    rec = {**out, "horizon": horizon, "launches": counts, "finite": finite,
           "fallback_ticks": int(telem["fallback"].sum()),
           "mean_iters": float(telem["iters"].mean()), "jax_package_cpu_float32": want,
           "rms_tan_mean_rel_diff_vs_jax": rel, "rms_tan_p95_rel_diff_vs_jax": rel95,
           "rtol": ENSEMBLE_RMS_RTOL}
    ok = (finite and max(rel, rel95) <= ENSEMBLE_RMS_RTOL
          and out["fn_final_mean"] == want["fn_final_mean"])
    return rec, ok, counts


def phase_ensemble():
    """The force-feedback ensemble against the JAX package's
    (`ensemble_against_jax`, ENSEMBLE_JAX), with the TPU record beside.
    Returns the launch counts of its run."""
    rec, ok, counts = ensemble_against_jax("force_feedback", ENSEMBLE_JAX, "ensemble")
    emit({"phase": "ensemble", **rec,
          "jax_tpu_record_results_ensemble512_json": ENSEMBLE_JAX_RECORD,
          "rms_tan_mean_rel_diff_vs_record": abs(
              rec["rms_tan_mean"] - ENSEMBLE_JAX_RECORD["rms_tan_mean"])
          / ENSEMBLE_JAX_RECORD["rms_tan_mean"]})
    if not ok:
        raise RuntimeError(f"ensemble: {rec} against JAX {ENSEMBLE_JAX} "
                           f"(rtol {ENSEMBLE_RMS_RTOL}) or non-finite telemetry")
    return counts


# ---------------------------------------------------------------------------
# phase classical_loop: the classical controller's closed loop and ensemble
# (x = (q, v), u = tau, nx = 14, N = 36) on the classical instantiations
# ---------------------------------------------------------------------------

CL_LOOP_TICKS, CL_LOOP_CHUNK = 60, 20
# Case (a) of the classical loop: the classical closed loop at float64 sits
# on the box QP's ties (PERF.md: Quu spans 1e-5 to 3.5), so
# CL_F64_RTOL cannot hold between any two implementations: over case (a)'s
# ticks plain mode from initial states one rounding apart parts by 6.9e-7 in
# tau_cmd, 6.7e-8 in the cost and 8.1e-9 in q on an H100 (1.3e-7 / 9.8e-9 /
# 1.1e-9 on a CPU), and the kernels part from plain mode by 3.3e-7 / 2.6e-8
# / 4.0e-9.  So a field there is held at CL_F64_RTOL or within
# CL_LOOP_TIE_FACTOR times that yardstick, measured in the same run;
# iterations and fallback ticks stay equal (a wrong index or sign gives
# O(1)).
CL_LOOP_TIE_FACTOR = 10.0
CL_SPLIT_TICKS = (20, 40)       # tick splits from the carries there (both free space)
# The JAX package's classical ensemble on case (c)'s configuration (512 x
# 100, flat, float32, horizon 36, seed 0, perturb_q 0.01), run on the CPU
# by its own entry point: `JAX_PLATFORMS=cpu python -m ffmpc_tpu.run.ensemble
# --controller classical --batch 512 --ticks 100 --horizon 36`.  The port on
# an H100 came within 1.8e-5 (rms_tan_mean) and 3.3e-4 (rms_tan_p95) of it,
# float32 against float32 on another machine, so ENSEMBLE_RMS_RTOL (1e-3)
# holds here too; the port's own float32 kernels part from its float64
# kernels by 4.8e-4 / 6.1e-4 on this configuration (an H100,
# `classical_ensemble_parting`).
ENSEMBLE_JAX_CLASSICAL = {"rms_tan_mean": 0.007752562873065472,
                          "rms_tan_p95": 0.00845207180827856, "fn_final_mean": 0.0}


def cast_carry(carry, dtype):
    """An episode carry (PlantState, xs, us, tau_prev, reg) in `dtype`."""
    plant, *rest = carry
    return (type(plant)(*(a.to(dtype) for a in plant)), *(a.to(dtype) for a in rest))


def run_chunked(ep, q0s, ticks, chunk):
    """`ticks` ticks of `ep` from t = 0 in calls of `chunk` ticks, each
    ended by a synchronize: (telemetry, the carries at the chunk boundaries
    by tick, the seconds inside the calls)."""
    carry, carries, parts, wall = ep.init(q0s), {}, [], 0.0
    for k0 in range(0, ticks, chunk):
        carries[k0] = carry
        t0 = time.perf_counter()
        carry, tl = ep.chunk(carry, k0 * 0.005, min(chunk, ticks - k0))
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        parts.append(tl)
    return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}, carries, wall


def stacked_solve_args(args_list):
    """The solve arguments of several E=1 ticks of one knot as one batch."""
    cat = torch.cat
    refs = [ProblemRefs(*(cat([getattr(a[i], f) for a in args_list])
                          for f in ProblemRefs._fields)) for i in (1, 2)]
    return (args_list[0][0], *refs, *(cat([a[i] for a in args_list]) for i in (3, 4, 5, 6)))


def tick_solve_args(ep, carry, k):
    """The arguments of the solve that tick k of `ep` runs from `carry`:
    (knot, refs_run, ref_T, x0, xs_init, us_init, reg0), captured from the
    episode's call of fddp.solve (wrapped at module level) while the tick
    runs."""
    from ffmpc_tpu_torch.run import batch_runner
    calls = []
    orig = batch_runner.fddp_solve

    def capture(*a, **kw):
        calls.append(a[:6] + (kw["reg0"],))
        return orig(*a, **kw)
    batch_runner.fddp_solve = capture
    try:
        ep.chunk(carry, k * 0.005, 1)
    finally:
        batch_runner.fddp_solve = orig
    return calls[0]


def warm_start_solves(ep, ep64, carries):
    """The solve of the tick at each chunk boundary (the running loop's
    shifted warm start and carried regularization), three ways: the kernels
    at float32, plain mode at float32 and plain mode at float64 (the float32
    carry cast).  The ticks of one knot are solved as one batch.  Returns
    each tick's iterations, accepted step lengths and final regularization
    by way, and the shares of ticks on which two ways take the same
    iterations and step lengths."""
    groups = {}
    for k, carry in sorted(carries.items()):
        a32 = tick_solve_args(ep, carry, k)
        a64 = tick_solve_args(ep64, cast_carry(carry, torch.float64), k)
        groups.setdefault(bool(a32[0].surface), []).append((k, a32, a64))
    ticks = []
    for surface, items in groups.items():
        args = {32: stacked_solve_args([a for _, a, _ in items]),
                64: stacked_solve_args([a for _, _, a in items])}
        res = {}
        for way, bits, mode in (("kernel32", 32, "kernel"), ("plain32", 32, "plain"),
                                ("plain64", 64, "plain")):
            S = FDDPSettings(max_iters=ITERS, backward_mode=mode, rollout_mode=mode,
                             diff_mode=mode)
            res[way] = fddp_solve(*args[bits][:6], S, reg0=args[bits][6])
        for j, (k, _, _) in enumerate(items):
            ticks.append({"tick": k, "contact_knot": surface, **{
                way: {"iters": int(r.iters[j]), "alpha_hist": r.alpha_hist[j].tolist(),
                      "xreg": float(r.xreg[j])} for way, r in res.items()}})
    ticks.sort(key=lambda t: t["tick"])

    def same(a, b):
        return sum(t[a]["iters"] == t[b]["iters"] and t[a]["alpha_hist"] == t[b]["alpha_hist"]
                   for t in ticks) / len(ticks)
    return {"ticks": ticks, "same_decisions_share": {
        f"{a}_vs_{b}": same(a, b) for a, b in (("kernel32", "plain32"), ("kernel32", "plain64"),
                                               ("plain32", "plain64"))}}


def classical_loop_full_width():
    """Case (b): the classical flagship episode at full width, float32, E=1,
    N=36, 10 iterations, CL_LOOP_TICKS ticks from t = 0 in calls of 20 ticks
    (60, all in free space: the run's clock), on the three kernels: finite
    telemetry and no tick on the divergence fallback
    unless a float64 run of the same ticks takes the same ones; ms a tick,
    mean iterations, contact ticks, the final normal force and 3D error, and
    ticks split into solve / plant / policy (`tick_split`, from the carries
    at CL_SPLIT_TICKS).  Returns (the launch counts of its ticks, the
    carries at the chunk boundaries)."""
    S = FDDPSettings(max_iters=ITERS)
    ep = flagship_episode(torch.float32, CL_HORIZON, CL_LOOP_TICKS, S, controller="classical")
    q0 = torch.as_tensor(KEYFRAMES["neutral"], dtype=torch.float32, device="cuda")[None]
    reset_launches()
    tl, carries, wall = run_chunked(ep, q0, CL_LOOP_TICKS, CL_LOOP_CHUNK)
    counts = read_launches()
    require_launches("classical closed loop (b)", counts, CL_LOOP_TICKS)
    finite = all(bool(torch.isfinite(v).all()) for v in tl.values() if v.is_floating_point())
    fb = tl["fallback"][0].nonzero().flatten().tolist()
    rec = {"dtype": "float32", "E": 1, "N": CL_HORIZON, "max_iters": ITERS,
           "ticks": CL_LOOP_TICKS, "chunk_ticks": CL_LOOP_CHUNK, "wall_s": wall,
           "ms_per_tick": wall / CL_LOOP_TICKS * 1e3, "launches": counts, "finite": finite,
           "fallback_ticks": fb, "n_fallback_ticks": len(fb),
           "mean_iters": float(tl["iters"].double().mean()),
           "contact_ticks": int((tl["fn_meas"][0] > 0).sum()),
           "fn_final_N": float(tl["fn_meas"][0, -1]),
           "err_3d_final_mm": float(tl["err_3d"][0, -1]) * 1e3,
           "trace": telemetry_summary(tl)}
    ok = finite
    if fb:
        ep64 = flagship_episode(torch.float64, CL_HORIZON, CL_LOOP_TICKS, S,
                                controller="classical")
        fb64 = run_chunked(ep64, q0.double(), CL_LOOP_TICKS, CL_LOOP_CHUNK)[0]["fallback"]
        rec["float64_fallback_ticks"] = fb64[0].nonzero().flatten().tolist()
        ok = ok and set(fb) <= set(rec["float64_fallback_ticks"])
    split = {str(k): tick_split(ep, carries[k], k) for k in CL_SPLIT_TICKS}
    rec["tick_split_median_of_5"] = {
        k: {f: float(np.median([t[f] for t in v])) for f in v[0]} for k, v in split.items()}
    rec["tick_split"] = split
    emit({"phase": "classical_loop", "case": "b", **rec})
    if not ok:
        raise RuntimeError(f"classical closed loop (b): non-finite telemetry or fallback "
                           f"ticks {fb}")
    return counts, carries


def classical_warm_start_draw():
    """Measured, not gated, and not run by main() (its plain float32 and
    float64 solves take about 100 s on an H100's host): whether the running
    loop's warm starts resolve the float32 tie.  Case (b)'s loop, then the
    solve of the tick at each of its chunk boundaries three ways
    (`warm_start_solves`)."""
    carries = classical_loop_full_width()[1]
    S = FDDPSettings(max_iters=ITERS)
    ep, ep64 = (flagship_episode(dt, CL_HORIZON, CL_LOOP_TICKS, S, controller="classical")
                for dt in (torch.float32, torch.float64))
    ws = warm_start_solves(ep, ep64, {k: c for k, c in carries.items() if k})
    emit({"phase": "classical_warm_start_draw", "measured_not_gated": True,
          "max_iters": ITERS, **ws})
    return ws


def classical_ensemble():
    """Case (c): the classical ensemble at horizon 36 against the JAX
    package's (`ensemble_against_jax`, ENSEMBLE_JAX_CLASSICAL, float32).
    Returns the launch counts of its run."""
    rec, ok, counts = ensemble_against_jax("classical", ENSEMBLE_JAX_CLASSICAL,
                                           "classical ensemble", horizon=CL_HORIZON)
    emit({"phase": "classical_loop", "case": "c", **rec})
    if not ok:
        raise RuntimeError(f"classical ensemble: {rec} against JAX {ENSEMBLE_JAX_CLASSICAL} "
                           f"(rtol {ENSEMBLE_RMS_RTOL}) or non-finite telemetry")
    return counts


def phase_classical_loop():
    """The classical controller's closed loop and ensemble on the classical
    instantiations of the three kernels: (a) `loop_kernel_vs_plain` at
    float64, E=2, N=8, 3 iterations, CL_A_TICKS ticks from t0 = CL_A_T0
    (both knots), with the tie yardstick (CL_LOOP_TIE_FACTOR);
    (b) `classical_loop_full_width`; (c) `classical_ensemble`.  Returns the
    launch counts of (b) and (c) by path."""
    rec_a = loop_kernel_vs_plain("classical", 8, CL_A_TICKS, CL_A_T0,
                                 "classical closed loop (a)",
                                 tie_factor=CL_LOOP_TIE_FACTOR)
    ok = rec_a.pop("ok")
    emit({"phase": "classical_loop", "case": "a", **rec_a})
    if not ok:
        raise RuntimeError(f"classical closed loop (a): kernel mode and plain mode "
                           f"disagree: {rec_a}")
    return {f"classical_closed_loop_{CL_LOOP_TICKS}_ticks": classical_loop_full_width()[0],
            "classical_ensemble_512x100": classical_ensemble()}


PARTING_WAYS = {"kernel32": (torch.float32, "kernel"), "kernel64": (torch.float64, "kernel"),
                "plain32": (torch.float32, "plain"), "plain64": (torch.float64, "plain")}


def classical_ensemble_parting(ways=("kernel32", "kernel64"), batch=512, ticks=100):
    """The float32 parting of case (c), measured, not run by main(): the
    classical ensemble's configuration (flat, seed 0, perturb_q 0.01, N=36,
    10 iterations; `flagship_episode`, the episode run_ensemble builds, in
    one call of `ticks` ticks) at `batch` episodes from the same float32
    initial states, each of `ways` (PARTING_WAYS: kernels or plain mode, at
    float32 or float64): its quality figures and seconds a tick, and the
    relative distances of rms_tan_mean and rms_tan_p95 between the ways.
    Plain mode is launch-bound, 8-9 s a tick at batch 32 on an H100, so its
    ways run at a small batch or on few ticks."""
    q0 = np.asarray(KEYFRAMES["neutral"])
    q0s = (q0[None] + 0.01 * np.random.default_rng(0).normal(size=(batch, 7))).astype(
        np.float32)
    figures = {}
    for way in ways:
        dtype, mode = PARTING_WAYS[way]
        S = FDDPSettings(max_iters=ITERS, backward_mode=mode, rollout_mode=mode,
                         diff_mode=mode)
        ep = flagship_episode(dtype, CL_HORIZON, ticks, S, controller="classical")
        tl, _, wall = run_chunked(ep, torch.as_tensor(q0s, dtype=dtype, device="cuda"),
                                  ticks, ticks)
        err = tl["err_tan"].double().cpu().numpy()
        figures[way] = {
            "rms_tan_mean": float(np.sqrt((err ** 2).mean())),
            "rms_tan_p95": float(np.quantile(np.sqrt((err ** 2).mean(axis=1)), 0.95)),
            "fn_final_mean": float(tl["fn_meas"][:, -1].double().mean()),
            "mean_iters": float(tl["iters"].double().mean()), "s_per_tick": wall / ticks}
        emit({"phase": "classical_ensemble_parting", "way": way, "batch": batch,
              "ticks": ticks, **figures[way]})
    rec = {f"{a}_vs_{b}": {k: abs(figures[a][k] - figures[b][k]) / figures[b][k]
                           for k in ("rms_tan_mean", "rms_tan_p95")}
           for i, a in enumerate(ways) for b in ways[i + 1:]}
    emit({"phase": "classical_ensemble_parting", "batch": batch, "ticks": ticks, **rec})
    return rec

# ---------------------------------------------------------------------------
# phase point3d: the point contact (nc = 3, with the friction cone) in both
# controllers' knots, on the point3d instantiations of the derivative and
# rollout kernels (the backward sweep's nx = 21 and nx = 14 builds serve it
# as they are: the contact model does not enter the sweep)
# ---------------------------------------------------------------------------

# The values MPCConfig gives a point3d run (ffmpc_tpu/mpc/config.py:54-57);
# the flagship's own w_friction_cone = 0 would leave the cone's rows dead.
P3_W = dict(contact_model="point3d", w_friction_cone=2.0e2, mu=0.6, friction_margin=1e-3)
P3_FAMILIES = ("augmented", "classical")
P3_LIBRARIES = {("knot_diff", "augmented"): "knot_diff_point3d",
                ("knot_diff", "classical"): "knot_diff_classical_point3d",
                ("rollout", "augmented"): "rollout_point3d",
                ("rollout", "classical"): "rollout_classical_point3d"}
P3_HORIZON = {"augmented": HORIZON, "classical": CL_HORIZON}
P3_NX = {"augmented": NX, "classical": CL_NX}
P3_CONTROLLER = {"augmented": "force_feedback", "classical": "classical"}
# (c)'s float32 episodes, about 40 ticks in contact each: the force-feedback
# one goes on P3_FF_TICKS ticks from phase closed_loop's case (b) (in contact
# from tick 161 of its CL_FF_TICKS); the classical one runs P3_CL_TICKS ticks
# from the neutral pose on the fast approach of
# tests/test_point3d_closed_loop.py (contact from about tick 46)
P3_FF_TICKS, P3_CL_TICKS = 40, 85
P3_FAST_TRAJ = dict(center=(-0.5, 0.0, 0.342), radius=0.10, omega=1.5, z_contact=0.342,
                    t_approach=0.12, z_pre=0.362, t_pre=0.06, ee_start=(-0.3, 0.0, 0.633),
                    t_stabilize=0.04)


def p3_weights():
    import dataclasses
    return dataclasses.replace(flagship_weights(), **P3_W)


def p3_knot(family, dtype, surface=True):
    make = make_augmented_knot if family == "augmented" else make_classical_knot
    return make(flagship(dtype)[0], p3_weights(), surface)


_P3_INPUTS = {}


def p3_first_iteration(family, B, dtype=torch.float32):
    """The point3d solve's first iteration at batch B, as its main path
    builds it (`make_batched_solve_fn` with the point3d weights, the warm
    starts of phases solve / classical, seed 0), on the contact knot; made
    once a (family, B, dtype) in a run."""
    key = ("first_iteration", family, B, dtype)
    if key not in _P3_INPUTS:
        _P3_INPUTS[key] = _p3_first_iteration(family, B, dtype)
    return _P3_INPUTS[key]


def _p3_first_iteration(family, B, dtype):
    model, W, traj, _, q0 = flagship(dtype)
    W = p3_weights()
    knot = p3_knot(family, dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=dtype, device="cuda")).cpu().numpy()
    warm = warm_start_args if family == "augmented" else classical_warm_starts
    ts, x0s, xs, us = (torch.as_tensor(a, device="cuda") for a in warm(
        B, q0, tau_g, np.random.default_rng(0), dtype=np_dtype))
    x_reg = torch.cat([torch.as_tensor(q0, dtype=dtype, device="cuda"),
                       torch.zeros(7, dtype=dtype, device="cuda")])
    refs_run, ref_T = build_problem_refs(
        traj, ts, P3_HORIZON[family], W.dt_ocp, x_reg, gravity_torque(model, x0s[:, :7]),
        make_vertical_down_R(), y_ref=x0s if family == "augmented" else None, dtype=dtype,
        device="cuda")
    refs_run = ProblemRefs(*(a.contiguous() for a in refs_run))
    ref_T = ProblemRefs(*(a.contiguous() for a in ref_T))
    feasible = torch.zeros(B, dtype=torch.bool, device="cuda")
    bi = backward_inputs(diff_reference(knot, refs_run, ref_T, xs, us), x0s, xs, us,
                         feasible, *control_bounds(knot, dtype, "cuda"))
    return dict(knot=knot, bi=bi, refs_run=refs_run, ref_T=ref_T, x0=x0s, xs=xs, us=us)


def p3_seeded_args(family, B, dtype, seed):
    """Seeded point3d rollout inputs (seeded_rollout_args' recipe at the
    family's state width and horizon).  (knot, consts on the card, args)."""
    model, W, traj, _, q0 = flagship(dtype)
    W, N, nx = p3_weights(), P3_HORIZON[family], P3_NX[family]
    knot = p3_knot(family, dtype)
    rng = np.random.default_rng(seed)

    def T(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()

    q = torch.as_tensor(q0, dtype=dtype, device="cuda")
    tau_g = gravity_torque(model, q)
    x_reg = torch.cat([q, torch.zeros(7, dtype=dtype, device="cuda")])
    y0 = torch.cat([x_reg, tau_g])[:nx]
    x0 = (y0[None] + 0.05 * T(rng.normal(size=(B, nx)))).contiguous()
    xs = (x0[:, None].repeat(1, N + 1, 1) + 0.02 * T(rng.normal(size=(B, N + 1, nx)))).contiguous()
    us = (tau_g.repeat(B, N, 1) + 2.0 * T(rng.normal(size=(B, N, NU)))).contiguous()
    K = 0.1 * T(rng.normal(size=(B, N, NU, nx)))
    kff = T(rng.normal(size=(B, N, NU)))
    fs = 0.1 * T(rng.normal(size=(B, N + 1, nx)))
    w_all = 0.3 * T(rng.normal(size=(B, N + 1, nx)))
    feasible = torch.arange(B, device="cuda") % 2 == 1
    refs_run, ref_T = build_problem_refs(
        traj, torch.full((B,), 1.2, dtype=dtype, device="cuda"), N, W.dt_ocp, x_reg, tau_g,
        make_vertical_down_R(), y_ref=x0 if family == "augmented" else None, dtype=dtype,
        device="cuda")
    refs_run = ProblemRefs(*(a.contiguous() for a in refs_run))
    ref_T = ProblemRefs(*(a.contiguous() for a in ref_T))
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype, knot.family).cuda()
    return knot, consts, (x0, xs, us, K, kff, fs, w_all, feasible, refs_run, ref_T)


def p3_rollout_args(it):
    """The rollout's inputs from a point3d first iteration: K, kff and the
    gap products from the backward kernel.  (knot, consts on the card,
    args)."""
    knot, dtype = it["knot"], it["xs"].dtype
    reg = torch.full((it["xs"].shape[0],), 1e-9, dtype=dtype, device="cuda")
    out = backward_box(*it["bi"].args, reg, reg, boxqp_iters=BOXQP_ITERS, kgain_reg=KGAIN_REG)
    consts = pack_knot_consts(knot.model, knot.W, knot.surface, dtype, knot.family).cuda()
    return knot, consts, (it["x0"], it["xs"], it["us"], out[0], out[1], it["bi"].fs, out[6],
                          it["bi"].feasible, it["refs_run"], it["ref_T"])


def same_bits(small, full):
    n = small[0].shape[0]
    return all(bool(((a == b[:n]) | (torch.isnan(a) & torch.isnan(b[:n]))).all())
               for a, b in zip(small, full))


def point3d_kernel_checks(kernel, family):
    """One point3d instantiation against its plain version on the card at
    B=1024 and the family's horizon, float64 and float32, at the gates of
    phases kernels (the augmented knot) and classical (the classical knot,
    with its ties; the rollout's float64 rows also against the rounding
    yardstick, `rollout_gate`'s tie_rows): on seeded inputs, and as
    launches of 1 and of 3 problems whose pooled outputs must equal the
    gated whole batch's bit for bit; on the point3d main path's
    first-iteration inputs; the free-space instantiation on the seeded
    inputs at float64.  Returns the records, each with "ok"."""
    B = BATCHES[-1]
    ties = family == "classical"
    knot64 = p3_knot(family, torch.float64)
    recs = []

    def diff_inputs(args):
        return args[1], args[2], args[8], args[9]

    def diff_slice(out, i, j):
        from ffmpc_tpu_torch.solver.diff_cuda import KnotDerivs
        return KnotDerivs(KnotDeriv(*(a[i:j] for a in out.run)), *(a[i:j] for a in out[1:]))

    def check(label, knot, consts, args, out_k=None):
        if kernel == "knot_diff":
            rec = diff_gate(knot, consts.cpu(), diff_inputs(args), knot64, out_k)
        else:
            if out_k is None:
                out_k = rollout(knot, consts, *args, N_ALPHAS)
            torch.cuda.synchronize()
            rec = rollout_gate(knot, args, out_k, knot64, ties=ties, tie_rows=ties)
        rec.update(case=label, kernel=kernel, family=family)
        recs.append(rec)
        return rec

    def launch(knot, consts, args):
        if kernel == "knot_diff":
            xs, us, rr, rT = diff_inputs(args)
            return diff_all(knot, consts.cpu(), rr, rT, xs, us)
        return rollout(knot, consts, *args, N_ALPHAS)

    for dtype in (torch.float64, torch.float32):
        knot, consts, args = p3_seeded_args(family, B, dtype, 7)
        full = launch(knot, consts, args)
        check("seeded", knot, consts, args, full)
        for k in SMALL_BATCHES:
            n = B // k * k
            outs = [launch(knot, consts, rollout_slice(args, i, i + k)) for i in range(0, n, k)]
            if kernel == "knot_diff":
                from ffmpc_tpu_torch.solver.diff_cuda import KnotDerivs
                pooled = KnotDerivs(KnotDeriv(*(torch.cat(f) for f in zip(*(o.run for o in outs)))),
                                    *(torch.cat(f) for f in zip(*(o[1:] for o in outs))))
                flat = lambda d: (*d.run, *d[1:])  # noqa: E731
                bits = same_bits(flat(pooled), flat(diff_slice(full, 0, n)))
            else:
                pooled = tuple(torch.cat(f) for f in zip(*outs))
                bits = same_bits(pooled, full)
            recs.append({"case": f"seeded_launches_of_{k}", "kernel": kernel, "family": family,
                         "dtype": str(dtype).replace("torch.", ""), "B": n, "launch_B": k,
                         "same_bits_as_full_batch": bits, "ok": bits})
        knot, consts, args = p3_rollout_args(p3_first_iteration(family, B, dtype))
        check("main_path_first_iteration", knot, consts, args)
    knot, consts, args = p3_seeded_args(family, B, torch.float64, 7)
    free = p3_knot(family, torch.float64, surface=False)
    check("seeded_free_space", free,
          pack_knot_consts(free.model, free.W, False, torch.float64, family).cuda(), args)
    return recs


def point3d_timing(kernel, family, b):
    """A point3d instantiation's time on the point3d main path's
    first-iteration inputs (float32, contact) at batch b and its bound; the
    plain version's at the largest batch only (one timed call)."""
    it = p3_first_iteration(family, b)
    knot, consts, args = p3_rollout_args(it)
    N = P3_HORIZON[family]
    if kernel == "knot_diff":
        xs, us, refs_run, ref_T = inputs = (it["xs"], it["us"], it["refs_run"], it["ref_T"])
        c = consts.cpu()
        out = diff_all(knot, c, refs_run, ref_T, xs, us)
        run = lambda: diff_all(knot, c, refs_run, ref_T, xs, us)  # noqa: E731
        plain = lambda: diff_reference(knot, refs_run, ref_T, xs, us)  # noqa: E731
        nbytes = diff_bytes(inputs, out)
        flops = diff_flops(b, N, family=family, nc=3)
    else:
        outs = rollout(knot, consts, *args, N_ALPHAS)
        run = lambda: rollout(knot, consts, *args, N_ALPHAS)  # noqa: E731
        plain = lambda: rollout_reference(knot, *args, N_ALPHAS)  # noqa: E731
        nbytes = rollout_bytes(args, outs)
        flops = rollout_flops(b, N, N_ALPHAS, nx=P3_NX[family], nc=3)
    ms = cuda_time_ms(run)
    plain_ms = cuda_time_ms(plain, reps=1, rounds=1) if b == BATCHES[-1] else None
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
            "bytes_ms": byte_ms, "operations_ms": flop_ms}


def point3d_residency(kernel, family):
    """ptxas' registers, stack and spills of a point3d instantiation's
    kernels (from phase build's logs), and the resident blocks an SM of its
    float32 and float64 builds."""
    usage = {}
    for rec in ptxas_usage(_cuda_build.build_all().logs[P3_LIBRARIES[kernel, family]]):
        if kernel + "_kernel" not in rec["function"]:
            continue
        key = ("float32" if re.search(r"_kernelIf[LE]", rec["function"]) else "float64") + (
            "_contact" if "Lb1E" in rec["function"] else "_free")
        usage[key] = rec
    resident = {}
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        if kernel == "knot_diff":
            resident[name] = diff_resident_blocks_per_sm(dt, family=family, contact="point3d")
        else:
            resident[name] = rollout_resident_blocks_per_sm(dt, N_ALPHAS, family=family,
                                                            contact="point3d")
    spill32 = sum(v.get("spill_bytes_with_callees", 1)
                  for k, v in usage.items() if k.startswith("float32"))
    return {"ptxas": usage, "resident_blocks_per_sm": resident, "float32_spill_bytes": spill32,
            "float32_builds": sum(k.startswith("float32") for k in usage)}


def point3d_solves():
    """(b) The point3d batched solves, float32, 10 iterations, the three
    kernels: the force-feedback one at N=40 and the classical one at N=36, at
    B=256 and 1024, timed (median of SOLVE_REPEATS), the launches read
    around the first timed solve.  Force feedback: its decisions against
    plain mode on the same inputs at B=1024 (phase solve's gate,
    MIN_AGREE_SOLVE).  Classical (its contact problem sits on the box QP's
    ties, so its float32 decisions are a draw, phase classical): at B=256
    the kernels against the point3d instantiations' plain versions at
    float64 by decisions (MIN_AGREE_SOLVE, phase classical's float64 gate),
    the backward sweep on its kernel in both (shared with the normal
    contact, held in phase classical; its plain version's regularization
    retries take most of a plain classical solve's 60 s); the float32 kernel
    path's distance from that float64 path printed.  A plain solve takes
    30-60 s of the host whatever the batch, so there is one a controller.
    Returns the launch counts of each controller's B=1024 solve."""
    W = p3_weights()
    traj = flagship_trajectory()
    q0 = np.asarray(KEYFRAMES["neutral"])
    KERNELS, PLAIN = ("kernel",) * 3, ("plain",) * 3
    # the point3d instantiations in plain mode, the backward sweep (shared
    # with the normal contact and held in phase classical) on its kernel
    POINT3D_PLAIN = ("kernel", "plain", "plain")
    launches = {}
    for family in P3_FAMILIES:
        N, ctrl = P3_HORIZON[family], P3_CONTROLLER[family]
        ep = EpisodeConfig(controller=ctrl, horizon=N)
        model = flagship(torch.float32)[0]
        tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=torch.float32,
                                                      device="cuda")).cpu().numpy()
        warm = warm_start_args if family == "augmented" else classical_warm_starts

        def solver(modes, iters=ITERS, dt=torch.float32):
            bw, ro, df = modes
            return make_batched_solve_fn(
                flagship(dt)[0], W, FDDPSettings(max_iters=iters, backward_mode=bw,
                                                 rollout_mode=ro, diff_mode=df),
                traj, ep, q0, surface=True, dtype=dt, device="cuda")

        def run(modes, args, repeats, dt=torch.float32):
            """Timed solves (a one-iteration warm-up first where the kernels
            time); the launch counts of the first."""
            if "plain" not in modes:
                solver(modes, 1, dt)(*args)
            solve = solver(modes, ITERS, dt)
            reset_launches()
            res, ms = timed_solves(solve, args, 1)
            counts = read_launches()
            ms += timed_solves(solve, args, repeats - 1)[1]
            return res, ms, counts

        rng = np.random.default_rng(0)
        for B in BATCHES:
            args = warm(B, q0, tau_g, rng)
            res_k, ms_k, counts = run(KERNELS, args, SOLVE_REPEATS)
            launches.setdefault(family, {})[B] = counts
            iters_run = max(int(res_k.iters.max()), 1)
            rec = {"phase": "point3d", "case": "solve", "controller": ctrl, "B": B, "N": N,
                   "max_iters": ITERS, "dtype": "float32", "kernel_launches": counts,
                   "mean_iters": float(res_k.iters.double().mean()),
                   "converged": int(res_k.converged.sum()),
                   "diverged": int(res_k.diverged.sum()),
                   "feasible": int(res_k.feasible.sum()), "mean_cost": float(res_k.cost.mean()),
                   "kernel_mode": rate_record(B, ms_k), "min_same_decisions_share": MIN_AGREE_SOLVE}
            nx = P3_NX[family]
            if (tuple(res_k.xs.shape) != (B, N + 1, nx) or not all(
                    bool(torch.isfinite(t).all()) for t in (res_k.xs, res_k.us, res_k.cost))):
                emit(rec)
                raise RuntimeError(f"point3d {ctrl} solve B={B}: shapes or non-finite")
            if min(counts.values()) < iters_run:
                emit(rec)
                raise RuntimeError(f"point3d {ctrl} solve B={B}: launches {counts}")
            if family == "augmented":
                if B != BATCHES[-1]:
                    emit(rec)
                    continue
                res_p, ms_p, counts_p = run(PLAIN, args, PLAIN_REPEATS)
                kp = decisions_and_distance(res_k, res_p)
                rec.update(plain_mode=rate_record(B, ms_p), kernel32_vs_plain32=kp)
                emit(rec)
                if any(counts_p.values()):
                    raise RuntimeError(f"point3d solve B={B}: plain mode launched {counts_p}")
                if (kp["same_decisions_share"] < MIN_AGREE_SOLVE
                        or kp["same_step_share_by_iteration"][0] < MIN_AGREE_SOLVE):
                    raise RuntimeError(f"point3d {ctrl} solve B={B}: kernel and plain mode "
                                       f"disagree: {kp}")
                continue
            if B != BATCHES[0]:
                emit(rec)
                continue
            args64 = tuple(np.asarray(a, np.float64) for a in args)
            res_p64, ms_p64, counts_p = run(POINT3D_PLAIN, args64, 1, torch.float64)
            res_k64, _, counts64 = run(KERNELS, args64, 1, torch.float64)
            k64 = decisions_and_distance(res_k64, res_p64)
            k32 = decisions_and_distance(res_k, res_p64)
            rec.update(point3d_plain_float64=rate_record(B, ms_p64), kernel64_vs_plain64=k64,
                       kernel32_vs_plain64=k32, kernel64_launches=counts64,
                       point3d_plain_launches=counts_p)
            emit(rec)
            if (k64["same_decisions_share"] < MIN_AGREE_SOLVE
                    or k64["same_step_share_by_iteration"][0] < MIN_AGREE_SOLVE):
                raise RuntimeError(f"point3d classical solve B={B}, float64: kernel and plain "
                                   f"mode disagree: {k64}")
            if counts_p["rollout"] or counts_p["knot_diff"]:
                raise RuntimeError(f"point3d classical solve: the plain point3d path launched "
                                   f"{counts_p}")
    return {f: launches[f][BATCHES[-1]] for f in P3_FAMILIES}


def ff_contact_carry():
    """The force-feedback closed loop's carry in contact: phase closed_loop's
    case (b) at its last tick (its episode again where that phase has not
    run), and its time."""
    if "force_feedback" not in _CONTACT_CARRY:
        ep = flagship_episode(torch.float32, HORIZON, CL_FF_TICKS, FDDPSettings(max_iters=ITERS))
        q0 = torch.as_tensor(KEYFRAMES["neutral"], dtype=torch.float32, device="cuda")[None]
        _CONTACT_CARRY["force_feedback"] = ep.chunk(ep.init(q0), 0.0, CL_FF_TICKS)[0]
    return _CONTACT_CARRY["force_feedback"], CL_FF_TICKS * 0.005


def point3d_loops():
    """(c) The closed loop of each controller on the point3d knots: (a)'s
    `loop_kernel_vs_plain` at float64, E=2, N=8, 3 iterations, 8 ticks from
    t0 = 0.78 s (both knots), with the tie yardstick (CL_LOOP_TIE_FACTOR);
    and one float32 full-width episode (E=1, N=40 / 36, 10 iterations),
    about 40 ticks in contact: the force-feedback one P3_FF_TICKS ticks on
    from `ff_contact_carry`, the classical one P3_CL_TICKS ticks from the
    neutral pose on the fast approach (P3_FAST_TRAJ): finite telemetry, no
    fallback tick unless a float64 run takes it too; ms a tick, mean
    iterations, contact ticks, the final normal force.  Returns the launch
    counts of each full-width episode."""
    from ffmpc_tpu_torch.tasks.trajectories import ApproachCircleTraj
    W = p3_weights()
    counts = {}
    for family in P3_FAMILIES:
        ctrl, N = P3_CONTROLLER[family], P3_HORIZON[family]
        rec = loop_kernel_vs_plain(ctrl, 8, CL_A_TICKS, CL_A_T0,
                                   f"point3d {ctrl} closed loop (a)",
                                   tie_factor=CL_LOOP_TIE_FACTOR, W=W)
        ok = rec.pop("ok")
        emit({"phase": "point3d", "case": "loop_kernel_vs_plain", "controller": ctrl, **rec})
        if not ok:
            raise RuntimeError(f"point3d {ctrl} closed loop: kernel and plain mode disagree: "
                               f"{rec}")
        S = FDDPSettings(max_iters=ITERS)
        if family == "augmented":
            ticks, traj = P3_FF_TICKS, None
            carry, t_start = ff_contact_carry()
        else:
            ticks, traj, t_start = P3_CL_TICKS, ApproachCircleTraj(**P3_FAST_TRAJ), 0.0
        ep = flagship_episode(torch.float32, N, ticks, S, controller=ctrl, W=W, traj=traj)
        if family != "augmented":
            carry = ep.init(torch.as_tensor(KEYFRAMES["neutral"], dtype=torch.float32,
                                            device="cuda")[None])
        reset_launches()
        t0 = time.perf_counter()
        tl = ep.chunk(carry, t_start, ticks)[1]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[family] = read_launches()
        require_launches(f"point3d {ctrl} episode", counts[family], ticks)
        finite = all(bool(torch.isfinite(v).all()) for v in tl.values() if v.is_floating_point())
        fb = tl["fallback"][0].nonzero().flatten().tolist()
        rec = {"phase": "point3d", "case": "episode", "controller": ctrl, "dtype": "float32",
               "E": 1, "N": N, "max_iters": ITERS, "t0": t_start, "ticks": ticks,
               "wall_s": wall, "ms_per_tick": wall / ticks * 1e3, "launches": counts[family],
               "finite": finite, "fallback_ticks": fb, "n_fallback_ticks": len(fb),
               "mean_iters": float(tl["iters"].double().mean()),
               "contact_ticks": int((tl["fn_meas"][0] > 0).sum()),
               "fn_final_N": float(tl["fn_meas"][0, -1]),
               "err_3d_final_mm": float(tl["err_3d"][0, -1]) * 1e3,
               "trace": telemetry_summary(tl, every=10)}
        ok = finite
        if fb:
            ep64 = flagship_episode(torch.float64, N, ticks, S, controller=ctrl, W=W, traj=traj)
            carry64 = cast_carry(carry, torch.float64)
            fb64 = ep64.chunk(carry64, t_start, ticks)[1]["fallback"][0]
            fb64 = fb64.nonzero().flatten().tolist()
            rec["float64_fallback_ticks"] = fb64
            ok = ok and set(fb) <= set(fb64)
        emit(rec)
        if not ok:
            raise RuntimeError(f"point3d {ctrl} episode: non-finite telemetry or fallback "
                               f"ticks {fb}")
    return counts


def phase_point3d():
    """The point contact (nc = 3, the friction cone; P3_W) in both
    controllers' knots on the point3d instantiations of the derivative and
    rollout kernels: (a) each instantiation against its plain version
    (`point3d_kernel_checks`), its ptxas registers, stack and spills (no
    float32 build may spill) and resident blocks, and its time, plain time
    and bound at B=1 / 256 / 1024; (b) `point3d_solves`; (c)
    `point3d_loops`.  Returns (the figures of each kernel by family, the
    launch counts by path)."""
    failures = []
    figures = {}
    seconds = {}
    t0 = time.perf_counter()
    for kernel in ("knot_diff", "rollout"):
        for family in P3_FAMILIES:
            recs = point3d_kernel_checks(kernel, family)
            failures += [f"{kernel}/{family}/{r['case']}/{r['dtype']}" for r in recs
                         if not r["ok"]]
            emit({"phase": "point3d", "kernel": kernel, "family": family, "checks": recs})
            res = point3d_residency(kernel, family)
            res["by_batch"] = {str(b): point3d_timing(kernel, family, b)
                               for b in (1,) + BATCHES}
            main = [r for r in recs if r["dtype"] == "float64"
                    and r["case"] == "main_path_first_iteration"][0]
            res["max_abs_err"] = max(main["max_abs_err"].values())
            res["max_rel_err"] = max(e / max(main["scale"][n], 1e-30)
                                     for n, e in main["max_abs_err"].items())
            res["max_abs_err_dtype"] = "float64"
            figures[kernel, family] = res
            emit({"phase": "point3d", "kernel": kernel, "family": family, **res})
            if res["float32_spill_bytes"] != 0 or res["float32_builds"] == 0:
                failures.append(f"{kernel}/{family}: float32 spill or no float32 build")
    if failures:
        raise RuntimeError(f"point3d instantiations: {failures}")
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = {"point3d_solve_1024": point3d_solves()}
    seconds["solves"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths["point3d_episode"] = point3d_loops()
    seconds["loops"] = time.perf_counter() - t0
    emit({"phase": "point3d", "seconds": seconds})
    return figures, paths



def main():
    seconds = {}

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t0, 1)
        return out

    smi = timed(phase_device)
    timed(phase_build)
    kernels = [timed(phase_kernels), timed(phase_rollout_kernel), timed(phase_diff_kernel)]
    timed(phase_small_reference)
    timed(phase_golden)
    launches = timed(phase_solve)
    classical, classical_launches = timed(phase_classical)
    timed(phase_stages)
    probes = timed(phase_probes)
    timed(phase_plant)
    paths = {f"closed_loop_{CL_FF_TICKS}_ticks": timed(phase_closed_loop)}
    timed(phase_b1)
    paths["ensemble_512x100"] = timed(phase_ensemble)
    paths["classical_solve_1024"] = classical_launches
    classical_paths = timed(phase_classical_loop)
    point3d, point3d_paths = timed(phase_point3d)
    emit({"phase_seconds": seconds})
    for entry in kernels:
        entry["launches_by_batch"] = {str(b): n[entry["name"]] for b, n in launches.items()}
        entry["launches"] = entry["launches_by_batch"][str(BATCHES[-1])]
        entry["launches_by_path"] = {p: n[entry["name"]] for p, n in paths.items()}
        entry["families"] = ["augmented (nx=21)", "classical (nx=14)",
                             "augmented point3d (nx=21, nc=3)",
                             "classical point3d (nx=14, nc=3)"]
        c = classical[entry["name"]]
        t = c["by_batch"][str(BATCHES[-1])]
        entry["classical"] = {
            "source": f"ffmpc_tpu_torch/csrc/{CL_LIBRARIES[entry['name']]}.cu",
            "replaces": entry["replaces"], "launches": classical_launches[entry["name"]],
            "launches_by_path": {p: n[entry["name"]] for p, n in classical_paths.items()},
            "max_abs_err": c["max_abs_err"], "max_abs_err_dtype": c["max_abs_err_dtype"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "shape": {"B": BATCHES[-1], "N": CL_HORIZON, "nx": CL_NX, "nu": NU,
                      "dtype": "float32"},
            "by_batch": c["by_batch"], "resident_blocks_per_sm": c["resident_blocks_per_sm"],
            "ptxas": c["ptxas"]}
        # the point contact: the derivative and rollout kernels' point3d
        # instantiations; the backward sweep's nx = 21 / 14 builds serve it
        name = entry["name"]
        entry["point3d"] = {}
        for family in P3_FAMILIES:
            by_path = {p: n[family][name] for p, n in point3d_paths.items()}
            if name == "backward_sweep":
                src = "backward_sweep" if family == "augmented" else CL_LIBRARIES[name]
                entry["point3d"][family] = {
                    "source": f"ffmpc_tpu_torch/csrc/{src}.cu", "same_build_as": family,
                    "launches": by_path["point3d_solve_1024"], "launches_by_path": by_path}
                continue
            f = point3d[name, family]
            t = f["by_batch"][str(BATCHES[-1])]
            entry["point3d"][family] = {
                "source": f"ffmpc_tpu_torch/csrc/{P3_LIBRARIES[name, family]}.cu",
                "replaces": entry["replaces"], "launches": by_path["point3d_solve_1024"],
                "launches_by_path": by_path, "max_abs_err": f["max_abs_err"],
                "max_rel_err": f["max_rel_err"], "max_abs_err_dtype": f["max_abs_err_dtype"],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None,
                "shape": {"B": BATCHES[-1], "N": P3_HORIZON[family], "nx": P3_NX[family],
                          "nu": NU, "nc": 3, "dtype": "float32"},
                "by_batch": f["by_batch"], "resident_blocks_per_sm": f["resident_blocks_per_sm"],
                "ptxas": f["ptxas"]}
    print(smi, flush=True)
    emit({"kernels": kernels + probes})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
