"""Batched closed-loop MPC ensembles: E perturbed episodes in one batch on
one card.

PyTorch counterpart of ``ffmpc_tpu/run/ensemble.py``, for both
controllers: perturbed initial states (and, for the
``actuation_uncertainty`` scenario, the uncertainty protocol) roll out
together on the device plant, every solve on the three kernels (their
instantiations for the controller's knot family), with per-episode metrics
reduced at the end.  ``horizon`` defaults to 40, as the JAX package's does;
the classical protocol of ``BASELINE.md`` is ``horizon=36``.  The draws of the
perturbations and of the uncertainty parameters are the JAX package's
(numpy generators), so both ensembles start from the same states.  Device
meshes (``n_devices``) and checkpoints are not ported yet.

Usage:
    python -m ffmpc_tpu_torch.run.ensemble --batch 512 --ticks 400 \
        --controller force_feedback --scenario flat
    python -m ffmpc_tpu_torch.run.ensemble --batch 512 --ticks 100 \
        --controller classical --horizon 36
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device


def run_ensemble(controller: str = "force_feedback", scenario: str = "flat",
                 batch: int = 512, ticks: int = 400, horizon: int = 40,
                 max_iters: int = 10, seed: int = 0, perturb_q: float = 0.01,
                 dtype_name: str = "float32", verbose: bool = True,
                 chunk_ticks: int | None = None, device="cuda"):
    """Run the ensemble; returns (summary dict, telemetry dict of (E, ticks,
    ...) numpy arrays).  A one-tick episode is run first, untimed, as the
    warm-up (first uses of the kernels' libraries and of the solver)."""
    from ..core import make_panda_model, KEYFRAMES
    from ..ocp.weights import (flagship_weights, flagship_trajectory,
                               flagship_ff_alpha, FLAGSHIP_DT_MPC)
    from ..solver.fddp import FDDPSettings
    from ..sim.device_plant import make_table_params
    from .batch_runner import make_episode_fn, EpisodeConfig, DeviceUncertainty
    from .scenarios import scenario_settings, scenario_seed

    dev = resolve_device(device)
    dtype = {"float32": torch.float32, "float64": torch.float64}[dtype_name]
    np_dtype = np.float32 if dtype_name == "float32" else np.float64
    settings_sc = scenario_settings(scenario)

    model = make_panda_model("plant", dtype=dtype, device=dev)
    W = flagship_weights()
    traj = flagship_trajectory()
    table = make_table_params(settings_sc.tilt_deg, dtype=dtype, device=dev)
    # the three kernels (the JAX ensemble's Pallas settings on the TPU)
    solver = FDDPSettings(max_iters=max_iters, backward_mode="kernel",
                          rollout_mode="kernel", diff_mode="kernel")
    ep = EpisodeConfig(controller=controller, horizon=horizon, n_ticks=ticks,
                       ff_alpha_ctrl=flagship_ff_alpha(FLAGSHIP_DT_MPC))

    unc = None
    if scenario == "actuation_uncertainty":
        rng = np.random.default_rng(scenario_seed(scenario))
        unc = DeviceUncertainty(
            a=float(rng.uniform(0.95, 1.05)), b=float(rng.uniform(-0.1, 0.1)),
            sigma_q=5e-4, sigma_dq=2e-3, sigma_tau=5e-2,
            seed=scenario_seed(scenario))
    torque_scale = None
    if np.any(settings_sc.torque_scale != 1.0) and unc is None:
        torque_scale = settings_sc.torque_scale

    q0 = np.asarray(KEYFRAMES["neutral"])
    episode = make_episode_fn(model, W, solver, traj, table, ep, q0,
                              torque_scale=torque_scale, uncertainty=unc,
                              dtype=dtype, device=dev)

    rng = np.random.default_rng(seed)
    q0s = (q0[None] + perturb_q * rng.normal(size=(batch, 7))).astype(np_dtype)
    q0s_dev = torch.as_tensor(q0s, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    episode.chunk(episode.init(q0s_dev), 0.0, 1)      # warm-up: one tick
    sync()
    step = ticks if chunk_ticks is None or chunk_ticks >= ticks else chunk_ticks
    n_chunks = (ticks + step - 1) // step
    carry = episode.init(q0s_dev)
    parts, wall = [], 0.0
    for ci in range(n_chunks):
        n = min(step, ticks - ci * step)
        # chunk start times as the JAX chunked run forms them
        t_start = torch.as_tensor(ci * step * FLAGSHIP_DT_MPC, dtype=dtype)
        t0 = time.perf_counter()
        carry, tl = episode.chunk(carry, t_start, n)
        sync()
        wall += time.perf_counter() - t0
        parts.append({k: v.cpu().numpy() for k, v in tl.items()})
        if verbose and n_chunks > 1:
            print(f"chunk {ci + 1}/{n_chunks}: "
                  f"{n * batch / (time.perf_counter() - t0):.0f} solves/s")
    telem = {k: np.concatenate([p[k] for p in parts], axis=1) for k in parts[0]}

    err = telem["err_tan"]          # (E, ticks)
    fn = telem["fn_meas"]
    out = {
        "controller": controller, "scenario": scenario,
        "batch": batch, "ticks": ticks,
        "wall_s": round(wall, 2),
        "episodes_per_s": round(batch / wall, 2),
        "solves_per_s": round(batch * ticks / wall, 1),
        "rms_tan_mean": float(np.sqrt((err ** 2).mean())),
        "rms_tan_p95": float(np.quantile(np.sqrt((err ** 2).mean(axis=1)), 0.95)),
        "fn_final_mean": float(fn[:, -1].mean()),
        "device": str(dev) if dev.type != "cuda" else torch.cuda.get_device_name(dev),
    }
    if verbose:
        print(json.dumps(out))
    return out, telem


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--controller", choices=("classical", "force_feedback"),
                    default="force_feedback")
    ap.add_argument("--scenario", default="flat")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--max-iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--perturb-q", type=float, default=0.01)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--chunk-ticks", type=int, default=None,
                    help="Run the episode in calls of this many ticks.")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run_ensemble(controller=a.controller, scenario=a.scenario, batch=a.batch,
                 ticks=a.ticks, horizon=a.horizon, max_iters=a.max_iters,
                 seed=a.seed, perturb_q=a.perturb_q, dtype_name=a.dtype,
                 chunk_ticks=a.chunk_ticks, device=a.device)


if __name__ == "__main__":
    main()
