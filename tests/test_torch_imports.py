"""The PyTorch port stands alone: importing every module of
``ffmpc_tpu_torch`` and ``chip_smoke`` pulls in neither ``jax``, nor the JAX
package, nor ``mujoco`` (the card's machine has none), and entry points
asked for "cuda" raise where there is no card (they never carry on on the
CPU by themselves).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import ffmpc_tpu_torch
names = ["ffmpc_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    ffmpc_tpu_torch.__path__, "ffmpc_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m == "ffmpc_tpu" or m.startswith("ffmpc_tpu.")
                or m == "mujoco" or m.startswith("mujoco."))
print("MODULES", len(names))
print("LEAKED", leaked)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    # every module of the port: the kernel wrappers, the plant, the episode,
    # the ensemble and the probes included
    assert int(lines["MODULES"]) >= 35
    assert lines["LEAKED"] == "[]", lines["LEAKED"]


def test_sources_do_not_mention_jax_imports():
    files = list((REPO / "ffmpc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 36
    for rel in ("solver/rollout_cuda.py", "solver/diff_cuda.py", "sim/device_plant.py",
                "run/ensemble.py", "tools/probe_mosaic2.py"):
        assert REPO / "ffmpc_tpu_torch" / rel in files, rel
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import ffmpc_tpu ",
                                     "from ffmpc_tpu ", "from ffmpc_tpu.",
                                     "import ffmpc_tpu.", "import mujoco",
                                     "from mujoco")), (f, line)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request for 'cuda' is honoured")


def test_model_constructor_raises_without_a_card():
    _no_card()
    from ffmpc_tpu_torch.core import make_panda_model
    with pytest.raises(RuntimeError, match="cuda"):
        make_panda_model("plant")                      # default device: the card
    with pytest.raises(RuntimeError, match="cuda"):
        make_panda_model("plant", device="cuda")


def test_refs_and_solve_entry_points_raise_without_a_card():
    _no_card()
    from ffmpc_tpu_torch.core import make_panda_model, KEYFRAMES
    from ffmpc_tpu_torch.ocp.problem import build_problem_refs
    from ffmpc_tpu_torch.ocp.weights import (flagship_weights, flagship_trajectory,
                                             make_problem_refs)
    from ffmpc_tpu_torch.run.batch_runner import make_batched_solve_fn, EpisodeConfig
    from ffmpc_tpu_torch.solver.fddp import FDDPSettings
    W = flagship_weights()
    with pytest.raises(RuntimeError, match="cuda"):
        build_problem_refs(flagship_trajectory(), np.zeros(2), 3, W.dt_ocp,
                           np.zeros(14), np.zeros(7), np.eye(3))
    with pytest.raises(RuntimeError, match="cuda"):
        make_problem_refs(np.zeros(3), np.zeros(3), np.zeros(14), np.zeros(7), np.eye(3))
    model = make_panda_model("plant", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        make_batched_solve_fn(model, W, FDDPSettings(), flagship_trajectory(),
                              EpisodeConfig(controller="force_feedback", horizon=3),
                              KEYFRAMES["neutral"])


def test_episode_and_ensemble_raise_without_a_card():
    _no_card()
    from ffmpc_tpu_torch.core import make_panda_model, KEYFRAMES
    from ffmpc_tpu_torch.ocp.weights import flagship_weights, flagship_trajectory
    from ffmpc_tpu_torch.run.batch_runner import make_episode_fn, EpisodeConfig
    from ffmpc_tpu_torch.run.ensemble import run_ensemble
    from ffmpc_tpu_torch.sim.device_plant import make_table_params, init_plant_state
    from ffmpc_tpu_torch.solver.fddp import FDDPSettings
    model = make_panda_model("plant", device="cpu")
    table = make_table_params(0.0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        make_episode_fn(model, flagship_weights(), FDDPSettings(), flagship_trajectory(),
                        table, EpisodeConfig(horizon=3), KEYFRAMES["neutral"])
    with pytest.raises(RuntimeError, match="cuda"):
        run_ensemble(batch=2, ticks=1, horizon=3, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_table_params(0.0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_plant_state(np.zeros(7))


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    _no_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout


def test_kernel_build_raises_without_a_compiler(tmp_path, monkeypatch):
    """No nvcc on the machine: the build raises, nothing falls back."""
    import shutil
    import os
    from ffmpc_tpu_torch.solver import _cuda_build
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA compiler is present")
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.build_all()
