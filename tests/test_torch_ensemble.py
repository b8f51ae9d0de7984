"""The port's ensemble (``ffmpc_tpu_torch.run.ensemble.run_ensemble``, CPU,
float64, the three modes "kernel", so the plain versions on these CPU
tensors) == the JAX package's ``run_ensemble`` on the same arguments, at the
full width (horizon 40, 10 iterations, the flagship weights, trajectory and
filter poles) and a small batch.

The JAX side compiles its whole vmapped episode at XLA's default
optimisation, which takes minutes on the CPU, so its figures are kept here
(``JAX_REFERENCE``) and this file regenerates them:

    JAX_PLATFORMS=cpu python tests/test_torch_ensemble.py

Held to 1e-9 of each field's scale (float64 against float64; the
whole-solve tolerance of ``tests/test_torch_solve.py`` is 1e-6), with the
iterations of every tick equal.
"""

import numpy as np

ARGS = dict(controller="force_feedback", scenario="flat", batch=2, ticks=2, horizon=40,
            max_iters=10, seed=0, perturb_q=0.01, dtype_name="float64")
RTOL = 1e-9

# printed by `JAX_PLATFORMS=cpu python tests/test_torch_ensemble.py` (the JAX
# package's run_ensemble on ARGS, about 3.5 minutes on an 8-core CPU)
JAX_REFERENCE = {'rms_tan_mean': 0.00419057272947835,
                 'rms_tan_p95': 0.005237410250181134,
                 'fn_final_mean': 0.0,
                 'iters': [[7, 4], [7, 4]],
                 'err_tan_last': [0.0024904940363281386, 0.0054818474307630405],
                 'q_last': [[0.0012308783517895787,
                             -0.7595552979986375,
                             0.006389600460777491,
                             -2.220592722195645,
                             -0.005256247521612704,
                             1.4354163063084107,
                             0.01388050885690268],
                            [0.009453351085370014,
                             -0.7652401576689836,
                             -0.012662426482359263,
                             -2.227825555120738,
                             0.00046853570273345466,
                             1.4086573135972202,
                             -0.0013357513885854542]],
                 'tau_cmd_last': [[-0.41535206087383963,
                                   9.820107018382169,
                                   -0.7784161031578762,
                                   -2.310870649068611,
                                   0.1468272133793992,
                                   3.4133655118897024,
                                   1.414024171106474],
                                  [-0.14474990230647913,
                                   10.186568628269812,
                                   -0.35661637509726524,
                                   -1.7679629482279051,
                                   0.1086395501040939,
                                   3.663956918638552,
                                   1.439124360696686]]}


def summarize(out, telem):
    """The figures compared: the ensemble's three quality figures and, per
    episode, every tick's iterations and the last tick's err_tan, q and
    tau_cmd."""
    return {"rms_tan_mean": float(out["rms_tan_mean"]),
            "rms_tan_p95": float(out["rms_tan_p95"]),
            "fn_final_mean": float(out["fn_final_mean"]),
            "iters": np.asarray(telem["iters"]).astype(int).tolist(),
            "err_tan_last": np.asarray(telem["err_tan"])[:, -1].tolist(),
            "q_last": np.asarray(telem["q"])[:, -1].tolist(),
            "tau_cmd_last": np.asarray(telem["tau_cmd"])[:, -1].tolist()}


def jax_reference():
    import jax
    jax.config.update("jax_enable_x64", True)
    from ffmpc_tpu.run.ensemble import run_ensemble
    return summarize(*run_ensemble(**ARGS, verbose=False))


def test_ensemble_equals_jax_run_ensemble():
    from ffmpc_tpu_torch.run.ensemble import run_ensemble
    got = summarize(*run_ensemble(**ARGS, verbose=False, device="cpu"))
    want = JAX_REFERENCE
    assert got["iters"] == want["iters"]
    for key in ("rms_tan_mean", "rms_tan_p95", "fn_final_mean", "err_tan_last",
                "q_last", "tau_cmd_last"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= RTOL * scale, f"{key}: err {err:.3e}, scale {scale:.3e}"
    assert np.isfinite(got["rms_tan_mean"]) and got["rms_tan_mean"] > 0.0


if __name__ == "__main__":
    import pprint
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    pprint.pprint(jax_reference(), width=100, sort_dicts=False)
