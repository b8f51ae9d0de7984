"""The classical controller's closed loop and ensemble (x = (q, v),
u = tau, nx = 14), float64 on the CPU with the three modes "kernel", so the
plain versions run on these CPU tensors, unless marked:

- the port's episode (``make_episode_fn(EpisodeConfig(controller=
  "classical"))``) == the JAX package's ``make_episode_fn`` on the setup of
  ``tests/test_torch_episode.py`` (``OCPWeights(dt_ocp=0.01,
  w_ee_pos=1.2e3)``, 2 iterations, horizon 4, from the neutral pose), over
  ticks 0-2 from t = 0 and over six ticks from t0 = 0.78 s, where the
  trajectory's surface flag switches at 0.80 s, so both knots run; clean,
  and with the uncertainty protocol's gain and bias (a = 1.03, b = 0.05,
  every sigma 0): equal iterations, and q, tau_cmd, cost and fn_meas within
  rtol 1e-6 / atol 1e-7 of the field's largest magnitude (the whole-solve
  tolerance of ``tests/test_torch_solve.py``: the box QP's argmin ties).
  The JAX episodes' figures are kept here (``JAX_EPISODES``; one JAX
  compile of a three-tick chunk, with a and b traced, serves every case,
  about two minutes);
- the port's ``run_ensemble(controller="classical")`` == the JAX package's
  at the full width (horizon 36, 10 iterations) and a small batch, at 1e-9
  of each field's scale with the iterations of every tick equal; the JAX
  figures are kept here (``JAX_REFERENCE``);
- a solve given another knot family's kernel constants raises;
- ``cuda``-marked: the classical loop on the card, kernels against plain
  mode at float64 (``chip_smoke.py`` phase ``classical_loop``, case (a), at
  N=4 and 4 ticks); skipped without a card.

The JAX package is imported only where its figures are made anew
(``python tests/test_torch_classical_loop.py``): on a card's machine the
``cuda`` tests run with ``python -m pytest --noconftest
tests/test_torch_classical_loop.py -m cuda``.

``python tests/test_torch_classical_loop.py`` prints ``JAX_EPISODES`` and
``JAX_REFERENCE`` anew and compares the regularization retries of the two packages' float32
classical solves (each problem's final regularization and iterations; B=64,
N=36, warm starts as ``chip_smoke.py::classical_warm_starts`` builds them).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

if __name__ == "__main__":      # run as a script: the repo's packages
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ffmpc_tpu_torch.core import KEYFRAMES, make_panda_model
from ffmpc_tpu_torch.ocp.action import make_augmented_knot, make_classical_knot
from ffmpc_tpu_torch.ocp.weights import OCPWeights as TWeights, flagship_weights
from ffmpc_tpu_torch.run.batch_runner import (DeviceUncertainty as TUnc,
                                              EpisodeConfig as TEpisode,
                                              make_episode_fn as t_episode_fn)
from ffmpc_tpu_torch.run.ensemble import run_ensemble
from ffmpc_tpu_torch.sim.device_plant import make_table_params as t_table
from ffmpc_tpu_torch.solver.fddp import FDDPSettings as TSettings, solve as t_solve
from ffmpc_tpu_torch.solver.rollout_cuda import consts_len, pack_knot_consts
from ffmpc_tpu_torch.tasks.trajectories import ApproachCircleTraj as TTraj
from jax_figures import print_figures, stored

CHUNK = 3
FIELDS = ("q", "tau_cmd", "cost", "fn_meas")
RTOL, ATOL = 1e-6, 1e-7
Z_C = 0.342
TRAJ_KW = dict(center=(-0.5, 0.0, Z_C), radius=0.10, omega=1.5, z_contact=Z_C,
               t_approach=0.55, z_pre=Z_C + 0.05, t_pre=0.25,
               ee_start=(-0.3, 0.0, 0.633), t_stabilize=0.2)
EP_KW = dict(controller="classical", horizon=4, n_ticks=CHUNK)
CASES = {"start": (0.0, 1), "switch": (0.78, 2)}      # t0, chunks of CHUNK ticks
GAIN_BIAS = (1.03, 0.05)

ENSEMBLE_ARGS = dict(controller="classical", scenario="flat", batch=2, ticks=2, horizon=36,
                     max_iters=10, seed=0, perturb_q=0.01, dtype_name="float64")
ENSEMBLE_RTOL = 1e-9

# printed by `JAX_PLATFORMS=cpu python tests/test_torch_classical_loop.py`
# (the JAX package's run_ensemble on ENSEMBLE_ARGS)
JAX_REFERENCE = {'rms_tan_mean': 0.00394227722654562,
                 'rms_tan_p95': 0.004886656673638792,
                 'fn_final_mean': 0.0,
                 'iters': [[10, 3], [9, 3]],
                 'err_tan_last': [0.002417681792166011, 0.004907386226457842],
                 'q_last': [[0.000625340457070645,
                             -0.7589261357521909,
                             0.006628545180717035,
                             -2.2233147311330383,
                             -0.005022916361388782,
                             1.4384561125769015,
                             0.017220291600270013],
                            [0.008892350427914242,
                             -0.7643716454066003,
                             -0.012286041475933145,
                             -2.2301486067539757,
                             0.0007899654253491131,
                             1.4117709298776209,
                             0.0021741155310402963]],
                 'tau_cmd_last': [[-4.351131641089686,
                                   58.510734570156565,
                                   -0.814804708436157,
                                   -42.968580188022955,
                                   -0.9424702275353682,
                                   6.372419995409236,
                                   5.323543430583517],
                                  [-2.300330731510023,
                                   60.34386640124729,
                                   2.20632950428153,
                                   -39.34667274721903,
                                   -0.6240050080286241,
                                   7.117567528247172,
                                   5.578441037756447]]}


# printed by `JAX_PLATFORMS=cpu python tests/test_torch_classical_loop.py`
# (jax_episodes: each case's telemetry, keyed "case/uncertainty")
JAX_EPISODES = {
    'start/clean': {
        't': ((3,), [
            0.005, 0.01, 0.015,
        ]),
        'iters': ((3,), [
            2.0, 2.0, 2.0,
        ]),
        'q': ((3, 7), [
            -4.380884558944801e-05, -0.7583552230312134, 7.263673076837046e-06, -2.221561467116507,
            2.0674002394076344e-05, 1.4311931999216325, 0.00034253143777368224,
            -0.00014197988875735764, -0.7592179655077937, 2.1555492494279675e-05,
            -2.2255591467959834, 6.476310852079123e-05, 1.4342826567934415, 0.0010851935559287838,
            -0.00026504875295509843, -0.760335913758832, 3.882919764634755e-05,
            -2.2311960762970737, 0.0001198475893927508, 1.438748383123295, 0.0019920014498109443,
        ]),
        'tau_cmd': ((3, 7), [
            -1.2182189813296265, 25.2008424687097, 0.45520159311551284, -52.13729850426719,
            -1.4977490312690191, 4.069850202321068, 2.4775769228814046, -0.7445345914461755,
            27.148964388656207, 0.4029685707093438, -47.21958556758181, -1.3416272489333418,
            4.48930840294939, 1.392840654681363, -0.2877376804736176, 19.112046473033836,
            -0.026038168553501162, -18.02067214822183, -0.3923483752794481, 4.245459671214627,
            0.5363544968332024,
        ]),
        'cost': ((3,), [
            0.629955042142485, 0.6708477414882984, 0.754411966811509,
        ]),
        'fn_meas': ((3,), [
            0.0, 0.0, 0.0,
        ]),
    },
    'start/gain_bias': {
        't': ((3,), [
            0.005, 0.01, 0.015,
        ]),
        'iters': ((3,), [
            2.0, 2.0, 2.0,
        ]),
        'q': ((3, 7), [
            -4.397436686751209e-05, -0.7583604663383829, 7.589461907188589e-06,
            -2.2215947404161773, 2.710765712731635e-05, 1.431232844627399, 0.00036005892077038205,
            -0.00014194588213521013, -0.7592310584703321, 2.2588340759313e-05, -2.225663153931054,
            8.496372036451879e-05, 1.4344114106889767, 0.0011362696119467713,
            -0.00026436882240040056, -0.760359674125449, 4.090182923303979e-05,
            -2.2314320766937947, 0.0001593718424805739, 1.4390357159978737, 0.002087944590501562,
        ]),
        'tau_cmd': ((3, 7), [
            -1.2182189813296265, 25.2008424687097, 0.45520159311551284, -52.13729850426719,
            -1.4977490312690191, 4.069850202321068, 2.4775769228814046, -0.7487999773316037,
            27.009562517507668, 0.3844609708617807, -46.69881114229366, -1.347211698282009,
            4.436174609156947, 1.340233968573975, -0.31587210874376603, 20.209645685038065,
            -6.589084754670543e-05, -20.072013066556973, -0.4760804560076039, 4.276832521285257,
            0.5374449217170165,
        ]),
        'cost': ((3,), [
            0.629955042142485, 0.670123564850787, 0.7555763524330642,
        ]),
        'fn_meas': ((3,), [
            0.0, 0.0, 0.0,
        ]),
    },
    'switch/clean': {
        't': ((6,), [
            0.785, 0.79, 0.795, 0.8, 0.805, 0.81,
        ]),
        'iters': ((6,), [
            2.0, 2.0, 2.0, 2.0, 2.0, 2.0,
        ]),
        'q': ((6, 7), [
            0.0003474780705084521, -0.7579210161561902, -0.00015199942545373663,
            -2.2218780314830315, 0.0002947716186755503, 1.4317182625833758, 0.0005549616886937073,
            0.0007665870344413077, -0.7576843027950959, -0.00038164342012527667, -2.22678353427828,
            0.0009692036063459192, 1.4356766642570948, 0.0015226251323439846, 0.001514914859598553,
            -0.7572670297973894, -0.0008395558696694113, -2.234718251392522, 0.0017102261190714693,
            1.4422967374007063, 0.0028333533503978325, 0.0028111161635431536, -0.7566248605905505,
            -0.0016392177662306682, -2.245642685062514, 0.002321040895882738, 1.4517375233453058,
            0.004496062508384578, 0.0007423229432095447, -0.7562726096780298,
            -0.0009591105188528114, -2.2568040941971317, 0.0017714533076965053, 1.462392802209913,
            0.004374276457441171, -0.00838484044940802, -0.7565744034012791, 0.004006525470457366,
            -2.2662702854401333, -0.000601714590009705, 1.4722815597853083, 0.0012313516847972951,
        ]),
        'tau_cmd': ((6, 7), [
            8.476244561435653, 87.0, 0.31451415187961507, -87.0, 0.5496206159497821,
            5.855746429927052, 3.8838641328348, -5.2271519703734, 87.0, -1.7336890300834693, -87.0,
            -0.9673466371073745, 1.3867423385317679, 0.655839815671013, 8.548984702536677, 87.0,
            -4.2569214101096, -87.0, -2.364374494135459, 8.68135982762758, 2.385039824239855,
            4.220050508726393, 87.0, -4.431723313887585, -87.0, -2.8809694551935943,
            6.0791681012488175, 1.3937263349240976, -87.0, -87.0, 9.173509528746564, 87.0, -12.0,
            12.0, -12.0, -87.0, -87.0, 87.0, 87.0, -12.0, 3.2067192719193987, -12.0,
        ]),
        'cost': ((6,), [
            115.10804727700635, 106.16211267003234, 99.05720807460159, 93.04148267130975,
            10241.07597927123, 2790.529168021003,
        ]),
        'fn_meas': ((6,), [
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
        ]),
    },
    'switch/gain_bias': {
        't': ((6,), [
            0.785, 0.79, 0.795, 0.8, 0.805, 0.81,
        ]),
        'iters': ((6,), [
            2.0, 2.0, 2.0, 2.0, 2.0, 2.0,
        ]),
        'q': ((6, 7), [
            0.0003590503069253556, -0.7579132242359455, -0.00015645526761582268,
            -2.221920795594195, 0.0003094300625233453, 1.4317736675128079, 0.0005788614305758986,
            0.0007874707999551458, -0.7576548733299107, -0.00039045649357949543,
            -2.226936919236102, 0.001012346831925384, 1.4358599768397557, 0.0015831812424328708,
            0.0015515212338877375, -0.7572011403906053, -0.0008579569103129136,
            -2.2350502639543812, 0.0017789004086891796, 1.4426971163982207, 0.002934499091110014,
            0.0028759063797063667, -0.7565056802867424, -0.0016758841504057958,
            -2.2462197285771035, 0.0024057870664582932, 1.4524492091844083, 0.004640222478617629,
            0.000832938875802875, -0.7561003833585298, -0.0010978126468503295, -2.2576139014187317,
            0.0018425733590533044, 1.4634608177311526, 0.004511097838148653, -0.008416085759557573,
            -0.756369705700429, 0.003811551111230884, -2.2672903977981544, -0.000579730789964622,
            1.474084066361474, 0.001283942677115837,
        ]),
        'tau_cmd': ((6, 7), [
            8.476244561435653, 87.0, 0.31451415187961507, -87.0, 0.5496206159497821,
            5.855746429927052, 3.8838641328348, -5.403143331349822, 87.0, -1.7612906351365978,
            -87.0, -1.036411176131029, 1.3790554399510344, 0.5806595923821869, 8.48724245491276,
            87.0, -4.303838441910038, -87.0, -2.4506799087861046, 8.711162724454887,
            2.313454083737935, 4.066957509074423, 87.0, -4.469953953720374, -87.0,
            -2.963656843684419, 6.084867063715259, 1.3056642344679976, -87.0, -87.0,
            3.000030884337022, 87.0, -12.0, 12.0, -12.0, -87.0, -87.0, 87.0, 87.0, -12.0,
            6.4285732933450435, -12.0,
        ]),
        'cost': ((6,), [
            115.10804727700635, 106.05160829701752, 98.83590005271603, 92.68495289423858,
            10488.831047726213, 2844.370990321473,
        ]),
        'fn_meas': ((6,), [
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
        ]),
    },
}


def jax_episodes():
    """The JAX classical episode's init and one CHUNK-tick chunk compiled
    once at LLVM -O0 with the uncertainty protocol's gain a and bias b
    traced and every sigma 0 (at a = 1, b = 0 each of its operations is
    exact, so it is the clean episode), run on every case: its telemetry,
    as ``JAX_EPISODES`` keeps it."""
    import jax
    import jax.numpy as jnp
    from ffmpc_tpu.core import make_panda_model as j_make_model
    from ffmpc_tpu.ocp.weights import OCPWeights as JWeights
    from ffmpc_tpu.run.batch_runner import (DeviceUncertainty as JUnc,
                                            EpisodeConfig as JEpisode,
                                            make_episode_fn as j_episode_fn)
    from ffmpc_tpu.sim.device_plant import make_table_params as j_table
    from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings
    from ffmpc_tpu.tasks.trajectories import ApproachCircleTraj as JTraj
    jax.config.update("jax_enable_x64", True)
    mj = j_make_model("plant", jnp.float64)

    def episode(**kw):
        return j_episode_fn(mj, JWeights(dt_ocp=0.01, w_ee_pos=1.2e3),
                            JSettings(max_iters=2, use_box=True), JTraj(**TRAJ_KW),
                            j_table(0.0, dtype=jnp.float64), JEpisode(**EP_KW),
                            np.asarray(KEYFRAMES["neutral"]), dtype=jnp.float64, **kw)

    init = episode().init
    carry = init(jnp.asarray(KEYFRAMES["neutral"]))
    f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    chunk = jax.jit(
        lambda c, t, a, b: episode(uncertainty=JUnc(a=a, b=b, seed=15)).chunk(c, t, CHUNK)
    ).lower(carry, f64(0.0), f64(1.0), f64(0.0)).compile(
        {"xla_backend_optimization_level": 0})

    def run(t0, n_chunks, a, b):
        c, parts = init(jnp.asarray(KEYFRAMES["neutral"])), []
        for i in range(n_chunks):
            c, tl = chunk(c, f64(t0 + i * CHUNK * 0.005), f64(a), f64(b))
            parts.append({k: np.asarray(v) for k, v in tl.items()})
        return {k: np.concatenate([p[k] for p in parts]) for k in ("t", "iters") + FIELDS}

    return {f"{case}/{unc}": run(*CASES[case], *((1.0, 0.0) if unc == "clean" else GAIN_BIAS))
            for case in CASES for unc in ("clean", "gain_bias")}


def t_episode(model, **kw):
    return t_episode_fn(model, TWeights(dt_ocp=0.01, w_ee_pos=1.2e3), TSettings(max_iters=2),
                        TTraj(**TRAJ_KW), t_table(0.0, dtype=torch.float64, device="cpu"),
                        TEpisode(**EP_KW), np.asarray(KEYFRAMES["neutral"]),
                        dtype=torch.float64, device="cpu", **kw)


def t_run(episode, t0, n_chunks):
    carry = episode.init(torch.as_tensor(np.asarray(KEYFRAMES["neutral"])[None]))
    parts = []
    for i in range(n_chunks):
        carry, tl = episode.chunk(carry, t0 + i * CHUNK * 0.005, CHUNK)
        parts.append({k: v[0].numpy() for k, v in tl.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def assert_close(got, want, rtol=RTOL, atol=ATOL, fields=FIELDS):
    np.testing.assert_array_equal(got["iters"], want["iters"])
    for name in fields:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max())
        scale = float(np.abs(w).max())
        assert err <= atol + rtol * scale, f"{name}: err {err:.3e}, scale {scale:.3e}"


@pytest.mark.parametrize("unc", ["clean", "gain_bias"])
@pytest.mark.parametrize("case", list(CASES))
def test_classical_episode_equals_jax(case, unc):
    """Ticks 0-2 from t = 0 ("start") and six ticks from t0 = 0.78 s over
    the knot switch ("switch"), clean and with the gain and bias on the
    command (the classical controller reads no torque estimate), against
    the JAX episode's figures (``JAX_EPISODES``)."""
    kw = {} if unc == "clean" else dict(uncertainty=TUnc(*GAIN_BIAS, seed=15))
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    got = t_run(t_episode(model, **kw), *CASES[case])
    want = stored(JAX_EPISODES)[f"{case}/{unc}"]
    assert_close(got, want)
    np.testing.assert_allclose(got["t"], want["t"], rtol=0, atol=1e-15)
    assert got["tau_cmd"].shape == (CHUNK * CASES[case][1], 7)
    assert not got["fallback"].any()
    if case == "switch":
        ts = want["t"] - 0.005
        assert (ts < 0.8 - 1e-9).any() and (ts >= 0.8 - 1e-9).any()
    if unc == "gain_bias":
        clean = stored(JAX_EPISODES)[f"{case}/clean"]
        assert not np.allclose(got["q"], clean["q"], rtol=0, atol=1e-12)


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


def test_classical_ensemble_equals_jax_run_ensemble():
    got = summarize(*run_ensemble(**ENSEMBLE_ARGS, verbose=False, device="cpu"))
    want = JAX_REFERENCE
    assert got["iters"] == want["iters"]
    for key in ("rms_tan_mean", "rms_tan_p95", "fn_final_mean", "err_tan_last", "q_last",
                "tau_cmd_last"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= ENSEMBLE_RTOL * scale, f"{key}: err {err:.3e}, scale {scale:.3e}"
    assert np.isfinite(got["rms_tan_mean"]) and got["rms_tan_mean"] > 0.0


@pytest.mark.parametrize("knot_family,consts_family", [("classical", "augmented"),
                                                        ("augmented", "classical")])
def test_solve_refuses_another_familys_constants(knot_family, consts_family):
    """``fddp.solve`` given kernel constants packed for the other knot
    family raises on every device, before any kernel could read them; the
    episode packs each knot's own."""
    model = make_panda_model("plant", dtype=torch.float64, device="cpu")
    W = flagship_weights()
    make = make_classical_knot if knot_family == "classical" else make_augmented_knot
    knot = make(model, W, surface=True)
    consts = pack_knot_consts(model, W, True, torch.float64, family=consts_family)
    assert consts.numel() == consts_len(consts_family) != consts_len(knot_family)
    N, nx = 2, knot.nx
    x0 = torch.zeros(1, nx, dtype=torch.float64)
    with pytest.raises(ValueError, match="consts"):
        t_solve(knot, None, None, x0, x0[:, None].repeat(1, N + 1, 1),
                torch.zeros(1, N, 7, dtype=torch.float64), TSettings(), consts=consts)


# ---------------------------------------------------------------------------
# the classical loop on the card (python -m pytest --noconftest -m cuda)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_classical_loop_kernels_match_plain_mode():
    """The classical flagship episode at float64, E=2, N=4, 3 iterations,
    4 ticks from t0 = 0.79 s (two ticks on each knot), on the kernels
    against plain mode: the same iterations and fallback ticks, every
    telemetry field within ``chip_smoke.CL_F64_RTOL`` or within
    ``CL_LOOP_TIE_FACTOR`` times plain mode's own parting under a
    rounding-level change of the initial states (the box QP's ties), each
    kernel launched every tick and none in plain mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the classical kernels have no CPU build")
    import chip_smoke as cs
    rec = cs.loop_kernel_vs_plain("classical", 4, 4, 0.79, "classical closed loop",
                                  tie_factor=cs.CL_LOOP_TIE_FACTOR)
    assert rec["ok"], rec


if __name__ == "__main__":
    import pprint
    import time
    import jax
    import jax.numpy as jnp
    from chip_smoke import classical_warm_starts
    from ffmpc_tpu.core import make_panda_model as j_make_model
    from ffmpc_tpu.ocp.weights import (flagship_trajectory as j_traj,
                                       flagship_weights as j_weights)
    from ffmpc_tpu.run.batch_runner import (EpisodeConfig as JEpisode,
                                            make_batched_solve_fn as j_make_solve)
    from ffmpc_tpu.solver.fddp import FDDPSettings as JSettings
    from ffmpc_tpu_torch.core import gravity_torque
    from ffmpc_tpu_torch.ocp.weights import flagship_trajectory
    from ffmpc_tpu_torch.run.batch_runner import make_batched_solve_fn

    # the regularization retries: each problem's final xreg (a retry
    # multiplies it by 10) and iterations, float32, both packages, the same
    # inputs; beside, the port's plain float64 solve of those inputs (the
    # tie's yardstick: how far float32 parts from float64 within one package)
    B, N = 64, 36
    q0 = np.asarray(KEYFRAMES["neutral"])
    model = make_panda_model("plant", dtype=torch.float32, device="cpu")
    tau_g = gravity_torque(model, torch.as_tensor(q0, dtype=torch.float32)).numpy()
    args = classical_warm_starts(B, q0, tau_g, np.random.default_rng(0))
    ep = TEpisode(controller="classical", horizon=N)
    plain = TSettings(max_iters=10, backward_mode="plain", rollout_mode="plain",
                      diff_mode="plain")

    def port_solve(dtype):
        return make_batched_solve_fn(
            make_panda_model("plant", dtype=dtype, device="cpu"), flagship_weights(), plain,
            flagship_trajectory(), ep, q0, surface=True, dtype=dtype, device="cpu")(*args)
    t0 = time.perf_counter()
    rt = port_solve(torch.float32)
    t_port = time.perf_counter() - t0
    rt64 = port_solve(torch.float64)
    t0 = time.perf_counter()
    j_args = [jnp.asarray(a) for a in args]
    rj = jax.jit(j_make_solve(
        j_make_model("plant", jnp.float32), j_weights(), JSettings(max_iters=10), j_traj(),
        JEpisode(controller="classical", horizon=N, deriv_mode="analytic"), q0,
        surface=True, dtype=jnp.float32, calc_mode="vector", solve_impl="vmap"))(*j_args)
    t_jax = time.perf_counter() - t0
    xreg = {"port": rt.xreg.double().numpy(), "jax": np.asarray(rj.xreg, np.float64),
            "port_float64": rt64.xreg.numpy()}
    iters = {"port": rt.iters.numpy(), "jax": np.asarray(rj.iters),
             "port_float64": rt64.iters.numpy()}
    decades = {k: np.round(np.log10(x)).astype(int) for k, x in xreg.items()}
    pairs = (("port", "jax"), ("port", "port_float64"), ("jax", "port_float64"))
    print("retries (B=64, N=36, float32 unless marked, contact knot, 10 iterations):")
    pprint.pprint({
        "same_iters_share": {f"{a}_vs_{b}": float((iters[a] == iters[b]).mean())
                             for a, b in pairs},
        "same_xreg_decade_share": {f"{a}_vs_{b}": float((decades[a] == decades[b]).mean())
                                   for a, b in pairs},
        "mean_iters": {k: float(v.mean()) for k, v in iters.items()},
        "mean_log10_xreg": {k: float(np.log10(x).mean()) for k, x in xreg.items()},
        "xreg_decades_from_1e-12": {k: np.bincount(d + 12).tolist()
                                    for k, d in decades.items()},
        "seconds": {"port_plain_float32": t_port, "jax_compile_and_run": t_jax}},
        width=100, sort_dicts=False)

    jax.config.update("jax_enable_x64", True)
    print_figures("JAX_EPISODES", jax_episodes())
    from ffmpc_tpu.run.ensemble import run_ensemble as j_run_ensemble
    pprint.pprint(summarize(*j_run_ensemble(**ENSEMBLE_ARGS, verbose=False)), width=100,
                  sort_dicts=False)
