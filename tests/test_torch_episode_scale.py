"""The closed loop with a per-joint torque scale (the
``actuation_uncertainty`` scenario's gain mismatch without the noise
protocol): the port's episode == the JAX package's ``make_episode_fn``,
CPU, float64, same setup and tolerance as ``tests/test_torch_episode.py``.
One JAX compile with the scale traced serves the scaled and the unscaled
(all ones) episode.  It cannot share the gain / bias program of
``tests/test_torch_episode.py``: given an uncertainty protocol, the JAX
episode applies the protocol's gain to the command in place of the torque
scale, so the scale needs a program without one.
"""

import numpy as np
import pytest

from test_torch_episode import (assert_close, j_chunk_fn, j_run, setup,  # noqa: F401
                                t_episode, t_run)

SCALE = np.array([0.90, 1.08, 0.92, 1.05, 0.88, 1.10, 0.86])


@pytest.fixture(scope="module")
def jax_scaled(setup):
    init, chunk = j_chunk_fn(setup, lambda s: dict(torque_scale=s), (np.ones(7),))
    q0 = setup["q0"]
    return {"ones": j_run(init, chunk, q0, 0.0, 1, np.ones(7)),
            "scaled": j_run(init, chunk, q0, 0.78, 2, SCALE)}


@pytest.mark.parametrize("case,scale,t0,n_chunks",
                         [("ones", None, 0.0, 1), ("scaled", SCALE, 0.78, 2)])
def test_torque_scaled_episode_equals_jax(setup, jax_scaled, case, scale, t0, n_chunks):
    got = t_run(t_episode(setup, torque_scale=scale), setup["q0"], t0, n_chunks)
    assert_close(got, jax_scaled[case])
    if scale is not None:
        clean = t_run(t_episode(setup), setup["q0"], t0, n_chunks)
        assert not np.allclose(got["q"], clean["q"], rtol=0, atol=1e-12)
