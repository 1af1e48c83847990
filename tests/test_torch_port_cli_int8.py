"""``evaluate`` with the calibrated static-int8 tower through both command
lines (XLA's int8 trunk on the JAX side, the plain int8 trunk on the
port's CPU route), on tests/test_torch_port_cli_eval.py's tree and
imported AV checkpoint.
"""

import numpy as np
import pytest

from test_torch_port_cli_eval import evaluate_both, make_env, soft_predictions


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory, ("av",))


def test_evaluate_static_int8_tower_matches_jax(env):
    """The calibrated static-int8 tower (XLA's int8 trunk on the JAX side,
    the plain int8 trunk here): the soft predictions at JAX's int8 bar, rel
    < 0.02 and corr > 0.999 (tests/test_torch_port_evaluate.py)."""
    jout, tout, _ = evaluate_both(env, "int8", ["--tower-int8", "--tower-quant-mode", "static",
                                            "--calibrate-utts", "4"])
    files, want = soft_predictions(jout)
    assert files == soft_predictions(tout)[0]
    got = np.concatenate(soft_predictions(tout)[1]).astype(np.float64)
    ref = np.concatenate(want).astype(np.float64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    corr = np.corrcoef(got, ref)[0, 1]
    assert rel < 0.02 and corr > 0.999, (rel, corr)
