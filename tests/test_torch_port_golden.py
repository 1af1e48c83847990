"""The committed reference golden fixtures through the port's converter.

Each fixture (tests/fixtures/torch_golden_*.npz) holds inputs, the
reference torch model's logits and a manifest from which the float weights
are re-synthesised (tests/golden_fixture_lib.py). The weights go reference
state dict -> JAX variables (the JAX package's importers) ->
``convert.from_flax_variables`` -> the port's model, whose logits are held
to the recorded reference logits on each sequence's valid frames at the JAX
package's own golden tolerances (tests/test_torch_golden_fixture.py). The
AV-MCB fixture is held in tests/test_torch_port_models.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from golden_fixture_lib import load_fixture

from avvad_tpu.models import AVVAD as JAVVAD
from avvad_tpu.models import AudioVAD as JAudioVAD
from avvad_tpu.models import VideoVAD as JVideoVAD
from avvad_tpu.utils import (import_reference_audio_vad, import_reference_avvad,
                             import_reference_video_vad)
from avvad_tpu_torch.convert import from_flax_variables
from avvad_tpu_torch.models import AVVAD, AudioVAD, VideoVAD

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
H = 128


def _fixture(name):
    return load_fixture(os.path.join(FIXDIR, f"torch_golden_{name}.npz"))


def _port(model, variables):
    model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)),
                          strict=True)
    return model.eval()


def _valid_frames_close(ours, ref, lengths, atol):
    assert ours.shape == ref.shape
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], atol=atol,
                                   err_msg=f"sequence {b} (length {n})")


def test_audio_golden_fixture():
    """AudioVAD (2 x LSTM 128): held at 1e-5, the JAX golden test's bar
    (reading 3.6e-7)."""
    state, arr = _fixture("audio")
    jm = JAudioVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2)
    variables = import_reference_audio_vad(
        state, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 513))))
    port = _port(AudioVAD(lstm_hidden_size=H, lstm_layers=2), variables)
    with torch.no_grad():
        ours = port(torch.from_numpy(arr["audio"])).numpy()
    _valid_frames_close(ours, arr["logits"], arr["lengths"], atol=1e-5)


def test_video_golden_fixture():
    """VideoVAD (ResNet-18 with the reference's trained-like BatchNorm
    statistics, 2 x LSTM 128): every frame's logits and, with
    ``return_last``, each sequence's last valid step, at 5e-4, the JAX
    golden test's bar (reading 5.5e-7)."""
    state, arr = _fixture("video")
    jm = JVideoVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2)
    variables = import_reference_video_vad(
        state, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 67, 67))))
    port = _port(VideoVAD(lstm_hidden_size=H, lstm_layers=2), variables)
    video = torch.from_numpy(arr["video"])
    with torch.no_grad():
        ours = port(video).numpy()
        last = port(video, lengths=torch.from_numpy(np.asarray(arr["lengths"])),
                    return_last=True).numpy()
    _valid_frames_close(ours, arr["logits"], arr["lengths"], atol=5e-4)
    np.testing.assert_allclose(last, arr["logits_last"], atol=5e-4)


def test_av_concat_golden_fixture():
    """AVVAD with concatenation fusion (2 x LSTM 128): at 1e-3, the JAX
    golden test's bar (reading 2.9e-7)."""
    state, arr = _fixture("av_concat")
    jm = JAVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=bool(arr["use_mcb"]))
    variables = import_reference_avvad(
        state, jm, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 513)),
                           jnp.zeros((1, 2, 67, 67))))
    port = _port(AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=bool(arr["use_mcb"])),
                 variables)
    with torch.no_grad():
        ours = port(torch.from_numpy(arr["audio"]), torch.from_numpy(arr["video"])).numpy()
    _valid_frames_close(ours, arr["logits"], arr["lengths"], atol=1e-3)
