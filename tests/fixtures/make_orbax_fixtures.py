"""Write the Orbax fixture that the port's ``orbax_io`` reader is held to on
every machine, the card's too (which has no Orbax, TensorStore or zstd
module): a real checkpoint, written here by the JAX package's
``save_checkpoint``, and what JAX computes with it.

- ``orbax_audio_h32/epoch_001_vloss_0.50/``: an ``AudioVAD`` train state
  (2 x LSTM 32) after one Adam step (lr 1e-2) on a seeded batch, with
  dataset statistics (``norm_stats``): Orbax's own layout, zarr chunks and
  OCDBT nodes compressed with zstd, the root manifest over
  ``ocdbt.process_0``.
- ``orbax_fixtures.json``: the model's shape, the SHA-256 of every array
  as Orbax restores it, and the probabilities of JAX's waveform serving
  step with those weights (``use_pallas_lstm=True``, the Pallas LSTM in
  interpret mode: W_hh in bfloat16, the arithmetic of the port's LSTM
  kernels) on ``waveforms(SEED)``, with the SHA-256 of those waveforms.

Run from the repository root (needs the JAX package and Orbax):
  python tests/fixtures/make_orbax_fixtures.py
"""

import hashlib
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

MODEL_DIR, META = "orbax_audio_h32", "orbax_fixtures.json"
H, LAYERS, SEED = 32, 2, 0
B, SAMPLES, T_FRAMES = 2, 16000, 60
EPOCH, VLOSS = 1, 0.5


def waveforms(seed: int) -> np.ndarray:
    """(B, SAMPLES) float32: a tone and noise bursts, so that the serving
    step's probabilities spread."""
    rng = np.random.default_rng(seed)
    t = np.arange(SAMPLES) / 16000.0
    env = (np.sin(2 * np.pi * 3.0 * t[None] + rng.uniform(0, 6, (B, 1))) > 0)
    wave = 0.3 * np.sin(2 * np.pi * 220.0 * t)[None] * env + 0.05 * rng.normal(size=(B, SAMPLES))
    return wave.astype(np.float32)


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from avvad_tpu.data.batching import Batch
    from avvad_tpu.export import make_waveform_serving_fn
    from avvad_tpu.models import AudioVAD
    from avvad_tpu.train import create_train_state, make_train_step, save_checkpoint
    from avvad_tpu.train.state import make_optimizer

    rng = np.random.default_rng(SEED)
    model = AudioVAD(lstm_hidden_size=H, lstm_layers=LAYERS, use_pallas_lstm=True)
    state = create_train_state(model, jax.random.PRNGKey(SEED), (jnp.zeros((1, 4, 513)),),
                               make_optimizer(1e-2))
    norm = {"audio_mean": rng.normal(size=(513, 1)).astype(np.float32) - 4.0,
            "audio_std": (rng.random((513, 1)) + 1.5).astype(np.float32)}
    batch = Batch(audio=jnp.asarray(rng.normal(size=(2, 8, 513)).astype(np.float32)),
                  video=None, label=jnp.asarray((rng.random((2, 8, 1)) > 0.5), jnp.float32),
                  lengths=jnp.asarray([8, 6]), mask=jnp.asarray(
                      (np.arange(8)[None] < np.array([[8], [6]])).astype(np.float32)))
    state, _ = make_train_step("audio", donate=False)(state, batch, norm)

    root = os.path.join(HERE, MODEL_DIR)
    shutil.rmtree(root, ignore_errors=True)
    path = save_checkpoint(root, state, norm, epoch=EPOCH, valid_loss=VLOSS)
    restored = ocp.StandardCheckpointer().restore(path)
    arrays = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): sha(v)
              for p, v in jax.tree_util.tree_flatten_with_path(restored)[0]}

    wave = waveforms(SEED)
    fn = make_waveform_serving_fn(model, state.variables(), t_frames=T_FRAMES,
                                  norm_stats=norm)
    probs = np.asarray(fn(jnp.asarray(wave)))
    meta = {"model_dir": MODEL_DIR, "checkpoint": os.path.basename(path),
            "lstm_hidden": H, "lstm_layers": LAYERS, "seed": SEED, "batch": B,
            "samples": SAMPLES, "t_frames": T_FRAMES, "step": int(state.step),
            "wave_sha256": sha(wave), "arrays_sha256": arrays,
            "probs": probs.reshape(B, -1).tolist()}
    with open(os.path.join(HERE, META), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(root) for n in ns)
    print(path, size, "bytes,", len(arrays), "arrays, probs", probs.shape,
          float(probs.min()), float(probs.max()))


if __name__ == "__main__":
    main()
