"""Per-modality serving timers of the port (counterpart of
scripts/bench_modalities.py, BASELINE.json configurations 0-1).

bench.py's twin times the AV headline; this times the other named
configurations with the same chained, fetch-barrier timing:

- ``audio``: AudioVAD, the log-power frontend -> 2 x LSTM 1024 (the
  inference kernel) -> Dense, bf16;
- ``wavenet``: RawAudioVAD, the WaveNet encoder on the raw waveform, bf16;
- ``video``: VideoVAD, the ResNet-18 tower on the unique 30 fps frames, its
  features gathered onto the 62.5 fps timeline, the calibrated static-int8
  tower (scales from 2 utterances) on the fused kernels (the stem epilogue
  kernel once, the int8 BasicBlock kernel 8 times a pass), bf16;
- ``video-pallas``: the same route (the JAX script's name for its fused
  Pallas tower).

Prints one json line a configuration with the JAX script's keys
(``metric``, ``value``, ``unit``, ``ms_per_step``, ``vs_baseline``).

    python -m avvad_tpu_torch.scripts.bench_modalities [--configs audio wavenet video]
        [--batch 64] [--frames 512] [--iters 20] [--rounds 3] [--device cpu]

Runs on the CUDA card unless ``--device cpu``, where the plain versions of
the kernels run and the numbers measure nothing.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from ._common import add_device_flag, device_of
from .bench import FRAME_RATE, serving_inputs, time_serve

CONFIGS = ("audio", "wavenet", "video", "video-pallas")
UNIT = "x_realtime_per_chip"


def bench(serve, inputs: tuple, audio_seconds: float, n_iters: int = 20,
          rounds: int = 3) -> tuple:
    """The JAX script's ``bench`` (bench_modalities.py:36-57), bench.py's
    chained timing -> (x real time, best seconds a step)."""
    best = min(time_serve(serve, inputs, n_iters, rounds))
    return audio_seconds / best, best


def _load(model, state_dict: Optional[dict]):
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def audio_spec_config(b: int, t: int, device: torch.device,
                      state_dict: Optional[dict] = None, lstm_hidden: int = 1024,
                      wave: Optional[np.ndarray] = None) -> tuple:
    """AudioVAD bf16 serving (bench_modalities.py:60-78) -> (serve, inputs,
    audio seconds): the log-power frontend (center=False, pad_at_end=True,
    the first ``t`` frames) -> the model -> sigmoid."""
    from ..export import make_waveform_serving_fn
    from ..models import AudioVAD

    model = _load(AudioVAD(y_dim=1, lstm_hidden_size=lstm_hidden, lstm_layers=2,
                           use_kernel_lstm=True, dtype=torch.bfloat16), state_dict)
    if wave is None:
        wave = serving_inputs(b, t)[0]
    fn = make_waveform_serving_fn(model, t_frames=t, device=device)
    return fn, (torch.as_tensor(wave, device=device),), b * t / FRAME_RATE


def audio_wavenet_config(b: int, t: int, device: torch.device,
                         state_dict: Optional[dict] = None, lstm_hidden: int = 1024,
                         wave: Optional[np.ndarray] = None) -> tuple:
    """RawAudioVAD bf16 serving (bench_modalities.py:81-94): the raw wave of
    ``bench.n_samples(t)`` samples -> WaveNet encoder pooled to ``t`` frames ->
    LSTM (its plain loop, as the JAX module's scan) -> sigmoid."""
    from ..export import make_waveform_serving_fn
    from ..models import RawAudioVAD

    model = _load(RawAudioVAD(y_dim=1, lstm_hidden_size=lstm_hidden, lstm_layers=2,
                              out_frames=t, dtype=torch.bfloat16), state_dict)
    if wave is None:
        wave = serving_inputs(b, t)[0]
    fn = make_waveform_serving_fn(model, device=device)
    return fn, (torch.as_tensor(wave, device=device),), b * t / FRAME_RATE


def video_config(b: int, t: int, device: torch.device, int8: bool = True,
                 state_dict: Optional[dict] = None, lstm_hidden: int = 1024,
                 video: Optional[np.ndarray] = None) -> tuple:
    """VideoVAD bf16 serving (bench_modalities.py:97-126): the static-int8
    tower on the fused kernels, its scales calibrated on the first 2
    utterances; the tower on the unique 30 fps frames, gathered onto the
    62.5 fps timeline -> (serve, inputs, audio seconds)."""
    from ..export import make_waveform_serving_fn
    from ..models import VideoVAD, calibrate

    _, video_draw, idx = serving_inputs(b, t)
    video = video_draw if video is None else video
    model = _load(VideoVAD(y_dim=1, lstm_hidden_size=lstm_hidden, lstm_layers=2,
                           use_kernel_lstm=True, dtype=torch.bfloat16, tower_int8=int8,
                           tower_quant_mode="static" if int8 else "dynamic",
                           tower_pallas=int8), state_dict).to(device).eval()
    video = torch.as_tensor(np.asarray(video, np.float32), device=device)
    if int8:
        calibrate(model, [video[:2]], video_frame_indices=torch.as_tensor(idx, device=device))
    fn = make_waveform_serving_fn(model, video_frame_indices=idx, device=device)
    return fn, (video,), b * t / FRAME_RATE


def builders(b: int, t: int, device: torch.device) -> dict:
    return {"audio": lambda: audio_spec_config(b, t, device),
            "wavenet": lambda: audio_wavenet_config(b, t, device),
            "video": lambda: video_config(b, t, device),
            "video-pallas": lambda: video_config(b, t, device)}


def record(name: str, rt: float, step: float) -> dict:
    """The JAX script's record (bench_modalities.py:145-150)."""
    return {"metric": f"{name}_vad_inference_rt_factor", "value": round(rt, 2),
            "unit": UNIT, "ms_per_step": round(step * 1e3, 2),
            "vs_baseline": round(rt / 50.0, 3)}


def main(argv=None, on_config=None) -> list:
    """-> the records, each printed as a json line. ``on_config(name, serve,
    inputs)``, if given, is called after each configuration is timed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=["audio", "wavenet", "video"],
                    choices=list(CONFIGS))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20, help="steps a round")
    ap.add_argument("--rounds", type=int, default=3, help="rounds (the best is reported)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    make = builders(args.batch, args.frames, device)
    records = []
    for name in args.configs:
        serve, inputs, audio_sec = make[name]()
        rt, step = bench(serve, inputs, audio_sec, args.iters, args.rounds)
        records.append(record(name, rt, step))
        print(json.dumps(records[-1]), flush=True)
        if on_config is not None:
            on_config(name, serve, inputs)
        del serve, inputs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
