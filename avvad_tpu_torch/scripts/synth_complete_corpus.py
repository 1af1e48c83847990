"""Synthesize a complete-mode NTCD-TIMIT-shaped RAW corpus tree (port of
scripts/synth_complete_corpus.py).

A dress rehearsal for the real corpus: the complete-mode catalog grid (6
noises x 3 SNRs, raw `u/drspeech/...` noisy layout — the reference's
packages/dataset/ntcd_timit.py:193-384) and the builders/loader at a
realistic tree size. This writes thousands of files in the exact raw
layout the reference corpus uses:

  ntcd_timit/matlab_raw/{train,dev,test}/<spk>/<utt>.mat      DCT lip video
  ntcd_timit/Clean/volunteers/<spk>/straightcam/<utt>.wav     clean speech
  ntcd_timit/u/drspeech/data/TCDTIMIT/Noisy_TCDTIMIT/
      <noise>/<snr>/volunteers/<spk>/straightcam/<utt>.wav    raw noisy grid

Audio is speech-like (voiced harmonic bursts with silence gaps, so VAD
labels are non-trivial); video is smooth low-frequency DCT fields at
30 fps (single HDF5 dataset per .mat, as in the corpus, written by the
port's own ``hdf5``); noise uses the same synthesized families as the
augmented-grid study (data/augment). The same seed writes the JAX
script's wav bytes and ``.mat`` arrays.

After this, the rehearse_complete twin drives
create_train_files -> train -> evaluate -> run_metrics end to end at
--dataset-size complete.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

FS = 16000
VIDEO_FPS = 30.0


def synth_speech(rng: np.random.Generator, dur_s: float) -> np.ndarray:
    """Speech-like signal: 2-4 voiced harmonic bursts separated by near
    silence, so the energy VAD produces real speech/pause structure."""
    n = int(dur_s * FS)
    x = rng.normal(size=n).astype(np.float32) * 1e-4  # silence floor
    t = np.arange(n) / FS
    n_bursts = int(rng.integers(2, 5))
    edges = np.sort(rng.uniform(0.05, 0.95, size=2 * n_bursts)) * dur_s
    for b in range(n_bursts):
        s, e = edges[2 * b], edges[2 * b + 1]
        if e - s < 0.08:
            e = min(dur_s - 0.01, s + 0.12)
        i0, i1 = int(s * FS), int(e * FS)
        seg_t = t[i0:i1]
        f0 = rng.uniform(80, 220) * (1 + 0.03 * np.sin(
            2 * np.pi * rng.uniform(2, 5) * seg_t))
        burst = np.zeros(i1 - i0)
        for h in range(1, 12):
            if h * 150 > 4000:
                break
            burst += np.sin(2 * np.pi * h * np.cumsum(f0) / FS
                            + rng.uniform(0, 2 * np.pi)) / h
        env = np.hanning(len(burst)) ** 0.5
        x[i0:i1] += (burst * env * rng.uniform(0.2, 0.5)).astype(np.float32)
    return np.clip(x, -1.0, 1.0)


def synth_dct_video(rng: np.random.Generator, n_frames: int) -> np.ndarray:
    """(frames, 4489) float32 DCT coefficients: temporally-smooth random
    low-frequency fields (energy ~exp(-(i+j)/6), like real lip crops)."""
    i, j = np.meshgrid(np.arange(67), np.arange(67), indexing="ij")
    envelope = np.exp(-(i + j) / 6.0).ravel().astype(np.float32)
    base = rng.normal(size=4489).astype(np.float32)
    frames = np.empty((n_frames, 4489), np.float32)
    for f in range(n_frames):
        base = 0.9 * base + 0.45 * rng.normal(size=4489).astype(np.float32)
        frames[f] = base * envelope * 120.0
    frames[:, 0] += 4000.0  # positive DC so decoded frames aren't centered
    return frames


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="raw tree root (will "
                    "contain ntcd_timit/...)")
    ap.add_argument("--train-speakers", type=int, default=14)
    ap.add_argument("--dev-speakers", type=int, default=3)
    ap.add_argument("--test-speakers", type=int, default=3)
    ap.add_argument("--utts", type=int, default=10)
    ap.add_argument("--min-dur", type=float, default=0.8)
    ap.add_argument("--max-dur", type=float, default=1.6)
    ap.add_argument("--seed", type=int, default=7)
    return ap


def main(argv=None) -> dict:
    """-> {"wavs", "mats" (files written), "seconds"}."""
    args = build_parser().parse_args(argv)
    from .. import hdf5
    from ..data.augment import mix_at_snr, synth_noise
    from ..datasets.ntcd_timit import NTCD_NOISE_TYPES, NTCD_SNRS
    from ..processing import write_wav

    rng = np.random.default_rng(args.seed)
    root = os.path.join(args.out, "ntcd_timit")
    splits = (("train", args.train_speakers), ("dev", args.dev_speakers),
              ("test", args.test_speakers))
    utt_names = [f"s{u:02d}" for u in range(args.utts)]

    t0 = time.perf_counter()
    n_wavs = n_mats = 0
    spk_counter = 0
    speech_pool = []  # babble needs a pool of speech signals
    for split, n_spk in splits:
        for _ in range(n_spk):
            spk_counter += 1
            spk = f"{spk_counter:02d}{'M' if spk_counter % 2 else 'F'}"
            mat_dir = os.path.join(root, "matlab_raw", split, spk)
            clean_dir = os.path.join(root, "Clean/volunteers", spk, "straightcam")
            os.makedirs(mat_dir, exist_ok=True)
            os.makedirs(clean_dir, exist_ok=True)
            for utt in utt_names:
                dur = float(rng.uniform(args.min_dur, args.max_dur))
                x = synth_speech(rng, dur)
                speech_pool.append(x)
                write_wav(os.path.join(clean_dir, f"{utt}.wav"), x, FS)
                n_wavs += 1
                vid = synth_dct_video(rng, max(4, round(dur * VIDEO_FPS)))
                with hdf5.File(os.path.join(mat_dir, f"{utt}.mat"), "w") as f:
                    f.create_dataset("data", data=vid)
                n_mats += 1
                # raw noisy grid (the u/drspeech layout)
                for kind in NTCD_NOISE_TYPES:
                    for snr in NTCD_SNRS:
                        noise = synth_noise(kind, len(x), rng, speech_pool=speech_pool)
                        noisy = mix_at_snr(x, noise, float(snr))
                        nd = os.path.join(
                            root, "u/drspeech/data/TCDTIMIT/Noisy_TCDTIMIT",
                            kind, snr, "volunteers", spk, "straightcam")
                        os.makedirs(nd, exist_ok=True)
                        write_wav(os.path.join(nd, f"{utt}.wav"), noisy, FS)
                        n_wavs += 1
        print(f"[{split}] done ({time.perf_counter() - t0:.1f}s)", flush=True)
    dt = time.perf_counter() - t0
    print(f"synthesized {n_wavs} wavs + {n_mats} mats in {dt:.1f}s "
          f"({n_wavs / dt:.0f} files/s)")
    return {"wavs": n_wavs, "mats": n_mats, "seconds": dt}


if __name__ == "__main__":
    main()
