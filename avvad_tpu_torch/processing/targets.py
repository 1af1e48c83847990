"""VAD / IBM label generators (host-side numpy).

Numerically matches the reference's packages/processing/target.py:
- frame-level VAD from time-domain frame energy vs 10^vad_threshold * min
  power (target.py:51-55),
- Ideal Binary Mask from log-magnitude within ibm_threshold dB of the max
  (target.py:65-70),
- noise-robust IBM = IBM * VAD (target.py:103),
- voiced/unvoiced split-characteristic threshold IBMs (target.py:110-250).
"""

from __future__ import annotations

import numpy as np

from .stft import frame, pad_for_stft


def clean_speech_VAD(
    speech_t: np.ndarray,
    fs: float = 16000,
    wlen_sec: float = 64e-3,
    hop_percent: float = 0.25,
    center: bool = False,
    pad_mode: str = "reflect",
    pad_at_end: bool = True,
    vad_threshold: float = 1.70,
) -> np.ndarray:
    """Energy-threshold VAD over STFT-aligned frames. Returns (1, n_frames) float32."""
    nfft = int(wlen_sec * fs)
    hopsamp = int(hop_percent * nfft)
    y = pad_for_stft(
        np.asarray(speech_t),
        fs=fs,
        wlen_sec=wlen_sec,
        hop_percent=hop_percent,
        center=center,
        pad_mode=pad_mode,
        pad_at_end=pad_at_end,
    )
    y_frames = frame(y, nfft, hopsamp)
    power = np.power(y_frames, 2).sum(axis=0)
    vad = power > np.power(10, vad_threshold) * np.min(power)
    return np.float32(vad)[None]


def clean_speech_IBM(
    speech_tf: np.ndarray,
    eps: float = 1e-8,
    ibm_threshold: float = 50,
) -> np.ndarray:
    """Ideal binary mask: bins within `ibm_threshold` dB of the global max."""
    mag = abs(speech_tf)
    power_db = 20 * np.log10(mag + eps)
    mask = power_db > np.max(power_db) - ibm_threshold
    return np.float32(mask)


def noise_robust_clean_speech_IBM(
    speech_t: np.ndarray,
    speech_tf: np.ndarray,
    fs: float = 16000,
    wlen_sec: float = 64e-3,
    hop_percent: float = 0.25,
    center: bool = False,
    pad_mode: str = "reflect",
    pad_at_end: bool = True,
    vad_threshold: float = 1.70,
    eps: float = 1e-8,
    ibm_threshold: float = 50,
) -> np.ndarray:
    """IBM gated by the energy VAD — robust to noise before/after speech."""
    vad = clean_speech_VAD(
        speech_t,
        fs=fs,
        wlen_sec=wlen_sec,
        hop_percent=hop_percent,
        center=center,
        pad_mode=pad_mode,
        pad_at_end=pad_at_end,
        vad_threshold=vad_threshold,
    )
    ibm = clean_speech_IBM(speech_tf, eps=eps, ibm_threshold=ibm_threshold)
    return ibm * vad


# --- voiced/unvoiced split-characteristic IBMs -------------------------
#
# Pinned numerical port (the one part of this module where "re-designed"
# does not apply): the mask GEOMETRY below — ramp placements including
# their off-by-one slice starts — reproduces the reference's
# (the reference's packages/processing/target.py:110-250, itself derived
# from pb_bss) bin for bin, because the output contract is exact label
# parity with fixture data built by that code. Everything is renamed and
# restructured to this repo's conventions; the arithmetic order inside
# each expression is kept so results stay bit-identical.

_SPLIT_BIN = 200  # voiced/unvoiced crossover (center of the wide ramp)
_SPLIT_RAMP_BINS = 99  # half-cosine ramp width at the crossover
_EDGE_RAMP_BINS = 5  # sharp ramp width at the outer band edges
_VOICED_LOW_BIN = 4  # below this the voiced characteristic is cut
_UNVOICED_HIGH_BIN = 500  # above this the unvoiced characteristic is cut
_PSD_FLOOR = 0.005  # bins quieter than this are never speech
_FIXED_NOISE_PSD = 10.0  # threshold_IBM's stand-in noise estimate


def _half_cosine_ramp(n_bins: int) -> np.ndarray:
    """Raised-cosine ramp 1 -> 0 over n_bins points (endpoints included)."""
    return 0.5 * (1 + np.cos(np.pi / (n_bins - 1) * np.arange(n_bins)))


def _voiced_unvoiced_split_characteristic(number_of_frequency_bins: int):
    """Complementary per-bin weights (voiced, unvoiced), each in [0, 1].

    Voiced: 0 below bin 3, edge-ramps up over bins 3..7, flat 1 through
    the low spectrum, ramps down across the split band (centered on
    _SPLIT_BIN), 0 above. Unvoiced: 0 through the voiced band, ramps up
    across the split band, flat 1 through the high spectrum, edge-ramps
    down at _UNVOICED_HIGH_BIN. Ramp slices start one bin below their
    nominal edge — a quirk of the ported geometry (see module note).
    """
    split_ramp = _half_cosine_ramp(_SPLIT_RAMP_BINS)
    edge_ramp = _half_cosine_ramp(_EDGE_RAMP_BINS)
    # first bin of the split ramp: the ramp is centered on _SPLIT_BIN
    ramp_lo = _SPLIT_BIN - (_SPLIT_RAMP_BINS + 1) // 2
    ramp_hi = ramp_lo + _SPLIT_RAMP_BINS  # one past the ramp's last bin

    voiced = np.ones(number_of_frequency_bins)
    voiced[ramp_lo - 1:ramp_hi - 1] = split_ramp
    voiced[ramp_hi - 1:] = 0
    voiced[:_VOICED_LOW_BIN] = 0
    voiced[_VOICED_LOW_BIN - 1:
           _VOICED_LOW_BIN - 1 + _EDGE_RAMP_BINS] = 1 - edge_ramp

    unvoiced = np.ones(number_of_frequency_bins)
    unvoiced[ramp_lo - 1:ramp_hi - 1] = 1 - split_ramp
    unvoiced[:ramp_lo] = 0
    unvoiced[_UNVOICED_HIGH_BIN - 1:] = 0
    unvoiced[_UNVOICED_HIGH_BIN - 1:
             _UNVOICED_HIGH_BIN - 1 + _EDGE_RAMP_BINS] = edge_ramp

    return voiced, unvoiced


def _regime_db(db_on_voiced: float, db_on_unvoiced: float,
               voiced: np.ndarray, unvoiced: np.ndarray) -> np.ndarray:
    """Per-bin dB offsets blended across the voiced/unvoiced regimes."""
    return db_on_voiced * voiced + db_on_unvoiced * unvoiced


def _attenuated_psd(spec: np.ndarray, per_bin_db: np.ndarray) -> np.ndarray:
    """|spec|^2 attenuated by per-bin dB (the regime-weighted threshold)."""
    return (spec * spec.conjugate()) / np.power(10, per_bin_db / 10)


def _force_band_edges(mask: np.ndarray, low_cut: int, high_cut: int,
                      value: bool) -> np.ndarray:
    """Pin the out-of-band bins ([0, low_cut-1) and [high_cut, F)) to
    `value` in place (speech masks force 0, noise masks force 1)."""
    mask[..., :low_cut - 1] = value
    mask[..., high_cut:] = value
    return mask


def noise_aware_IBM(
    X: np.ndarray,
    N: np.ndarray,
    threshold_unvoiced_speech: float = 5,
    threshold_voiced_speech: float = 0,
    threshold_unvoiced_noise: float = -10,
    threshold_voiced_noise: float = -10,
    low_cut: int = 5,
    high_cut: int = 500,
):
    """Speech/noise masks from per-bin PSD thresholds. X, N: (frames, bins).

    A bin is speech when the regime-attenuated speech PSD still beats the
    noise PSD (and the absolute floor); a bin is noise when the
    regime-BOOSTED speech PSD falls below the noise PSD (or the floor) —
    the two regime blends differ, so the masks are not complements.
    (The noise blend pairs the `unvoiced` dB with the voiced weight and
    vice versa, exactly as the ported geometry does; the stock thresholds
    are symmetric so it is invisible at the defaults.)
    """
    voiced, unvoiced = _voiced_unvoiced_split_characteristic(X.shape[-1])
    speech_psd = _attenuated_psd(
        X, _regime_db(threshold_voiced_speech, threshold_unvoiced_speech,
                      voiced, unvoiced))
    boosted_psd = _attenuated_psd(
        X, _regime_db(threshold_unvoiced_noise, threshold_voiced_noise,
                      voiced, unvoiced))
    noise_psd = N * N.conjugate()

    speech_mask = np.logical_and(speech_psd > noise_psd,
                                 speech_psd > _PSD_FLOOR)
    noise_mask = np.logical_or(boosted_psd < noise_psd,
                               boosted_psd < _PSD_FLOOR)
    return (_force_band_edges(speech_mask, low_cut, high_cut, False),
            _force_band_edges(noise_mask, low_cut, high_cut, True))


def threshold_IBM(
    X: np.ndarray,
    threshold_unvoiced_speech: float = 5,
    threshold_voiced_speech: float = 0,
    threshold_unvoiced_noise: float = -10,
    threshold_voiced_noise: float = -10,
    low_cut: int = 5,
    high_cut: int = 500,
) -> np.ndarray:
    """Speech mask against a fixed PSD floor (no noise estimate).

    The noise-threshold kwargs are accepted but unused — kept so the
    signature mirrors noise_aware_IBM (and the reference's, which carries
    the same vestigial parameters at target.py:202-210).
    """
    del threshold_unvoiced_noise, threshold_voiced_noise
    voiced, unvoiced = _voiced_unvoiced_split_characteristic(X.shape[-1])
    speech_psd = _attenuated_psd(
        X, _regime_db(threshold_voiced_speech, threshold_unvoiced_speech,
                      voiced, unvoiced))
    speech_mask = np.logical_and(speech_psd > _FIXED_NOISE_PSD,
                                 speech_psd > _PSD_FLOOR)
    return _force_band_edges(speech_mask, low_cut, high_cut, False)
