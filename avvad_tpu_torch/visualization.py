"""Figure rendering: waveplots, spectrograms, masks, composites (port of
avvad_tpu/visualization.py).

librosa-free re-implementation of the reference's visualization layer
(the reference's packages/visualization.py:8-331): amplitude-dB conversion
with librosa semantics, a specshow-equivalent imshow with time/kHz axes,
the repeat-a-(1,T)-VAD-row-to-513-bins trick (:73-75), and the composite
wav+spectrogram+mask and N-signal grid figures used by the metrics and
oracle-QA scripts, on the non-interactive Agg backend.

``matplotlib`` is imported by ``pyplot``, which every drawing function
calls first: importing this module needs numpy only, and where
``matplotlib`` is missing a drawing function raises an ``ImportError``
that names it and the function that needed it.
"""

from __future__ import annotations

import numpy as np

DEFAULT_FONTSIZE = 14  # the reference's 50pt is tuned for 25-inch figures


def pyplot(caller: str):
    """-> (matplotlib.pyplot, matplotlib.gridspec) on the Agg backend; an
    ``ImportError`` naming ``caller`` where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{caller} needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.gridspec as grd
    import matplotlib.pyplot as plt

    return plt, grd


def amplitude_to_db(s: np.ndarray, ref: str | float = "max", amin: float = 1e-5,
                    top_db: float = 80.0) -> np.ndarray:
    """20*log10(|S|) with max-referencing and top_db flooring (librosa
    amplitude_to_db semantics, used via convert_to_db in the reference)."""
    mag = np.abs(s)
    ref_value = mag.max() if ref == "max" else float(ref)
    db = 20.0 * np.log10(np.maximum(amin, mag))
    db -= 20.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db


def _expand_vad_rows(spec: np.ndarray, freq_bins: int = 513) -> np.ndarray:
    """(1, T) VAD row -> (freq_bins, T) so masks render like spectrograms."""
    if spec.shape[0] == 1:
        return np.repeat(spec, freq_bins, axis=0)
    return spec


def display_waveplot(x, fs: float = 16e3, ymax: float = 1.0, ymin: float = -1.0,
                     xticks_sec: float = 1.0, fontsize: int = DEFAULT_FONTSIZE,
                     ax=None):
    """Amplitude envelope plot (librosa.display.waveplot equivalent)."""
    plt, _ = pyplot("visualization.display_waveplot")
    ax = ax or plt.gca()
    t = np.arange(len(x)) / fs
    ax.fill_between(t, x, -np.asarray(x), linewidth=0.2)
    ax.set_ylabel("Amplitude", fontsize=fontsize + 2)
    ax.set_xlabel("Time (s)", fontsize=fontsize + 2)
    ax.set_xticks(np.arange(0, len(x) / fs, step=xticks_sec))
    ax.tick_params(labelsize=fontsize)
    ax.set_ylim(ymin, ymax)
    ax.set_xlim(0, len(x) / fs)
    return ax


def display_spectrogram(complex_spec, convert_to_db: bool = False,
                        fs: float = 16e3, vmin: float = -60, vmax: float = 10,
                        wlen_sec: float = 64e-3, hop_percent: float = 0.25,
                        xticks_sec: float = 1.0, cmap: str = "magma",
                        fontsize: int = DEFAULT_FONTSIZE, ax=None):
    """Spectrogram/mask image with time (s) and frequency (kHz) axes."""
    plt, _ = pyplot("visualization.display_spectrogram")
    ax = ax or plt.gca()
    amp = np.abs(complex_spec)
    if convert_to_db:
        amp = amplitude_to_db(amp)
    amp = _expand_vad_rows(amp)

    freq_bins, frames = amp.shape
    hop_sec = int(hop_percent * wlen_sec * fs) / fs
    time_sec = frames * hop_sec
    max_khz = (fs / 2) / 1e3

    img = ax.imshow(amp, origin="lower", aspect="auto", cmap=cmap,
                    vmin=vmin, vmax=vmax, extent=[0, time_sec, 0, max_khz],
                    interpolation="nearest")
    ax.set_ylabel("Frequency (kHz)", fontsize=fontsize + 2)
    ax.set_xlabel("Time (s)", fontsize=fontsize + 2)
    ax.set_xticks(np.arange(0, time_sec + hop_sec, step=xticks_sec))
    ax.tick_params(labelsize=fontsize)
    return img


def display_power_spectro(psd, fs: float = 16e3, vmin: float = -60,
                          vmax: float = 10, wlen_sec: float = 64e-3,
                          hop_percent: float = 0.25, xticks_sec: float = 1.0,
                          cmap: str = "magma", fontsize: int = DEFAULT_FONTSIZE,
                          ax=None):
    """Power spectrogram in dB (10*log10)."""
    pyplot("visualization.display_power_spectro")
    db = 10.0 * np.log10(np.maximum(np.asarray(psd), 1e-10))
    return display_spectrogram(10 ** (db / 20.0), True, fs, vmin, vmax,
                               wlen_sec, hop_percent, xticks_sec, cmap,
                               fontsize, ax=ax)


def display_wav_spectro_mask(x, x_tf, x_ibm, fs: float = 16e3,
                             vmin: float = -60, vmax: float = 10,
                             wlen_sec: float = 64e-3, hop_percent: float = 0.25,
                             xticks_sec: float = 1.0,
                             fontsize: int = DEFAULT_FONTSIZE):
    """Waveplot + dB spectrogram + binary mask, stacked with colorbars."""
    plt, grd = pyplot("visualization.display_wav_spectro_mask")
    fig = plt.figure(figsize=(10, 12))
    gs = grd.GridSpec(3, 2, height_ratios=[5, 10, 10], width_ratios=[10, 0.5],
                      wspace=0.1, hspace=0.35, left=0.1)

    display_waveplot(x, fs, xticks_sec=xticks_sec, fontsize=fontsize,
                     ax=plt.subplot(gs[0]))
    img = display_spectrogram(x_tf, True, fs, vmin, vmax, wlen_sec,
                              hop_percent, xticks_sec, "magma", fontsize,
                              ax=plt.subplot(gs[2]))
    fig.colorbar(img, cax=plt.subplot(gs[3]), format="%+2.0f dB")
    img2 = display_spectrogram(x_ibm, False, fs, 0, 1, wlen_sec, hop_percent,
                               xticks_sec, "Greys_r", fontsize,
                               ax=plt.subplot(gs[4]))
    fig.colorbar(img2, cax=plt.subplot(gs[5]), format="%0.1f")
    return fig


def display_multiple_signals(signal_list, fs: float = 16e3, vmin: float = -60,
                             vmax: float = 10, wlen_sec: float = 64e-3,
                             hop_percent: float = 0.25, xticks_sec: float = 1.0,
                             fontsize: int = DEFAULT_FONTSIZE,
                             last_only_label: bool = False):
    """Side-by-side [waveform, spectrogram, mask] columns for N signals.

    signal_list: [[x, x_tf, x_mask], ...]; None entries skip a panel."""
    plt, grd = pyplot("visualization.display_multiple_signals")
    n = len(signal_list)
    fig = plt.figure(figsize=(10 * n, 12))
    gs = grd.GridSpec(3, 3 * n, height_ratios=[5, 10, 10],
                      width_ratios=[10, 0.5, 2.0] * n,
                      wspace=0.1, hspace=0.35, left=0.08)

    for i, (x, x_tf, x_ibm) in enumerate(signal_list):
        if x is not None:
            display_waveplot(x, fs, xticks_sec=xticks_sec, fontsize=fontsize,
                             ax=plt.subplot(gs[3 * i]))
        if x_tf is not None:
            ax = plt.subplot(gs[3 * (i + n)])
            if last_only_label and i == n - 1:
                img = display_spectrogram(x_tf, False, fs, 0, 1, wlen_sec,
                                          hop_percent, xticks_sec, "Greys_r",
                                          fontsize, ax=ax)
                fig.colorbar(img, cax=plt.subplot(gs[3 * (i + n) + 1]),
                             format="%0.1f")
            else:
                img = display_spectrogram(x_tf, True, fs, vmin, vmax, wlen_sec,
                                          hop_percent, xticks_sec, "magma",
                                          fontsize, ax=ax)
                fig.colorbar(img, cax=plt.subplot(gs[3 * (i + n) + 1]),
                             format="%+2.0f dB")
        if x_ibm is not None:
            ax = plt.subplot(gs[3 * (i + 2 * n)])
            img = display_spectrogram(x_ibm, False, fs, 0, 1, wlen_sec,
                                      hop_percent, xticks_sec, "Greys_r",
                                      fontsize, ax=ax)
            fig.colorbar(img, cax=plt.subplot(gs[3 * (i + 2 * n) + 1]),
                         format="%0.1f")
    return fig


def display_multiple_spectro(signal_list, fs: float = 16e3, vmin: float = -60,
                             vmax: float = 10, wlen_sec: float = 64e-3,
                             hop_percent: float = 0.25, xticks_sec: float = 1.0,
                             fontsize: int = DEFAULT_FONTSIZE):
    """Waveform + power spectrogram columns for N signals."""
    plt, grd = pyplot("visualization.display_multiple_spectro")
    n = len(signal_list)
    fig = plt.figure(figsize=(10 * n, 8))
    gs = grd.GridSpec(2, 3 * n, height_ratios=[5, 10],
                      width_ratios=[10, 0.5, 2.0] * n,
                      wspace=0.1, hspace=0.35, left=0.08)
    for i, (x, x_psd) in enumerate(signal_list):
        if x is not None:
            display_waveplot(x, fs, xticks_sec=xticks_sec, fontsize=fontsize,
                             ax=plt.subplot(gs[3 * i]))
        img = display_power_spectro(x_psd, fs, vmin, vmax, wlen_sec,
                                    hop_percent, xticks_sec, "magma", fontsize,
                                    ax=plt.subplot(gs[3 * (i + n)]))
        fig.colorbar(img, cax=plt.subplot(gs[3 * (i + n) + 1]),
                     format="%+2.0f dB")
    return fig
