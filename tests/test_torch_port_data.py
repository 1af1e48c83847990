"""CPU parity of the port's corpus path with the JAX package: config,
host processing, catalogs, builders, statistics, sources, augmentation,
the loader, the prefetcher and ``Trainer.fit`` on corpus loaders.

A tiny raw NTCD-TIMIT tree is written once per module into a temporary
directory by chip_smoke.py's writer, in the layout of
scripts/synth_complete_corpus.py: speech-like clean wavs with silences (so
the energy VAD labels are not constant), DCT lip video as single-dataset
HDF5 ``.mat`` files at 30 fps, one noise at -5 dB (the "subset" grid's
Babble directory), 2 speakers x 2 utterances a split of 1-1.6 s. The JAX builders and the port's build a processed tree
each from it; the sources of both packages then read the JAX one. Nothing
here reads a reference checkout.
"""

import importlib
import os
import pathlib

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from avvad_tpu import builders as jbuilders
from avvad_tpu import config as jconfig
from avvad_tpu.data import augment as jaugment
from avvad_tpu.data import pipeline as jpipeline
from avvad_tpu.data import records as jrecords
from avvad_tpu.data import sources as jsources
from avvad_tpu.data import statistics as jstatistics
from avvad_tpu.datasets import csr1_wjs0 as jcsr
from avvad_tpu.datasets import ntcd_timit as jcatalog
from avvad_tpu.processing import audio_io as jaudio_io
from avvad_tpu.processing import targets as jtargets
from avvad_tpu.processing import video as jvideo
from avvad_tpu_torch import builders, config
from avvad_tpu_torch.data import (DataLoader, Prefetcher, augment, records, sources,
                                  statistics)
from avvad_tpu_torch.datasets import csr1_wjs0 as csr
from avvad_tpu_torch.datasets import ntcd_timit as catalog
from avvad_tpu_torch.processing import audio_io, targets, video

# the packages' __init__ binds the name ``stft`` to the function
jstft = importlib.import_module("avvad_tpu.processing.stft")
tstft = importlib.import_module("avvad_tpu_torch.processing.stft")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 16000
SPLITS = ("train", "validation", "test")


# --- the raw corpus ---------------------------------------------------------


def write_raw_corpus(root: str, seed: int = 0) -> str:
    """chip_smoke.py's raw NTCD-TIMIT tree (its disk route's writer) under
    ``root``: 4 utterances a split, 2 a speaker, 1-1.6 s -> ``root`` with a
    trailing separator (the catalogs' convention)."""
    chip_smoke.write_raw_corpus(pathlib.Path(root), {s: 4 for s in SPLITS}, seed=seed,
                                dur=(1.0, 1.6))
    return root.rstrip(os.sep) + os.sep


def speech(seed: int, dur: float) -> np.ndarray:
    return chip_smoke.corpus_audio(np.random.default_rng(seed), dur)[0]


def build_tree(bmod, raw: str, out: str, splits=SPLITS) -> list:
    """Each split through ``bmod``'s video and audio builders (labels with
    the ``_upsampled`` suffix for the AV pairing), then the train split's
    frame store -> what each builder returned."""
    cfg = bmod.BuildConfig(raw_dir=raw, processed_dir=out, dataset_size="subset",
                           upsampled_suffix=True, max_workers=0)
    counts = [(bmod.build_video_split(cfg, split), bmod.build_audio_split(cfg, split))
              for split in splits]
    return counts + [bmod.build_frame_store(cfg, "train", os.path.join(out, "frames.h5"))]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """-> (raw root, JAX-built processed root, port-built processed root,
    the JAX builders' return values, the port's)."""
    raw = write_raw_corpus(str(tmp_path_factory.mktemp("raw")))
    jout = str(tmp_path_factory.mktemp("proc_jax")) + os.sep
    tout = str(tmp_path_factory.mktemp("proc_port")) + os.sep
    return raw, jout, tout, build_tree(jbuilders, raw, jout), build_tree(builders, raw, tout)


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _h5_arrays(path: str) -> dict:
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in f}


def _assert_items_equal(got, ref):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            _assert_items_equal(got[k], ref[k])
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, (got, ref)
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref and type(got) is type(ref)


# --- builders ---------------------------------------------------------------


def test_builders_write_the_same_tree(corpus):
    """The port's builders write the same files as the JAX builders.
    Reading: the same 63 files on both sides (24 wavs, 12 upsampled videos,
    12 + 12 labels, 2 statistics files, the frame store)."""
    _, jout, tout = corpus[:3]
    files = _files(jout)
    assert files == _files(tout) and len(files) == 63
    assert sum(f.endswith(".wav") for f in files) == 2 * 3 * 2 * 2  # clean + noisy
    assert sum(f.endswith("_upsampled.h5") for f in files) == 3 * 2 * 2 * 2


@pytest.mark.parametrize("kind", ["h5", "wav"])
def test_builders_outputs_equal_jax(corpus, kind):
    """Every h5 dataset (video X, labels Y, both statistics files, the frame
    store) equal with np.array_equal; every copied wav byte-equal.
    Reading: every dataset equal, every wav byte-equal."""
    _, jout, tout = corpus[:3]
    names = [f for f in _files(jout) if f.endswith("." + kind)]
    assert names
    for rel in names:
        if kind == "wav":
            with open(jout + rel, "rb") as a, open(tout + rel, "rb") as b:
                assert a.read() == b.read(), rel
            continue
        ref, got = _h5_arrays(jout + rel), _h5_arrays(tout + rel)
        assert ref.keys() == got.keys(), rel
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), (rel, k)


def test_builder_process_pool_writes_the_same_files(corpus, tmp_path):
    """build_audio_split over a pool of 2 spawned workers (not forked: a
    caller may hold CUDA state) writes the test split's wavs and labels as
    the serial JAX build did. Reading: every file equal."""
    out = str(tmp_path) + os.sep
    cfg = builders.BuildConfig(raw_dir=corpus[0], processed_dir=out, dataset_size="subset",
                               upsampled_suffix=True, max_workers=2)
    assert builders.build_audio_split(cfg, "test") == 8
    files = _files(out)
    assert len(files) == 12  # 4 clean + 4 noisy wavs, 4 labels
    for rel in files:
        with open(out + rel, "rb") as a:
            got = a.read() if rel.endswith(".wav") else None
        if got is not None:
            with open(corpus[1] + rel, "rb") as b:
                assert got == b.read(), rel
        else:
            np.testing.assert_array_equal(_h5_arrays(out + rel)["Y"],
                                          _h5_arrays(corpus[1] + rel)["Y"])


def test_labels_are_not_constant(corpus):
    """The synthetic speech has silences: every VAD label file holds both
    classes, so the scoring and training below see both.
    Reading: speech shares between 0 and 1 in all 12 files."""
    jout = corpus[1]
    labels = [f for f in _files(jout) if f.endswith("_vad_labels.h5")]
    assert len(labels) == 12
    for rel in labels:
        y = _h5_arrays(jout + rel)["Y"]
        assert 0 < y.mean() < 1, rel


def test_build_counts_match_jax(corpus):
    """build_video_split / build_audio_split / build_frame_store return the
    same counts: 4 utterances, 4 clean + 4 noisy wavs a split.
    Reading: (4, 8) a split on both sides, the same frame count."""
    assert corpus[3] == corpus[4]
    assert corpus[3][:3] == [(4, 8)] * 3 and corpus[3][3] >= 4 * 62  # 1 s or more each


@pytest.mark.parametrize("kind", ["vad_labels", "ibm_labels"])
def test_make_label_matches_jax(kind):
    """make_label (VAD and IBM) on seeded speech, from both packages' configs.
    Reading: equal."""
    x = speech(5, 1.3)
    cfg = (config.STFTConfig(), config.LabelConfig(kind=kind))
    jcfg = (jconfig.STFTConfig(), jconfig.LabelConfig(kind=kind))
    got, ref = builders.make_label(x, FS, *cfg), jbuilders.make_label(x, FS, *jcfg)
    t = tstft.n_stft_frames(x.size)
    assert got.shape == ref.shape == ((1 if kind == "vad_labels" else 513), t)
    np.testing.assert_array_equal(got, ref)


# --- catalogs ---------------------------------------------------------------


CATALOG_CALLS = [
    ("video_list", {}), ("kaldi_list", {}), ("speech_list", {}),
    ("proc_video_audio_pair_dict", {"upsampled": True}),
    ("proc_video_audio_pair_dict", {}),
    ("proc_video_audio_pair_dict", {"dct": True}),
    ("noisy_speech_dict", {"dataset_size": "subset"}),
    ("noisy_speech_dict", {"dataset_size": "complete"}),
    ("noisy_clean_pair_dict", {"dataset_size": "subset"}),
    ("proc_noisy_clean_pair_dict", {"dataset_size": "subset", "upsampled": True}),
    ("proc_noisy_clean_pair_dict", {"dataset_size": "subset"}),
]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("call", CATALOG_CALLS, ids=lambda c: c[0] + "".join(c[1]))
def test_catalog_lists_match_jax(corpus, call, split):
    """The catalog's lists and pairings, on the raw and the processed tree.
    Reading: equal; 4 utterances a split."""
    name, kw = call
    for root in corpus[:2]:
        got = getattr(catalog, name)(root, split, **kw)
        assert got == getattr(jcatalog, name)(root, split, **kw)
    if name in ("video_list", "speech_list"):
        assert len(catalog.video_list(corpus[0], split)) == 4
    elif name == "proc_noisy_clean_pair_dict":
        assert len(catalog.proc_noisy_clean_pair_dict(corpus[1], split, **kw)) == 4


def test_catalog_rejects_unknown_split(corpus):
    """An unknown split name: both catalogs raise. Reading: both raise ValueError."""
    for mod in (catalog, jcatalog):
        with pytest.raises(ValueError, match="dataset_type"):
            mod.video_list(corpus[0], "dev")


def test_csr1_wjs0_catalog_matches_jax(tmp_path):
    """speech_list over a WSJ0 layout and the pickle round trip.
    Reading: equal lists and paths; each package reads the other's pickle."""
    for split in ("si_tr_s", "si_et_05"):
        d = tmp_path / "CSR-1-WSJ-0/WAV/wsj0" / split / "011"
        d.mkdir(parents=True)
        for u in ("a.wav", "b.wav"):
            (d / u).write_bytes(b"")
    root = str(tmp_path)
    for split in ("train", "test", "validation"):
        assert csr.speech_list(root, split) == jcsr.speech_list(root, split)
    assert len(csr.speech_list(root, "train")) == 2
    path = csr.write_dataset({"x": [1, 2]}, str(tmp_path / "out"), "train")
    assert path == jcsr._pickle_path(str(tmp_path / "out"), "train", "unlabeled_frames")
    assert jcsr.read_dataset(str(tmp_path / "out"), "train") == {"x": [1, 2]}
    assert csr.read_dataset(str(tmp_path / "out"), "train") == {"x": [1, 2]}


# --- processing ---------------------------------------------------------------


def _signal(seed, n=FS + 333):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("n", [FS, FS + 333])
def test_stft_istft_match_jax(center, n):
    """stft, istft, log_power_spectrogram, n_stft_frames, pad_for_stft and
    frame on a seeded signal: equal. Reading: equal."""
    x = _signal(1, n)
    kw = dict(center=center)
    s = tstft.stft(x, **kw)
    np.testing.assert_array_equal(s, jstft.stft(x, **kw))
    np.testing.assert_array_equal(tstft.istft(s, **kw), jstft.istft(s, **kw))
    np.testing.assert_array_equal(tstft.istft(s, max_len=0.5, **kw),
                                  jstft.istft(s, max_len=0.5, **kw))
    np.testing.assert_array_equal(tstft.log_power_spectrogram(s),
                                  jstft.log_power_spectrogram(s))
    assert tstft.n_stft_frames(n, **kw) == jstft.n_stft_frames(n, **kw) == s.shape[1]
    np.testing.assert_array_equal(tstft.pad_for_stft(x, **kw), jstft.pad_for_stft(x, **kw))
    np.testing.assert_array_equal(tstft.frame(x, 1024, 256), jstft.frame(x, 1024, 256))
    np.testing.assert_array_equal(tstft.hann_window(1024), jstft.hann_window(1024))


def test_stft_rejects_what_jax_rejects():
    """Another window or a too-short signal: both raise. Reading: both raise ValueError."""
    for mod in (tstft, jstft):
        with pytest.raises(ValueError, match="window"):
            mod.stft(_signal(0), win="hamming")
        with pytest.raises(ValueError, match="too short"):
            mod.frame(np.zeros(10), 1024, 256)


TARGETS = ["clean_speech_VAD", "clean_speech_IBM", "noise_robust_clean_speech_IBM",
           "noise_aware_IBM", "threshold_IBM"]


@pytest.mark.parametrize("name", TARGETS)
def test_targets_match_jax(name):
    """The five label generators on seeded speech and noise: equal.
    Reading: equal, both classes present."""
    rng = np.random.default_rng(2)
    x = speech(2, 1.2)
    sx = jstft.stft(x)
    sn = jstft.stft(rng.normal(size=x.size).astype(np.float32) * 0.05)
    args = {"clean_speech_VAD": (x,), "clean_speech_IBM": (sx,),
            "noise_robust_clean_speech_IBM": (x, sx),
            "noise_aware_IBM": (sx.T, sn.T), "threshold_IBM": (sx.T * 30,)}[name]
    got, ref = getattr(targets, name)(*args), getattr(jtargets, name)(*args)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
        assert 0 < np.mean(r) < 1  # both classes present


@pytest.mark.parametrize("norm", ["frame", "global"])
def test_video_decode_matches_jax(corpus, norm):
    """decode_and_upsample of a corpus .mat (and, per frame, its steps):
    equal. Reading: equal."""
    mat = os.path.join(corpus[0], jcatalog.video_list(corpus[0], "train")[0])
    got = video.decode_and_upsample(mat, norm=norm)
    ref = jvideo.decode_and_upsample(mat, norm=norm)
    assert got.shape[:2] == (67, 67) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    if norm == "global":
        return
    coeffs = video.read_mat_dct(mat)
    np.testing.assert_array_equal(coeffs, jvideo.read_mat_dct(mat))
    np.testing.assert_array_equal(video.idct2(coeffs[:3].reshape(3, 67, 67)),
                                  jvideo.idct2(coeffs[:3].reshape(3, 67, 67)))
    frames = video.decode_dct_frames(coeffs, norm=norm)
    np.testing.assert_array_equal(video.upsample_video(frames),
                                  jvideo.upsample_video(frames))
    np.testing.assert_array_equal(video.overlay_vad_square(frames[0], True),
                                  jvideo.overlay_vad_square(frames[0], True))


def test_video_decode_rejects_unknown_norm():
    """An unknown normalisation mode: both raise. Reading: both raise ValueError."""
    for mod in (video, jvideo):
        with pytest.raises(ValueError, match="norm"):
            mod.decode_dct_frames(np.zeros((1, 4489)), norm="minmax")


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32", "stereo"])
def test_read_wav_matches_jax(tmp_path, dtype):
    """read_wav of each PCM kind the scipy path decodes, write_wav and
    peak_normalize: equal. Reading: equal samples, byte-equal written files."""
    from scipy.io import wavfile

    x = _signal(3, 4000) * 0.2
    data = {"int16": (x * 32767).astype(np.int16), "int32": (x * 2**31).astype(np.int32),
            "uint8": (x * 127 + 128).astype(np.uint8), "float32": x,
            "stereo": np.stack([x, -x], 1)}[dtype]
    path = str(tmp_path / "a.wav")
    wavfile.write(path, FS, data)
    got, ref = audio_io.read_wav(path), jaudio_io.read_wav(path)
    assert got[1] == ref[1] == FS
    assert got[0].dtype == ref[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(audio_io.peak_normalize(got[0]),
                                  jaudio_io.peak_normalize(ref[0]))
    audio_io.write_wav(str(tmp_path / "t.wav"), got[0], FS)
    jaudio_io.write_wav(str(tmp_path / "j.wav"), ref[0], FS)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


# --- config -----------------------------------------------------------------


@pytest.mark.parametrize("source", ["defaults", "reference_av.yaml"])
def test_config_yaml_matches_jax(tmp_path, source):
    """to_yaml of the port's Config equals JAX's text; the round trip
    through from_yaml / save_yaml / load_yaml holds.
    Reading: equal text; the round trips hold."""
    if source == "defaults":
        cfg, jcfg = config.Config(), jconfig.Config()
    else:
        path = os.path.join(ROOT, "configs", source)
        cfg, jcfg = config.load_yaml(path), jconfig.load_yaml(path)
        assert cfg.data.dataset_size == "complete"
    text = config.to_yaml(cfg)
    assert text == jconfig.to_yaml(jcfg)
    assert config.from_yaml(text) == cfg
    config.save_yaml(cfg, str(tmp_path / "c.yaml"))
    assert config.load_yaml(str(tmp_path / "c.yaml")) == cfg
    assert jconfig.load_yaml(str(tmp_path / "c.yaml")) == jcfg


def test_config_properties_match_jax():
    """The derived properties of each section and the video-rate hop. Reading: equal."""
    cfg, jcfg = config.Config(), jconfig.Config()
    for a, b in ((cfg.stft, jcfg.stft), (cfg.label, jcfg.label), (cfg.data, jcfg.data)):
        for name in dir(type(b)):
            if isinstance(getattr(type(b), name), property):
                assert getattr(a, name) == getattr(b, name), name
    assert (config.STFTConfig.video_rate_hop_percent()
            == jconfig.STFTConfig.video_rate_hop_percent())
    assert cfg.replace(train=config.TrainConfig(seed=3)).train.seed == 3


# --- statistics and records -------------------------------------------------


STATS_FILES = ["ntcd_timit/Noisy/ntcd_timit_log_power_spec_upsampled_statistics.h5",
               "ntcd_timit/matlab_raw/ntcd_timit_upsampled_statistics.h5"]


@pytest.mark.parametrize("rel", STATS_FILES)
def test_statistics_match_jax(corpus, tmp_path, rel):
    """load_statistics of the built files, welford_merge and a
    save / load round trip: equal. Reading: equal."""
    path = corpus[1] + rel
    got, ref = statistics.load_statistics(path), jstatistics.load_statistics(path)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape and g.shape[1] == 1
        np.testing.assert_array_equal(g, r)
    statistics.save_statistics(str(tmp_path / "s.h5"), got[0][:, 0], got[1][:, 0])
    np.testing.assert_array_equal(jstatistics.load_statistics(str(tmp_path / "s.h5"))[1],
                                  ref[1])
    rng = np.random.default_rng(4)
    parts = [(5.0, rng.normal(size=3), rng.random(3) + 4) for _ in range(3)]
    for g, r in zip(statistics.welford_merge(parts), jstatistics.welford_merge(parts)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("variant", ["auto", "upsampled", "normvideo", "plain"])
@pytest.mark.parametrize("upsampled", [True, False])
def test_video_path_for_label_matches_jax(variant, upsampled):
    """The label-to-video path rewrite for each variant. Reading: equal."""
    rel = "ntcd_timit/Clean/test/05M/s1_vad_labels_upsampled.h5"
    assert (records.video_path_for_label(rel, "vad_labels", upsampled, variant)
            == jrecords.video_path_for_label(rel, "vad_labels", upsampled, variant))


# --- sources ----------------------------------------------------------------


PAIR_SOURCES = ["AudioSequenceSource", "AudioWaveformSource", "AudioVisualSource",
                "AudioVisualWaveformSource"]


def _pair_pair(name, root, split, **kw):
    kw = {"dataset_size": "subset", **kw}
    return (getattr(sources, name)(root, split, **kw),
            getattr(jsources, name)(root, split, **kw))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", PAIR_SOURCES)
def test_pair_sources_match_jax(corpus, name, split):
    """Each whole-utterance source: every item dict, probe_length,
    rel_path, label_rel_path and metadata equal. Reading: equal."""
    src, jsrc = _pair_pair(name, corpus[1], split)
    assert len(src) == len(jsrc) == 4
    for i in range(len(jsrc)):
        _assert_items_equal(src[i], jsrc[i])
        assert src.probe_length(i) == jsrc.probe_length(i)
        assert src.rel_path(i) == jsrc.rel_path(i)
        assert src.label_rel_path(i) == jsrc.label_rel_path(i)
        assert src.metadata(i) == jsrc.metadata(i)
    assert src[0]["noise_type"] == "Babble" and src[0]["snr_db"] == "-5"


@pytest.mark.parametrize("split", SPLITS)
def test_video_sequence_source_matches_jax(corpus, split):
    """VideoSequenceSource over the processed tree: items, probe_length and paths.
    Reading: equal."""
    src = sources.VideoSequenceSource(corpus[1], split)
    jsrc = jsources.VideoSequenceSource(corpus[1], split)
    assert len(src) == len(jsrc) == 4
    for i in range(len(jsrc)):
        _assert_items_equal(src[i], jsrc[i])
        assert (src.probe_length(i), src.rel_path(i), src.label_rel_path(i)) == \
            (jsrc.probe_length(i), jsrc.rel_path(i), jsrc.label_rel_path(i))


def test_video_sequence_source_rejects_incomplete_tree(corpus, tmp_path):
    """A tree with videos and no labels: both raise the same ValueError.
    Reading: the same message."""
    d = tmp_path / "ntcd_timit/matlab_raw/test/01M"
    d.mkdir(parents=True)
    (d / "s0_upsampled.h5").write_bytes(b"")
    msgs = []
    for mod in (sources, jsources):
        with pytest.raises(ValueError, match="mismatch") as e:
            mod.VideoSequenceSource(str(tmp_path) + os.sep, "test")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kind", ["SpectrogramFrameSource", "SpectrogramWindowSource",
                                  "SpectrogramChunkSource"])
def test_frame_store_sources_match_jax(corpus, kind):
    """The legacy sources over the packed frame store: every item equal. Reading: equal."""
    path = corpus[1] + "frames.h5"
    args = () if kind == "SpectrogramFrameSource" else (7,)
    src = getattr(sources, kind)(path, "train", *args)
    jsrc = getattr(jsources, kind)(path, "train", *args)
    assert src.n_frames == jsrc.n_frames >= 4 * 62 and len(src) == len(jsrc)
    for i in range(0, len(jsrc), max(1, len(jsrc) // 40)):
        _assert_items_equal(src[i], jsrc[i])
    src.close()
    jsrc.close()
    assert src._f is None


def test_video_clip_source_matches_jax(corpus, tmp_path):
    """Random clips from raw .mat files with the label at the clip's end:
    the same draws from the same seed. Reading: equal."""
    mats = jcatalog.video_list(corpus[0], "train")
    items = [os.path.splitext(m)[0] for m in mats]
    for it in items:
        os.makedirs(os.path.dirname(str(tmp_path / it)), exist_ok=True)
        np.save(str(tmp_path / it) + ".npy", np.arange(100) % 2)
    items = items[:2]  # each draw decodes a whole .mat
    src = sources.VideoClipSource(corpus[0], items, str(tmp_path), seq_length=9, seed=3)
    jsrc = jsources.VideoClipSource(corpus[0], items, str(tmp_path), seq_length=9, seed=3)
    assert len(src) == 2
    for i in range(len(src)):
        _assert_items_equal(src[i], jsrc[i])


def test_parse_utt_metadata_matches_jax():
    """Noise, SNR, split, speaker and utterance from a processed path. Reading: equal."""
    rel = "ntcd_timit/Noisy/Babble/-5/test/34M/sa1.wav"
    assert sources.parse_utt_metadata(rel) == jsources.parse_utt_metadata(rel)


# --- augmentation -----------------------------------------------------------


@pytest.mark.parametrize("inner", ["AudioSequenceSource", "AudioVisualSource"])
def test_augmenting_source_matches_jax(corpus, inner):
    """AugmentingSource over the train split, epoch 1, seed 3: items (each
    noise family at each SNR for one utterance, then one per other
    utterance), probe_length, feature_item and feature_stats equal. Reading: equal."""
    src, jsrc = _pair_pair(inner, corpus[1], "train")
    aug, jaug = augment.AugmentingSource(src, seed=3), jaugment.AugmentingSource(jsrc, seed=3)
    aug.set_epoch(1)
    jaug.set_epoch(1)
    assert len(aug) == len(jaug) == 4 * 18
    for i in [*range(18), 18 + 5, 36 + 11, 54 + 17]:
        _assert_items_equal(aug[i], jaug[i])
        assert aug.probe_length(i) == jaug.probe_length(i)
    np.testing.assert_array_equal(aug.feature_item(7), jaug.feature_item(7))
    for g, r in zip(augment.feature_stats(aug, max_items=5),
                    jaugment.feature_stats(jaug, max_items=5)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("kind", [*augment.NOISE_KINDS, "Pink"])
def test_synth_noise_and_mix_match_jax(kind):
    """Each noise family mixed at 5 dB from the same generator state; an unknown family raises.
    Reading: equal; the same error."""
    pool = [_signal(s, 3000) for s in range(3)]
    outs = []
    for mod in (augment, jaugment):
        rng = np.random.default_rng(9)
        try:
            noise = mod.synth_noise(kind, 2000, rng, pool)
        except ValueError as e:
            outs.append(str(e))
            continue
        outs.append(mod.mix_at_snr(pool[0][:2000], noise, 5.0))
    if kind == "Pink":
        assert outs[0] == outs[1] and "unknown" in outs[0]
    else:
        np.testing.assert_array_equal(outs[0], outs[1])
    rel = "ntcd_timit/Noisy/Babble/-5/test/34M/sa1.wav"
    assert augment.clean_rel_from_noisy(rel) == jaugment.clean_rel_from_noisy(rel)


# --- loader and prefetcher ----------------------------------------------------


LOADER_CONFIGS = {
    "plain": dict(batch_size=3),
    "bucket": dict(batch_size=2, bucket=32),
    "ladder_full": dict(batch_size=3, bucket=16, bucket_ladder=True, pad_batch_to_full=True),
    "sorted": dict(batch_size=2, bucket=32, sort_pool_factor=2, drop_last=True),
}


def _batches_equal(got, ref):
    for name in ref._fields:
        g, r = getattr(got, name), getattr(ref, name)
        if r is None:
            assert g is None, name
        else:
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            assert g.dtype == r.dtype and np.array_equal(g, r), name


@pytest.mark.parametrize("cfg", LOADER_CONFIGS)
def test_dataloader_matches_jax(corpus, cfg):
    """DataLoader over the AV source of all 12 utterances' train split...
    over two shuffled epochs: the batch plans and every Batch equal. Reading: equal."""
    src, jsrc = _pair_pair("AudioVisualSource", corpus[1], "train")
    kw = dict(LOADER_CONFIGS[cfg], shuffle=True, seed=5, num_workers=2)
    loader, jloader = DataLoader(src, **kw), jpipeline.DataLoader(jsrc, **kw)
    assert len(loader) == len(jloader)
    for epoch in range(2):
        plan = loader.batch_plan()
        assert [p.tolist() for p in plan] == [p.tolist() for p in jloader.batch_plan()]
        got, ref = list(loader), list(jloader)
        assert len(got) == len(ref) == len(plan) and loader.epoch == epoch + 1
        for g, r in zip(got, ref):
            _batches_equal(g, r)
    if cfg == "plain":  # the shuffle moves with the epoch
        assert [p.tolist() for p in loader.batch_plan()] != [p.tolist() for p in plan]


def test_prefetcher_on_cpu_yields_the_loader_batches(corpus):
    """Prefetcher(device="cpu"): the loader's batches, as CPU tensors. Reading: equal."""
    src, _ = _pair_pair("AudioVisualSource", corpus[1], "validation")
    loader = DataLoader(src, batch_size=3, bucket=32, shuffle=False, num_workers=2)
    ref = list(loader)
    got = list(Prefetcher(loader, device="cpu"))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert all(a is None or (isinstance(a, torch.Tensor) and a.device.type == "cpu")
                   for a in g)
        _batches_equal(g, r)


def test_prefetcher_passes_tensors_through():
    """Arrays that are tensors already (as a caller on the card passes
    them): one on the device stays as it is, others move there.
    Reading: the same tensor object for the device one."""
    from avvad_tpu_torch.data import Batch

    audio = torch.ones(1, 3, 513)
    batch = Batch(audio=audio, video=None, label=np.zeros((1, 3, 1), np.float32),
                  lengths=np.array([3]), mask=torch.ones(1, 3))
    (got,) = list(Prefetcher([batch], device="cpu"))
    assert got.audio is audio and isinstance(got.label, torch.Tensor)
    assert got.lengths.tolist() == [3]


class _Failing:
    def __init__(self, inner, bad):
        self.inner, self.bad = inner, bad

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError(f"unreadable item {i}")
        return self.inner[i]


def test_prefetcher_reraises_a_source_error(corpus):
    """A source that fails on its third item: the consumer gets the first
    batch, then the source's OSError, as from the JAX Prefetcher.
    Reading: the OSError at the second batch."""
    src, _ = _pair_pair("AudioSequenceSource", corpus[1], "test")
    loader = DataLoader(_Failing(src, 2), batch_size=2, shuffle=False, num_workers=1)
    it = iter(Prefetcher(loader, device="cpu"))
    assert next(it).batch_size == 2
    with pytest.raises(OSError, match="unreadable item 2"):
        next(it)


# --- Trainer.fit on corpus loaders --------------------------------------------


def _norm_stats(root):
    m, s = jstatistics.load_statistics(root + STATS_FILES[0])
    return {"audio_mean": m, "audio_std": s}


@pytest.fixture(scope="module")
def fit_runs(corpus, tmp_path_factory):
    """Trainer.fit for one epoch of AudioVAD(1 x LSTM 16) on the train
    split (batch 2, bucket 32, shuffled), validated on the validation
    split, with the built statistics: JAX with prefetch=False, the port
    with prefetch=True on the CPU, from the same init."""
    from avvad_tpu.models import AudioVAD as JAudioVAD
    from avvad_tpu.train import create_train_state as jcreate_train_state
    from avvad_tpu.train.state import make_optimizer as jmake_optimizer
    from avvad_tpu.train.trainer import Trainer as JTrainer
    from avvad_tpu_torch.convert import from_flax_variables
    from avvad_tpu_torch.models import AudioVAD
    from avvad_tpu_torch.train import Trainer, create_train_state

    root = corpus[1]
    stats = _norm_stats(root)
    out = tmp_path_factory.mktemp("fit")
    kw = dict(batch_size=2, bucket=32, shuffle=True, seed=1, num_workers=2)
    jm = JAudioVAD(lstm_hidden_size=16, lstm_layers=1, use_pallas_lstm=True)
    jstate = jcreate_train_state(jm, jax.random.PRNGKey(0), (jnp.zeros((1, 4, 513)),),
                                 jmake_optimizer(1e-3))
    init = jax.tree_util.tree_map(np.asarray, jstate.variables())
    jtrainer = JTrainer(jstate, "audio", str(out / "jax"), norm_stats=stats, prefetch=False)
    jlast = jtrainer.fit(
        jpipeline.DataLoader(jsources.AudioSequenceSource(root, "train"), **kw),
        jpipeline.DataLoader(jsources.AudioSequenceSource(root, "validation"), **kw),
        end_epoch=2)
    model = AudioVAD(lstm_hidden_size=16, lstm_layers=1, use_kernel_lstm=True)
    model.load_state_dict(from_flax_variables(init))
    state = create_train_state(model, learning_rate=1e-3, device="cpu")
    trainer = Trainer(state, "audio", str(out / "port"), norm_stats=stats, prefetch=True)
    last = trainer.fit(DataLoader(sources.AudioSequenceSource(root, "train"), **kw),
                       DataLoader(sources.AudioSequenceSource(root, "validation"), **kw),
                       end_epoch=2)
    jfinal = from_flax_variables(jax.tree_util.tree_map(np.asarray,
                                                        jtrainer.state.variables()))
    return {"dir": out, "last": last, "jlast": jlast, "state": state,
            "jfinal": jfinal, "init": from_flax_variables(init)}


def test_trainer_fit_on_corpus_logs_as_jax(fit_runs):
    """output_batch.log and output_epoch.log equal line for line (but the
    [Time] lines); one checkpoint each.
    Reading: equal lines; epoch metrics within 1e-5 relative."""
    out = fit_runs["dir"]

    def lines(side, name):
        return [ln for ln in (out / side / name).read_text().splitlines()
                if not ln.startswith("[Time]")]

    assert len(lines("port", "output_batch.log")) == 2  # 4 utterances, batch 2
    for name in ("output_batch.log", "output_epoch.log"):
        assert lines("port", name) == lines("jax", name)
    assert fit_runs["state"].step == 2
    for split in ("train", "valid"):
        for k, v in fit_runs["jlast"][split].items():
            np.testing.assert_allclose(fit_runs["last"][split][k], v, rtol=1e-5, atol=1e-7)
    assert [p.name for p in (out / "port").glob("epoch_*")] == \
        [p.name for p in (out / "jax").glob("epoch_*")]


def test_trainer_fit_on_corpus_params_match_jax(fit_runs):
    """Parameters after the epoch (2 Adam steps at lr 1e-3) against JAX's.
    Adam's early updates are about +-lr wherever |g| >> eps, so an entry
    whose gradient is near 0 with another sign in the two frameworks moves
    up to 2 lr apart a step: all entries are held at 4 lr, and 99.9 % of
    each tensor at 1e-6. Readings: every entry within 6.7e-7 (the first
    layer's W_ih; the rest within 3e-8), each tensor moved 1.9e-3 to 2e-3."""
    sd = fit_runs["state"].model.state_dict()
    for n, ref in fit_runs["jfinal"].items():
        got, ref = sd[n].numpy(), ref.numpy()
        diff = np.abs(got - ref)
        assert diff.max() < 4e-3, n
        assert np.mean(diff < 1e-6) > 0.999, (n, np.mean(diff < 1e-6))
        assert np.abs(ref - fit_runs["init"][n].numpy()).max() > 1e-4, n  # it trained
