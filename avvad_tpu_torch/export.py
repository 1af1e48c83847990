"""Serving artifacts and the raw-input serving step (port of
avvad_tpu/export.py: ``ServingArtifact``, ``make_streaming_step_fn``,
``make_multistream_tick_fn``, ``export_multistream_server``,
``load_multistream_server`` and ``make_waveform_serving_fn``).

An artifact is a zip file of a ``meta.json`` and one ``<name>.pt2`` blob an
entry: a ``torch.export`` program (``torch.export.save``) of a small module
that holds the model, so that the weights are the program's state and the
frontend, normalisation and model its graph. The hand-written kernels are
``torch.library`` custom ops (``avvad_tpu_torch::lstm_infer``,
``::int8_basic_block``, ``::stem_epilogue_pool_quant``), recorded in the
graph as the JAX artifact records its Mosaic custom calls, and launched
when the program runs; ``load`` imports ``avvad_tpu_torch.ops`` so that
they are registered first. A program replays with ``ExportedProgram.module()``,
eagerly: neither Inductor nor AOTInductor is asked for. Shapes are static,
one entry a serving shape.

The precision flags are process state, not program state: ``meta`` records
the TF32 switches the program was built under (off: the JAX package pins
fp32 in the STFT DFT and the MCB matmuls), and ``load`` and ``call`` set
them again. ``meta`` also records ``torch_version``, the device and its
kind, and the custom ops each entry calls.

A mesh-sharded multi-stream server exports the tick of one shard (its
N / n_data streams) and records ``mesh_data``; ``load_multistream_server``
rebuilds the sharded server, one replay of the tick a shard, on each
shard's device.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from types import SimpleNamespace
from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from . import ops  # noqa: F401  (registers the custom ops before a program loads)
from ._device import resolve_device
from .models.vad_nets import AVVAD, AudioVAD, RawAudioVAD, VideoVAD
from .ops.stft import log_power_frontend
from .utils import profiling

_META_NAME = "meta.json"
_ENTRY_SUFFIX = ".pt2"
_FORMAT_VERSION = 1
OP_NAMESPACE = "avvad_tpu_torch"


class ServingStep(nn.Module):
    """A serving step as a module: ``model`` (its weights this module's
    state, or None) and ``body``, a function of tensors only. Calling it
    runs the body under ``torch.inference_mode()`` as the ``serve.step``
    span; ``forward`` is the untraced body, which ``ServingArtifact.build``
    exports."""

    def __init__(self, model: Optional[nn.Module], body: Callable):
        super().__init__()
        self.model = model
        self._body = body

    def forward(self, *args):
        return self._body(*args)

    def __call__(self, *args):
        with profiling.span("serve.step"), torch.inference_mode():
            return super().__call__(*args)


class _Traced(nn.Module):
    """What ``torch.export`` traces: a serving step's forward, outside
    inference mode (tensors made under it cannot be exported)."""

    def __init__(self, step: ServingStep):
        super().__init__()
        self.step = step

    def forward(self, *args):
        return self.step.forward(*args)


def _precision() -> dict:
    return {"cuda_matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32)}


def _set_precision(flags: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = flags.get("cuda_matmul_allow_tf32", False)
    torch.backends.cudnn.allow_tf32 = flags.get("cudnn_allow_tf32", False)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def _to_device(tree, device: torch.device):
    """Arrays, scalars and tensors of a (nested list / tuple) argument ->
    tensors on ``device``; None passes through."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(x, device) for x in tree)
    if tree is None:
        return None
    return torch.as_tensor(np.asarray(tree) if not torch.is_tensor(tree) else tree,
                           device=device)


def _custom_ops(program) -> list:
    return sorted({str(n.target) for n in program.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith(OP_NAMESPACE)})


class ServingArtifact:
    """A named set of exported serving programs and their build metadata."""

    def __init__(self, entries: Mapping[str, "torch.export.ExportedProgram"],
                 meta: Optional[dict] = None):
        self.entries = dict(entries)
        self.meta = dict(meta or {})
        self._modules: dict[str, nn.Module] = {}

    @classmethod
    def build(cls, fns: Mapping[str, tuple], meta: Optional[dict] = None) -> "ServingArtifact":
        """Export each ``name -> (fn, example_args)``: ``fn`` a
        ``ServingStep`` (what ``make_waveform_serving_fn``,
        ``make_streaming_step_fn`` and ``make_multistream_tick_fn`` return),
        or a function of tensors, whose weights then become constants;
        ``example_args`` fixes the static serving shapes and the device.
        Each step runs once eagerly before it is traced, so that what it
        keeps between calls (the int8 tower's fold) is current and the
        traced forward only reads it."""
        entries, ops_used, device = {}, {}, None
        for name, (fn, example) in fns.items():
            step = fn if isinstance(fn, ServingStep) else ServingStep(None, fn)
            example = tuple(example)
            device = next((x.device for x in _leaves(example) if torch.is_tensor(x)), device)
            with torch.no_grad():
                step.forward(*example)
                entries[name] = torch.export.export(_Traced(step), example)
            # the example tensors would be saved with the program: at the
            # serving shape, twice the size of the weights
            entries[name].example_inputs = None
            ops_used[name] = _custom_ops(entries[name])
        device = device or torch.device("cpu")
        full_meta = {
            "format_version": _FORMAT_VERSION,
            "torch_version": torch.__version__,
            "device": device.type,
            "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
            "custom_ops": ops_used,
            "precision": _precision(),
        }
        full_meta.update(meta or {})
        return cls(entries, full_meta)

    def save(self, path: str) -> None:
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(_META_NAME, json.dumps(self.meta, indent=2))
            for name, program in self.entries.items():
                buf = io.BytesIO()
                torch.export.save(program, buf)
                # stored: a .pt2 is a zip of its own, mostly weights
                zf.writestr(name + _ENTRY_SUFFIX, buf.getvalue(), zipfile.ZIP_STORED)

    @classmethod
    def load(cls, path: str) -> "ServingArtifact":
        """Read an artifact and set the precision flags it was built under."""
        blobs, meta = {}, {}
        with zipfile.ZipFile(path) as zf:
            for info in zf.infolist():
                if info.filename == _META_NAME:
                    meta = json.loads(zf.read(info))
                elif info.filename.endswith(_ENTRY_SUFFIX):
                    blobs[info.filename[: -len(_ENTRY_SUFFIX)]] = zf.read(info)
        if not blobs:
            raise ValueError(f"{path}: no serving entries found")
        version = meta.get("format_version")
        if version is not None and version > _FORMAT_VERSION:
            raise ValueError(f"{path}: artifact format {version} is newer than this "
                             f"library supports ({_FORMAT_VERSION})")
        entries = {name: torch.export.load(io.BytesIO(blob)) for name, blob in blobs.items()}
        _set_precision(meta.get("precision", {}))
        return cls(entries, meta)

    @property
    def device(self) -> torch.device:
        return torch.device(self.meta.get("device", "cpu"))

    def call(self, name: str, *args, device: str | torch.device | None = None):
        """Run entry ``name`` on the artifact's device, or on ``device`` (a
        copy of the program's state moved there, kept for the next call);
        shapes must match the exported example shapes exactly (static-shape
        serving). Arrays and scalars are moved there; the outputs stay
        there."""
        dev = self.device if device is None else torch.device(device)
        module = self._modules.get((name, dev))
        if module is None:
            module = self.entries[name].module()
            if dev != self.device:
                module = module.to(dev)
            self._modules[(name, dev)] = module
        _set_precision(self.meta.get("precision", {}))
        with torch.inference_mode():
            return module(*_to_device(args, dev))

    def _user_inputs(self, name: str) -> list:
        program = self.entries[name]
        users = set(program.graph_signature.user_inputs)
        return [n.meta["val"] for n in program.graph.nodes
                if n.op == "placeholder" and n.name in users]

    def input_shapes(self, name: str) -> list:
        return [tuple(v.shape) for v in self._user_inputs(name)]

    def input_dtypes(self, name: str) -> list:
        return [v.dtype for v in self._user_inputs(name)]

    def __contains__(self, name: str) -> bool:
        return name in self.entries


def _video_dtype(streamer) -> torch.dtype:
    return torch.uint8 if streamer._vdtype == np.uint8 else torch.float32


def make_streaming_step_fn(streamer) -> tuple:
    """-> (fn, example_args): a single streamer's device step with its
    weights, for ``ServingArtifact.build``. ``fn`` returns ``(probs, new
    carries)``; a deployment loop cuts the windows on the host as
    ``feed()`` does and feeds the carries back, so a replay equals the live
    streamer block for block. StreamingAVVAD: ``fn(frames, video, peak,
    carries)``; StreamingVideoVAD: ``fn(video, carries)``; StreamingVAD:
    ``fn(frames, peak, carries)``."""
    from . import serve

    if not isinstance(streamer, (serve.StreamingVAD, serve.StreamingAVVAD,
                                 serve.StreamingVideoVAD)):
        raise TypeError(f"not a single-stream streamer: {type(streamer)!r}")
    dev, bf = streamer._dev, streamer.block_frames
    carries = serve._zero_carries(streamer.model, 1, dev)
    step = ServingStep(streamer.model, streamer._device_step)
    peak = torch.ones((), device=dev)
    if isinstance(streamer, serve.StreamingAVVAD):
        return step, (torch.zeros(bf, streamer._nfft, device=dev),
                      torch.zeros(bf, 67, 67, dtype=_video_dtype(streamer), device=dev),
                      peak, carries)
    if isinstance(streamer, serve.StreamingVideoVAD):
        return step, (torch.zeros(bf, 67, 67, dtype=_video_dtype(streamer), device=dev),
                      carries)
    return step, (torch.zeros(bf, streamer._nfft, device=dev), peak, carries)


def make_multistream_tick_fn(server) -> tuple:
    """-> (fn, example_args): a multi-stream server's tick with its weights,
    for ``ServingArtifact.build``. The tick advances all N streams at once;
    padded streams pass ``active=0`` and have their carries mask-restored
    inside the step, as the live server does, so an artifact-driven server
    (``load_multistream_server``) reproduces it. The inputs are those of
    the server's step, without ``vidx`` where there is no ``video_fps``:
    AV ``(frames, video[, vidx], peaks, active, carries)``, video
    ``(video[, vidx], active, carries)``, audio ``(frames, peaks, active,
    carries)``; ``frames`` is the (N, span) sample span (int16 with
    ``audio_int16``) on the span wire, else (N, block, nfft) windows. A
    mesh-sharded server's tick is its first shard's: N / n_data streams."""
    from . import serve

    if not isinstance(server.model, nn.Module):
        raise TypeError("the server runs a step_override: it has no model to export")
    shard = server._shards[0]
    dev, n, bf = shard.dev, shard.hi - shard.lo, server.block_frames
    carries = serve._zero_carries(server.model, n, dev)
    peaks = torch.ones(n, device=dev)
    active = torch.ones(n, device=dev)
    body = shard.view._tick_body
    model = shard.view.model

    def audio_example():
        if server.span_wire:
            dt = torch.int16 if server.audio_int16 else torch.float32
            return torch.zeros(n, server._hub.span, dtype=dt, device=dev)
        return torch.zeros(n, bf, server._nfft, device=dev)

    def video_example():
        frames = server._vsrc_max if server.video_fps else bf
        return torch.zeros(n, frames, 67, 67, dtype=_video_dtype(server), device=dev)

    vidx = torch.zeros(n, bf, dtype=torch.int32, device=dev)
    if isinstance(server, serve.MultiStreamAVVAD):
        if server.video_fps:
            return (ServingStep(model, body),
                    (audio_example(), video_example(), vidx, peaks, active, carries))

        def av_tick(frames, video, peaks, active, carries):
            return body(frames, video, None, peaks, active, carries)
        return (ServingStep(model, av_tick),
                (audio_example(), video_example(), peaks, active, carries))
    if isinstance(server, serve.MultiStreamVideoVAD):
        if server.video_fps:
            return ServingStep(model, body), (video_example(), vidx, active, carries)

        def video_tick(video, active, carries):
            return body(video, None, active, carries)
        return ServingStep(model, video_tick), (video_example(), active, carries)
    if isinstance(server, serve.MultiStreamVAD):
        return ServingStep(model, body), (audio_example(), peaks, active, carries)
    raise TypeError(f"not a multi-stream server: {type(server)!r}")


def export_multistream_server(server, path: str, meta: Optional[dict] = None) -> None:
    """Save a multi-stream server as a self-contained artifact: the tick
    program (weights and normalisation in it) and the server's geometry
    (``meta["multistream"]``, as avvad_tpu/export.py:283-303 records it), so
    that ``load_multistream_server`` rebuilds a working server with no model
    code and no checkpoint."""
    from . import serve

    fn, example = make_multistream_tick_fn(server)
    kind = ("av" if isinstance(server, serve.MultiStreamAVVAD) else
            "video" if isinstance(server, serve.MultiStreamVideoVAD) else "audio")
    geometry = {
        "kind": kind,
        "n_streams": server.n,
        "block_frames": server.block_frames,
        "max_backlog_blocks": server.max_backlog_blocks,
        "lstm_hidden": server.model.lstm_hidden_size,
        "lstm_layers": server.model.lstm_layers,
        "nfft": getattr(server, "_nfft", None),
        "span_wire": bool(getattr(server, "span_wire", False)),
        "hop_dft": bool(getattr(server, "hop_dft", False)),
        "audio_int16": bool(getattr(server, "audio_int16", False)),
        "video_fps": getattr(server, "video_fps", None),
        "video_uint8": bool(getattr(server, "_vdtype", None) == np.uint8),
        "mesh_data": server.mesh_data,
    }
    if hasattr(server, "cfg"):  # audio / AV: the hub cuts the traced windows
        geometry["stft_cfg"] = dataclasses.asdict(server.cfg)
    ServingArtifact.build({"tick": (fn, example)},
                          meta={"multistream": geometry, **(meta or {})}).save(path)


def _local_mesh(n_data: int, device: torch.device):
    """A serving mesh over the first ``n_data`` local devices of
    ``device``'s kind: the cards cuda:0 .. cuda:n_data-1, or the CPU
    ``n_data`` times."""
    from .parallel import make_mesh

    if device.type == "cpu":
        return make_mesh(n_data=n_data, n_model=1, devices=["cpu"] * n_data)
    have = torch.cuda.device_count()
    if have < n_data:
        raise ValueError(f"the artifact shards over {n_data} cards and {have} are "
                         "visible: pass a mesh (devices may repeat)")
    return make_mesh(n_data=n_data, n_model=1,
                     devices=[f"cuda:{i}" for i in range(n_data)])


def load_multistream_server(path: str, native: bool = True, mesh=None,
                            device: str | torch.device | None = None):
    """Rebuild a multi-stream server from ``export_multistream_server``'s
    artifact: a real MultiStream{VAD,VideoVAD,AVVAD} (feed / tick /
    reset_stream / ``VADServer``) whose step is the artifact's tick, on
    ``device`` (by default the device the artifact was exported on). An
    artifact exported from a mesh-sharded server replays sharded: pass a
    mesh with a matching ``data`` axis (default: one over the first
    ``mesh_data`` local devices); each shard replays the tick on its
    device."""
    from . import serve
    from .config import STFTConfig

    artifact = ServingArtifact.load(path)
    geo = artifact.meta.get("multistream")
    if geo is None:
        raise ValueError(f"{path}: not a multistream server artifact")
    dev = resolve_device(artifact.device if device is None else device)
    if geo.get("mesh_data") and mesh is None:
        mesh = _local_mesh(geo["mesh_data"], dev)
    if mesh is not None and geo.get("mesh_data") != mesh.shape.get("data"):
        raise ValueError(
            f"{path}: exported for data axis {geo.get('mesh_data')}, "
            f"got mesh data axis {mesh.shape.get('data')}")
    facts = SimpleNamespace(lstm_hidden_size=geo["lstm_hidden"],
                            lstm_layers=geo["lstm_layers"])
    common = dict(n_streams=geo["n_streams"], block_frames=geo["block_frames"],
                  max_backlog_blocks=geo["max_backlog_blocks"], device=dev, mesh=mesh)
    if geo.get("stft_cfg") is not None:
        common["stft_cfg"] = STFTConfig(**geo["stft_cfg"])
    if geo["kind"] != "video":
        # the wire is baked into the tick: the hub must assemble its shape
        common.update(span_wire=geo.get("span_wire", False),
                      hop_dft=geo.get("hop_dft", False),
                      audio_int16=geo.get("audio_int16", False), native=native)

    def tick(*args):
        # a shard's tensors are on its device: replay there
        return artifact.call("tick", *args, device=args[-1][0][0].device)

    if geo["kind"] == "av":
        def av_step(frames, video, vidx, peaks, active, carries):
            rest = (peaks, active, carries)
            return tick(frames, video, *(() if vidx is None else (vidx,)), *rest)
        return serve.MultiStreamAVVAD(facts, video_uint8=geo["video_uint8"],
                                      video_fps=geo.get("video_fps"),
                                      step_override=av_step, **common)
    if geo["kind"] == "video":
        def video_step(video, vidx, active, carries):
            return tick(video, *(() if vidx is None else (vidx,)), active, carries)
        return serve.MultiStreamVideoVAD(facts, video_uint8=geo["video_uint8"],
                                         video_fps=geo.get("video_fps"),
                                         step_override=video_step, **common)
    return serve.MultiStreamVAD(facts, step_override=tick, **common)


def _stat(norm_stats: Optional[dict], device, *keys):
    for k in keys:
        v = (norm_stats or {}).get(k)
        if v is not None:
            return torch.as_tensor(np.asarray(v, np.float32).reshape(-1),
                                   device=device)
    return None


@profiling.setup_span("setup.serving_fn")
def make_waveform_serving_fn(model: AVVAD | AudioVAD | RawAudioVAD | VideoVAD, *,
                             t_frames: Optional[int] = None,
                             fs: int = 16000,
                             wlen_sec: float = 64e-3, hop_percent: float = 0.25,
                             hop_dft: bool = False,
                             norm_stats: Optional[dict] = None,
                             eps: float = 1e-8, video_frame_indices=None,
                             device: str | torch.device | None = None) -> ServingStep:
    """AVVAD: -> ``fn(wave (B, n), video (B, T_src, 67, 67)) -> probs
    (B, T, 1)``, ``t_frames`` required; AudioVAD: -> ``fn(wave) -> probs``;
    RawAudioVAD: -> ``fn(wave) -> probs`` (B, out_frames, 1), the raw wave
    through its WaveNet encoder, no STFT and no normalisation; VideoVAD:
    -> ``fn(video) -> probs`` (the audio options unused for both). ``fn``
    is a ``ServingStep``, which ``ServingArtifact.build`` exports.

    The model moves to ``device`` (the card unless ``device="cpu"``) in
    eval mode. ``norm_stats`` with audio_mean/audio_std (or mean/std) and
    video_mean/video_std applies ``(x - mean) / (std + eps)``. The frontend
    runs with center=False, pad_at_end=True (``hop_dft``: on the
    hop-block DFT route of ``ops.stft``) and keeps the first ``t_frames``
    frames. ``video_frame_indices`` ((t_frames,) int) gathers
    camera-rate tower features onto the audio timeline.

    TF32 stays off for matmuls and cuDNN convolutions: the JAX package pins
    fp32 (Precision.HIGHEST) in the STFT DFT and the MCB matmuls, and its
    float convs run in the model dtype, never in TF32.

    The call is the ``setup.serving_fn`` set-up span; the frontend of each
    step the ``serve.frontend`` span."""
    if not isinstance(model, (AVVAD, AudioVAD, RawAudioVAD, VideoVAD)):
        raise TypeError(f"unsupported model for serving: {type(model)!r}")
    if isinstance(model, AVVAD) and t_frames is None:
        raise TypeError("AVVAD serving needs t_frames")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = model.to(dev).eval()
    a_mean = _stat(norm_stats, dev, "audio_mean", "mean")
    a_std = _stat(norm_stats, dev, "audio_std", "std")
    v_mean, v_std = _stat(norm_stats, dev, "video_mean"), _stat(norm_stats, dev, "video_std")
    idx = (None if video_frame_indices is None
           else torch.as_tensor(np.asarray(video_frame_indices), dtype=torch.long,
                                device=dev))

    def norm_video(video):
        video = torch.as_tensor(video, device=dev, dtype=torch.float32)
        if v_mean is not None:
            video = (video - v_mean) / (v_std + eps)
        return video

    if isinstance(model, RawAudioVAD):
        def raw_fn(wave):
            return torch.sigmoid(model(torch.as_tensor(wave, device=dev)))

        return ServingStep(model, raw_fn)

    if isinstance(model, VideoVAD):
        def video_fn(video):
            return torch.sigmoid(model(norm_video(video), video_frame_indices=idx))

        return ServingStep(model, video_fn)

    def frontend(wave):
        with profiling.span("serve.frontend"):
            wave = torch.as_tensor(wave, device=dev)
            feats = log_power_frontend(wave, fs=fs, wlen_sec=wlen_sec,
                                       hop_percent=hop_percent, center=False,
                                       pad_at_end=True, hop_dft=hop_dft)[:, :t_frames, :]
            if a_mean is not None:
                feats = (feats - a_mean) / (a_std + eps)
            return feats

    if isinstance(model, AudioVAD):
        def audio_fn(wave):
            return torch.sigmoid(model(frontend(wave)))

        return ServingStep(model, audio_fn)

    def fn(wave, video):
        return torch.sigmoid(model(frontend(wave), norm_video(video),
                                   video_frame_indices=idx))

    return ServingStep(model, fn)
