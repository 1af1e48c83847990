"""The reference's (PyTorch) checkpoints into the port's models (port of
avvad_tpu/utils/torch_import.py).

The reference saved torch state dicts of DeepVAD_{audio,video,AV} (the
reference's scripts/train_AV_net.py:443-448): a torchvision ResNet-18
trunk wrapped in an ``nn.Sequential`` (``features.N.*``), ``nn.LSTM``
(``lstm_*``), ``nn.Linear`` (``vad_*``) and the MCB's count-sketch
buffers (``mcb.sketch{1,2}.{h,s}``) with its BatchNorm (``mcb_bn``). The
port keeps torch's layouts, so the conversions are renames, and:

- an LSTM's two biases summed into one and its weights transposed to the
  port's (in, 4H) (gate order [i, f, g, o] on both sides; the JAX
  package's models.lstm.lstm_import_torch_weights);
- each (h, s) pair made into the dense (d_in, out) sketch matrix
  (models/mcb.py:43 of the JAX package, ``sketch_matrix_from_hs``).

The JAX package returns Flax variables; here the result is a state dict
for the port's ``AudioVAD`` / ``VideoVAD`` / ``AVVAD`` (``load_state_dict``,
strict), BatchNorm statistics included. Entries the reference has no
counterpart for (``num_batches_tracked``, the int8 tower's scales) keep
the model's values.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# torchvision's children after the FC layer is stripped, by Sequential index
SEQ_IDX = {0: "conv1", 1: "bn1", 4: "layer1", 5: "layer2", 6: "layer3", 7: "layer4"}
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _t(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v), dtype=torch.float32)


def load_torch_state_dict(path: str) -> dict:
    """A torch ``.pt`` state dict as {name: numpy array} (CPU)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().numpy() for k, v in state.items()}


def sketch_matrix_from_hs(h, s, out_dim: int) -> np.ndarray:
    """The dense (in_dim, out_dim) sketch matrix of reference-style (h, s)
    buffers: row i holds s[i] at column h[i]."""
    in_dim = np.shape(h)[0]
    m = np.zeros((in_dim, out_dim), dtype=np.float32)
    m[np.arange(in_dim), np.asarray(h, dtype=np.int64)] = np.asarray(s, dtype=np.float32)
    return m


def _normalize_resnet_keys(state: Mapping, prefix: str) -> dict:
    """Strip ``prefix`` and map Sequential indices to torchvision names."""
    out = {}
    for k, v in state.items():
        if prefix and not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split(".")
        if parts[0].isdigit():
            if int(parts[0]) not in SEQ_IDX:
                continue
            parts[0] = SEQ_IDX[int(parts[0])]
        out[".".join(parts)] = v
    return out


def import_torch_resnet18(state: Mapping, prefix: str = "features.") -> dict:
    """A torchvision ResNet-18 trunk's state -> the port's ``ResNet18``
    state dict entries (``conv1.weight``, ``layer2_0.downsample_conv.weight``,
    BatchNorm weights and running statistics)."""
    s = _normalize_resnet_keys(state, prefix)
    out = {"conv1.weight": _t(s["conv1.weight"])}

    def bn(ours: str, theirs: str):
        for leaf in BN_LEAVES:
            out[f"{ours}.{leaf}"] = _t(s[f"{theirs}.{leaf}"])

    bn("bn1", "bn1")
    for stage in range(1, 5):
        for block in range(2):
            name, t = f"layer{stage}_{block}", f"layer{stage}.{block}"
            out[f"{name}.conv1.weight"] = _t(s[f"{t}.conv1.weight"])
            out[f"{name}.conv2.weight"] = _t(s[f"{t}.conv2.weight"])
            bn(f"{name}.bn1", f"{t}.bn1")
            bn(f"{name}.bn2", f"{t}.bn2")
            if f"{t}.downsample.0.weight" in s:
                # torch names the shortcut 'downsample.0' (conv) and '.1' (BN)
                out[f"{name}.downsample_conv.weight"] = _t(s[f"{t}.downsample.0.weight"])
                bn(f"{name}.downsample_bn", f"{t}.downsample.1")
    return out


def import_torch_lstm(state: Mapping, prefix: str) -> dict:
    """``nn.LSTM`` weights -> the port's ``LSTMStack`` entries
    (``layer_k.w_ih`` (in, 4H), ``layer_k.w_hh`` (H, 4H), ``layer_k.bias``
    the sum of torch's two)."""
    def key(name: str) -> str:
        return f"{prefix}.{name}" if prefix else name

    out, layer = {}, 0
    while key(f"weight_ih_l{layer}") in state:
        out[f"layer_{layer}.w_ih"] = _t(np.asarray(state[key(f"weight_ih_l{layer}")]).T)
        out[f"layer_{layer}.w_hh"] = _t(np.asarray(state[key(f"weight_hh_l{layer}")]).T)
        out[f"layer_{layer}.bias"] = _t(np.asarray(state[key(f"bias_ih_l{layer}")])
                                        + np.asarray(state[key(f"bias_hh_l{layer}")]))
        layer += 1
    return out


def import_torch_linear(state: Mapping, prefix: str) -> dict:
    """``nn.Linear`` -> the port's ``Linear`` entries (the same layout)."""
    out = {"weight": _t(state[f"{prefix}.weight"])}
    if f"{prefix}.bias" in state:
        out["bias"] = _t(state[f"{prefix}.bias"])
    return out


def _merge(model_state: Mapping, prefix: str, entries: dict) -> None:
    for k, v in entries.items():
        key = f"{prefix}.{k}"
        if key not in model_state:
            raise KeyError(f"{key}: not an entry of the model's state dict")
        if tuple(model_state[key].shape) != tuple(v.shape):
            raise ValueError(f"{key}: the checkpoint's shape {tuple(v.shape)}, the "
                             f"model's {tuple(model_state[key].shape)}")
        model_state[key] = v


def import_reference_audio_vad(state: Mapping, model_state: Mapping) -> dict:
    """DeepVAD_audio torch state dict (lstm_audio.*, vad_audio.*; the
    reference's Audio_Net.py:30-35) -> ``AudioVAD`` state dict, from the
    model's own ``model_state``."""
    out = dict(model_state)
    _merge(out, "lstm_audio", import_torch_lstm(state, "lstm_audio"))
    _merge(out, "vad_audio", import_torch_linear(state, "vad_audio"))
    return out


def import_reference_video_vad(state: Mapping, model_state: Mapping) -> dict:
    """DeepVAD_video torch state dict (features.* trunk, lstm_video.*,
    vad_video.*; the reference's Video_Net.py:35-51) -> ``VideoVAD``
    state dict."""
    out = dict(model_state)
    _merge(out, "tower.features", import_torch_resnet18(state, "features."))
    _merge(out, "lstm_video", import_torch_lstm(state, "lstm_video"))
    _merge(out, "vad_video", import_torch_linear(state, "vad_video"))
    return out


def import_reference_avvad(state: Mapping, model, model_state: Mapping | None = None) -> dict:
    """A full DeepVAD_AV torch state dict (the reference's AV_Net.py:12-141)
    -> ``AVVAD`` state dict: features.* -> tower.features, lstm_merged.*,
    vad_merged.*, and with ``model.use_mcb`` the sketches from their (h, s)
    buffers and mcb_bn.* ``model_state``: the model's own state dict (by
    default ``model.state_dict()``)."""
    out = dict(model.state_dict() if model_state is None else model_state)
    _merge(out, "tower.features", import_torch_resnet18(state, "features."))
    _merge(out, "lstm_merged", import_torch_lstm(state, "lstm_merged"))
    _merge(out, "vad_merged", import_torch_linear(state, "vad_merged"))
    if model.use_mcb:
        d = model.mcb_bn.num_features
        _merge(out, "mcb", {f"sketch{i}": torch.from_numpy(sketch_matrix_from_hs(
            state[f"mcb.sketch{i}.h"], state[f"mcb.sketch{i}.s"], d)) for i in (1, 2)})
        _merge(out, "mcb_bn", {leaf: _t(state[f"mcb_bn.{leaf}"]) for leaf in BN_LEAVES})
    return out


def random_reference_state(seed: int, h: int, mcb_out: int = 1024, layers: int = 2,
                           lstm_std: float = 0.1, head_std: float = 1.0) -> dict:
    """A DeepVAD_{audio,video,AV} state dict in the reference's layout (the
    three share nothing but the trunk), made from ``seed``, as the input of
    the importers in tests and smoke runs: {name: numpy array}.

    Drawn normal (LSTM weights at ``lstm_std``, heads at ``head_std``; the
    sketches' (h, s) uniform), then brought to the scales of a trained
    model: convolutions at He's scale, the trunk's BatchNorm statistics near
    0 and 1, the post-MCB BatchNorm's variances at the scale of the
    L2-normalised features, the first layers' input weights at a tenth (an
    imported checkpoint carries no normalisation statistics), the heads'
    biases 0 but the AV head's at -1.2."""
    rng = np.random.default_rng(seed)
    state = {}

    def bn(prefix, c):
        state[f"{prefix}.weight"] = rng.normal(size=c).astype(np.float32)
        state[f"{prefix}.bias"] = rng.normal(size=c).astype(np.float32)
        state[f"{prefix}.running_mean"] = rng.normal(size=c).astype(np.float32)
        state[f"{prefix}.running_var"] = np.abs(rng.normal(size=c)).astype(np.float32) + 0.5

    state["features.0.weight"] = rng.normal(size=(64, 3, 7, 7)).astype(np.float32)
    bn("features.1", 64)
    widths = (64, 128, 256, 512)
    for stage, seq in enumerate((4, 5, 6, 7)):
        w, w_in = widths[stage], widths[max(stage - 1, 0)]
        for block in range(2):
            t, cin = f"features.{seq}.{block}", (w_in if block == 0 else w)
            state[f"{t}.conv1.weight"] = rng.normal(size=(w, cin, 3, 3)).astype(np.float32)
            bn(f"{t}.bn1", w)
            state[f"{t}.conv2.weight"] = rng.normal(size=(w, w, 3, 3)).astype(np.float32)
            bn(f"{t}.bn2", w)
            if block == 0 and stage > 0:
                state[f"{t}.downsample.0.weight"] = rng.normal(size=(w, cin, 1, 1)).astype(
                    np.float32)
                bn(f"{t}.downsample.1", w)
    for prefix, d in (("lstm_merged", mcb_out), ("lstm_video", 512), ("lstm_audio", 513)):
        for layer in range(layers):
            din = d if layer == 0 else h
            for name, shape in ((f"weight_ih_l{layer}", (4 * h, din)),
                                (f"weight_hh_l{layer}", (4 * h, h)),
                                (f"bias_ih_l{layer}", (4 * h,)),
                                (f"bias_hh_l{layer}", (4 * h,))):
                state[f"{prefix}.{name}"] = (rng.normal(size=shape) * lstm_std).astype(np.float32)
    for head in ("vad_merged", "vad_video", "vad_audio"):
        state[f"{head}.weight"] = (rng.normal(size=(1, h)) * head_std).astype(np.float32)
        state[f"{head}.bias"] = (rng.normal(size=1) * head_std).astype(np.float32)
    for i, d in ((1, 513), (2, 512)):
        state[f"mcb.sketch{i}.h"] = rng.integers(0, mcb_out, d)
        state[f"mcb.sketch{i}.s"] = (rng.integers(0, 2, d) * 2 - 1).astype(np.float32)
    state["mcb_bn.weight"] = rng.uniform(0.5, 1.5, mcb_out).astype(np.float32)
    state["mcb_bn.bias"] = rng.normal(size=mcb_out).astype(np.float32) * 0.1
    state["mcb_bn.running_mean"] = rng.normal(size=mcb_out).astype(np.float32) * 0.01
    state["mcb_bn.running_var"] = rng.uniform(0.5, 1.5, mcb_out).astype(np.float32)

    for k, v in state.items():
        if not k.startswith("features."):
            continue
        if v.ndim == 4:
            state[k] = (v * np.sqrt(2.0 / np.prod(v.shape[1:]))).astype(np.float32)
        elif k.endswith("running_mean"):
            state[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k.endswith("running_var"):
            state[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k.endswith(".weight"):
            state[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k.endswith(".bias"):
            state[k] = (0.1 * v).astype(np.float32)
    state["mcb_bn.running_mean"] = np.zeros(mcb_out, np.float32)
    state["mcb_bn.running_var"] = rng.uniform(1e-6, 3e-6, mcb_out).astype(np.float32)
    state["lstm_merged.weight_ih_l0"] = state["lstm_merged.weight_ih_l0"] * 0.1
    state["lstm_audio.weight_ih_l0"] = state["lstm_audio.weight_ih_l0"] * 0.1
    for head in ("vad_merged", "vad_video", "vad_audio"):
        state[f"{head}.bias"] = np.zeros(1, np.float32)
    state["vad_merged.bias"] = np.float32([-1.2])
    return state
