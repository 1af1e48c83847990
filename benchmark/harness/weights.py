"""Seeded weights and inputs, made on the device in a few large draws.

Every tensor of ``reference.model.state_shapes`` comes from one generator on
the device, seeded by ``--seed``: one normal draw for all float leaves, cut
into views and scaled by kind; the count sketches from two integer draws.
The same seed gives the same weights on the same kind of device."""

from __future__ import annotations

import math

import torch

from ..reference import model as ref


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 64))


def _scale(name: str, shape: tuple, hidden: int) -> tuple:
    """(mean, std) of a leaf by its kind: lecun-normal convolutions and
    Dense kernels, LSTM tensors of std 1/sqrt(3H) (torch's U(+-1/sqrt(H))
    has that std), BatchNorm affines and statistics around identity."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("w_ih", "w_hh") or (leaf == "bias" and ".layer_" in name):
        return 0.0, 1.0 / math.sqrt(3 * hidden)
    if leaf == "weight" and len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf == "weight":          # BatchNorm scale
        return 1.0, 0.1
    if leaf in ("bias", "running_mean"):
        return 0.0, 0.1
    if leaf == "running_var":     # exp of this draw: positive, around 1
        return 0.0, 0.2
    raise ValueError(f"no rule for weight {name!r}")


def make_weights(cfg: dict, g: torch.Generator, device: torch.device) -> dict:
    """name -> fp32 tensor on ``device`` for every leaf of the configuration,
    drawn from ``g`` (a generator on ``device``)."""
    shapes = ref.state_shapes(cfg)
    sketches = {k: s for k, s in shapes.items() if k.startswith("mcb.sketch")}
    floats = {k: s for k, s in shapes.items() if k not in sketches}
    flat = torch.randn(sum(math.prod(s) for s in floats.values()), generator=g,
                       device=device)
    out, at = {}, 0
    for name, shape in floats.items():
        n = math.prod(shape)
        mean, std = _scale(name, shape, cfg.get("lstm_hidden_size", 1))
        t = flat[at:at + n].view(shape) * std + mean
        out[name] = t.exp() if name.endswith("running_var") else t
        at += n
    if sketches:
        d_total = sum(s[0] for s in sketches.values())
        m = next(iter(sketches.values()))[1]
        hashes = torch.randint(0, m, (d_total,), generator=g, device=device)
        signs = torch.randint(0, 2, (d_total,), generator=g, device=device).float() * 2 - 1
        at = 0
        for name, (d, m) in sketches.items():
            dense = torch.zeros(d, m, device=device)
            dense[torch.arange(d, device=device), hashes[at:at + d]] = signs[at:at + d]
            out[name] = dense
            at += d
    return out


def to_host(w: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in w.items()}


def to_device(w: dict, device: torch.device) -> dict:
    return {k: v.to(device) for k, v in w.items()}
