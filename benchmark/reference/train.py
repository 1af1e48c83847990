"""Plain PyTorch reference of the training step: the fp32 model in train
mode (every BatchNorm on batch statistics; the video trunk frozen, so no
gradient reaches it), the masked per-sequence BCE (the sum over sequences of
each one's mean over its valid frames), autograd, and Adam (bias-corrected
moments, eps added outside the square root). TF32 is off unless the caller
asks for it (the lower-precision control).
"""

from __future__ import annotations

import torch

from . import model as ref


def trainable(cfg: dict) -> list:
    """Names of the leaves Adam updates: all but the video trunk's."""
    return [k for k in ref.state_shapes(cfg)
            if not k.startswith("tower.features.") and not k.startswith("mcb.sketch")
            and "running_" not in k]


def masked_sequence_bce(logits, target, mask, eps: float = 1e-8):
    elt = (target * torch.log(torch.sigmoid(logits) + eps)
           + (1.0 - target) * torch.log(torch.sigmoid(-logits) + eps)) * mask[..., None]
    frames = mask.sum(dim=1)
    per_seq = -elt.sum(dim=(1, 2)) / torch.clamp(frames * logits.shape[-1], min=1.0)
    return torch.sum(per_seq * (frames > 0))


def logits(w: dict, cfg: dict, batch: dict) -> torch.Tensor:
    layers, dt = cfg["lstm_layers"], torch.float32
    if cfg["model"] == "AudioVAD":
        y = ref.lstm_stack(batch["audio"].float(), w, "lstm_audio", layers, dt)
        return ref.head(y, w, "vad_audio")
    video = batch["video"]
    b, t = video.shape[:2]
    with torch.no_grad():
        frames = video.reshape(b * t, 1, *video.shape[2:]).float()
        v = ref.float_trunk(frames, w, cfg, train=True).reshape(b, t, -1)
    y = ref.fuse(batch["audio"].float(), v, w, cfg, train=True)
    y = ref.lstm_stack(y, w, "lstm_merged", layers, dt)
    return ref.head(y, w, "vad_merged")


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g)).mul_(self.b1).add_(g, alpha=1 - self.b1)
            v = self.v.setdefault(k, torch.zeros_like(g)).mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            params[k].sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def run(w0: dict, cfg: dict, batches: list, lr: float, use_tf32: bool = False,
        loss_scale: float = 1.0, adam: dict | None = None) -> dict:
    """Train ``len(batches)`` steps from the weights ``w0`` (not modified)
    -> {"losses": [float], "grads1": {leaf: first step's gradient},
    "params": {leaf: trained value after the last step}}. ``adam``: the
    optimizer state to go on from, {"m": {leaf: ...}, "v": {leaf: ...},
    "t": steps taken}; else a fresh one. ``loss_scale`` multiplies the loss
    (a planted fault's, in the readings tool)."""
    names = trainable(cfg)
    w = {k: v.detach().clone() for k, v in w0.items()}
    opt = Adam(lr)
    if adam is not None:
        opt.m = {k: v.clone() for k, v in adam["m"].items()}
        opt.v = {k: v.clone() for k, v in adam["v"].items()}
        opt.t = adam["t"]
    losses, grads1 = [], None
    with ref.tf32(use_tf32):
        for batch in batches:
            leaves = {k: w[k].requires_grad_(True) for k in names}
            loss = loss_scale * masked_sequence_bce(logits(w, cfg, batch), batch["label"],
                                                    batch["mask"])
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
            for k in names:
                w[k] = w[k].detach()
            opt.step(w, grads)
            losses.append(float(loss.detach()))
            if grads1 is None:
                grads1 = grads
    return {"losses": losses, "grads1": grads1, "params": {k: w[k] for k in names}}
