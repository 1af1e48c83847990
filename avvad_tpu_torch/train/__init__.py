"""Training for the audio (``AudioVAD``), video (``VideoVAD``) and
audio-visual (``AVVAD``, the ResNet trunk frozen or not) models: state,
steps, checkpoints and the epoch loop (port of avvad_tpu/train). Entry
points run on ``cuda`` unless given ``device="cpu"``."""

from .checkpoint import (best_checkpoint, latest_checkpoint, load_pretrained_trunk,
                         prune_checkpoints, resolve_checkpoint, restore_checkpoint,
                         save_checkpoint)
from .state import (TrainState, create_train_state, make_optimizer,
                    trainable_except_video_trunk)
from .steps import make_eval_step, make_predict_step, make_train_step, normalize
from .trainer import MetricAccumulator, Trainer

__all__ = ["MetricAccumulator", "TrainState", "Trainer", "best_checkpoint",
           "create_train_state", "latest_checkpoint", "load_pretrained_trunk",
           "make_eval_step", "make_optimizer", "make_predict_step",
           "make_train_step", "normalize", "prune_checkpoints",
           "resolve_checkpoint", "restore_checkpoint", "save_checkpoint",
           "trainable_except_video_trunk"]
