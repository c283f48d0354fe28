"""Training: losses, mixing, schedules, steps, metrics and the Trainer."""

from .losses import cross_entropy, mixup_criterion, soft_target_cross_entropy
from .metrics_logger import MetricsLogger
from .mixing import cutmix, mix_or_cutmix, mixup
from .schedules import warmup_cosine, warmup_cosine_min_lr
from .steps import (
    ClipAdamW,
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from .trainer import TrainConfig, Trainer

__all__ = [
    "ClipAdamW", "MetricsLogger", "TrainConfig", "TrainState", "Trainer",
    "cross_entropy", "cutmix", "make_eval_step", "make_optimizer",
    "make_train_step", "mix_or_cutmix", "mixup", "mixup_criterion",
    "soft_target_cross_entropy", "warmup_cosine", "warmup_cosine_min_lr",
]
