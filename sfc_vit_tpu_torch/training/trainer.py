"""Epoch-level training on one device: counterpart of
``sfc_vit_tpu/training/trainer.py``.

``Trainer`` keeps the JAX Trainer's schedule and optimizer set-up, its
``init_params`` check, and ``train_epoch`` / ``evaluate`` / ``fit`` with
one host sync per epoch.  What needs more than one device or a
checkpoint store raises ``NotImplementedError`` naming its ROADMAP.md
item: the mesh options (data, model, pipeline and sequence parallelism,
FSDP: queue 1 item 13), and checkpointing, resume and TensorBoard under
``workdir`` (queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..utils.convert import _leaves, load_flax_params, to_flax_params
from .metrics_logger import MetricsLogger
from .schedules import warmup_cosine, warmup_cosine_min_lr
from .steps import TrainState, make_eval_step, make_optimizer, make_train_step

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    """The JAX TrainConfig's fields that a one-device trainer reads, and
    the multi-device / checkpoint ones, which it refuses."""

    num_classes: int = 10
    epochs: int = 300
    warmup_epochs: int = 10
    base_lr: float = 3e-4
    weight_decay: float = 5e-5
    grad_clip: float = 1.0
    mixup_alpha: float = 0.2
    cutmix_alpha: float = 1.0
    mix_prob: float = 0.5
    use_mixing: bool = True
    schedule: str = "cosine"  # "cosine" (HF math) | "cosine_min_lr"
    min_lr: float = 1e-6
    seed: int = 42
    grad_accum: int = 1
    workdir: Optional[str] = None
    data_parallel: int = -1  # -1: all devices, which is one here
    model_parallel: int = 1
    pipeline_parallel: int = 1
    fsdp: bool = False
    sequence_parallel: bool = False
    tensorboard: bool = False


def _refuse_unported(cfg: TrainConfig) -> None:
    parallel = "ROADMAP.md queue 1 item 13 (parallel)"
    checks = [
        (cfg.data_parallel not in (-1, 1), f"data_parallel={cfg.data_parallel}", parallel),
        (cfg.model_parallel != 1, f"model_parallel={cfg.model_parallel}", parallel),
        (cfg.pipeline_parallel != 1, f"pipeline_parallel={cfg.pipeline_parallel}", parallel),
        (cfg.fsdp, "fsdp=True", parallel),
        (cfg.sequence_parallel, "sequence_parallel=True", parallel),
        (cfg.workdir is not None, "workdir (checkpointing and resume)",
         "ROADMAP.md queue 1 item 8 (entry points: checkpoint.py)"),
        (cfg.tensorboard, "tensorboard=True",
         "ROADMAP.md queue 1 item 8 (entry points)"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"Trainer: {what} is not ported to PyTorch yet: {item}")


def _check_init_params(model: nn.Module, init_params) -> None:
    """The JAX Trainer's check: the same tree and the same leaf shapes
    as the model's own parameters."""
    want = {path: np.shape(v) for path, v in _leaves(init_params)}
    got = {path: np.shape(v) for path, v in _leaves(to_flax_params(model))}
    if set(want) != set(got):
        raise ValueError(
            f"init_params tree mismatch: missing {sorted(set(got) - set(want))}, "
            f"extra {sorted(set(want) - set(got))}")
    for path, shape in want.items():
        if shape != got[path]:
            raise ValueError(f"init_params leaf {'/'.join(path)} has shape "
                             f"{shape}, model expects {got[path]}")


def _to_device(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


class Trainer:
    """Train a model over iterable epochs of ``(images NHWC, labels)``
    batches on the device its parameters live on.

    ``train_data`` / ``eval_data`` of :meth:`fit` are callables returning
    a fresh iterator per epoch; images may be numpy or tensors, labels
    numpy or tensors.  ``init_params``: an optional flax parameter tree
    (same structure and shapes as the model's) to start from.
    """

    def __init__(self, model: nn.Module, config: TrainConfig,
                 steps_per_epoch: int, init_params=None) -> None:
        _refuse_unported(config)
        self.model = model
        self.config = config
        self.device = next(model.parameters()).device
        total_steps = config.epochs * steps_per_epoch
        warmup_steps = config.warmup_epochs * steps_per_epoch
        if config.schedule == "cosine":
            self.schedule = warmup_cosine(config.base_lr, warmup_steps,
                                          total_steps)
        elif config.schedule == "cosine_min_lr":
            self.schedule = warmup_cosine_min_lr(
                config.base_lr, warmup_steps, total_steps, config.min_lr)
        else:
            raise ValueError(f"unknown schedule {config.schedule!r}")
        if init_params is not None:
            _check_init_params(model, init_params)
            load_flax_params(model, init_params)
        optimizer = make_optimizer(model.parameters(), self.schedule,
                                   config.weight_decay, config.grad_clip)
        self.state = TrainState(model=model, optimizer=optimizer)
        # Mixing draws on the CPU; dropout on the model's device, from a
        # stream of its own (seed + 1: distinct even when both are CPU).
        self.generator = torch.Generator().manual_seed(config.seed)
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self._train_step = make_train_step(
            num_classes=config.num_classes, mixup_alpha=config.mixup_alpha,
            cutmix_alpha=config.cutmix_alpha, mix_prob=config.mix_prob,
            use_mixing=config.use_mixing, grad_accum=config.grad_accum)
        self._eval_step = make_eval_step(config.num_classes)
        self.logger = MetricsLogger(None)
        self.steps_per_epoch = steps_per_epoch

    def maybe_resume(self) -> bool:
        raise NotImplementedError(
            "Trainer.maybe_resume: checkpointing is not ported to PyTorch "
            "yet: ROADMAP.md queue 1 item 8 (entry points: checkpoint.py)")

    def restore_best(self) -> None:
        raise NotImplementedError(
            "Trainer.restore_best: checkpointing is not ported to PyTorch "
            "yet: ROADMAP.md queue 1 item 8 (entry points: checkpoint.py)")

    def _batch(self, batch):
        return (_to_device(batch[0], self.device),
                _to_device(batch[1], self.device, torch.long))

    def train_epoch(self, batches: Iterable) -> dict:
        losses, accs = [], []
        t0 = time.time()
        images = 0
        for batch in batches:
            x, y = self._batch(batch)
            m = self._train_step(self.state, (x, y), self.generator,
                                 self.dropout_generator)
            losses.append(m["loss"])
            accs.append(m["accuracy"])
            images += y.shape[0]
        # one host sync per epoch
        loss = float(torch.stack(losses).mean()) if losses else 0.0
        acc = float(torch.stack(accs).mean()) if accs else 0.0
        dt = time.time() - t0
        return {
            "train_loss": loss,
            "train_accuracy": acc,
            "images_per_sec": images / dt if dt > 0 else 0.0,
        }

    def evaluate(self, batches: Iterable) -> dict:
        ms = [self._eval_step(self.state, self._batch(b)) for b in batches]
        loss_sum = float(sum(m["loss_sum"] for m in ms)) if ms else 0.0
        correct = int(sum(m["correct"] for m in ms)) if ms else 0
        count = int(sum(m["count"] for m in ms)) if ms else 0
        return {
            "test_loss": loss_sum / max(1, count),
            "test_accuracy": correct / max(1, count),
        }

    def fit(self, train_data: Callable[[], Iterable],
            eval_data: Callable[[], Iterable],
            epochs: Optional[int] = None) -> dict:
        cfg = self.config
        epochs = epochs if epochs is not None else cfg.epochs
        if epochs > cfg.epochs:
            warnings.warn(
                f"fit(epochs={epochs}) exceeds the schedule horizon "
                f"(TrainConfig.epochs={cfg.epochs}): the LR schedule has "
                "fully decayed, so the extra epochs update at lr=min_lr "
                "(cosine_min_lr) or exactly 0 (cosine)",
                stacklevel=2,
            )
        best_acc = 0.0
        record = {}
        for epoch in range(epochs):
            record = {"epoch": epoch + 1}
            record.update(self.train_epoch(train_data()))
            record.update(self.evaluate(eval_data()))
            self.logger.log(record)
            best_acc = max(best_acc, record["test_accuracy"])
        record["best_test_accuracy"] = best_acc
        return record
