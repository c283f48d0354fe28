"""Train and eval steps: counterpart of ``sfc_vit_tpu/training/steps.py``.

PyTorch runs eagerly, so a step is a plain function: mix, forward,
soft-target loss, backward (the encoder blocks' backward kernels on the
card), clip by global norm, AdamW.  The optimizer and the clipping are
plain PyTorch, as the JAX package leaves them to XLA.  The mixing draws
from a CPU generator and dropout from a second generator on the model's
device, as the JAX step splits its key into a mixing and a dropout key.
A ``'random'``-curve model draws its one token permutation of the step
from the mixing generator, shared by every micro-batch (JAX's ``k_perm``);
the eval step's is drawn from a generator seeded 0 (JAX's constant
``jax.random.key(0)``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import dropout_generator, permutation_generator
from .losses import soft_target_cross_entropy
from .mixing import mix_or_cutmix
from .schedules import Schedule

__all__ = ["ClipAdamW", "TrainState", "make_optimizer", "make_train_step",
           "make_eval_step"]


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, ...))``
    over a model's gradients.

    Clipping uses optax's formula: gradients pass unchanged where the
    global norm is below ``grad_clip``, else each becomes
    ``g / norm * grad_clip`` (no ``+1e-6`` as in ``clip_grad_norm_``),
    with no host sync.  AdamW is ``torch.optim.AdamW``, whose update
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` is optax's
    decoupled, lr-scaled decay.  The learning rate of each update is
    ``schedule(count)`` with ``count`` the number of updates before it,
    so the first runs at ``schedule(0)``, as in optax.
    """

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule,
                 weight_decay: float = 5e-5, grad_clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=(b1, b2),
                                       eps=eps, weight_decay=weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def global_norm(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()

    def step(self) -> float:
        """Clip, update; returns the learning rate the update used."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = self.global_norm()
        keep = norm < self.grad_clip
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.grad_clip))
        lr = float(self.schedule(self.count))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return lr


def make_optimizer(params: Iterable[torch.Tensor], schedule: Schedule,
                   weight_decay: float = 5e-5, grad_clip: float = 1.0,
                   b1: float = 0.9, b2: float = 0.999) -> ClipAdamW:
    """Clip-by-global-norm 1.0 + AdamW, the reference recipe."""
    return ClipAdamW(params, schedule, weight_decay, grad_clip, b1, b2)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of updates taken."""

    model: nn.Module
    optimizer: ClipAdamW
    step: int = 0


def _soft_targets(y_a, y_b, lam: torch.Tensor, num_classes: int):
    one_a = F.one_hot(y_a, num_classes).float()
    one_b = F.one_hot(y_b, num_classes).float()
    return lam * one_a + (1.0 - lam) * one_b


def make_train_step(num_classes: int, mixup_alpha: float = 0.2,
                    cutmix_alpha: float = 1.0, mix_prob: float = 0.5,
                    use_mixing: bool = True, grad_accum: int = 1) -> Callable:
    """Build ``step(state, batch, generator, dropout_gen=None) -> metrics``.

    ``batch`` is ``(images [B, H, W, C], labels [B])`` on the model's
    device; ``generator`` (a CPU ``torch.Generator``) draws the mixing and
    ``dropout_gen`` (a ``torch.Generator`` on the model's device) every
    dropout mask of the forward (None: PyTorch's default generator); a
    ``'random'``-curve model's token permutation comes from ``generator``
    too, once a step.
    Metrics: the loss, the lambda-weighted accuracy and the lr of the
    update (loss and accuracy stay on the device).

    ``grad_accum=A`` splits the mixed batch into A strided microbatches
    (rows ``i::A``, as the JAX step does) and averages their gradients
    before the one update: activation memory drops to one microbatch's.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum}: must be >= 1")

    def step(state: TrainState, batch: Tuple[torch.Tensor, torch.Tensor],
             generator: torch.Generator,
             dropout_gen: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        x, y = batch
        y = y.long()
        if use_mixing:
            x, y_a, y_b, lam = mix_or_cutmix(generator, x, y, mixup_alpha,
                                             cutmix_alpha, mix_prob)
        else:
            y_a = y_b = y
            lam = 1.0
        if x.shape[0] % grad_accum:
            raise ValueError(f"batch size {x.shape[0]} not divisible by "
                             f"grad_accum={grad_accum}")
        lam_t = torch.tensor(lam, dtype=torch.float32, device=x.device)
        model = state.model
        model.train()
        state.optimizer.zero_grad()
        losses, accs = [], []
        with permutation_generator(generator):  # one permutation a step
            for i in range(grad_accum):
                rows = slice(i, None, grad_accum)
                ya, yb = y_a[rows], y_b[rows]
                with dropout_generator(dropout_gen):
                    logits = model(x[rows])
                loss = soft_target_cross_entropy(
                    logits, _soft_targets(ya, yb, lam_t, num_classes))
                (loss / grad_accum).backward()
                preds = logits.detach().argmax(dim=-1)
                accs.append((lam_t * (preds == ya).float()
                             + (1.0 - lam_t) * (preds == yb).float()).mean())
                losses.append(loss.detach())
        lr = state.optimizer.step()
        state.step += 1
        return {"loss": torch.stack(losses).mean(),
                "accuracy": torch.stack(accs).mean(), "lr": lr}

    return step


def make_eval_step(num_classes: int) -> Callable:
    """Build ``step(state, batch) -> metrics`` with sum-reduced
    ``loss_sum`` / ``correct`` / ``count``.  Rows labelled -1 are padding
    and count in no metric.  A ``'random'``-curve model takes the same
    permutation on every call, drawn from a generator seeded 0."""

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        x, y = batch
        y = y.long()
        state.model.eval()
        with torch.no_grad(), permutation_generator(torch.Generator().manual_seed(0)):
            logits = state.model(x)
        valid = (y >= 0) & (y < num_classes)
        logp = F.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(-1, y.clamp(0, num_classes - 1)[:, None])[:, 0]
        return {
            "loss_sum": -(picked * valid).sum(),
            "correct": ((logits.argmax(dim=-1) == y) & valid).sum(),
            "count": valid.sum(),
        }

    return step
