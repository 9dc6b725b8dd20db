"""Optimizer: AdamW (eps 1e-3) + polynomial LR decay, power 0.9; counterpart
of ``bts_tpu/training/optimizer.py``.

    lr(step) = (lr0 - end_lr) * (1 - min(step, total)/total)^0.9 + end_lr

with ``end_learning_rate -1`` meaning ``0.1 * lr0``; the step counts
optimizer updates from 0, as optax's schedule counts them.  Weight decay is
decoupled (AdamW), applied to every trainable tensor as optax.adamw does.
``--fix_first_conv_block(s)`` freezes the encoder stem and the first one or
two dense blocks: their parameters get ``requires_grad=False`` and are left
out of the optimizer, so neither the step nor the decay moves them.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from bts_tpu_torch.models.encoders import freeze_prefixes


def poly_decay(step: int, lr: float, end_lr: float, total_steps: int, power: float = 0.9) -> float:
    """``optax.polynomial_schedule(lr, end_lr, power, total_steps)(step)``."""
    frac = 1.0 - min(max(step, 0), total_steps) / max(total_steps, 1)
    return (lr - end_lr) * frac**power + end_lr


def freeze(model: torch.nn.Module, cfg) -> List[str]:
    """Apply ``--fix_first_conv_block(s)`` to ``model``'s encoder; returns the
    frozen parameter names."""
    num = 2 if cfg.fix_first_conv_blocks else (1 if cfg.fix_first_conv_block else 0)
    if num == 0:
        return []
    prefixes = tuple(p + "." for p in freeze_prefixes(cfg.encoder, num))
    frozen = []
    for name, p in model.encoder.named_parameters():
        if name.startswith(prefixes):
            p.requires_grad_(False)
            frozen.append("encoder." + name)
    return frozen


def make_optimizer(model: torch.nn.Module, cfg, total_steps: int
                   ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over the trainable parameters and its poly-decay schedule."""
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
    lr0, end_lr = cfg.learning_rate, cfg.end_lr
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: poly_decay(step, lr0, end_lr, total_steps) / lr0)
    return opt, sched
