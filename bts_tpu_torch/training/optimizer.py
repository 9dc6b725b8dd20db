"""Optimizer: AdamW (eps 1e-3) + polynomial LR decay, power 0.9; counterpart
of ``bts_tpu/training/optimizer.py``.

    lr(step) = (lr0 - end_lr) * (1 - min(step, total)/total)^0.9 + end_lr

with ``end_learning_rate -1`` meaning ``0.1 * lr0``; the step counts
optimizer updates from 0, as optax's schedule counts them.  Weight decay is
decoupled (AdamW), applied to every trainable tensor as optax.adamw does.
``--fix_first_conv_block(s)`` freezes the encoder stem and the first one or
two dense blocks: their parameters get ``requires_grad=False`` and are left
out of the optimizer, so neither the step nor the decay moves them.

``--shard_opt_state`` in a data-parallel run (world size > 1) is ZeRO-1:
``ZeroRedundancyOptimizer`` around the same AdamW, so each rank holds the
moments of about 1/N of the parameters, updates those and broadcasts them;
the trajectory is replicated AdamW's.  At world size 1 there is nothing to
shard and the flag leaves plain AdamW.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer

from bts_tpu_torch.models.encoders import freeze_prefixes
from bts_tpu_torch.parallel import distributed as parallel


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
                   ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW (ZeRO-1 under ``--shard_opt_state`` at world size > 1) over the
    trainable parameters and its poly-decay schedule."""
    params = [p for p in model.parameters() if p.requires_grad]
    kw = dict(lr=cfg.learning_rate, betas=(0.9, 0.999), eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
    if cfg.shard_opt_state and parallel.world() > 1:
        opt = ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.AdamW, **kw)
    else:
        opt = torch.optim.AdamW(params, **kw)
    lr0, end_lr = cfg.learning_rate, cfg.end_lr
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: poly_decay(step, lr0, end_lr, total_steps) / lr0)
    return opt, sched


def state_bytes(opt: torch.optim.Optimizer) -> int:
    """Bytes of optimizer state this rank holds (under ZeRO-1, its shard)."""
    inner = opt.optim if isinstance(opt, ZeroRedundancyOptimizer) else opt
    return sum(t.numel() * t.element_size() for st in inner.state.values()
               for t in st.values() if torch.is_tensor(t))
