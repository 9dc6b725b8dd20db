"""One BTS training step in plain PyTorch: augmentation, the forward in
train mode, the scale-invariant log loss and AdamW with polynomial decay.

- silog (BTS eq. 7): over the valid pixels (depth > 1.0 for KITTI, > 0.1
  for NYU), d = log(pred) - log(gt),
  loss = 10 * sqrt(mean(d^2) - variance_focus * mean(d)^2);
- AdamW (betas 0.9, 0.999; eps and decoupled weight decay from the
  configuration): p <- p (1 - lr wd); m, v the moment estimates;
  p <- p - lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps);
- the learning rate of update s (from 0):
  (lr0 - end) * (1 - min(s, total) / total)^0.9 + end, end = lr0 / 10
  unless the configuration gives it.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import augment
from .model import forward

BETAS = (0.9, 0.999)


def silog(pred: torch.Tensor, gt: torch.Tensor, dataset: str, variance_focus: float) -> torch.Tensor:
    mask = gt > (0.1 if dataset == "nyu" else 1.0)
    d = torch.log(pred[mask]) - torch.log(gt[mask])
    return torch.sqrt(torch.clamp_min((d * d).mean() - variance_focus * d.mean() ** 2, 1e-12)) * 10.0


def learning_rate(step: int, train: dict) -> float:
    lr0 = train["learning_rate"]
    end = train["end_learning_rate"] if train["end_learning_rate"] > 0 else 0.1 * lr0
    total = train["total_steps"]
    return (lr0 - end) * (1.0 - min(step, total) / total) ** 0.9 + end


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], train: dict):
        self.params, self.train = params, train
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr, wd, eps = learning_rate(self.t, self.train), self.train["weight_decay"], self.train["adam_eps"]
        self.t += 1
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            p.mul_(1 - lr * wd)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr / bc1 * self.m[n] / (self.v[n].sqrt() / bc2 ** 0.5 + eps))


def step(params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor], opt: AdamW, batch: dict,
         seed: int, model: dict, train: dict, quant=None):
    """One step on a host batch {'image', 'depth', 'focal'} already on the
    device; updates ``params`` (through ``opt``) and ``buffers`` in place.
    Returns (loss, {name: gradient}, the predicted depth (B, 1, H, W))."""
    images, depths = batch["image"], batch["depth"]
    b, h, w = images.shape[:3]
    d = augment.draws(seed, opt.t, b, h, w, train["input_height"], train["input_width"],
                      model["dataset"], train["degree"])
    img, gt = augment.augment(images, depths, d, train["input_height"], train["input_width"],
                              train["degree"], train["do_random_rotate"])
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    focal = batch["focal"] if model["dataset"] == "kitti" else None
    outs = forward({**leaves, **buffers}, img.permute(0, 3, 1, 2), focal, encoder=model["encoder"],
                   bts_size=model["bts_size"], max_depth=model["max_depth"], train=True, quant=quant)
    loss = silog(outs[4][:, 0], gt, model["dataset"], train["variance_focus"])
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    opt.step(grads)
    return loss.detach(), grads, outs[4].detach()
