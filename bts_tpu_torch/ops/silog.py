"""Scale-invariant log (silog) training loss; counterpart of
``bts_tpu/ops/silog.py``.

    d    = log(pred[mask]) - log(gt[mask])
    loss = sqrt(mean(d^2) - variance_focus * mean(d)^2) * 10

with variance_focus = 0.85 by default.  The valid mask is ``gt > 1.0`` for
KITTI (sparse LiDAR) and ``gt > 0.1`` for NYU.  Mask-weighted, as the JAX
version, so an all-masked batch gives a finite loss.

The means run over every valid pixel of the batch, so the loss is not a mean
of per-sample terms: in a data-parallel step (``group``) the sums of d, d^2
and the pixel count are all-reduced before the square root, and every rank
holds the loss of the global batch.
"""

from __future__ import annotations

import torch
import torch.distributed.nn.functional as dist_fn


def silog_loss(depth_est, depth_gt, mask, variance_focus: float = 0.85, group=None) -> torch.Tensor:
    """Mask-weighted silog loss in f32 whatever the input dtype (the loss is a
    difference of means whose cancellation is catastrophic in bf16).

    ``group``: a process group over which the batch is split; the sums go
    through an autograd all-reduce, whose backward sums the cotangents of
    every rank, so each rank's gradient is N times its share and DDP's
    average over N ranks gives the gradient of the global loss."""
    mask = mask.float()
    est = torch.where(mask > 0, depth_est.float(), 1.0)
    gt = torch.where(mask > 0, depth_gt.float(), 1.0)
    d = (torch.log(est) - torch.log(gt)) * mask
    sums = torch.stack([d.sum(), (d * d).sum(), mask.sum()])
    if group is not None:
        sums = dist_fn.all_reduce(sums, group=group)
    n = sums[2].clamp_min(1.0)
    mean_d2 = sums[1] / n
    mean_d = sums[0] / n
    # max() guards the sqrt against tiny negative values from cancellation
    return torch.sqrt(torch.clamp_min(mean_d2 - variance_focus * mean_d * mean_d, 1e-12)) * 10.0


def default_mask(depth_gt: torch.Tensor, dataset: str) -> torch.Tensor:
    """Reference valid-pixel mask: gt > 1.0 (kitti) / gt > 0.1 (nyu)."""
    thresh = 0.1 if dataset == "nyu" else 1.0
    return depth_gt > thresh
