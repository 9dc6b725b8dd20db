"""The 9-metric Eigen-split evaluation suite; counterpart of
``bts_tpu/evaluation/metrics.py``.

Given valid (masked, clamped) gt/pred depth vectors, return

    silog, abs_rel, log10, rms, sq_rel, log_rms, d1, d2, d3

with the standard BTS-lineage formulas:
    thresh  = max(gt/pred, pred/gt);  d_i = mean(thresh < 1.25**i)
    rms     = sqrt(mean((gt - pred)^2))
    log_rms = sqrt(mean((log gt - log pred)^2))
    abs_rel = mean(|gt - pred| / gt)
    sq_rel  = mean((gt - pred)^2 / gt)
    silog   = sqrt(mean(err^2) - mean(err)^2) * 100,  err = log pred - log gt
    log10   = mean(|log10 pred - log10 gt|)

Two implementations: numpy float64 (``bts_eval`` and online eval, on the
host), copied from the JAX package, and torch (:func:`compute_errors_torch`,
mask-weighted so shapes stay static, on whatever device its tensors lie).
"""

from __future__ import annotations

import numpy as np

METRIC_NAMES = (
    "silog",
    "abs_rel",
    "log10",
    "rms",
    "sq_rel",
    "log_rms",
    "d1",
    "d2",
    "d3",
)


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Reference-exact 9 metrics over already-masked 1-D gt/pred arrays."""
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    thresh = np.maximum(gt / pred, pred / gt)
    d1 = float((thresh < 1.25).mean())
    d2 = float((thresh < 1.25**2).mean())
    d3 = float((thresh < 1.25**3).mean())

    rms = float(np.sqrt(((gt - pred) ** 2).mean()))
    log_rms = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))

    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))

    err = np.log(pred) - np.log(gt)
    silog = float(np.sqrt(np.mean(err**2) - np.mean(err) ** 2) * 100)

    log10 = float(np.mean(np.abs(np.log10(pred) - np.log10(gt))))
    return np.array([silog, abs_rel, log10, rms, sq_rel, log_rms, d1, d2, d3])


def compute_errors_torch(gt, pred, mask):
    """Mask-weighted torch version (static shapes), the counterpart of the
    JAX package's ``compute_errors_jnp``.

    ``mask`` is a boolean tensor; invalid pixels contribute zero weight.  The
    formulas match :func:`compute_errors` on the masked subset; the result is
    a (9,) tensor in ``gt``'s floating dtype.
    """
    import torch  # lazy: keeps the numpy-only bts_eval free of torch

    w = mask.to(gt.dtype)
    n = w.sum().clamp_min(1.0)
    # guard invalid entries so log and division stay finite under the mask
    safe_gt = torch.where(mask, gt, torch.ones_like(gt))
    safe_pred = torch.where(mask, pred, torch.ones_like(pred))

    def mmean(x):
        return (x * w).sum() / n

    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    d1 = mmean((thresh < 1.25).to(gt.dtype))
    d2 = mmean((thresh < 1.25**2).to(gt.dtype))
    d3 = mmean((thresh < 1.25**3).to(gt.dtype))

    rms = torch.sqrt(mmean((safe_gt - safe_pred) ** 2))
    log_diff = torch.log(safe_gt) - torch.log(safe_pred)
    log_rms = torch.sqrt(mmean(log_diff**2))

    abs_rel = mmean((safe_gt - safe_pred).abs() / safe_gt)
    sq_rel = mmean((safe_gt - safe_pred) ** 2 / safe_gt)

    err = torch.log(safe_pred) - torch.log(safe_gt)
    # clamp: f32 cancellation can push the variance term slightly negative
    silog = torch.sqrt((mmean(err**2) - mmean(err) ** 2).clamp_min(0.0)) * 100.0

    log10 = mmean((torch.log10(safe_pred) - torch.log10(safe_gt)).abs())
    return torch.stack([silog, abs_rel, log10, rms, sq_rel, log_rms, d1, d2, d3])
