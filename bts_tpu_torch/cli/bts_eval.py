"""Metric-evaluation entry point (reference ``bts_eval.py``); counterpart of
``bts_tpu/cli/bts_eval.py``.

Loads the GT depth PNGs (the split file and ``--gt_path``) and the
predicted PNGs (``--image_path`` or ``--out_path``: the ``raw/`` directory
``bts_test`` writes), clamps the predictions to [min_depth_eval,
max_depth_eval], applies the garg (KITTI default) or eigen (NYU) crop, and
prints the mean of the 9 metrics over the split.

It computes in numpy on the host and touches no device, like the reference
(torch is imported only for ``bts_test.pred_name``, the names bts_test
writes).

    python -m bts_tpu_torch.cli.bts_eval @arguments/arguments_eval_eigen.txt
"""

from __future__ import annotations

import os
import sys

import numpy as np

from bts_tpu_torch.config import parse_args
from bts_tpu_torch.data.crops import eigen_crop_mask, garg_crop_mask, kb_crop_box
from bts_tpu_torch.data.dataloader import parse_filenames_file
from bts_tpu_torch.data.depth_io import read_depth_png
from bts_tpu_torch.evaluation.metrics import METRIC_NAMES, compute_errors


def sanitize_pred(pred: np.ndarray, cfg) -> np.ndarray:
    """Reference NaN/Inf handling: NaN -> min_depth_eval, Inf -> max, clip."""
    pred = np.where(np.isnan(pred), cfg.min_depth_eval, pred)
    pred = np.where(np.isinf(pred), cfg.max_depth_eval, pred)
    return np.clip(pred, cfg.min_depth_eval, cfg.max_depth_eval)


def pad_pred_to_gt(pred: np.ndarray, gt_shape, cfg) -> np.ndarray:
    """Map a KB-cropped prediction back onto the full-resolution GT frame."""
    if pred.shape == tuple(gt_shape):
        return pred
    top, left, h, w = kb_crop_box(gt_shape[0], gt_shape[1])
    full = np.zeros(gt_shape, pred.dtype)
    full[top : top + h, left : left + w] = pred
    return full


def masked_errors(gt: np.ndarray, pred: np.ndarray, cfg):
    """Shared metric core of bts_eval and online eval: sanitize the pred,
    build the validity mask and the garg/eigen crop on the full-resolution
    gt, and return the 9 metrics (None when no pixel is valid)."""
    pred = sanitize_pred(pred, cfg)
    valid = (gt > cfg.min_depth_eval) & (gt < cfg.max_depth_eval)
    hh, ww = gt.shape
    if cfg.garg_crop:
        valid &= garg_crop_mask(hh, ww)
    elif cfg.eigen_crop:
        valid &= eigen_crop_mask(hh, ww, cfg.dataset)
    if valid.sum() == 0:
        return None
    return compute_errors(gt[valid], pred[valid])


def evaluate(cfg) -> np.ndarray:
    samples = parse_filenames_file(cfg.filenames_file, cfg.data_path, cfg.gt_path)
    pred_dir = cfg.image_path or cfg.out_path  # dir of predicted PNGs
    accum, missing = [], 0
    from bts_tpu_torch.cli.bts_test import pred_name  # the names bts_test writes

    for s in samples:
        if s.depth_path is None:
            continue
        pred_file = os.path.join(pred_dir, pred_name(s.image_path, cfg.data_path) + ".png")
        if not os.path.exists(pred_file):
            # legacy/basename layout fallback
            alt = os.path.join(pred_dir, os.path.splitext(os.path.basename(s.image_path))[0] + ".png")
            if os.path.exists(alt):
                pred_file = alt
            else:
                missing += 1
                continue
        gt = read_depth_png(s.depth_path, cfg.dataset)
        pred = read_depth_png(pred_file, cfg.dataset)
        if cfg.do_kb_crop:
            # the reference maps the 352x1216 prediction back onto full-res GT
            pred = pad_pred_to_gt(pred, gt.shape, cfg)
        errs = masked_errors(gt, pred, cfg)
        if errs is not None:
            accum.append(errs)
    if missing:
        print(f"[bts_tpu_torch] WARNING: {missing} predictions missing from {pred_dir}")
    if not accum:
        raise SystemExit("no valid samples evaluated")
    return np.mean(np.stack(accum), axis=0)


def print_table(results: np.ndarray) -> None:
    print(("{:>9}" * len(METRIC_NAMES)).format(*METRIC_NAMES))
    print(("{:9.4f}" * len(results)).format(*results))


def main(argv=None):
    cfg = parse_args(argv, mode="eval")
    results = evaluate(cfg)
    print_table(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
