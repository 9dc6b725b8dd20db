"""Batch-inference CLI (reference ``bts_test.py``); counterpart of
``bts_tpu/cli/bts_test.py``.

:func:`predict` is the serving forward: config + model + batches of
``{"image": uint8 (B, H, W, 3), "focal": (B,)}`` -> the model's five outputs
per batch.  :func:`main` adds the split-file loader and writes uint16 depth
PNGs (KITTI x256 / NYU x1000) into ``--out_path`` (default
``result_<model_name>``), with optional colormapped previews
(``--save_cmap``) and per-scale LPG maps (``--save_lpg``).

``--checkpoint_path`` names one of three things
(``utils/weights.py::read_weights``):
a checkpoint directory that ``bts_main`` fills (its latest ``<step>.pt``),
one such trainer file (its ``"model"``), or a bare torch ``state_dict`` file,
as ``utils/weights.py::state_dict_from_jax`` and ``torch.save`` write it.
Without one, the seeded initialisation is used.  :func:`main` runs on
``--device`` (default ``cuda``; it raises when there is no card, and
``--device cpu`` runs on the CPU).  The loader and PNG I/O
(``bts_tpu_torch.data``, Pillow) are imported only by :func:`main`.

    python -m bts_tpu_torch.cli.bts_test @arguments/arguments_test_eigen.txt \\
        --checkpoint_path runs/bts_eigen_v2/ckpt
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from bts_tpu_torch.config import adopt_sidecar_geometry, parse_args, require_device
from bts_tpu_torch.data.augment import eval_preprocess
from bts_tpu_torch.models.bts import set_float32_precision
from bts_tpu_torch.utils.weights import restore_model


def predict(cfg, model, batches: Iterable[dict], device) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Forward each batch; yields the five outputs, each (B, 1, H, W) f32 on
    ``device``.  KITTI batches are scaled by their focal length."""
    set_float32_precision()
    use_focal = cfg.dataset == "kitti"
    for batch in batches:
        with torch.inference_mode():
            images = torch.as_tensor(batch["image"]).to(device)
            image = eval_preprocess(images).permute(0, 3, 1, 2).contiguous()
            focal = torch.as_tensor(batch["focal"]).to(device) if use_focal else None
            outs = model(image, focal)
        yield outs


def pred_name(image_path: str, data_path: str) -> str:
    """Collision-free prediction filename: the data_path-relative image path
    flattened with '_' (KITTI basenames repeat across drives)."""
    rel = os.path.relpath(image_path, data_path) if data_path else image_path
    rel = os.path.splitext(rel)[0]
    return rel.replace(os.sep, "_").replace("/", "_").lstrip("._")


def save_cmap_png(path: str, depth: np.ndarray, max_depth: float) -> None:
    """Colormapped preview (magma; grayscale without matplotlib)."""
    from PIL import Image

    norm = np.clip(depth / max_depth, 0.0, 1.0)
    try:
        from matplotlib import colormaps
    except ImportError:
        img = (norm * 255).astype(np.uint8)
    else:
        img = (colormaps["magma"](norm)[..., :3] * 255).astype(np.uint8)
    Image.fromarray(img).save(path)


def main(argv=None):
    from bts_tpu_torch.data.dataloader import BtsDataLoader
    from bts_tpu_torch.data.depth_io import write_depth_png

    cfg = parse_args(argv, mode="test")
    cfg = adopt_sidecar_geometry(cfg)  # trained-run stride-2 geometry, if recorded
    device = require_device(cfg)
    print(f"[bts_tpu_torch] device {device}")
    model = restore_model(cfg, device)
    loader = BtsDataLoader(cfg, "test")
    out_dir = cfg.out_path or f"result_{cfg.model_name}"
    os.makedirs(os.path.join(out_dir, "raw"), exist_ok=True)
    if cfg.save_cmap:
        os.makedirs(os.path.join(out_dir, "cmap"), exist_ok=True)
    lpg_names = ("8x8", "4x4", "2x2") if cfg.save_lpg else ()
    for k in lpg_names:
        os.makedirs(os.path.join(out_dir, f"lpg_{k}"), exist_ok=True)
    n_total = len(loader)

    def write_outputs(start, outs):
        """PNGs of one batch; the loader's pad samples in the tail batch
        (the last sample repeated) are skipped."""
        final = outs[4][:, 0].cpu().numpy()
        lpgs = [(k, outs[i][:, 0].cpu().numpy()) for i, k in enumerate(lpg_names)]
        for j in range(final.shape[0]):
            i = start + j
            if i >= n_total:
                break
            name = pred_name(loader.samples[i].image_path, cfg.data_path)
            write_depth_png(os.path.join(out_dir, "raw", name + ".png"), final[j], cfg.dataset)
            if cfg.save_cmap:
                save_cmap_png(os.path.join(out_dir, "cmap", name + ".png"), final[j], cfg.max_depth)
            for k, d in lpgs:
                path = os.path.join(out_dir, f"lpg_{k}", name + ".png")
                write_depth_png(path, d[j] * cfg.max_depth, cfg.dataset)
            if (i + 1) % 50 == 0:
                print(f"[bts_tpu_torch] {i + 1}/{n_total}", flush=True)
        return min(start + final.shape[0], n_total)

    start = 0
    for outs in predict(cfg, model, loader.prefetched(num_epochs=1), device):
        start = write_outputs(start, outs)
    print(f"[bts_tpu_torch] wrote {start} predictions to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
