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

Spatial inference (``--spatial_shards N [--spatial_shards_w M]``) under
torchrun, laid out as ``bts_main``'s (``parallel/spatial.py``): the batch
over the D = world / (N*M) data groups (over one group when the batch does
not divide, as the JAX package shrinks its data axis), each frame in N x M
bands, and the bands of the five outputs gathered on the first rank of
each data group, which writes that group's PNGs (:func:`predict_banded`):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m bts_tpu_torch.cli.bts_test @arguments/arguments_test_eigen.txt --spatial_shards 2
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
from bts_tpu_torch.models.encoders import check_bands
from bts_tpu_torch.parallel import distributed as parallel
from bts_tpu_torch.parallel import spatial
from bts_tpu_torch.utils.profiling import span
from bts_tpu_torch.utils.weights import restore_model


def predict(cfg, model, batches: Iterable[dict], device) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Forward each batch; yields the five outputs, each (B, 1, H, W) f32 on
    ``device``.  KITTI batches are scaled by their focal length.  Each
    batch's work is one ``bts.predict`` span, closed before the yield."""
    set_float32_precision()
    use_focal = cfg.dataset == "kitti"
    for i, batch in enumerate(batches):
        with span("bts.predict", i), torch.inference_mode():
            with span("bts.input"):
                images = torch.as_tensor(batch["image"]).to(device)
                image = eval_preprocess(images).permute(0, 3, 1, 2).contiguous()
                focal = torch.as_tensor(batch["focal"]).to(device) if use_focal else None
            outs = model(image, focal)
        yield outs


def predict_banded(cfg, model, batches: Iterable[dict], device, n_data: int) -> Iterator[tuple]:
    """:func:`predict` on spatial bands: for each batch, this rank's data
    group's rows (of ``n_data`` groups; none past them) and its band of
    each frame go through the model, and the bands of the five outputs are
    gathered over the spatial group.  Yields (first row, the five whole
    outputs) on the group's first rank and (first row, None) elsewhere."""
    set_float32_precision()
    grid = spatial.grid()
    use_focal = cfg.dataset == "kitti"
    for i, batch in enumerate(batches):
        b = len(batch["image"])
        if grid.d >= n_data:
            yield 0, None
            continue
        rows = slice(grid.d * b // n_data, (grid.d + 1) * b // n_data)
        with span("bts.predict", i), torch.inference_mode():
            with span("bts.input"):
                images = torch.as_tensor(batch["image"][rows]).to(device)
                bands = spatial.bands(grid, images.shape[1], images.shape[2])
                image = bands.cut(eval_preprocess(images).permute(0, 3, 1, 2)).contiguous()
                focal = torch.as_tensor(batch["focal"][rows]).to(device) if use_focal else None
            with spatial.use(bands):
                outs = model(image, focal)
            outs = tuple(bands.gather(o) for o in outs)
        yield rows.start, outs if grid.writer else None


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
    cfg = parse_args(argv, mode="test")
    cfg = adopt_sidecar_geometry(cfg)  # trained-run stride-2 geometry, if recorded
    device = require_device(cfg)
    banded = cfg.spatial_shards * cfg.spatial_shards_w > 1
    if banded:
        check_bands(cfg.encoder)  # here, before the process group starts; create_model refuses only after it
    started = parallel.maybe_init_distributed(cfg) if banded else False
    try:
        return _test(cfg, parallel.local_device(device) if banded else device, banded)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _test(cfg, device, banded: bool) -> int:
    from bts_tpu_torch.data.dataloader import BtsDataLoader
    from bts_tpu_torch.data.depth_io import write_depth_png

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

    def write_outputs(start, outs) -> int:
        """PNGs of one batch's samples from ``start`` on; returns how many.
        The loader's pad samples in the tail batch (the last sample
        repeated) are skipped."""
        final = outs[4][:, 0].cpu().numpy()
        lpgs = [(k, outs[i][:, 0].cpu().numpy()) for i, k in enumerate(lpg_names)]
        for j in range(final.shape[0]):
            i = start + j
            if i >= n_total:
                return j
            name = pred_name(loader.samples[i].image_path, cfg.data_path)
            write_depth_png(os.path.join(out_dir, "raw", name + ".png"), final[j], cfg.dataset)
            if cfg.save_cmap:
                save_cmap_png(os.path.join(out_dir, "cmap", name + ".png"), final[j], cfg.max_depth)
            for k, d in lpgs:
                path = os.path.join(out_dir, f"lpg_{k}", name + ".png")
                write_depth_png(path, d[j] * cfg.max_depth, cfg.dataset)
            if (i + 1) % 50 == 0:
                print(f"[bts_tpu_torch] {i + 1}/{n_total}", flush=True)
        return final.shape[0]

    start = written = 0
    if banded:
        n_data = parallel.data_world()
        n_data = n_data if cfg.batch_size % n_data == 0 else 1
        if parallel.is_primary():
            print(f"[bts_tpu_torch] spatial inference: H over {cfg.spatial_shards} x W over "
                  f"{cfg.spatial_shards_w} processes, batch over {n_data}")
        for first, outs in predict_banded(cfg, model, loader.prefetched(num_epochs=1), device, n_data):
            if outs is not None:
                written += write_outputs(start + first, outs)
            start += cfg.batch_size
        parallel.barrier()
    else:
        for outs in predict(cfg, model, loader.prefetched(num_epochs=1), device):
            written += write_outputs(start, outs)
            start += outs[4].shape[0]
    if not banded or spatial.grid().writer:
        print(f"[bts_tpu_torch] wrote {written} predictions to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
