"""Sequence/video inference entry point (reference ``bts_sequence.py``);
counterpart of ``bts_tpu/cli/bts_sequence.py``.

Globs a directory of frames (``--image_path``), forwards them in fixed-size
batches (``--batch_size``; the tail batch is padded with its last frame)
and writes per-frame uint16 depth PNGs, named by frame basename, into
``--out_path`` (default ``sequence_out``).  A decode thread reads and
KB-crops (``--do_kb_crop``) the frames ahead of the device; the forward of
batch i+1 is launched before the PNGs of batch i are written.  Runs on
``--device`` (default ``cuda``; it raises without a card, ``--device cpu``
runs on the CPU).  The JAX package's TPU batch-size warning
(``warn_b4_anomaly``) is not ported: the port's config dropped it.

    python -m bts_tpu_torch.cli.bts_sequence @arguments/arguments_test_eigen.txt \\
        --image_path frames/ --out_path depth/ --do_kb_crop --batch_size 4
"""

from __future__ import annotations

import glob
import os
import queue
import sys
import threading
import time

import numpy as np
import torch
from PIL import Image

from bts_tpu_torch.cli.bts_export import ServingForward
from bts_tpu_torch.config import adopt_sidecar_geometry, parse_args, require_device
from bts_tpu_torch.data.crops import kb_crop
from bts_tpu_torch.data.depth_io import write_depth_png
from bts_tpu_torch.models.bts import set_float32_precision
from bts_tpu_torch.utils.weights import restore_model


def frame_batches(files, batch: int, do_kb_crop: bool, q: "queue.Queue") -> None:
    """Decode ``files`` into (uint8 (batch, H, W, 3), names) items on ``q``;
    the tail is padded with its last frame (only its own names are listed);
    None ends the stream, an exception stands in for the rest of it."""
    try:
        buf, names = [], []
        for f in files:
            img = np.asarray(Image.open(f).convert("RGB"), np.uint8)
            buf.append(kb_crop(img) if do_kb_crop else img)
            names.append(os.path.splitext(os.path.basename(f))[0])
            if len(buf) == batch:
                q.put((np.stack(buf), names))
                buf, names = [], []
        if buf:  # pad the tail so every forward has the same shape
            q.put((np.stack(buf + [buf[-1]] * (batch - len(buf))), names))
        q.put(None)
    except Exception as e:  # handed to the main thread, which raises it
        q.put(e)


def main(argv=None):
    cfg = parse_args(argv, mode="sequence")
    cfg = adopt_sidecar_geometry(cfg)  # trained-run stride-2 geometry, if recorded
    device = require_device(cfg)
    files = sorted(
        sum((glob.glob(os.path.join(cfg.image_path, p)) for p in ("*.png", "*.jpg", "*.jpeg")), [])
    )
    if not files:
        raise SystemExit(f"no frames found in {cfg.image_path}")
    out_dir = cfg.out_path or "sequence_out"
    os.makedirs(out_dir, exist_ok=True)
    set_float32_precision()
    forward = ServingForward(restore_model(cfg, device))
    batch = max(1, cfg.batch_size)

    q: "queue.Queue" = queue.Queue(maxsize=2)
    threading.Thread(target=frame_batches, args=(files, batch, cfg.do_kb_crop, q), daemon=True).start()
    n, pending, t0 = 0, None, time.perf_counter()

    def flush(depth, names):
        nonlocal n
        depth = depth.cpu().numpy()  # waits for this batch's forward
        for j, name in enumerate(names):
            write_depth_png(os.path.join(out_dir, name + ".png"), depth[j, ..., 0], cfg.dataset)
            n += 1
        if n % 100 < batch:
            print(f"[bts_tpu_torch] {n}/{len(files)} frames", flush=True)

    # one-deep pipeline: launch the next batch's forward before copying and
    # encoding the previous batch's PNGs (device/host overlap)
    while (item := q.get()) is not None:
        if isinstance(item, Exception):
            raise item
        images, names = item
        x = torch.from_numpy(images)
        with torch.inference_mode():
            depth = forward(x.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else x)
        if pending is not None:
            flush(*pending)
        pending = (depth, names)
    if pending is not None:
        flush(*pending)
    print(f"[bts_tpu_torch] wrote {n} depth frames to {out_dir} "
          f"({n / (time.perf_counter() - t0):.2f} frames/s after the model restore)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
