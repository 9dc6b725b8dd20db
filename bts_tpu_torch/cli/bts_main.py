"""Training driver (reference ``bts_main.py``); counterpart of
``bts_tpu/cli/bts_main.py``.

    python -m bts_tpu_torch.cli.bts_main @arguments/arguments_train_eigen.txt
    python -m bts_tpu_torch.cli.bts_main arguments/arguments_train_nyu.txt --device cpu

Pipeline: args -> loader -> model / optimizer -> train steps (augmentation,
forward, silog, backward, AdamW) -> TensorBoard scalars and depth images,
checkpoints every ``--save_freq`` steps and at the end, sample-exact resume,
a config sidecar beside the checkpoints, a SIGTERM stop that saves and
exits 0, and (``--do_online_eval``) the 9 metrics on the eval split every
``--eval_freq`` steps with a per-metric best checkpoint under
``ckpt_best/<metric>/``.  It runs on ``--device`` (default ``cuda``; it
raises when there is no card).

    python -m bts_tpu_torch.cli.bts_main @arguments/arguments_train_nyu.txt --do_online_eval \
        --data_path_eval D --gt_path_eval D --filenames_file_eval F --eval_freq 500

Data parallel: one process per card, launched by torchrun; ``--batch_size``
is the global batch, ``--num_devices`` (-1: the world size) must match
``--nproc_per_node`` x nodes, ``--shard_opt_state`` shards AdamW's moments
(ZeRO-1).  NCCL on the cards, gloo with ``--device cpu``:

    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m bts_tpu_torch.cli.bts_main @arguments/arguments_train_eigen.txt --shard_opt_state

Every rank trains on its rows of each global batch and runs the
visualisation forward and the online eval (the same whole frames on every
rank); rank 0 alone writes the config sidecar, checkpoints, summaries, best
checkpoints and the step log.  A checkpoint holds the whole state whatever
the world size, so a run resumes at another one, with or without spatial
sharding.  A SIGTERM stops every rank at the same ``--preempt_sync_freq``
step.

Spatial sharding: ``--spatial_shards N [--spatial_shards_w M]`` splits each
frame into N x M bands over as many processes (``parallel/spatial.py``);
the world holds D x N x M processes, the batch splits over the D data
groups.  ``input_height`` must divide by N and ``input_width`` by M, and
the LPG heads need ``input_height/(8*N)`` and ``input_width/(8*M)`` whole:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m bts_tpu_torch.cli.bts_main @arguments/arguments_train_eigen.txt \
        --spatial_shards 2 --spatial_shards_w 2

Input: a PNG-tree split file through the native C++ loader or PIL
(``--use_native_loader auto|always|never``), or ArrayRecord shards
(``--filenames_file 'DIR/train-*.array_record'``, written by
``python -m bts_tpu_torch.tools.make_records``); ``data/dataloader.py``.
``--debug_nans`` fails the step at the first module whose output holds a
NaN (``training/trainer.py::install_nan_checks``) and runs the backward in
autograd's anomaly mode.
"""

from __future__ import annotations

import os
import queue
import shutil
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from bts_tpu_torch.config import (
    adopt_sidecar_geometry,
    parse_args,
    require_device,
    write_config_sidecar,
)
from bts_tpu_torch.data.augment import eval_preprocess
from bts_tpu_torch.data.dataloader import BtsDataLoader
from bts_tpu_torch.evaluation.best import BestCheckpoints, BestTracker
from bts_tpu_torch.evaluation.metrics import METRIC_NAMES
from bts_tpu_torch.models.bts import create_model, set_float32_precision
from bts_tpu_torch.models.encoders import check_bands, resolved_pad
from bts_tpu_torch.ops.lpg import check_divisible
from bts_tpu_torch.parallel import distributed as parallel
from bts_tpu_torch.training.trainer import Trainer
from bts_tpu_torch.utils.checkpoint import CheckpointManager, restore_for_retrain
from bts_tpu_torch.utils.summary import SummaryWriter


def check_spatial(cfg) -> None:
    """The augmented frames are what is split into bands: their geometry must
    tile the N x M bands exactly, and the LPG heads' cells too; the encoder
    must run on bands."""
    n, m = cfg.spatial_shards, cfg.spatial_shards_w
    if n * m == 1:
        return
    check_bands(cfg.encoder)  # here, before the process group starts; create_model refuses only after it
    if cfg.input_height % n:
        raise SystemExit(f"input_height {cfg.input_height} not divisible by --spatial_shards {n}")
    if cfg.input_width % m:
        raise SystemExit(f"input_width {cfg.input_width} not divisible by --spatial_shards_w {m}")
    check_divisible(cfg.input_height, cfg.input_width, n, m)
    print(f"[bts_tpu_torch] spatial sharding: H over {n} x W over {m} processes")


def load_pretrained_encoder(model, path: str) -> None:
    """--pretrained_model: a torchvision DenseNet, ResNet, ResNeXt or
    MobileNetV2 ``state_dict`` into the encoder (the port's encoders have
    torchvision's names); the classifier (``classifier.``, ``fc.``) and the
    ``num_batches_tracked`` entries are not part of the encoder."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items()
          if not k.startswith(("classifier.", "fc.")) and not k.endswith("num_batches_tracked")}
    model.encoder.load_state_dict(sd, strict=True)


def online_eval(model, cfg, device, max_samples: int = 0):
    """Reference ``online_eval()``: forward the eval split, return the mean
    of the 9 metrics (None when no sample has a valid pixel); counterpart of
    ``bts_tpu/cli/bts_main.py::online_eval``.

    Metrics are taken against the full-resolution gt (a KB-cropped
    prediction is zero-padded back onto it), so the garg/eigen crop selects
    the pixels bts_eval and the published protocol select.  Frames go
    ``--batch_size`` at a time (KITTI without ``--do_kb_crop`` at batch 1:
    raw frames differ in size between drives); the tail batch is padded by
    repeating its last sample and the padded predictions are dropped.  A
    thread decodes image and gt PNGs ahead of the card, and the forward of
    batch i+1 is queued on the card before the host computes the metrics of
    batch i, with one device->host copy per batch.  The model runs in eval
    mode (train-mode BN without statistics updates under
    ``--bn_no_track_stats``, as its training does), under
    ``torch.inference_mode``, and goes back to train mode after.
    """
    if not cfg.filenames_file_eval:
        print("[bts_tpu_torch] --do_online_eval needs --filenames_file_eval; skipping")
        return None
    from bts_tpu_torch.cli.bts_eval import masked_errors, pad_pred_to_gt
    from bts_tpu_torch.data.dataloader import load_sample, parse_filenames_file
    from bts_tpu_torch.data.depth_io import read_depth_png

    samples = parse_filenames_file(cfg.filenames_file_eval, cfg.data_path_eval, cfg.gt_path_eval)
    if max_samples:
        samples = samples[:max_samples]
    samples = [s for s in samples if s.depth_path is not None]
    bs = 1 if cfg.dataset == "kitti" and not cfg.do_kb_crop else max(1, cfg.batch_size)
    q: queue.Queue = queue.Queue(maxsize=2)

    def producer():
        try:
            buf = []

            def flush(count):
                buf.extend([buf[-1]] * (bs - len(buf)))  # pad the tail batch
                q.put((np.stack([x[0] for x in buf]), np.array([x[1] for x in buf], np.float32),
                       [x[2] for x in buf], count))
                buf.clear()

            for s in samples:
                img, _, focal = load_sample(s, cfg.dataset, cfg.do_kb_crop, need_depth=False,
                                            border_crop=False)
                buf.append((img, focal, read_depth_png(s.depth_path, cfg.dataset)))
                if len(buf) == bs:
                    flush(bs)
            if buf:
                flush(len(buf))
        except Exception as e:  # surface loader errors on the consumer side
            q.put(e)
        q.put(None)

    threading.Thread(target=producer, daemon=True).start()
    accum = []

    def finish(pred, gts, count):
        preds = pred.cpu().numpy()  # one device->host copy per batch
        for j in range(count):
            p = pad_pred_to_gt(preds[j], gts[j].shape, cfg) if cfg.do_kb_crop else preds[j]
            errs = masked_errors(gts[j], p, cfg)
            if errs is not None:
                accum.append(errs)

    use_focal = cfg.dataset == "kitti"
    model.train(cfg.bn_no_track_stats)
    try:
        with torch.inference_mode():
            pending = None
            while (item := q.get()) is not None:
                if isinstance(item, Exception):
                    raise item
                imgs, focals, gts, count = item
                image = eval_preprocess(torch.from_numpy(imgs).to(device)).permute(0, 3, 1, 2)
                focal = torch.from_numpy(focals).to(device) if use_focal else None
                pred = model(image.contiguous(), focal)[4][:, 0]
                if pending is not None:
                    finish(*pending)
                pending = (pred, gts, count)
            if pending is not None:
                finish(*pending)
    finally:
        model.train()
    return np.mean(np.stack(accum), axis=0) if accum else None


def main(argv=None):
    cfg = parse_args(argv, mode="train")
    check_spatial(cfg)
    device = require_device(cfg)
    started = parallel.maybe_init_distributed(cfg)
    try:
        return train(cfg, parallel.local_device(device))
    finally:
        if started:
            dist.destroy_process_group()


def train(cfg, device):
    world, primary = parallel.world(), parallel.is_primary()
    if cfg.batch_size % parallel.data_world():
        raise SystemExit(f"batch_size {cfg.batch_size} not divisible by {parallel.data_world()} processes"
                         + ("" if parallel.data_world() == world else " (data groups)"))
    backend = f", {dist.get_backend()}" if parallel.initialized() else ""
    print(f"[bts_tpu_torch] device {device}, rank {parallel.rank()} of {world}{backend}")
    set_float32_precision()

    loader = BtsDataLoader(cfg, "train")
    steps_per_epoch = loader.steps_per_epoch()
    total_steps = steps_per_epoch * cfg.num_epochs
    log = print if primary else (lambda *a, **k: None)
    log(f"[bts_tpu_torch] {len(loader)} samples, {steps_per_epoch} steps/epoch, {total_steps} total")

    # resuming / fine-tuning: adopt the original run's stride-2 geometry
    logdir = os.path.join(cfg.log_directory or "runs", cfg.model_name)
    cfg = adopt_sidecar_geometry(cfg, extra_dirs=(logdir,))
    model = create_model(cfg, device)
    if cfg.pretrained_model:
        load_pretrained_encoder(model, cfg.pretrained_model)
        log(f"[bts_tpu_torch] encoder initialized from {cfg.pretrained_model}")
    trainer = Trainer(model, cfg, total_steps, device, augment=True)
    if primary:
        write_config_sidecar(cfg, logdir, resolved_pad(cfg))

    # --retrain restores FROM checkpoint_path and saves into a fresh
    # directory, with the step reset to 0
    save_dir = os.path.join(logdir, "ckpt")
    restore_dir = cfg.checkpoint_path or save_dir
    if cfg.retrain:
        if os.path.abspath(restore_dir) == os.path.abspath(save_dir):
            raise SystemExit(
                "--retrain restores weights and resets the step counter; give it a "
                "--checkpoint_path different from log_directory/model_name/ckpt"
            )
        src = CheckpointManager(restore_dir)
        if src.latest_step() is None:
            raise SystemExit(f"--retrain: no checkpoint found in {restore_dir}")
        restore_for_retrain(src, trainer)
        log(f"[bts_tpu_torch] retrain from {restore_dir} (step reset)")
        if primary and os.path.isdir(save_dir) and CheckpointManager(save_dir).steps():
            shutil.rmtree(save_dir)  # the old run's later steps would shadow the new run's
            print(f"[bts_tpu_torch] retrain: cleared stale checkpoints in {save_dir}")
        parallel.barrier()
        mgr = CheckpointManager(save_dir)
    else:
        mgr = CheckpointManager(restore_dir)
        if mgr.latest_step() is not None:
            trainer.load_state_dict(mgr.restore(map_location=device))
            log(f"[bts_tpu_torch] resumed @ step {trainer.step}")

    # the best value of each metric across online evals, resume-safe in a
    # JSON sidecar, and a per-metric best checkpoint (evaluation/best.py)
    best_tracker = BestTracker(logdir)
    best_ckpts = BestCheckpoints(os.path.join(logdir, "ckpt_best"))
    if cfg.retrain and best_tracker.best and primary:
        # a step-0 run must not compete against the old run's bar
        best_tracker.reset()
        best_ckpts.reset()
        print("[bts_tpu_torch] retrain: reset stale best-metric bar + best checkpoints")

    writer = eval_writer = None
    if primary:
        writer = SummaryWriter(logdir)
        # reference flag: a separate TensorBoard directory for the eval scalars
        eval_writer = (SummaryWriter(os.path.join(cfg.eval_summary_directory, cfg.model_name))
                       if cfg.eval_summary_directory else writer)
    t0 = time.time()
    last = {"t": t0, "step": trainer.step}
    stream = loader.batches(num_epochs=1)
    vis_image = torch.as_tensor(next(stream)["image"][:1, : cfg.input_height, : cfg.input_width])
    stream.close()

    def on_metrics(step, metrics):
        # TensorBoard depth and per-scale LPG images of a fixed crop; eval-mode
        # BN unless --bn_no_track_stats, whose runs keep no running statistics
        # (then its BatchNorms all-reduce, so every rank runs this forward)
        model.train(cfg.bn_no_track_stats)
        with torch.no_grad():
            image = eval_preprocess(vis_image.to(device)).permute(0, 3, 1, 2)
            d8, d4, d2, _, final = model(image)
        model.train()
        if not primary:
            return
        now = time.time()
        ips = (step - last["step"]) * cfg.batch_size / max(now - last["t"], 1e-9)
        last.update(t=now, step=step)
        writer.scalars(step, {"train/" + k: v for k, v in metrics.items()})
        writer.scalars(step, {"train/images_per_sec": ips})
        for tag, img in (("depth", final), ("lpg8x8", d8 * cfg.max_depth),
                         ("lpg4x4", d4 * cfg.max_depth), ("lpg2x2", d2 * cfg.max_depth)):
            writer.depth_image(step, f"train/{tag}", img[0, 0].cpu().numpy(), cfg.max_depth)
        print(f"step {step}/{total_steps} loss {metrics['loss']:.4f} "
              f"| {ips:.1f} img/s | elapsed {now - t0:.0f}s", flush=True)

    def on_eval(step):
        results = online_eval(model, cfg, device)
        if results is None or not primary:
            return
        eval_writer.scalars(step, dict(zip(("eval/" + n for n in METRIC_NAMES), results)))
        print("eval: " + " ".join(f"{n}={v:.4f}" for n, v in zip(METRIC_NAMES, results)), flush=True)
        # the sidecar is written only after the best checkpoints: a crash in
        # between must not leave a bar whose checkpoints do not exist
        improved = best_tracker.update(step, results, persist=False)
        if improved:
            best_ckpts.save(improved, step, model)
            best_tracker.persist()
            eval_writer.scalars(step, {f"eval/best_{n}": best_tracker.best[n]["value"] for n in improved})
            print(f"[bts_tpu_torch] new best @ step {step}: {', '.join(improved)}", flush=True)

    guard = None
    if cfg.preempt_sync_freq > 0:
        from bts_tpu_torch.utils.preemption import PreemptionGuard

        guard = PreemptionGuard(sync_freq=cfg.preempt_sync_freq, device=device)
    stream = loader.prefetched(start_step=trainer.step)  # sample-exact resume
    try:
        trainer.run(
            stream,
            total_steps - trainer.step,
            on_metrics,
            lambda step: trainer.save(mgr, step),
            on_eval if cfg.do_online_eval else None,
            profile_dir=os.path.join(logdir, "profile") if cfg.profile else None,
            should_stop=guard.should_stop if guard is not None else None,
        )
    finally:
        stream.close()  # stops the loader's threads (the native loader's C++ workers)
        if guard is not None:
            guard.uninstall()
    trainer.save(mgr, trainer.step)
    if primary:
        if eval_writer is not writer:
            eval_writer.close()
        writer.close()
    if guard is not None and guard.preempted:
        print(f"[bts_tpu_torch] preempted: checkpoint saved at step {trainer.step} "
              "— rerun the same command to resume")
    else:
        log(f"[bts_tpu_torch] done at step {trainer.step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
