"""Training driver (reference ``bts_main.py``); counterpart of
``bts_tpu/cli/bts_main.py`` on one card.

    python -m bts_tpu_torch.cli.bts_main @arguments/arguments_train_eigen.txt
    python -m bts_tpu_torch.cli.bts_main arguments/arguments_train_nyu.txt --device cpu

Pipeline: args -> loader -> model / optimizer -> train steps (augmentation,
forward, silog, backward, AdamW) -> TensorBoard scalars and depth images,
checkpoints every ``--save_freq`` steps and at the end, sample-exact resume,
a config sidecar beside the checkpoints, and a SIGTERM stop that saves and
exits 0.  It runs on ``--device`` (default ``cuda``; it raises when there
is no card).

Not ported yet (each raises ``NotImplementedError``; ROADMAP.md): more than
one device (``--num_devices > 1``), ``--spatial_shards[_w]``,
``--shard_opt_state``, ``--do_online_eval``, ``--debug_nans`` and the
non-DenseNet encoders (``create_model``).
"""

from __future__ import annotations

import os
import shutil
import sys
import time

import torch

from bts_tpu_torch.config import (
    adopt_sidecar_geometry,
    parse_args,
    require_device,
    write_config_sidecar,
)
from bts_tpu_torch.data.augment import eval_preprocess
from bts_tpu_torch.data.dataloader import BtsDataLoader
from bts_tpu_torch.models.bts import create_model, set_float32_precision
from bts_tpu_torch.training.trainer import Trainer
from bts_tpu_torch.utils.checkpoint import CheckpointManager, restore_for_retrain
from bts_tpu_torch.utils.summary import SummaryWriter


def _refuse_unported(cfg) -> None:
    unported = {
        "--num_devices > 1 (data parallel, 'DDP/ZeRO')": cfg.num_devices > 1,
        "--spatial_shards[_w] ('Modules to port' 7)": cfg.spatial_shards > 1 or cfg.spatial_shards_w > 1,
        "--shard_opt_state ('DDP/ZeRO')": cfg.shard_opt_state,
        "--do_online_eval ('online eval + best checkpoints')": cfg.do_online_eval,
        "--debug_nans": cfg.debug_nans,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported to bts_tpu_torch yet (ROADMAP.md)")


def load_pretrained_encoder(model, path: str) -> None:
    """--pretrained_model: a torchvision DenseNet ``state_dict`` into the
    encoder (the port's encoder has torchvision's names); the classifier
    and ``num_batches_tracked`` entries are not part of the encoder."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items()
          if not k.startswith("classifier.") and not k.endswith("num_batches_tracked")}
    model.encoder.load_state_dict(sd, strict=True)


def main(argv=None):
    cfg = parse_args(argv, mode="train")
    _refuse_unported(cfg)
    device = require_device(cfg)
    print(f"[bts_tpu_torch] device {device}")
    set_float32_precision()

    loader = BtsDataLoader(cfg, "train")
    steps_per_epoch = loader.steps_per_epoch()
    total_steps = steps_per_epoch * cfg.num_epochs
    print(f"[bts_tpu_torch] {len(loader)} samples, {steps_per_epoch} steps/epoch, {total_steps} total")

    # resuming / fine-tuning: adopt the original run's stride-2 geometry
    logdir = os.path.join(cfg.log_directory or "runs", cfg.model_name)
    cfg = adopt_sidecar_geometry(cfg, extra_dirs=(logdir,))
    model = create_model(cfg, device)
    if cfg.pretrained_model:
        load_pretrained_encoder(model, cfg.pretrained_model)
        print(f"[bts_tpu_torch] encoder initialized from {cfg.pretrained_model}")
    trainer = Trainer(model, cfg, total_steps, device, augment=True)
    write_config_sidecar(cfg, logdir)

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
        print(f"[bts_tpu_torch] retrain from {restore_dir} (step reset)")
        if os.path.isdir(save_dir) and CheckpointManager(save_dir).steps():
            shutil.rmtree(save_dir)  # the old run's later steps would shadow the new run's
            print(f"[bts_tpu_torch] retrain: cleared stale checkpoints in {save_dir}")
        mgr = CheckpointManager(save_dir)
    else:
        mgr = CheckpointManager(restore_dir)
        if mgr.latest_step() is not None:
            trainer.load_state_dict(mgr.restore(map_location=device))
            print(f"[bts_tpu_torch] resumed @ step {trainer.step}")

    writer = SummaryWriter(logdir)
    t0 = time.time()
    last = {"t": t0, "step": trainer.step}
    stream = loader.batches(num_epochs=1)
    vis_image = torch.as_tensor(next(stream)["image"][:1, : cfg.input_height, : cfg.input_width])
    stream.close()

    def on_metrics(step, metrics):
        now = time.time()
        ips = (step - last["step"]) * cfg.batch_size / max(now - last["t"], 1e-9)
        last.update(t=now, step=step)
        writer.scalars(step, {"train/" + k: v for k, v in metrics.items()})
        writer.scalars(step, {"train/images_per_sec": ips})
        # TensorBoard depth and per-scale LPG images of a fixed crop; eval-mode
        # BN unless --bn_no_track_stats, whose runs keep no running statistics
        model.train(cfg.bn_no_track_stats)
        with torch.no_grad():
            image = eval_preprocess(vis_image.to(device)).permute(0, 3, 1, 2)
            d8, d4, d2, _, final = model(image)
        model.train()
        for tag, img in (("depth", final), ("lpg8x8", d8 * cfg.max_depth),
                         ("lpg4x4", d4 * cfg.max_depth), ("lpg2x2", d2 * cfg.max_depth)):
            writer.depth_image(step, f"train/{tag}", img[0, 0].cpu().numpy(), cfg.max_depth)
        print(f"step {step}/{total_steps} loss {metrics['loss']:.4f} "
              f"| {ips:.1f} img/s | elapsed {now - t0:.0f}s", flush=True)

    guard = None
    if cfg.preempt_sync_freq > 0:
        from bts_tpu_torch.utils.preemption import PreemptionGuard

        guard = PreemptionGuard()
    try:
        trainer.run(
            loader.prefetched(start_step=trainer.step),  # sample-exact resume
            total_steps - trainer.step,
            on_metrics,
            lambda step: mgr.save(step, trainer.state_dict()),
            profile_dir=os.path.join(logdir, "profile") if cfg.profile else None,
            should_stop=guard.should_stop if guard is not None else None,
        )
    finally:
        if guard is not None:
            guard.uninstall()
    mgr.save(trainer.step, trainer.state_dict())
    writer.close()
    if guard is not None and guard.preempted:
        print(f"[bts_tpu_torch] preempted: checkpoint saved at step {trainer.step} "
              "— rerun the same command to resume")
    else:
        print(f"[bts_tpu_torch] done at step {trainer.step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
