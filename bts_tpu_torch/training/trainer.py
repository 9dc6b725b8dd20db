"""The training step and loop; counterpart of ``bts_tpu/training/trainer.py``.

One step (:meth:`Trainer.train_step`): the batch goes to the device,
augmentation on the card (or ``eval_preprocess`` with ``augment=False``),
the forward in train mode, the silog loss on the final depth, the backward
(K2 through the LPG heads' autograd Function) and one AdamW update with the
poly-decay schedule.  Parameters and optimizer state are f32; the forward
runs in the model's compute dtype; loss, BN and LPG maths are f32.

Augmentation draws come from a CPU ``torch.Generator`` seeded from
(seed, step[, microbatch]), so a run is reproducible whatever the host's
timing (JAX's per-step PRNG keys are not reproduced).

``--grad_accum_steps N`` splits the delivered batch into N microbatches:
gradients are averaged over them against constant parameters, BN running
statistics update sequentially, and one optimizer update follows.

Data parallel (a ``torch.distributed`` group, ``parallel/distributed.py``):
the model runs wrapped in ``DistributedDataParallel``, and the step equals
the one-process step on the same global batch.  Each rank gets its rows of
every global microbatch (``parallel.rank_rows``), draws the augmentation of
the whole global microbatch and keeps its rows, and (world size > 1)
all-reduces BatchNorm's moments and the silog sums, so every rank holds the
global loss; the backward of those all-reduces makes each rank's gradient N
times its share and DDP's average divides it back.  Microbatches before the
last run under ``no_sync``.  ``depth_mean`` is averaged over the ranks;
after DDP's all-reduce every rank holds the same gradient, so ``grad_norm``
is the global one.  ``state_dict`` and ``load_state_dict`` read and write
the unwrapped model; under ZeRO-1 :meth:`Trainer.save` gathers the
optimizer state on rank 0, which alone writes the checkpoint.

``--debug_nans`` (the counterpart of ``jax_debug_nans``): a forward hook on
every module raises ``FloatingPointError`` naming the module whose output
first holds a NaN (:func:`install_nan_checks`), and the step runs in
autograd's anomaly mode, which fails the backward at the first function
that returns a NaN and prints the forward line that made it.  Nothing is
installed without the flag.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.optim import ZeroRedundancyOptimizer
from torch.nn.parallel import DistributedDataParallel

from bts_tpu_torch.data.augment import augment_batch, eval_preprocess
from bts_tpu_torch.models.layers import BatchNorm
from bts_tpu_torch.ops.silog import default_mask, silog_loss
from bts_tpu_torch.parallel import distributed as parallel
from bts_tpu_torch.training.optimizer import freeze, make_optimizer


def step_generator(seed: int, step: int, micro: Optional[int] = None) -> torch.Generator:
    """The CPU generator of one step's (or microbatch's) augmentation draws."""
    key = [seed, step] if micro is None else [seed, step, micro]
    return torch.Generator().manual_seed(int(np.random.SeedSequence(key).generate_state(1)[0]))


def install_nan_checks(model: torch.nn.Module) -> list:
    """A forward hook on every module of ``model`` that raises
    ``FloatingPointError`` when a floating output holds a NaN, naming the
    module by its qualified name.  A module's hook runs after its
    children's, so the innermost module that made the NaN is named, and the
    forward stops there: under remat the recomputation in the backward never
    sees a NaN that the forward did not raise on.  Each check waits for the
    device.  Returns the hook handles."""

    def hook(name):
        def check(module, inputs, output):
            outs = output if isinstance(output, (tuple, list)) else (output,)
            for t in outs:
                if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"--debug_nans: NaN in the output of {name} ({type(module).__name__})")
        return check

    return [m.register_forward_hook(hook(name or "model")) for name, m in model.named_modules()]


class Trainer:
    """Owns the model in train mode, its optimizer and schedule, and the step
    counter; ``run`` is the loop with the log/save/eval/stop hooks."""

    def __init__(self, model: torch.nn.Module, cfg, total_steps: int, device, augment: bool = True):
        self.model = model.train()
        self.cfg = cfg
        self.device = torch.device(device)
        self.augment = augment
        self.step = 0
        self.rank, self.world = parallel.rank(), parallel.world()
        # the group the batch is split over (None: the batch is whole here)
        self.group = dist.group.WORLD if self.world > 1 else None
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.track_stats = not cfg.bn_no_track_stats
                m.process_group = self.group
        self.frozen = freeze(model, cfg)
        self.ddp = None
        if parallel.initialized():
            # frozen parameters (requires_grad False) are not DDP's; the
            # global BatchNorm keeps every rank's buffers equal, so rank 0's
            # are not broadcast before each forward
            self.ddp = DistributedDataParallel(
                model, device_ids=[self.device.index] if self.device.type == "cuda" else None,
                broadcast_buffers=False)
        self.optimizer, self.scheduler = make_optimizer(model, cfg, total_steps)
        self.params = [p for p in model.parameters() if p.requires_grad]
        if cfg.debug_nans:
            install_nan_checks(model)

    def _loss(self, images, depths, focal, gen: torch.Generator):
        cfg = self.cfg
        if self.augment:
            images, depths = augment_batch(
                images, depths, gen, out_h=cfg.input_height, out_w=cfg.input_width,
                dataset=cfg.dataset, degree=cfg.degree, do_random_rotate=cfg.do_random_rotate,
                share=(self.rank, self.world),
            )
        else:
            images, depths = eval_preprocess(images), depths.float()
        model = self.model if self.ddp is None else self.ddp
        outs = model(images.permute(0, 3, 1, 2), focal if cfg.dataset == "kitti" else None)
        final = outs[4][:, 0]
        loss = silog_loss(final, depths, default_mask(depths, cfg.dataset), cfg.variance_focus,
                          group=self.group)
        return loss, final

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One optimizer step on a host batch {'image': (B, H, W, 3) uint8,
        'depth': (B, H, W) f32, 'focal': (B,)}; returns device scalars
        (loss, depth_mean, grad_norm) and the learning rate applied.  In a
        data-parallel run the batch is this rank's rows of the global batch
        (``parallel.rank_rows``)."""
        dev = self.device
        images = torch.as_tensor(batch["image"]).to(dev, non_blocking=True)
        depths = torch.as_tensor(batch["depth"]).to(dev, non_blocking=True)
        focal = torch.as_tensor(batch["focal"]).to(dev, non_blocking=True)
        accum = max(1, int(self.cfg.grad_accum_steps))
        if images.shape[0] % accum:
            raise ValueError(
                f"batch_size {images.shape[0]} not divisible by --grad_accum_steps {accum}")
        mb = images.shape[0] // accum
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = depth_sum = 0.0
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            gen = step_generator(self.cfg.seed, self.step, None if accum == 1 else i)
            last = i == accum - 1
            with contextlib.ExitStack() as scope:
                if self.ddp is not None and not last:
                    scope.enter_context(self.ddp.no_sync())
                if self.cfg.debug_nans:
                    scope.enter_context(torch.autograd.set_detect_anomaly(True))
                loss, final = self._loss(images[sl], depths[sl], focal[sl], gen)
                (loss / accum).backward()
            loss_sum = loss_sum + loss.detach()
            depth_sum = depth_sum + final.detach().mean()
        if self.group is not None:
            dist.all_reduce(depth_sum, group=self.group)
            depth_sum = depth_sum / self.world
        grad_norm = torch.nn.utils.get_total_norm([p.grad for p in self.params if p.grad is not None])
        lr = self.scheduler.get_last_lr()[0]
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"loss": loss_sum / accum, "depth_mean": depth_sum / accum,
                "grad_norm": grad_norm, "learning_rate": lr}

    def state_dict(self) -> dict:
        """Model, optimizer, schedule and step.  Under ZeRO-1 every rank must
        call it (it gathers the optimizer state on rank 0), and only rank 0's
        holds the optimizer state (None elsewhere)."""
        opt = self.optimizer
        if isinstance(opt, ZeroRedundancyOptimizer):
            opt.consolidate_state_dict(to=0)
            opt_state = opt.state_dict() if parallel.is_primary() else None
        else:
            opt_state = opt.state_dict()
        return {"model": self.model.state_dict(), "optimizer": opt_state,
                "scheduler": self.scheduler.state_dict(), "step": self.step}

    def save(self, mgr, step: int) -> None:
        """Checkpoint into ``mgr`` (``utils/checkpoint.py``): every rank
        gathers, rank 0 writes, the others wait for it."""
        state = self.state_dict()
        if parallel.is_primary():
            mgr.save(step, state)
        parallel.barrier()

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])

    def run(
        self,
        batches,
        num_steps: int,
        on_metrics: Optional[Callable] = None,
        on_save: Optional[Callable] = None,
        on_eval: Optional[Callable] = None,
        profile_dir: Optional[str] = None,
        should_stop: Optional[Callable[[int], bool]] = None,
    ) -> int:
        """Up to ``num_steps`` steps over ``batches``; returns the step reached.

        ``on_metrics(step, metrics)`` runs on the first step and every
        ``log_freq`` steps, ``on_save(step)`` every ``save_freq``,
        ``on_eval(step)`` every ``eval_freq``; ``should_stop(step)`` ends the
        loop after a step (preemption).  ``profile_dir``: a ``torch.profiler``
        trace of steps 10..15, closed in ``finally`` when the loop ends early.
        """
        cfg = self.cfg
        prof = None
        try:
            for i, batch in enumerate(batches):
                if i >= num_steps:
                    break
                if profile_dir is not None and i == 10:
                    prof = _start_profile(self.device)
                if prof is not None and i == 15:
                    prof = _stop_profile(prof, profile_dir, self.device)
                metrics = self.train_step(batch)
                step = self.step
                if on_metrics is not None and (step % cfg.log_freq == 0 or i == 0):
                    on_metrics(step, {k: float(v) for k, v in metrics.items()})
                if on_save is not None and step % cfg.save_freq == 0:
                    on_save(step)
                if on_eval is not None and step % cfg.eval_freq == 0:
                    on_eval(step)
                if should_stop is not None and should_stop(step):
                    print(f"[bts_tpu_torch] stop requested: breaking at step {step}", flush=True)
                    break
        finally:
            if prof is not None:
                _stop_profile(prof, profile_dir, self.device)
            # an infinite train stream: closing it stops the loader's threads
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        return self.step


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profile(prof, profile_dir: str, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[bts_tpu_torch] profile written to {path}")
    return None
