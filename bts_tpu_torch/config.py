"""Config system: dataclass config + reference-compatible CLI parser.

The port's own copy of ``bts_tpu/config.py`` (which it may not import): the
same flags, so every ``arguments_*.txt`` file parses unmodified, plus
``--device``.  Arguments files are accepted both as ``@arguments_train_nyu.txt``
(argparse fromfile syntax) and as a bare positional first token (upstream
style: ``python bts_main.py arguments_train_nyu.txt``).

Flags the JAX package needs for its TPU mesh or its XLA lowering are kept
so arg-files still load; the drivers raise on values the port does not
implement (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Config:
    # -- identity / mode
    mode: str = "train"  # train | test | eval | sequence
    model_name: str = "bts_v1"
    # -- model
    encoder: str = "densenet161_bts"
    bts_size: int = 512  # decoder num_features
    max_depth: float = 80.0
    # -- data
    dataset: str = "kitti"  # kitti | nyu
    data_path: str = ""
    gt_path: str = ""
    filenames_file: str = ""
    input_height: int = 352
    input_width: int = 704
    do_kb_crop: bool = False
    use_right: bool = False
    # -- augmentation
    do_random_rotate: bool = False
    degree: float = 1.0
    # -- training
    batch_size: int = 4
    num_epochs: int = 50
    learning_rate: float = 1e-4
    end_learning_rate: float = -1.0  # -1 => 0.1 * learning_rate (reference default)
    variance_focus: float = 0.85
    weight_decay: float = 1e-2
    adam_eps: float = 1e-3
    retrain: bool = False
    fix_first_conv_blocks: bool = False
    fix_first_conv_block: bool = False
    bn_no_track_stats: bool = False
    # -- checkpoint / logging
    checkpoint_path: str = ""
    log_directory: str = ""
    log_freq: int = 100
    save_freq: int = 500
    pretrained_model: str = ""  # torchvision encoder state_dict (.pth)
    torch_checkpoint: str = ""  # full BTS torch checkpoint (the JAX package's bts_convert)
    # -- online eval
    do_online_eval: bool = False
    data_path_eval: str = ""
    gt_path_eval: str = ""
    filenames_file_eval: str = ""
    min_depth_eval: float = 1e-3
    max_depth_eval: float = 80.0
    eigen_crop: bool = False
    garg_crop: bool = False
    eval_freq: int = 500
    eval_summary_directory: str = ""
    # -- multi-device
    num_devices: int = -1  # processes (one per card) under torchrun; -1 => the world size
    num_threads: int = 1
    # -- test / sequence drivers
    image_path: str = ""
    out_path: str = ""
    save_lpg: bool = False
    save_cmap: bool = False
    # -- device and kernel knobs
    device: str = "cuda"  # cuda | cpu; a driver asked for cuda without a card raises
    profile: bool = False  # torch.profiler trace of steps 10..15 into the log dir
    debug_nans: bool = False
    remat: bool = False  # recompute encoder activations in the backward (larger batches)
    remat_policy: str = "layer"  # layer | block | convs (DenseNet remat granularity)
    compute_dtype: str = "bfloat16"  # forward/backward compute dtype
    use_pallas: str = "auto"  # auto | always | never: the hand-written kernels or their plain versions
    fused_tail: str = "auto"  # auto | always | never; auto = the literal decoder tail
    upconv_bwd: str = "auto"  # parsed for arg-file compatibility: the port's one UpConv backward is autograd's, the counterpart of "dilated" (the literal custom VJP exists in the JAX package only for GSPMD's spatial sharding)
    encoder_pad: str = "auto"  # auto | same | torch; stride-2 window alignment in the encoder — torchvision weights (--pretrained_model) need "torch" or they land one pixel off at every downsampling stage; "auto" = torch when --pretrained_model is set (TF-SAME for efficientnet_b5_bts, whose weights are TF-ported; recorded in the run's config sidecar so test/eval restore matches), else TF-SAME
    use_native_loader: str = "auto"  # auto | always | never (C++ decode path)
    shard_opt_state: bool = False  # ZeRO-1 optimizer-state sharding
    spatial_shards: int = 1  # split each frame's height into this many bands, one process each (parallel/spatial.py)
    spatial_shards_w: int = 1  # and its width into this many
    grad_accum_steps: int = 1  # microbatches per optimizer step (batch_size must divide)
    dataloader_workers: int = 2
    seed: int = 0  # base seed for init, augmentation draws, loader shuffle
    preempt_sync_freq: int = 10  # SIGTERM guard cadence (0 disables the guard)
    # -- serving export / server (JAX package drivers)
    export_path: str = ""
    export_platforms: str = ""
    serve_port: int = 8502
    serve_linger_ms: float = 5.0

    @property
    def end_lr(self) -> float:
        return self.end_learning_rate if self.end_learning_rate > 0 else 0.1 * self.learning_rate

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def write_config_sidecar(cfg: Config, logdir: str, encoder_pad: str) -> str:
    """Record the run's full flag surface next to the checkpoints, plus the
    resolved stride-2 geometry ``encoder_pad``
    (``models/encoders::resolved_pad``), so restore-side drivers reproduce
    it without the train-only flags."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "config.json")
    rec = dataclasses.asdict(cfg)
    rec["encoder_pad_resolved"] = encoder_pad
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    return path


def adopt_sidecar_geometry(cfg: Config, extra_dirs: tuple = ()) -> Config:
    """For drivers restoring a checkpoint: if ``encoder_pad`` is 'auto' and a
    training-run config sidecar is found next to the checkpoint, adopt its
    resolved stride-2 geometry — a checkpoint fine-tuned from torch weights
    must be evaluated with torch window alignment."""
    if cfg.encoder_pad != "auto" or cfg.pretrained_model:
        return cfg
    dirs = list(extra_dirs)
    if cfg.checkpoint_path:
        ab = os.path.abspath(cfg.checkpoint_path)
        dirs += [ab, os.path.dirname(ab)]
    for d in dirs:
        path = os.path.join(d, "config.json")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            pad = rec.get("encoder_pad_resolved") or rec.get("encoder_pad")
            if pad in ("same", "torch"):
                if pad != "same":
                    print(f"[bts_tpu_torch] encoder_pad={pad} (from {path})")
                return cfg.replace(encoder_pad=pad)
    return cfg


def _convert_arg_line_to_args(arg_line: str):
    """Reference-compatible arg-file line splitting: each whitespace-separated
    token on a line becomes an argument; ``#`` starts a comment."""
    for arg in arg_line.split():
        if not arg.strip():
            continue
        if arg.startswith("#"):
            break
        yield arg


def build_parser(mode: Optional[str] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="bts_tpu_torch: BTS (arXiv:1907.10326) in PyTorch",
        fromfile_prefix_chars="@",
    )
    parser.convert_arg_line_to_args = _convert_arg_line_to_args

    defaults = Config()
    for f in dataclasses.fields(Config):
        flag = "--" + f.name
        default = getattr(defaults, f.name)
        if f.type == "bool" or isinstance(default, bool):
            parser.add_argument(flag, action="store_true", default=default)
        elif f.name == "batch_size":
            # sentinel default: the test/sequence drivers run batch-1 like the
            # reference unless --batch_size is given explicitly
            parser.add_argument(flag, type=int, default=None)
        else:
            # dataclass field types arrive as strings under PEP 563
            typ = {int: int, float: float, str: str}[type(default)]
            parser.add_argument(flag, type=typ, default=default)
    if mode is not None:
        parser.set_defaults(mode=mode)
    return parser


def parse_args(argv: Optional[List[str]] = None, mode: Optional[str] = None) -> Config:
    """Parse CLI args into a Config.

    Accepts both ``prog @arguments_train_nyu.txt`` and the upstream style
    ``prog arguments_train_nyu.txt`` (bare arg-file as sole positional).
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 1 and not argv[0].startswith("-") and not argv[0].startswith("@"):
        argv = ["@" + argv[0]]
    parser = build_parser(mode)
    ns = parser.parse_args(argv)
    if ns.batch_size is None:
        # reference semantics: test/sequence drivers are batch-1 by default
        ns.batch_size = 1 if ns.mode in ("test", "sequence") else Config().batch_size
    cfg = Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)})
    # Reference eval-crop defaults: garg crop for KITTI, eigen crop for NYU,
    # applied when neither flag is given and we are evaluating.
    if cfg.mode in ("eval",) or cfg.do_online_eval:
        if not cfg.garg_crop and not cfg.eigen_crop:
            cfg = cfg.replace(garg_crop=cfg.dataset == "kitti", eigen_crop=cfg.dataset == "nyu")
    return cfg


def require_device(cfg: Config):
    """``torch.device(cfg.device)``; raises when CUDA is asked for and there
    is no card (an entry point never moves to the CPU by itself)."""
    import torch

    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda, but torch.cuda.is_available() is false; pass --device cpu "
            "to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {cfg.device!r}")
    return device
