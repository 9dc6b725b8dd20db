"""The learning check of the port at flagship size: train, serve and score
the port's entry points on synthetic scenes whose depth can be read from
the red channel, from random init and after training; counterpart of
``scripts/train_flagship_smoke.py``, whose results ``FLAGSHIP_SMOKE.json``
holds.

    python -m bts_tpu_torch.tools.flagship_smoke --dataset kitti   # config 4, 200 steps
    python -m bts_tpu_torch.tools.flagship_smoke --dataset nyu     # config 3, 192 steps

Each run generates the JAX script's scene set (its own copy of the
generator: uint8 PNGs, uint16 depth x256 (KITTI) or x1000 (NYU), the same
seed and counts: 64 training and 8 evaluation frames) under ``--root``, then
drives

    bts_main  --dataset kitti: config 4 (densenet161_bts, 352x704, b16,
              --remat, KB crop, rotation 1 degree, AdamW poly decay);
              --dataset nyu: config 3 (resnext101_bts, 416x544, b4,
              border crop, rotation 2.5 degrees)
    bts_test  b1 at the evaluation shape, uint16 PNGs, from random init and
              from the final checkpoint
    bts_eval  garg crop (KITTI) or eigen crop (NYU), nine metrics

each in its own process on ``--device`` (default cuda).

The record goes into ``--out`` (default ``FLAGSHIP_SMOKE_TORCH.json`` at the
repo root), merged by key (the dataset), each number beside the JAX
package's from
``FLAGSHIP_SMOKE.json``.  The run fails (exit 1) unless the last logged
loss is below a third of the first and abs_rel falls from its untrained
value.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KITTI_FOCAL = 721.5377
NYU_FOCAL = 518.8579
METRIC_NAMES = ("silog", "abs_rel", "log10", "rms", "sq_rel", "log_rms", "d1", "d2", "d3")
N_TRAIN, N_EVAL = 64, 8

# the JAX script's recipes: config 4 (KITTI) and config 3 (NYU)
DATASETS = {
    "kitti": dict(h=375, w=1242, max_depth=80.0, focal=KITTI_FOCAL, sparse_top=True,
                  encoder="densenet161_bts", batch_size=16, ih=352, iw=704, degree=1.0, remat=True,
                  kb_crop=True, test_hw=None, steps=200),
    "nyu": dict(h=480, w=640, max_depth=10.0, focal=NYU_FOCAL, sparse_top=False,
                encoder="resnext101_bts", batch_size=4, ih=416, iw=544, degree=2.5, remat=False,
                kb_crop=False, test_hw=(480, 640), steps=192),
}


def make_scene(rng: np.random.Generator, h, w, max_depth, sparse_top):
    """A frame whose depth is decodable from the red channel,
    R = 255 * (1 - depth / max_depth): a vertical far-to-near ramp with 2-5
    boxes at nearer depths; with ``sparse_top`` no depth above 28% of the
    height (KITTI's LiDAR).  Returns uint8 RGB and uint16 depth (x256 for
    KITTI's max depth, x1000 for NYU's)."""
    far, near = 0.75 * max_depth, 0.0625 * max_depth
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    depth = far - (far - near) * yy
    depth = np.broadcast_to(depth, (h, w)).copy()
    for _ in range(int(rng.integers(2, 6))):
        bw = int(rng.integers(w // 16, w // 5))
        bh = int(rng.integers(h // 6, h // 2.5))
        x0 = int(rng.integers(0, w - bw))
        y0 = int(rng.integers(h // 3, h - bh))
        depth[y0: y0 + bh, x0: x0 + bw] = float(rng.uniform(0.04 * max_depth, 0.375 * max_depth))
    r = np.clip(255.0 * (1.0 - depth / max_depth), 0, 255)
    g = np.clip(r + rng.normal(0, 6.0, (h, w)), 0, 255)
    b = np.clip(255.0 * yy + rng.normal(0, 6.0, (h, w)), 0, 255)
    img = np.stack([r, np.broadcast_to(g, (h, w)), b], -1).astype(np.uint8)
    if sparse_top:
        depth[: int(0.28 * h)] = 0.0
    scale = 256.0 if max_depth > 20 else 1000.0
    return img, (depth * scale).astype(np.uint16)


def gen_dataset(root: str, ds: dict) -> None:
    """``root/rgb``, ``root/depth`` and the split files ``train.txt`` (64
    frames) and ``eval.txt`` (8), seed 42 as in the JAX script."""
    from PIL import Image

    rng = np.random.default_rng(42)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lines = []
    for i in range(N_TRAIN + N_EVAL):
        img, d = make_scene(rng, ds["h"], ds["w"], ds["max_depth"], ds["sparse_top"])
        Image.fromarray(img).save(os.path.join(root, "rgb", f"{i:04d}.png"))
        Image.fromarray(d).save(os.path.join(root, "depth", f"{i:04d}.png"))
        lines.append(f"rgb/{i:04d}.png depth/{i:04d}.png {ds['focal']}")
    for name, part in (("train.txt", lines[:N_TRAIN]), ("eval.txt", lines[N_TRAIN:])):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(part))


def run(argv, log_path) -> tuple:
    """``python -m argv`` from the repo root, its output in ``log_path``;
    returns (output, seconds).  A failure raises with the log's tail."""
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        p = subprocess.run([sys.executable, "-m"] + argv, cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                           text=True)
    seconds = time.perf_counter() - t0
    with open(log_path) as f:
        out = f.read()
    if p.returncode != 0:
        print(out[-4000:])
        raise SystemExit(f"{argv[0]} failed rc={p.returncode} (log: {log_path})")
    return out, seconds


def parse_losses(train_out: str) -> list:
    return [(int(s), float(v)) for s, v in re.findall(r"^step\s+(\d+)/\d+ loss ([0-9.]+)", train_out, re.M)]


def parse_metrics(eval_out: str) -> dict:
    """bts_eval prints a header row, then a row of the nine values."""
    nums = re.findall(r"[-+]?\d*\.\d+(?:[eE][-+]?\d+)?", eval_out.strip().splitlines()[-1])
    if len(nums) < len(METRIC_NAMES):
        raise SystemExit(f"bts_eval printed no metrics: {eval_out[-400:]}")
    return dict(zip(METRIC_NAMES, (float(x) for x in nums)))


def beside(port, ref):
    """``port`` with the JAX package's value beside each number."""
    if isinstance(port, dict):
        return {k: beside(v, (ref or {}).get(k)) for k, v in port.items()}
    return {"torch": port, "jax": ref}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=sorted(DATASETS), default="kitti")
    ap.add_argument("--steps", type=int, default=None, help="default: 200 (kitti), 192 (nyu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=os.path.join(REPO, "build", "flagship_smoke"))
    ap.add_argument("--out", default=os.path.join(REPO, "FLAGSHIP_SMOKE_TORCH.json"))
    args = ap.parse_args(argv)

    ds = DATASETS[args.dataset]
    key = args.dataset
    root = os.path.join(os.path.abspath(args.root), args.dataset)
    data, runs = os.path.join(root, "data"), os.path.join(root, key)
    if not os.path.isfile(os.path.join(data, "eval.txt")):
        print(f"generating the synthetic {args.dataset} scenes ...", flush=True)
        gen_dataset(data, ds)
    shutil.rmtree(runs, ignore_errors=True)
    os.makedirs(runs)

    steps = args.steps or ds["steps"]
    b = ds["batch_size"]
    steps_per_epoch = N_TRAIN // b
    epochs = max(1, steps // steps_per_epoch)
    md = str(int(ds["max_depth"]))
    common = ["--dataset", args.dataset, "--encoder", ds["encoder"], "--max_depth", md,
              "--data_path", data, "--gt_path", data]
    model = ["--device", args.device]
    train = ["bts_tpu_torch.cli.bts_main", "--mode", "train", "--model_name", "flagship_smoke", *common,
             *model, "--filenames_file", os.path.join(data, "train.txt"), "--batch_size", str(b),
             "--num_epochs", str(epochs), "--learning_rate", "1e-4", "--weight_decay", "1e-2",
             "--adam_eps", "1e-3", "--input_height", str(ds["ih"]), "--input_width", str(ds["iw"]),
             "--do_random_rotate", "--degree", str(ds["degree"]), "--log_freq", str(steps_per_epoch),
             "--save_freq", str(max(steps_per_epoch, steps // 4)), "--log_directory", runs]
    train += ["--do_kb_crop"] * ds["kb_crop"] + ["--remat"] * ds["remat"]
    print(f"training {key}: {epochs} epochs x {steps_per_epoch} steps ...", flush=True)
    train_out, train_s = run(train, os.path.join(runs, "train.log"))
    losses = parse_losses(train_out)
    if not losses:
        raise SystemExit(f"no loss logged: {train_out[-2000:]}")
    print(f"loss: first {losses[0][1]} last {losses[-1][1]} ({len(losses)} logged)", flush=True)

    evals, seconds = {}, {"train": train_s}
    test_common = common + ["--filenames_file", os.path.join(data, "eval.txt")]
    test_common += ["--do_kb_crop"] * ds["kb_crop"]
    if ds["test_hw"]:
        test_common += ["--input_height", str(ds["test_hw"][0]), "--input_width", str(ds["test_hw"][1])]
    ckpt = os.path.join(runs, "flagship_smoke", "ckpt")
    for tag, restore in (("untrained", []), ("final", ["--checkpoint_path", ckpt])):
        pred = os.path.join(runs, f"preds_{tag}")
        _, seconds[f"test_{tag}"] = run(["bts_tpu_torch.cli.bts_test", *test_common, *model, *restore,
                                         "--out_path", pred], os.path.join(runs, f"test_{tag}.log"))
        crop = "--garg_crop" if args.dataset == "kitti" else "--eigen_crop"
        eval_out, seconds[f"eval_{tag}"] = run(
            ["bts_tpu_torch.cli.bts_eval", *test_common, "--out_path", os.path.join(pred, "raw"),
             "--min_depth_eval", "1e-3", "--max_depth_eval", md, crop], os.path.join(runs, f"eval_{tag}.log"))
        evals[tag] = parse_metrics(eval_out)
        print(f"  {tag}: {evals[tag]}", flush=True)

    with open(os.path.join(REPO, "FLAGSHIP_SMOKE.json")) as f:
        jax_rec = json.load(f).get(args.dataset, {})
    checks = {"loss_last_below_a_third_of_first": losses[-1][1] < losses[0][1] / 3,
              "abs_rel_fell": evals["final"]["abs_rel"] < evals["untrained"]["abs_rel"]}
    result = {
        "recipe": f"{ds['encoder']} {args.dataset} {ds['ih']}x{ds['iw']} b{b}{' remat' if ds['remat'] else ''}"
                  f"{' kb_crop' if ds['kb_crop'] else ''} rotate, upconv fused",
        "date": datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%d"),
        "device": args.device, "card": card() if args.device == "cuda" else "cpu",
        "torch": torch.__version__,
        **beside({"steps": losses[-1][0], "loss_first": losses[0][1], "loss_last": losses[-1][1],
                  "eval": evals}, jax_rec),
        "losses": losses, "checks": checks, "seconds": seconds,
    }
    merged = {}
    if os.path.isfile(args.out):
        with open(args.out) as f:
            merged = json.load(f)
    merged[key] = result
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1)
    print(json.dumps({key: result}))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
