"""The learning check of bts_tpu_torch on the CPU: the port's training stack
must fit a learnable scene.  Ports tests/test_convergence.py's
test_training_fits_synthetic_scene and
test_densenet_remat_fits_synthetic_scene with their scenes, recipes, step
counts and asserts, through create_model and training.Trainer (the
augmentation off, as there), and test_densenet_spatial_remat_fits_synthetic_scene
in four gloo ranks.  All are ``slow``: the tier-1 command's ``-m 'not slow'``
leaves them out.

    python -m pytest -m slow tests/test_torch_port_convergence.py
"""

import datetime
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bts_tpu_torch.config import Config
from bts_tpu_torch.data.augment import eval_preprocess
from bts_tpu_torch.models.bts import create_model
from bts_tpu_torch.training.trainer import Trainer

H = W = 64  # divisible by 32 (five stride-2 stages)
STEPS = 300
NYU_FOCAL = 518.8579


def _scene(h=H, w=W):
    """A smooth depth ramp and a box at a nearer depth: depth predictable
    from the image's intensity and position (the JAX tests' scene)."""
    yy, _ = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = 2.0 + 6.0 * (yy / h).astype(np.float32)
    depth[16:40, 20:44] = 1.5
    img = np.stack([depth / 10.0 * 255] * 3, -1).astype(np.uint8)
    return img, depth


def _fit(cfg, steps=STEPS):
    """``steps`` train steps of a fresh seeded model on the scene at b2;
    returns the model, the scene's depth, its batch, and the first and the
    last loss."""
    img, depth = _scene()
    model = create_model(cfg, "cpu")
    trainer = Trainer(model, cfg, total_steps=steps, device="cpu", augment=False)
    batch = {"image": np.stack([img, img]), "depth": np.stack([depth, depth]),
             "focal": np.full((2,), NYU_FOCAL, np.float32)}
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(steps)]
    return model, depth, batch, losses[0], losses[-1]


def _config(**kw):
    return Config(dataset="nyu", max_depth=10.0, bts_size=64, input_height=H, input_width=W, batch_size=2,
                  learning_rate=3e-4, num_epochs=1, compute_dtype="float32", do_random_rotate=False, seed=0,
                  device="cpu", **kw)


@pytest.mark.slow
def test_training_fits_synthetic_scene():
    """MobileNetV2: silog collapses on the learnable scene (below a third of
    its first value), and the eval-mode prediction's abs_rel on the interior
    is under 0.35 (the JAX test's bound: eval-mode BatchNorm's 0.99-momentum
    running statistics still lag after 300 steps)."""
    model, depth, batch, first, last = _fit(_config(encoder="mobilenetv2_bts"))
    assert np.isfinite(last)
    assert last < first / 3.0, f"loss did not fit: {first:.4f} -> {last:.4f}"
    model.eval()
    with torch.no_grad():
        *_, final = model(eval_preprocess(torch.as_tensor(batch["image"])).permute(0, 3, 1, 2))
    pred = final[0, 0].numpy()
    abs_rel = np.abs(pred - depth)[4:-4, 4:-4] / depth[4:-4, 4:-4]
    assert abs_rel.mean() < 0.35, f"abs_rel {abs_rel.mean():.3f} after fit"


@pytest.mark.slow
def test_densenet_remat_fits_synthetic_scene(monkeypatch):
    """A reduced DenseNet (growth 8, blocks 2/2/2/2, 16 initial features)
    with --remat: the flagship path's BatchNorm and concat topology and the
    recomputing backward; the loss falls below a third of its first value."""
    from bts_tpu_torch.models import encoders
    from bts_tpu_torch.models.encoders.densenet import DenseNet

    kwargs = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16)
    monkeypatch.setitem(encoders.ENCODERS, "tiny_densenet_bts",
                        dict(cls=DenseNet, kwargs=kwargs, channels=DenseNet(**kwargs).channels))
    cfg = _config(encoder="tiny_densenet_bts", remat=True)
    model, _, _, first, last = _fit(cfg)
    assert model.encoder.remat
    assert np.isfinite(last)
    assert last < first / 3.0, f"loss did not fit: {first:.4f} -> {last:.4f}"


TINY_DENSENET = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16)
SPATIAL_STEPS = 200


def _spatial_fit_rank(rank, world, port, out):
    """One of four ranks of the spatial fit: the tiny DenseNet registered
    here (the rank is a new process), the frame's quarter rows, 200 steps;
    rank 0 writes the first and the last loss."""
    from bts_tpu_torch.models import encoders
    from bts_tpu_torch.models.encoders.densenet import DenseNet
    from bts_tpu_torch.parallel import distributed as parallel

    torch.set_num_threads(1)
    encoders.ENCODERS["tiny_densenet_bts"] = dict(cls=DenseNet, kwargs=TINY_DENSENET,
                                                  channels=DenseNet(**TINY_DENSENET).channels)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        cfg = _config(encoder="tiny_densenet_bts", remat=True, spatial_shards=world)
        parallel.maybe_init_distributed(cfg)
        _, _, _, first, last = _fit(cfg, SPATIAL_STEPS)
        if rank == 0:
            torch.save((first, last), out)
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_densenet_spatial_remat_fits_synthetic_scene(tmp_path):
    """--spatial_shards 4 (the 64-row frame in bands of 16 rows; of one row
    or none at H/32) with --remat through the DenseNet path: the loss falls
    below a third of its first value in 200 steps, as in the JAX test."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_spatial_fit_rank, args=(4, port, str(tmp_path / "losses.pt")), nprocs=4, join=True)
    first, last = torch.load(tmp_path / "losses.pt")
    assert np.isfinite(last)
    assert last < first / 3.0, f"loss did not fit: {first:.4f} -> {last:.4f}"

