"""The ranks of tests/test_torch_port_spatial.py and what they share with
it: each rank imports this module and nothing of pytest, hypothesis or JAX,
so a spawned rank starts as fast as torch does."""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from bts_tpu_torch.config import Config
from bts_tpu_torch.models.bts import BtsDecoder, BtsModel
from bts_tpu_torch.models.encoders.densenet import DenseNet
from bts_tpu_torch.models.layers import BatchNorm
from bts_tpu_torch.parallel import distributed as parallel
from bts_tpu_torch.parallel import spatial
from bts_tpu_torch.utils.weights import load_state_dict

H, W, B = 64, 96, 2
BTS_SIZE, MAX_DEPTH = 128, 10.0
TINY = dict(growth_rate=8, block_config=(1, 1, 2, 1), num_init_features=16)  # a tiny DenseNet


def config(**kw) -> Config:
    base = dict(mode="train", encoder="densenet121_bts", bts_size=BTS_SIZE, dataset="kitti", max_depth=MAX_DEPTH,
                input_height=H, input_width=W, batch_size=B, compute_dtype="float32", do_random_rotate=True,
                degree=2.5, seed=0, device="cpu")
    base.update(kw)
    return Config(**base)


def inputs(b=B):
    """Frames, focals (one without: 0) and a raw train batch of ``b``, from seeds."""
    rng = np.random.default_rng(7)
    image = torch.from_numpy(rng.normal(size=(B, 3, H, W)).astype(np.float32))
    focal = torch.tensor([721.5377, 0.0])
    depth = rng.uniform(1.0, 9.5, (b, 80, 112)).astype(np.float32)
    depth[rng.random(depth.shape) >= 0.3] = 0.0
    batch = {"image": rng.integers(0, 256, (b, 80, 112, 3), dtype=np.uint8), "depth": depth,
             "focal": np.linspace(700.0, 725.0, b).astype(np.float32)}
    return image, focal, batch


def build(cfg):
    """The tiny DenseNet under the BTS decoder of ``cfg``, in eval mode."""
    encoder = DenseNet(remat=cfg.remat, **TINY)
    return BtsModel(encoder, BtsDecoder(encoder.channels, cfg.max_depth, cfg.bts_size)).eval()


def load(cfg, weights):
    """:func:`build` with the weights saved at ``weights``."""
    model = build(cfg)
    load_state_dict(model, torch.load(weights))
    return model


def train_step(cfg, model, batch, rows, frozen_bn=False):
    """One Trainer step on ``rows`` of ``batch`` (``frozen_bn``: every
    BatchNorm in eval mode): the loss, depth_mean, BatchNorm buffers, the
    gradient the step applied (the Trainer's own reduction under spatial
    sharding) and the parameters after the update."""
    from bts_tpu_torch.training.trainer import Trainer

    trainer = Trainer(model, cfg, total_steps=10, device="cpu")
    if frozen_bn:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.eval()
    metrics = trainer.train_step({k: v[rows] for k, v in batch.items()})
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return {"loss": float(metrics["loss"]), "depth_mean": float(metrics["depth_mean"]),
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "grads": {n: p.grad.clone() for n, p in trained},
            "params": {n: p.detach().clone() for n, p in trained}}


def rank(rank, world, port, cfg_kw, weights, out, parts):
    """One rank of a spatial group (``cfg_kw``: the spatial flags and any
    other Config field): ``parts`` among "forward" (the banded forward,
    gathered into whole frames), "step" (one train step on this data
    group's rows of the global batch) and "frozen" (the same step with
    BatchNorm frozen)."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        shards = cfg_kw.get("spatial_shards", 1) * cfg_kw.get("spatial_shards_w", 1)
        cfg = config(**{"batch_size": B * world // shards, **cfg_kw})
        parallel.maybe_init_distributed(cfg)
        bands = spatial.bands(spatial.grid(), H, W)
        image, focal, batch = inputs(cfg.batch_size)
        state = torch.load(weights)
        rows = parallel.rank_rows(cfg.batch_size, cfg.grad_accum_steps, parallel.data_rank(), parallel.data_world())
        rec = {}
        if "forward" in parts:
            model = build(cfg)
            load_state_dict(model, state)
            with torch.inference_mode(), spatial.use(bands):
                outs = model(bands.cut(image), focal)
            rec.update(forward=[bands.gather(o) for o in outs], halo_bytes=spatial.HALO_BYTES["sent"])
        for part in ("step", "frozen"):
            if part in parts:
                model = build(cfg)
                load_state_dict(model, state)
                rec[part] = train_step(cfg, model, batch, rows, frozen_bn=part == "frozen")
        torch.save(rec, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()
