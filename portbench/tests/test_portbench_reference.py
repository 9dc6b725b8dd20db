"""The plain reference against the program's plain path
(``use_pallas="never"``, float32) on one seeded state, at a tiny size on
the CPU: the forward in eval mode, and one training step (loss, every
gradient, every parameter and BatchNorm statistic after the update)."""

from __future__ import annotations

import pytest
import torch

from bts_tpu_torch.config import Config
from bts_tpu_torch.models.bts import create_model
from bts_tpu_torch.training.trainer import Trainer
from portbench.harness import inputs, program, weights
from portbench.reference import augment, model as ref_model, train as ref_train

ENCODERS = ["densenet161_bts", "resnext101_bts"]


@pytest.mark.parametrize("bts_size", [512, 128])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_state_shapes_are_the_programs(encoder, bts_size):
    with torch.device("meta"):
        m = create_model(Config(encoder=encoder, bts_size=bts_size), "meta")
    assert {n: tuple(t.shape) for n, t in m.state_dict().items()} == \
        {n: tuple(s) for n, s in ref_model.state_shapes(encoder, bts_size)}


def _model_cfg(encoder, dataset, max_depth):
    return {"encoder": encoder, "bts_size": 512, "max_depth": max_depth, "dataset": dataset,
            "compute_dtype": "float32", "use_pallas": "never", "focal": 721.5377}


@pytest.mark.parametrize("encoder,dataset,max_depth", [("densenet161_bts", "kitti", 80.0),
                                                       ("resnext101_bts", "nyu", 10.0)])
def test_forward_matches_the_program(encoder, dataset, max_depth):
    m = _model_cfg(encoder, dataset, max_depth)
    cfg = program.config(m, {}, 0, "cpu", "test")
    state = weights.model_state(m, 7, "cpu")
    model = program.build_model(cfg, state, "cpu")
    frames = inputs.frames(torch.Generator().manual_seed(3), 2, 64, 96, "cpu")
    focal = torch.tensor([721.5377, 700.0]) if dataset == "kitti" else None
    with torch.no_grad():
        image = augment.eval_preprocess(frames).permute(0, 3, 1, 2)
        got = model(image, focal)
        want = ref_model.forward(state, image, focal, encoder=encoder, bts_size=512, max_depth=max_depth)
    # the final depth; the LPG maps can be large where a denominator nears 0
    gap = (got[4] - want[4]).pow(2).mean().sqrt() / want[4].pow(2).mean().sqrt()
    assert gap < 1e-4
    for g, w in zip(got[1:4], want[1:4]):
        assert torch.allclose(g, w, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("encoder,dataset,max_depth", [("densenet161_bts", "kitti", 80.0),
                                                       ("resnext101_bts", "nyu", 10.0)])
def test_training_step_matches_the_program(encoder, dataset, max_depth):
    m = _model_cfg(encoder, dataset, max_depth)
    train = {"input_height": 64, "input_width": 96, "batch_size": 2, "do_random_rotate": True, "degree": 2.5,
             "learning_rate": 1e-4, "end_learning_rate": -1.0, "weight_decay": 1e-2, "adam_eps": 1e-3,
             "variance_focus": 0.85, "remat": False, "total_steps": 100}
    traffic = {"batch": 2, "pool_batches": 1, "frame_height": 80, "frame_width": 112,
               "depth": {"kind": "sparse", "fraction": 0.3, "low": 1.0, "high": 80.0}}
    batch = inputs.train_pool(traffic, 721.5377, 5, "cpu")[0]
    cfg = program.config(m, train, 11, "cpu", "train")
    state = weights.model_state(m, 9, "cpu")
    model = program.build_model(cfg, {n: t.clone() for n, t in state.items()}, "cpu")
    trainer = Trainer(model, cfg, total_steps=train["total_steps"], device="cpu")
    loss = float(trainer.train_step(batch)["loss"])
    grads = {n: p.grad for n, p in model.named_parameters()}

    stat = (".running_mean", ".running_var")
    params = {n: t for n, t in state.items() if not n.endswith(stat)}
    buffers = {n: t for n, t in state.items() if n.endswith(stat)}
    opt = ref_train.AdamW(params, train)
    ref_loss, ref_grads, _ = ref_train.step(params, buffers, opt, batch, 11, m, train)

    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    total = torch.sqrt(sum(g.pow(2).sum() for g in ref_grads.values()))
    diff = torch.sqrt(sum((grads[n] - g).pow(2).sum() for n, g in ref_grads.items()))
    assert diff <= 1e-3 * total  # the dense-ASPP ReLU masks make f32 gradients differ by ~1e-4 here
    # the update: AdamW's first step is ~lr * sign(g) where |g| >> eps, so an
    # element whose tiny gradient differs between the two moves differently;
    # held as a whole, and the BatchNorm statistics each
    after = model.state_dict()
    before = weights.model_state(m, 9, "cpu")
    moved = {n: after[n] - before[n] for n in params}
    ref_moved = {n: params[n] - before[n] for n in params}
    diff = torch.sqrt(sum((moved[n] - d).pow(2).sum() for n, d in ref_moved.items()))
    assert diff <= 1e-2 * torch.sqrt(sum(d.pow(2).sum() for d in ref_moved.values()))
    for n, t in buffers.items():
        assert torch.allclose(after[n], t, rtol=1e-4, atol=1e-6), n
