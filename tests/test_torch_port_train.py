"""bts_tpu_torch's training slice against bts_tpu on the CPU: train-mode
BatchNorm, remat, one train step of a tiny model (loss, gradients, BN
statistics, the AdamW update, gradient accumulation), the poly schedule,
freezing, the augmentation with JAX's own draws, the data loader, and the
``bts_main`` driver.  The same numpy inputs go to both sides; JAX's PRNG
streams are not reproduced, so the augmentation draws are re-derived from a
JAX key and handed to the port.

Tolerances: BatchNorm output and statistics rtol 2e-5; the train step's loss
rtol 1e-5, BN statistics rtol 2e-5 (atol 2e-5*max|ref|), the whole gradient
within 2e-3 and each tensor within 1e-4 of its norm or twice its measured
sensitivity to a 4e-6 change of the weights (``_assert_step_matches`` says
why), and the AdamW update from the same gradients rtol 1e-5; the augmentation 1e-5
(resampling weights from sin/tan of the same f32 angle).
"""

import copy
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bts_tpu.config import Config as JConfig
from bts_tpu.data import augment as jaug
from bts_tpu.models import layers as jlayers
from bts_tpu.models.bts import BtsDecoder as JBtsDecoder
from bts_tpu.models.encoders.densenet import DenseNet as JDenseNet
from bts_tpu.ops.silog import default_mask as j_default_mask
from bts_tpu.ops.silog import silog_loss as j_silog_loss
from bts_tpu_torch.config import Config
from bts_tpu_torch.data import augment
from bts_tpu_torch.models import layers
from bts_tpu_torch.models.bts import BtsDecoder, BtsModel, create_model
from bts_tpu_torch.models.encoders.densenet import DenseNet
from bts_tpu_torch.training.optimizer import make_optimizer
from bts_tpu_torch.training.trainer import Trainer
from bts_tpu_torch.utils import torch_converter as TC
from bts_tpu_torch.utils import weights
from test_torch_port_model import _load_port, _nchw, _one_torch_thread, _random_variables  # noqa: F401

TINY = dict(growth_rate=8, block_config=(1, 1, 2, 1), num_init_features=16)
NF, MAX_DEPTH, LR = 128, 80.0, 1e-3
PERTURB = 4e-6  # the weight perturbation of the gradient rule (_assert_step_matches)


def _kitti_batch(seed, b, h=64, w=96):
    """uint8 frames, LiDAR-like depth (~30% of pixels in [1, 80) m), focal."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, MAX_DEPTH, (b, h, w)).astype(np.float32)
    depth[rng.random((b, h, w)) >= 0.3] = 0.0
    return {"image": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8), "depth": depth,
            "focal": np.linspace(700.0, 725.0, b).astype(np.float32)}


def test_batchnorm_train_matches_flax():
    """flax BatchNorm(train=True) with mutable batch_stats: the output and
    the updated running mean and (biased) variance."""
    x = (np.random.default_rng(1).normal(size=(2, 6, 10, 4)) * 2 + 0.5).astype(np.float32)
    jmod = jlayers.BatchNorm()
    variables = _random_variables(jmod, 2, jnp.asarray(x))
    ref, mut = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    pmod = _load_port(layers.BatchNorm(4), variables, TC._bn((), "")).train()
    out = pmod(_nchw(x))
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=2e-5, atol=2e-5 * np.abs(np.asarray(ref)).max())
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(pmod.running_mean.numpy(), np.asarray(stats["mean"]), rtol=2e-5)
    np.testing.assert_allclose(pmod.running_var.numpy(), np.asarray(stats["var"]), rtol=2e-5)


@pytest.mark.parametrize("policy", ["layer", "block", "convs"])
def test_remat_matches_no_remat(policy):
    """Each remat policy gives the no-remat loss, gradients and running
    statistics exactly: the recompute does not fold BN statistics in twice."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 64, 96)).astype(np.float32))
    results = []
    for remat in (False, True):
        torch.manual_seed(0)
        net = DenseNet(remat=remat, remat_policy=policy, **TINY).train()
        loss = sum(f.square().mean() for f in net(x))
        loss.backward()
        results.append((loss, [p.grad for p in net.parameters()], list(net.buffers())))
    (l0, g0, b0), (l1, g1, b1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))


class _JTinyTrain(fnn.Module):
    """A tiny DenseNet + BtsDecoder with BtsModel's subtree names, in train mode."""

    @fnn.compact
    def __call__(self, image, focal, train: bool = True):
        feats = JDenseNet(**TINY)(image, train)
        return JBtsDecoder(max_depth=MAX_DEPTH, num_features=NF)(feats, train, focal)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX package's train-step semantics for the tiny model, jitted once
    per module: trainer.py::loss_fn with augment=False (loss, new
    batch_stats, gradients) and the AdamW update of training/optimizer.py
    from those gradients."""
    import optax
    from bts_tpu.training.optimizer import make_optimizer as j_make_optimizer

    jm = _JTinyTrain()
    tx = j_make_optimizer(JConfig(learning_rate=LR), 10)

    @jax.jit
    def step(params, batch_stats, images, depths, focal):
        def loss_fn(p):
            outs, mut = jm.apply({"params": p, "batch_stats": batch_stats},
                                 jaug.eval_preprocess(images), focal, True, mutable=["batch_stats"])
            mask = j_default_mask(depths, "kitti")
            return j_silog_loss(outs[4][..., 0], depths, mask, 0.85), mut["batch_stats"]

        (loss, new_bs), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(g, tx.init(params), params)
        return loss, new_bs, g, optax.apply_updates(params, updates)

    return jm, step


def _tiny_pair(seed):
    """The tiny model's random flax variables and the port model loaded with them."""
    jm = _jax_step()[0]
    variables = _random_variables(jm, seed, jnp.zeros((1, 64, 96, 3)), None)
    encoder = DenseNet(**TINY)
    model = BtsModel(encoder, BtsDecoder(encoder.channels, MAX_DEPTH, NF))
    sd = weights.state_dict_from_jax(variables, "densenet121_bts", NF,
                                     encoder_mapping=TC.densenet_mapping(TINY["block_config"]))
    weights.load_state_dict(model, sd)
    return variables, model


def _mapping():
    return ([("encoder.", "DenseNet_0", e) for e in TC.densenet_mapping(TINY["block_config"])]
            + [("decoder.", "BtsDecoder_0", e) for e in TC.decoder_mapping(NF)])


def _leaf(tree, sub, path):
    for p in (sub,) + tuple(path):
        tree = tree[p]
    return np.asarray(tree)


def _perturbed(model):
    """A copy of ``model`` with every weight moved by PERTURB (relative,
    random sign)."""
    other = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(1 + PERTURB * (torch.randint(0, 2, p.shape, generator=gen) * 2 - 1))
    return other


def _assert_step_matches(model, loss, jloss, jgrads, jstats, probe):
    """Loss rtol 1e-5, BN statistics rtol 2e-5 (atol 2e-5*max|ref|, the
    layer tests' rule), the whole gradient within 2e-3, and each gradient
    tensor within 1e-4 of its norm or within twice the distance it moves
    when the weights move by PERTURB (``probe``: the same step from
    :func:`_perturbed` weights).

    Why not 1e-4 for every tensor: upstream of the dense-ASPP cells the f32
    gradient is not continuous in the inputs.  A biased conv feeding a
    train-mode BatchNorm makes the gradient there a ReLU-masked sum of a
    zero-mean field, so the few pre-activations that sit within rounding of
    zero decide it; XLA's and the port's forwards differ by about 1e-6
    relative (the loss by 2e-7) and flip some of those masks, which moves
    e.g. daspp_24.first_bn.bias by ~5e-3 — as far as a 4e-6 change of the
    weights moves the port's own gradient.  The conv bias itself has a
    gradient that is zero in exact arithmetic; its rounding noise is held to
    1e-6 of the whole gradient's norm."""
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    params, buffers = dict(model.named_parameters()), dict(model.named_buffers())
    moved = dict(probe.named_parameters())
    rows = []
    for prefix, sub, (path, key, kind) in _mapping():
        name = prefix + key
        if path[-1] in ("mean", "var"):
            ref = _leaf(jstats, sub, path)
            np.testing.assert_allclose(buffers[name].numpy(), ref, rtol=2e-5,
                                       atol=2e-5 * np.abs(ref).max(), err_msg=name)
            continue
        ref = TC.flax_to_torch_tensor(_leaf(jgrads, sub, path), kind)
        grad = params[name].grad.numpy()
        gap, norm = np.linalg.norm(grad - ref), np.linalg.norm(ref)
        rows.append((name, gap, norm, np.linalg.norm(grad - moved[name].grad.numpy())))
    total = np.sqrt(sum(norm**2 for _, _, norm, _ in rows))
    for name, gap, norm, sensitivity in rows:
        assert gap <= max(1e-4 * norm, 2 * sensitivity, 1e-6 * total), (name, gap, norm, sensitivity)
    assert np.sqrt(sum(gap**2 for _, gap, _, _ in rows)) <= 2e-3 * total


def _assert_update_matches(model, initial, jgrads, jparams, cfg):
    """One AdamW step of the port's optimizer from the initial weights, fed
    the JAX gradients, against optax.adamw's step: rtol 1e-5."""
    model.load_state_dict(initial)
    trainer = Trainer(model, cfg, total_steps=10, device="cpu", augment=False)
    params = dict(model.named_parameters())
    entries = [(prefix + key, sub, path, kind) for prefix, sub, (path, key, kind) in _mapping()
               if path[-1] not in ("mean", "var")]
    for name, sub, path, kind in entries:
        params[name].grad = torch.tensor(TC.flax_to_torch_tensor(_leaf(jgrads, sub, path), kind))
    trainer.optimizer.step()
    for name, sub, path, kind in entries:
        ref = TC.flax_to_torch_tensor(_leaf(jparams, sub, path), kind)
        np.testing.assert_allclose(params[name].detach().numpy(), ref, rtol=1e-5, atol=1e-8, err_msg=name)


def test_train_step_matches_jax():
    """One f32 step (augment=False, KITTI focal): loss, per-tensor gradients
    and BN statistics against jax.value_and_grad with mutable batch_stats,
    and the AdamW update against optax.adamw."""
    variables, model = _tiny_pair(5)
    initial = copy.deepcopy(model.state_dict())
    probe = _perturbed(model)
    batch = _kitti_batch(6, 2)
    jloss, jstats, jg, jparams = _jax_step()[1](
        variables["params"], variables["batch_stats"],
        *(jnp.asarray(batch[k]) for k in ("image", "depth", "focal")))
    cfg = Config(learning_rate=LR, compute_dtype="float32", batch_size=2)
    metrics = Trainer(model, cfg, total_steps=10, device="cpu", augment=False).train_step(batch)
    Trainer(probe, cfg, total_steps=10, device="cpu", augment=False).train_step(batch)
    _assert_step_matches(model, float(metrics["loss"]), jloss, jg, jstats, probe)
    _assert_update_matches(model, initial, jg, jparams, cfg)


def test_grad_accumulation_matches_jax_semantics():
    """--grad_accum_steps 2 on a batch of 4: the loss and gradients averaged
    over the two microbatches against constant parameters, BN statistics
    updated sequentially (trainer.py::grads_accumulated)."""
    jstep = _jax_step()[1]
    variables, model = _tiny_pair(7)
    probe = _perturbed(model)
    batch = _kitti_batch(8, 4)
    params, stats, losses, gsum = variables["params"], variables["batch_stats"], [], None
    for i in range(2):
        sl = slice(2 * i, 2 * i + 2)
        loss, stats, g, _ = jstep(params, stats, *(jnp.asarray(batch[k][sl]) for k in ("image", "depth", "focal")))
        losses.append(float(loss))
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
    jg = jax.tree.map(lambda x: x / 2, gsum)
    cfg = Config(learning_rate=LR, compute_dtype="float32", batch_size=4, grad_accum_steps=2)
    metrics = Trainer(model, cfg, total_steps=10, device="cpu", augment=False).train_step(batch)
    Trainer(probe, cfg, total_steps=10, device="cpu", augment=False).train_step(batch)
    _assert_step_matches(model, float(metrics["loss"]), np.mean(losses), jg, stats, probe)


def test_poly_schedule_matches_optax():
    from bts_tpu.training.optimizer import polynomial_schedule

    cfg = Config(learning_rate=3e-4, end_learning_rate=-1.0)
    opt, sched = make_optimizer(torch.nn.Linear(2, 2), cfg, total_steps=7)
    ref = polynomial_schedule(cfg.learning_rate, cfg.end_lr, 7)
    for step in range(10):  # past the end, where the schedule holds end_lr
        np.testing.assert_allclose(sched.get_last_lr()[0], float(ref(step)), rtol=1e-6)
        opt.step()
        sched.step()


@pytest.mark.parametrize("flag", ["fix_first_conv_block", "fix_first_conv_blocks"])
def test_freezing_matches_jax_and_holds_tensors(flag):
    """The frozen set is the JAX package's (freeze_prefixes, in torchvision
    names through the mapping), and a step leaves it bit-identical while
    every other parameter moves."""
    from bts_tpu.models.encoders import freeze_prefixes as j_freeze_prefixes

    num = 2 if flag.endswith("blocks") else 1
    jfrozen = set(j_freeze_prefixes("densenet121_bts", num))
    expected = {"encoder." + key for path, key, _ in TC.ENCODER_MAPPINGS["densenet121_bts"]()
                if path[0] in jfrozen and path[-1] not in ("mean", "var")}
    cfg = Config(encoder="densenet121_bts", bts_size=128, compute_dtype="float32", batch_size=2,
                 **{flag: True})
    model = create_model(cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(model, cfg, total_steps=10, device="cpu", augment=False)
    assert set(trainer.frozen) == expected
    trainer.train_step(_kitti_batch(9, 2))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == (n in expected), n


def test_bn_no_track_stats_keeps_running_statistics():
    _, model = _tiny_pair(10)
    before = [b.clone() for b in model.buffers()]
    cfg = Config(compute_dtype="float32", batch_size=2, bn_no_track_stats=True)
    Trainer(model, cfg, total_steps=10, device="cpu", augment=False).train_step(_kitti_batch(11, 2))
    assert all(torch.equal(a, b) for a, b in zip(before, model.buffers()))


@pytest.mark.parametrize("fn,order", [("shear", 1), ("shear", 0), ("gather", 1), ("gather", 0)])
def test_rotations_match_jax(fn, order):
    """rotate_image_shear (the training path) and rotate_image (map_coordinates,
    above 128 slices) per sample against the batched port, with fixed angles."""
    rng = np.random.default_rng(12)
    img = rng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    depth = rng.uniform(0, 80, (2, 24, 40)).astype(np.float32)
    angle = np.array([0.8, -2.3], np.float32) * np.pi / 180
    for x in (img, depth):
        if fn == "shear":
            ref = [jaug.rotate_image_shear(jnp.asarray(x[i]), angle[i], order, 2.5) for i in range(2)]
            port = augment.rotate_image_shear(torch.from_numpy(x), torch.from_numpy(angle), order, 2.5)
        else:
            ref = [jaug.rotate_image(jnp.asarray(x[i]), angle[i] * 10, order) for i in range(2)]
            port = augment.rotate_image(torch.from_numpy(x), torch.from_numpy(angle * 10), order)
        ref = np.stack([np.asarray(r) for r in ref])
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _draws_from_jax_key(key, b, h, w, out_h, out_w, dataset, degree):
    """The draws augment_sample makes from each per-sample key, re-derived."""
    rows = []
    for k in jax.random.split(key, b):
        k_rot, k_crop, k_flip, k_gate, k_color = jax.random.split(k, 5)
        ky, kx = jax.random.split(k_crop)
        kg, kb, kc = jax.random.split(k_color, 3)
        bmin, bmax = (0.75, 1.25) if dataset == "nyu" else (0.9, 1.1)
        rows.append(dict(
            angle=jax.random.uniform(k_rot, (), minval=-degree, maxval=degree) * (jnp.pi / 180.0),
            top=jax.random.randint(ky, (), 0, h - out_h + 1),
            left=jax.random.randint(kx, (), 0, w - out_w + 1),
            flip=jax.random.bernoulli(k_flip), gate=jax.random.bernoulli(k_gate),
            gamma=jax.random.uniform(kg, (), minval=0.9, maxval=1.1),
            brightness=jax.random.uniform(kb, (), minval=bmin, maxval=bmax),
            colors=jax.random.uniform(kc, (3,), minval=0.9, maxval=1.1)))
    return augment.AugmentDraws(**{
        name: torch.from_numpy(np.stack([np.asarray(r[name]) for r in rows]))
        for name in rows[0]})


@pytest.mark.parametrize("dataset", ["kitti", "nyu"])
def test_augment_chain_matches_jax_with_its_draws(dataset):
    """The whole chain (rotate, crop, flip, gated colour jitter, normalise)
    against bts_tpu's augment_batch, fed the draws JAX made from its key."""
    rng = np.random.default_rng(13)
    b, h, w, out_h, out_w = 4, 40, 64, 32, 48
    images = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    depths = rng.uniform(0, 80, (b, h, w)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    ref_img, ref_depth = jaug.augment_batch(jnp.asarray(images), jnp.asarray(depths), key,
                                            out_h=out_h, out_w=out_w, dataset=dataset, degree=1.0,
                                            do_random_rotate=True)
    draws = _draws_from_jax_key(key, b, h, w, out_h, out_w, dataset, 1.0)
    assert draws.flip.any() and not draws.flip.all()
    img, depth = augment.apply_augment(torch.from_numpy(images), torch.from_numpy(depths), draws,
                                       out_h=out_h, out_w=out_w, degree=1.0, do_random_rotate=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref_depth), rtol=1e-5, atol=1e-5 * MAX_DEPTH)


def test_augment_batch_is_reproducible():
    from bts_tpu_torch.training.trainer import step_generator

    batch = _kitti_batch(15, 2, 40, 64)
    images, depths = torch.from_numpy(batch["image"]), torch.from_numpy(batch["depth"])

    def run(step):
        return augment.augment_batch(images, depths, step_generator(0, step), out_h=32, out_w=48)

    (a, da), (b, db), (c, _) = run(3), run(3), run(4)
    assert torch.equal(a, b) and torch.equal(da, db) and not torch.equal(a, c)


def _png_tree(root, dataset, n, h, w):
    rng = np.random.default_rng(16)
    (root / "rgb").mkdir()
    (root / "gt").mkdir()
    scale = 256.0 if dataset == "kitti" else 1000.0
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / "rgb" / f"{i}.png")
        depth = rng.uniform(0.5, 60.0, (h, w)) * (rng.random((h, w)) < 0.3)
        Image.fromarray((depth * scale).astype(np.uint16)).save(root / "gt" / f"{i}.png")
        lines.append(f"rgb/{i}.png gt/{i}.png {700.0 + i}")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return dict(dataset=dataset, data_path=str(root), gt_path=str(root),
                filenames_file=str(root / "split.txt"), batch_size=2, seed=3,
                use_native_loader="never", dataloader_workers=1)


@pytest.mark.parametrize("dataset,h,w,kb", [("kitti", 376, 1242, True), ("nyu", 480, 640, False)])
def test_loader_matches_jax_loader(tmp_path, dataset, h, w, kb):
    """Batch order over two seeded epochs, the KB / NYU border crops, depth
    scaling and focal, and the resume at a global step, against the JAX
    package's PNG-tree loader."""
    from bts_tpu.data.dataloader import BtsDataLoader as JLoader
    from bts_tpu_torch.data.dataloader import BtsDataLoader

    kw = _png_tree(tmp_path, dataset, 5, h, w)
    port = BtsDataLoader(Config(do_kb_crop=kb, **kw), "train")
    ref = JLoader(JConfig(do_kb_crop=kb, **kw), "train")
    for start in (0, 3):
        pb = list(port.batches(num_epochs=2, start_step=start))
        jb = list(ref.batches(num_epochs=2, start_step=start))
        assert len(pb) == len(jb) == {0: 4, 3: 3}[start]  # two epochs from the start epoch
        for a, b in zip(pb, jb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    crop = (352, 1216) if kb else (427, 565)
    assert pb[0]["image"].shape == (2, *crop, 3)


def test_bts_main_trains_resumes_and_retrains(tmp_path, capsys):
    """bts_main on the CPU: 2 steps and a checkpoint; a resume continues at
    step 2; --retrain restores the weights into a fresh run at step 0."""
    from bts_tpu_torch.cli.bts_main import main
    from bts_tpu_torch.utils.checkpoint import CheckpointManager

    kw = _png_tree(tmp_path, "kitti", 4, 80, 112)
    argv = ["--device", "cpu", "--encoder", "densenet121_bts", "--bts_size", "128",
            "--input_height", "64", "--input_width", "96", "--compute_dtype", "float32",
            "--do_random_rotate", "--log_freq", "100", "--save_freq", "100",  # the first and last steps
            "--log_directory", str(tmp_path / "runs"), "--model_name", "m"]
    for k in ("dataset", "data_path", "gt_path", "filenames_file", "batch_size", "use_native_loader"):
        argv += [f"--{k}", str(kw[k])]
    ckpt = CheckpointManager(tmp_path / "runs" / "m" / "ckpt")

    assert main(argv + ["--num_epochs", "1"]) == 0
    assert ckpt.latest_step() == 2 and ckpt.restore()["step"] == 2
    assert main(argv + ["--num_epochs", "2"]) == 0
    assert "resumed @ step 2" in capsys.readouterr().out
    assert ckpt.latest_step() == 4

    retrained = CheckpointManager(tmp_path / "runs" / "m2" / "ckpt")
    assert main(argv + ["--num_epochs", "1", "--model_name", "m2", "--retrain",
                        "--checkpoint_path", str(ckpt.directory)]) == 0
    assert "retrain from" in capsys.readouterr().out
    assert retrained.latest_step() == 2 and retrained.restore()["step"] == 2
    assert os.path.exists(tmp_path / "runs" / "m2" / "config.json")

    # bts_test serves the latest step of the directory bts_main filled
    from bts_tpu_torch.cli import bts_test
    from bts_tpu_torch.data.depth_io import depth_to_png

    image = np.array(Image.open(tmp_path / "rgb" / "0.png"))[:64, :96]  # a multiple of 32
    Image.fromarray(image).save(tmp_path / "rgb" / "t0.png")
    (tmp_path / "test.txt").write_text("rgb/t0.png None 700.0\n")
    out = tmp_path / "pred"
    assert bts_test.main(["--device", "cpu", "--encoder", "densenet121_bts", "--bts_size", "128",
                          "--compute_dtype", "float32", "--dataset", "kitti",
                          "--data_path", kw["data_path"], "--filenames_file", str(tmp_path / "test.txt"),
                          "--use_native_loader", "never", "--checkpoint_path", str(ckpt.directory),
                          "--out_path", str(out)]) == 0
    assert f"restored {ckpt.directory} @ step 4" in capsys.readouterr().out
    cfg = Config(mode="test", encoder="densenet121_bts", bts_size=128, dataset="kitti",
                 compute_dtype="float32")
    model = create_model(cfg)
    model.load_state_dict(ckpt.restore()["model"])
    batch = {"image": image[None], "focal": np.array([700.0], np.float32)}
    outs = next(bts_test.predict(cfg, model, [batch], "cpu"))
    np.testing.assert_array_equal(np.array(Image.open(out / "raw" / "rgb_t0.png")),
                                  depth_to_png(outs[4][0, 0].numpy(), "kitti"))


def test_pretrained_encoder_loads_a_torchvision_state_dict(tmp_path):
    """--pretrained_model: a torchvision DenseNet state_dict, classifier and
    num_batches_tracked included, loads into the encoder by name."""
    from bts_tpu_torch.cli.bts_main import load_pretrained_encoder

    cfg = Config(encoder="densenet121_bts", bts_size=128)
    src = create_model(cfg.replace(seed=1)).encoder.state_dict()
    extra = {"classifier.weight": torch.zeros(10, 1024), "classifier.bias": torch.zeros(10),
             "features.norm0.num_batches_tracked": torch.tensor(3)}
    torch.save(dict(src, **extra), tmp_path / "densenet121.pth")
    model = create_model(cfg)
    load_pretrained_encoder(model, str(tmp_path / "densenet121.pth"))
    assert all(torch.equal(v, src[k]) for k, v in model.encoder.state_dict().items())
