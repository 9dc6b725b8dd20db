"""bts_tpu_torch's layers, encoder, decoder and serving CLI against
bts_tpu on the CPU, with the same weights.

Weights go from the flax tree to the port through the port's copy of the
JAX package's mapping (``bts_tpu_torch/utils/torch_converter.py``, via
``utils/weights.py``; held equal to the original below), with BN statistics
and biases randomised so every leaf matters.

Tolerances: a single layer holds rtol 2e-5, atol 2e-5*max|ref| (one conv's
summation order); the whole tiny slice holds the decoder-oracle rule of
tests/test_torch_oracle.py, rtol 2e-4, atol 2e-4*max|ref|.
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu_torch.config import Config
from bts_tpu.models import layers as jlayers
from bts_tpu.models.bts import BtsDecoder as JBtsDecoder
from bts_tpu.models.encoders.densenet import DenseNet as JDenseNet
from bts_tpu_torch.models import layers
from bts_tpu_torch.models.bts import BtsDecoder, BtsModel, create_model
from bts_tpu_torch.models.encoders.densenet import DenseNet
from bts_tpu_torch.utils import torch_converter as TC
from bts_tpu_torch.utils import weights
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: beside the suite's other
    workers, torch's OpenMP pool oversubscribes the cores and runs tens of
    times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_variables(module, seed, *args):
    """A flax variables tree for ``module`` with numpy leaves drawn from
    ``seed``: lecun-scaled kernels (activations stay O(1)), and non-default
    biases, BN affine and BN statistics so every leaf matters.  The tree's
    structure comes from ``jax.eval_shape`` of the init, so nothing compiles."""
    rng = np.random.default_rng(seed)

    def draw(name, shape, collection):
        if collection == "batch_stats":
            return rng.uniform(0.5, 2.0, shape) if name == "var" else rng.normal(0, 0.1, shape)
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape)
        return rng.normal(0, 0.05, shape)  # bias

    def walk(tree, collection):
        return {
            name: walk(v, collection) if hasattr(v, "items")
            else draw(name, v.shape, collection).astype(np.float32)
            for name, v in tree.items()
        }

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    variables = {c: walk(t, c) for c, t in shapes.items()}
    variables.setdefault("batch_stats", {})
    return variables


def _load_port(module, variables, entries):
    """Copy flax leaves into ``module`` along (flax_path, torch_key, kind)
    entries built from torch_converter's helpers."""
    sd = {}
    for flax_path, torch_key, kind in entries:
        tree = variables["batch_stats"] if flax_path[-1] in ("mean", "var") else variables["params"]
        for p in flax_path:
            tree = tree[p]
        sd[torch_key.lstrip(".")] = torch.from_numpy(TC.flax_to_torch_tensor(np.asarray(tree), kind))
    weights.load_state_dict(module, sd)
    return module.eval()  # inference: BatchNorm applies its running statistics


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _assert_close_nhwc(port, ref, rtol, scale_tol):
    ref = np.asarray(ref)
    port = port.detach().numpy()
    if port.ndim == 4:
        port = port.transpose(0, 2, 3, 1)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=scale_tol * scale)


def _layer_cases():
    conv, bn = TC._conv, TC._bn
    return {
        "conv_block": (
            jlayers.ConvBlock(6),
            layers.ConvBlock(4, 6),
            conv(("Conv_0",), ""),
        ),
        "batch_norm": (jlayers.BatchNorm(), layers.BatchNorm(4), bn((), "")),
        "up_conv": (
            jlayers.UpConv(6),
            layers.UpConv(4, 6),
            conv(("ConvBlock_0", "Conv_0"), "conv"),
        ),
        "atrous_first_bn": (
            jlayers.AtrousConv(3, 6),
            layers.AtrousConv(4, 3, 6),
            bn(("BatchNorm_0",), "first_bn") + conv(("Conv_0",), "conv1")
            + bn(("BatchNorm_1",), "bn") + conv(("Conv_1",), "conv2"),
        ),
        "atrous_rate3": (
            jlayers.AtrousConv(3, 3, apply_bn_first=False),
            layers.AtrousConv(4, 3, 3, apply_bn_first=False),
            conv(("Conv_0",), "conv1") + bn(("BatchNorm_0",), "bn") + conv(("Conv_1",), "conv2"),
        ),
        "reduction_plane": (
            jlayers.Reduction1x1(16),
            layers.Reduction1x1(4, 16),
            TC._reduc_mapping("", "", 16),
        ),
        "reduction_final": (
            jlayers.Reduction1x1(8, is_final=True),
            layers.Reduction1x1(4, 8, is_final=True),
            TC._reduc_mapping("", "", 8),
        ),
    }


@pytest.mark.parametrize("case", sorted(_layer_cases()))
def test_layer_matches_flax(case):
    jmod, pmod, entries = _layer_cases()[case]
    entries = [(tuple(p for p in path if p), key, kind) for path, key, kind in entries]
    x = np.random.default_rng(1).normal(size=(2, 6, 10, 4)).astype(np.float32)
    variables = _random_variables(jmod, 2, jnp.asarray(x))
    ref = jmod.apply(variables, jnp.asarray(x))
    _load_port(pmod, variables, entries)
    with torch.no_grad():
        _assert_close_nhwc(pmod(_nchw(x)), ref, rtol=2e-5, scale_tol=2e-5)


@pytest.mark.parametrize("size", [6, 7])
@pytest.mark.parametrize("style", ["same", "torch"])
def test_stride2_stem_matches_flax(style, size):
    """The stride-2 geometry (layers.pad2) on even and odd sizes: a 7x7/2
    conv and the -inf-padded 3x3/2 max pool, against flax's own padding."""
    x = np.random.default_rng(3).normal(size=(1, size, size + 4, 3)).astype(np.float32)
    jconv = fnn.Conv(5, (7, 7), strides=(2, 2), padding=jlayers.pad2(7, style), use_bias=False)
    jv = _random_variables(jconv, 3, jnp.asarray(x))
    y = jconv.apply({"params": jv["params"]}, jnp.asarray(x))
    ref = fnn.max_pool(y, (3, 3), strides=(2, 2), padding=jlayers.pad2(3, style))
    conv = layers.Conv2d(3, 5, 7, stride=2, padding=0, bias=False)
    _load_port(conv, {"params": jv["params"]}, [(("kernel",), "weight", TC.K_CONV)])
    with torch.no_grad():
        py = conv(layers.pad_stride2(_nchw(x), 7, style))
        out = torch.nn.functional.max_pool2d(layers.pad_stride2(py, 3, style, float("-inf")), 3, 2)
    _assert_close_nhwc(out, ref, rtol=2e-5, scale_tol=2e-5)


TINY = dict(growth_rate=8, block_config=(1, 1, 2, 1), num_init_features=16)
NF, MAX_DEPTH = 128, 80.0  # bts_size 128: the smallest decoder_mapping accepts


class _JTiny(fnn.Module):
    """A tiny DenseNet + BtsDecoder, with BtsModel's subtree names."""

    pad_style: str
    num_features: int = NF

    @fnn.compact
    def __call__(self, image, focal):
        feats = JDenseNet(pad_style=self.pad_style, **TINY)(image, False)
        return JBtsDecoder(max_depth=MAX_DEPTH, num_features=self.num_features)(feats, False, focal)


@pytest.mark.parametrize("pad_style", ["same", "torch"])
def test_tiny_slice_matches_jax(pad_style):
    """Encoder + decoder + the three LPG heads end to end, both stride-2
    geometries, one sample with focal 0 (passes through unscaled)."""
    rng = np.random.default_rng(4)
    image = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    focal = np.array([721.5377, 0.0], np.float32)
    jm = _JTiny(pad_style)
    variables = _random_variables(jm, 5, jnp.zeros((1, 64, 96, 3)), None)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(image), jnp.asarray(focal))

    encoder = DenseNet(pad_style=pad_style, **TINY)
    model = BtsModel(encoder, BtsDecoder(encoder.channels, MAX_DEPTH, NF)).eval()
    sd = weights.state_dict_from_jax(
        variables, "densenet121_bts", NF, encoder_mapping=TC.densenet_mapping(TINY["block_config"])
    )
    weights.load_state_dict(model, sd)
    with torch.inference_mode():
        outs = model(_nchw(image), torch.from_numpy(focal))
    assert len(outs) == len(ref) == 5
    for name, port, r in zip(("depth8", "depth4", "depth2", "depth1x1", "final"), outs, ref):
        assert port.dtype == torch.float32, name
        _assert_close_nhwc(port, r, rtol=2e-4, scale_tol=2e-4)


def _decoder_mapping_64():
    """``decoder_mapping``'s entries for bts_size 64, which it refuses: the
    reduction heads' chains at nf // 4, 8, 16 = 16, 8, 4 and none for
    reduc1x1 (nf // 32 = 2: the JAX module passes its input through)."""
    heads = {"reduc8x8": ("Reduction1x1_0", 16), "reduc4x4": ("Reduction1x1_1", 8),
             "reduc2x2": ("Reduction1x1_2", 4), "reduc1x1": ("Reduction1x1_3", 2)}
    entries = [e for e in TC.decoder_mapping(128) if e[1].split(".")[0] not in heads]
    for prefix, (module, nf) in heads.items():
        entries += TC._reduc_mapping(module, prefix, nf)
    return entries


def test_bts_size_64_matches_jax(monkeypatch):
    """bts_size 64 (the JAX serving tests' tiny config): reduc1x1 has no conv
    and passes upconv1's 4 channels through, so depth_1x1 has 4 channels and
    conv1 takes 11; the forward matches bts_tpu's through a hand-built map."""
    rng = np.random.default_rng(6)
    image = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    focal = np.array([721.5377, 700.0], np.float32)
    jm = _JTiny("same", num_features=64)
    variables = _random_variables(jm, 7, jnp.zeros((1, 64, 96, 3)), None)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(image), jnp.asarray(focal))

    model = create_model(Config(bts_size=64))
    assert model.decoder.conv1.in_channels == 11 and not model.decoder.reduc1x1.convs
    encoder = DenseNet(**TINY)
    model = BtsModel(encoder, BtsDecoder(encoder.channels, MAX_DEPTH, 64)).eval()
    entries = _decoder_mapping_64()
    monkeypatch.setattr(TC, "decoder_mapping", lambda nf: entries)
    sd = weights.state_dict_from_jax(
        variables, "densenet121_bts", 64, encoder_mapping=TC.densenet_mapping(TINY["block_config"])
    )
    weights.load_state_dict(model, sd)
    with torch.inference_mode():
        outs = model(_nchw(image), torch.from_numpy(focal))
    assert outs[3].shape == (2, 4, 64, 96)
    for name, port, r in zip(("depth8", "depth4", "depth2", "depth1x1", "final"), outs, ref):
        _assert_close_nhwc(port, r, rtol=2e-4, scale_tol=2e-4)


def test_full_width_keys_and_shapes():
    """create_model at full width (densenet161_bts, bts_size 512) has exactly
    the keys the mappings name, with the shapes of the independent torch
    oracle modules in tests/test_torch_oracle.py; no forward runs."""
    from test_torch_oracle import TorchBtsDecoder, TorchDenseNet

    model = create_model(Config(encoder="densenet161_bts", bts_size=512))
    sd = model.state_dict()
    expected = {"encoder." + t for _, t, _ in TC.ENCODER_MAPPINGS["densenet161_bts"]()}
    expected |= {"decoder." + t for _, t, _ in TC.decoder_mapping(512)}
    assert set(sd) == expected
    with torch.device("meta"):
        oracle = {"encoder": TorchDenseNet(48, (6, 12, 36, 24), 96),
                  "decoder": TorchBtsDecoder((96, 96, 192, 384, 2208), 512, 80.0)}
    for part, mod in oracle.items():
        for k, v in mod.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert tuple(sd[f"{part}.{k}"].shape) == tuple(v.shape), k
    enc, dec = TC.split_full_state_dict(sd)
    assert len(enc) + len(dec) == len(sd)


def test_seeded_init_is_flax_like_and_reproducible():
    cfg = Config(encoder="densenet121_bts", bts_size=128, seed=3)
    a, b = create_model(cfg).state_dict(), create_model(cfg).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["encoder.features.conv0.weight"]  # lecun normal, truncated at 2 std
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std and 0.8 < w.std().item() / (std * 0.87962566103423978) < 1.2
    assert torch.count_nonzero(a["decoder.conv5.bias"]) == 0
    assert torch.equal(a["decoder.bn5.running_var"], torch.ones(128))


@pytest.mark.parametrize(
    "change,match",
    [({"spatial_shards_w": 2}, "ROADMAP"), ({"spatial_shards": 2}, "ROADMAP")],
)
def test_unported_options_raise(change, match):
    with pytest.raises(NotImplementedError, match=match):
        create_model(Config(bts_size=128, **change))


PORT_MODULES = (
    "bts_tpu_torch", "bts_tpu_torch.config", "bts_tpu_torch.models", "bts_tpu_torch.ops",
    "bts_tpu_torch.ops.lpg_cuda", "bts_tpu_torch.ops.lpg", "bts_tpu_torch.ops.tail_cuda",
    "bts_tpu_torch.ops.silog", "bts_tpu_torch.data.augment",
    "bts_tpu_torch.utils.weights", "bts_tpu_torch.utils.torch_converter",
    "bts_tpu_torch.utils.checkpoint", "bts_tpu_torch.utils.summary", "bts_tpu_torch.utils.preemption",
    "bts_tpu_torch.utils.profiling",
    "bts_tpu_torch.training.optimizer", "bts_tpu_torch.training.trainer",
    "bts_tpu_torch.cli.bts_test", "bts_tpu_torch.tools.lpg_launch_shapes", "bts_tpu_torch.tools.phase_ab",
    "bts_tpu_torch.evaluation", "bts_tpu_torch.evaluation.metrics", "bts_tpu_torch.evaluation.best",
    "bts_tpu_torch.models.encoders.resnet", "bts_tpu_torch.models.encoders.mobilenetv2",
    "bts_tpu_torch.utils.serving", "bts_tpu_torch.cli.bts_export", "bts_tpu_torch.cli.bts_convert",
    "bts_tpu_torch.parallel", "bts_tpu_torch.parallel.distributed",
    "bts_tpu_torch.data.records", "bts_tpu_torch.data.native_loader", "bts_tpu_torch.tools.make_records",
)
NEEDS_PIL = ("bts_tpu_torch.data.crops", "bts_tpu_torch.data.depth_io",
             "bts_tpu_torch.data.dataloader", "bts_tpu_torch.cli.bts_main", "bts_tpu_torch.cli.bts_eval",
             "bts_tpu_torch.cli.bts_serve", "bts_tpu_torch.cli.bts_sequence", "chip_smoke")


def test_port_imports_no_jax_and_no_pil():
    """Every module of the port and chip_smoke.py, imported in a fresh
    process: none pulls in JAX, its libraries, or any module of the JAX
    package ``bts_tpu``; the serving and training modules before the loader,
    the records module and the native loader's binding do not pull in Pillow
    or ``array_record`` either."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "assert 'PIL' not in sys.modules and 'array_record' not in sys.modules\n"
        f"for m in {NEEDS_PIL!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'bts_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_converter_copy_matches_the_jax_package():
    """The port's copy of the weight-name mapping is the JAX package's."""
    from bts_tpu.utils import torch_converter as jtc

    assert TC.decoder_mapping(512) == jtc.decoder_mapping(512)
    assert TC.ENCODER_MAPPINGS.keys() == jtc.ENCODER_MAPPINGS.keys()
    for name in jtc.ENCODER_MAPPINGS:
        assert TC.ENCODER_MAPPINGS[name]() == jtc.ENCODER_MAPPINGS[name]()
    assert (TC.K_CONV, TC.K_DEPTHWISE, TC.K_DIRECT) == (jtc.K_CONV, jtc.K_DEPTHWISE, jtc.K_DIRECT)


@pytest.mark.parametrize("cli", ["bts_test", "bts_main"])
def test_cli_raises_on_cuda_without_a_card(cli, monkeypatch, tmp_path):
    """--device cuda (the default) on a machine without a card raises; the
    entry points never move to the CPU by themselves."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "split.txt").write_text("")
    main = importlib.import_module(f"bts_tpu_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--filenames_file", str(tmp_path / "split.txt"), "--device", "cuda"])


def _save_checkpoint(form, model, tmp_path):
    """``model``'s weights saved in checkpoint ``form``; returns the path
    bts_test is given and the step it should report (None: none)."""
    from bts_tpu_torch.utils.checkpoint import CheckpointManager

    def trainer_state(sd, step):  # Trainer.state_dict()'s keys
        return {"model": sd, "optimizer": {}, "scheduler": {}, "step": step}

    sd = model.state_dict()
    if form == "state_dict":
        torch.save(sd, tmp_path / "sd.pt")
        return tmp_path / "sd.pt", None
    if form == "trainer_file":
        torch.save(trainer_state(sd, 7), tmp_path / "7.pt")
        return tmp_path / "7.pt", 7
    # a directory with an older step of other weights: the latest is used
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(3, trainer_state({k: torch.zeros_like(v) for k, v in sd.items()}, 3))
    mgr.save(5, trainer_state(sd, 5))
    return tmp_path / "ckpt", 5


@pytest.mark.parametrize("checkpoint", ["none", "state_dict", "trainer_file", "directory"])
def test_cli_writes_uint16_predictions(tmp_path, checkpoint, capsys):
    """main() on two tiny KITTI PNGs writes uint16 depth x256 PNGs equal to
    predict()'s final depth, from the seeded init or from saved weights: a
    bare state_dict, a trainer file, or the latest step of a checkpoint
    directory."""
    from PIL import Image

    from bts_tpu.data.depth_io import depth_to_png
    from bts_tpu_torch.cli.bts_test import main, predict

    rng = np.random.default_rng(6)
    (tmp_path / "rgb").mkdir()
    images = rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    for i, img in enumerate(images):
        Image.fromarray(img).save(tmp_path / "rgb" / f"{i}.png")
    (tmp_path / "split.txt").write_text("rgb/0.png None 721.5377\nrgb/1.png None 707.0493\n")
    cfg = Config(mode="test", encoder="densenet121_bts", bts_size=128, dataset="kitti",
                 compute_dtype="float32", seed=0)
    model = create_model(cfg if checkpoint == "none" else cfg.replace(seed=1))
    argv = ["--encoder", "densenet121_bts", "--bts_size", "128", "--dataset", "kitti",
            "--data_path", str(tmp_path), "--filenames_file", str(tmp_path / "split.txt"),
            "--compute_dtype", "float32", "--out_path", str(tmp_path / "out"), "--save_lpg",
            "--use_native_loader", "never", "--device", "cpu"]
    if checkpoint != "none":
        path, step = _save_checkpoint(checkpoint, model, tmp_path)
        argv += ["--checkpoint_path", str(path)]
    assert main(argv) == 0
    if checkpoint != "none":
        at = "" if step is None else f" @ step {step}"
        assert f"restored {path}{at}\n" in capsys.readouterr().out

    # batch 1, as main() runs (the CPU conv's rounding depends on the batch)
    batches = [{"image": images[i : i + 1], "focal": np.array([f], np.float32)}
               for i, f in enumerate((721.5377, 707.0493))]
    for i, outs in enumerate(predict(cfg, model, batches, "cpu")):
        png = np.array(Image.open(tmp_path / "out" / "raw" / f"rgb_{i}.png"))
        assert png.dtype == np.uint16
        np.testing.assert_array_equal(png, depth_to_png(outs[4][0, 0].numpy(), "kitti"))
        assert (tmp_path / "out" / "lpg_8x8" / f"rgb_{i}.png").exists()


def test_cli_refuses_an_empty_checkpoint_directory(tmp_path):
    """An empty --checkpoint_path directory raises; bts_test never serves
    the random init in its place."""
    from bts_tpu_torch.cli.bts_test import main

    (tmp_path / "ckpt").mkdir()
    (tmp_path / "split.txt").write_text("")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        main(["--encoder", "densenet121_bts", "--bts_size", "128", "--filenames_file",
              str(tmp_path / "split.txt"), "--checkpoint_path", str(tmp_path / "ckpt"),
              "--use_native_loader", "never", "--device", "cpu"])
