"""bts_tpu_torch's EfficientNet-B5 encoder (``efficientnet_b5_bts``, which the
JAX package does not have) against the benchmark's plain reference
(``portbench/reference``) on the CPU, on seeded weights
(``portbench/harness/weights.make_state``): its names and shapes, its five
taps, a whole BtsModel's forward and one training step, remat, a timm
``state_dict`` through ``--pretrained_model``, and K7's SiLU in its plain
version.  No JAX: the reference is plain PyTorch.

Tolerances: the taps of a one-block-per-stage B5 at full widths hold rtol
2e-4, atol 2e-4*max|ref| (the slice rule of tests/test_torch_port_model.py);
the whole model's final depth a relative rms under 1e-4 and the LPG maps
1e-3, as portbench/tests/test_portbench_reference.py holds the other
encoders (an LPG map is large where a denominator nears 0).
"""

import pytest
import torch
import torch.nn.functional as F

from bts_tpu_torch.cli.bts_main import check_spatial, load_pretrained_encoder
from bts_tpu_torch.config import Config
from bts_tpu_torch.models import layers
from bts_tpu_torch.models.bts import create_model
from bts_tpu_torch.models.encoders import freeze_prefixes, resolved_pad
from bts_tpu_torch.models.encoders.efficientnet import EfficientNet
from bts_tpu_torch.ops import bn_cuda
from bts_tpu_torch.training.optimizer import freeze
from bts_tpu_torch.training.trainer import Trainer
from portbench.harness import inputs, program, weights
from portbench.reference import augment
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.reference.encoders import efficientnet_b5_bts as ref_enc

NAME = "efficientnet_b5_bts"
ONE_A_STAGE = (1,) * 7
PERTURB = 4e-6  # the relative weight perturbation of the gradient rule, tests/test_torch_port_train.py's


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers torch's OpenMP
    pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_rms(a, b):
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def test_state_dict_is_the_references_and_timms_layout():
    """The full-width B5 BtsModel has exactly the reference's names and
    shapes (meta tensors), timm's ``tf_efficientnet_b5`` encoder widths
    (28.34 M parameters without the classifier) and the registry's taps."""
    with torch.device("meta"):
        model = create_model(Config(encoder=NAME, bts_size=512), "meta")
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == \
        {n: tuple(s) for n, s in ref_model.state_shapes(NAME, 512)}
    assert sum(p.numel() for p in model.encoder.parameters()) == 28_340_784
    assert model.encoder.channels == ref_enc.CHANNELS == (24, 40, 64, 176, 2048)
    sd = model.encoder.state_dict()
    assert tuple(sd["blocks.2.0.conv_dw.weight"].shape) == (240, 1, 5, 5)
    assert tuple(sd["blocks.0.0.se.conv_reduce.weight"].shape) == (12, 48, 1, 1)
    assert tuple(sd["blocks.6.2.se.conv_expand.bias"].shape) == (3072,)
    assert len([k for k in sd if k.endswith(".conv_dw.weight")]) == 39


@pytest.mark.parametrize("num", [1, 2])
def test_freeze_prefixes_are_the_stem_and_first_stages(num):
    """--fix_first_conv_block(s) freezes the stem and blocks.0 (and
    blocks.1) of the encoder, by timm's names, and nothing else."""
    with torch.device("meta"):
        model = create_model(Config(encoder=NAME, bts_size=128), "meta")
    assert freeze_prefixes(NAME, num) == ("conv_stem", "bn1") + tuple(f"blocks.{i}" for i in range(num))
    frozen = set(freeze(model, Config(encoder=NAME, fix_first_conv_block=num == 1, fix_first_conv_blocks=num == 2)))
    stages = tuple(f"encoder.blocks.{i}." for i in range(num))
    expected = {"encoder." + n for n, _ in model.encoder.named_parameters()
                if n.startswith(("conv_stem.", "bn1.")) or ("encoder." + n).startswith(stages)}
    assert frozen == expected and "encoder.bn1.weight" in frozen and "encoder.bn2.weight" not in frozen


def _small_state(seed):
    """Seeded weights of a one-block-per-stage B5 at full widths, with
    running statistics away from (0, 1) so that every BatchNorm leaf counts."""
    shapes = []
    ref_enc.shapes(lambda n, o, i, k, bias=False: shapes.extend(
        [(n + ".weight", torch.Size((o, i, k, k)))] + ([(n + ".bias", torch.Size((o,)))] if bias else [])),
        lambda n, c: shapes.extend((f"{n}.{t}", torch.Size((c,)))
                                   for t in ("weight", "bias", "running_mean", "running_var")),
        repeats=ONE_A_STAGE)
    state = weights.make_state(shapes, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for n, t in state.items():
        if n.endswith(".running_mean"):
            t.copy_(0.1 * torch.randn(t.shape, generator=g))
        elif n.endswith(".running_var"):
            t.copy_(0.5 + torch.rand(t.shape, generator=g))
    return state


@pytest.mark.parametrize("pad_style", ["same", "torch"])
def test_taps_match_the_reference(pad_style):
    """The five taps (strides 2..32) of a one-block-per-stage B5 at full
    widths, 2 x 64 x 96, f32, eval.  The reference pads stride-2 windows as
    TF-SAME; ``encoder_pad=torch`` must then differ at the first one."""
    state = _small_state(3)
    enc = EfficientNet(ONE_A_STAGE, pad_style=pad_style).eval()
    enc.load_state_dict({n[len("encoder."):]: t for n, t in state.items()})
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(4))
    m = ref_model.Model(state, NAME, 512, 80.0, train=False)
    with torch.no_grad():
        taps, want = enc(x), ref_enc.features(m, x, repeats=ONE_A_STAGE)
    assert [tuple(t.shape) for t in taps] == [tuple(w.shape) for w in want] == \
        [(2, c, 64 // s, 96 // s) for c, s in zip(enc.channels, (2, 4, 8, 16, 32))]
    for t, w in zip(taps, want):
        close = torch.allclose(t, w, rtol=2e-4, atol=2e-4 * w.abs().max().item())
        assert close == (pad_style == "same")


def _model_cfg(bts_size):
    return {"encoder": NAME, "bts_size": bts_size, "max_depth": 80.0, "dataset": "kitti",
            "compute_dtype": "float32", "use_pallas": "never", "focal": 721.5377}


def test_model_forward_matches_the_reference():
    """A whole BtsModel (B5, bts_size 512) at 2 x 64 x 96 against the
    reference's forward on one seeded state: the final depth, and the LPG
    maps."""
    m = _model_cfg(512)
    state = weights.model_state(m, 7, "cpu")
    model = program.build_model(program.config(m, {}, 0, "cpu", "test"), state, "cpu")
    frames = inputs.frames(torch.Generator().manual_seed(3), 2, 64, 96, "cpu")
    focal = torch.tensor([721.5377, 700.0])
    with torch.no_grad():
        image = augment.eval_preprocess(frames).permute(0, 3, 1, 2)
        got = model(image, focal)
        want = ref_model.forward(state, image, focal, encoder=NAME, bts_size=512, max_depth=80.0)
    assert _rel_rms(got[4], want[4]) < 1e-4
    for g, w in zip(got[1:4], want[1:4]):
        assert torch.allclose(g, w, rtol=1e-3, atol=1e-3)


def test_training_step_matches_the_reference():
    """One Trainer.train_step (B5, bts_size 128, b2, 64 x 96 crops of 80 x
    112 frames, f32) against reference/train.py's step: the loss (rtol
    1e-5), each BatchNorm statistic after the step, and every gradient
    tensor within 1e-4 of its norm or within twice the distance it moves
    when the weights move by ``PERTURB`` (the program's own step from
    perturbed weights), the whole gradient likewise.

    Why the probe: here the f32 gradient is not continuous in the weights.
    Every conv feeds a train-mode BatchNorm, which makes its gradient a
    ReLU-masked sum of a zero-mean field (the decoder's ReLUs), so the
    pre-activations within rounding of zero decide it: a relative change of
    1e-7 in the weights, f32's rounding, moves the reference's own gradient
    by ~2% of its norm, most in the encoder's first stages, and the
    program's forward differs from the reference's by ~1e-6 (the fused
    UpConv, summation orders).  The rule and its perturbation are
    tests/test_torch_port_train.py's for DenseNet against JAX."""
    m = _model_cfg(128)
    train = {"input_height": 64, "input_width": 96, "batch_size": 2, "do_random_rotate": True, "degree": 1.0,
             "learning_rate": 1e-4, "end_learning_rate": -1.0, "weight_decay": 1e-2, "adam_eps": 1e-3,
             "variance_focus": 0.85, "remat": False, "total_steps": 100}
    traffic = {"batch": 2, "pool_batches": 1, "frame_height": 80, "frame_width": 112,
               "depth": {"kind": "sparse", "fraction": 0.3, "low": 1.0, "high": 80.0}}
    batch = inputs.train_pool(traffic, 721.5377, 5, "cpu")[0]
    cfg = program.config(m, train, 11, "cpu", "train")
    state = weights.model_state(m, 9, "cpu")
    g = torch.Generator().manual_seed(0)
    perturbed = {n: t * (1 + PERTURB * (torch.randint(0, 2, t.shape, generator=g) * 2 - 1))
                 if not n.endswith((".running_mean", ".running_var")) else t.clone() for n, t in state.items()}
    runs = []
    for st in (state, perturbed):
        model = program.build_model(cfg, {n: t.clone() for n, t in st.items()}, "cpu")
        trainer = Trainer(model, cfg, total_steps=train["total_steps"], device="cpu")
        runs.append((float(trainer.train_step(batch)["loss"]), {n: p.grad for n, p in model.named_parameters()},
                     model.state_dict()))
    (loss, grads, after), (_, probe, _) = runs

    stat = (".running_mean", ".running_var")
    params = {n: t for n, t in state.items() if not n.endswith(stat)}
    buffers = {n: t for n, t in state.items() if n.endswith(stat)}
    ref_loss, ref_grads, _ = ref_train.step(params, buffers, ref_train.AdamW(params, train), batch, 11, m, train)

    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    total = torch.sqrt(sum(r.pow(2).sum() for r in ref_grads.values()))
    gaps = {n: ((grads[n] - r).norm(), r.norm(), (grads[n] - probe[n]).norm()) for n, r in ref_grads.items()}
    for n, (gap, norm, moved) in gaps.items():
        assert gap <= max(1e-4 * norm, 2 * moved, 1e-6 * total), (n, gap, norm, moved)
    whole = [torch.sqrt(sum(v[i] ** 2 for v in gaps.values())) for i in (0, 2)]
    assert whole[0] <= max(2e-3 * total, 2 * whole[1])
    for n, t in buffers.items():
        assert torch.allclose(after[n], t, rtol=1e-4, atol=1e-6), n


def test_remat_matches_no_remat():
    """--remat (a checkpoint per block) gives the no-remat loss, gradients
    and BatchNorm running statistics exactly."""
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(3))
    results = []
    for remat in (False, True):
        torch.manual_seed(0)
        net = EfficientNet(ONE_A_STAGE, remat=remat).train()
        loss = sum(f.square().mean() for f in net(x))
        loss.backward()
        results.append((loss, [p.grad for p in net.parameters()], list(net.buffers())))
    (l0, g0, b0), (l1, g1, b1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))


def test_a_timm_state_dict_loads_through_pretrained_model(tmp_path):
    """A state_dict under timm's tf_efficientnet_b5 names, with its
    ``num_batches_tracked`` entries and its classifier, loads into the
    encoder through --pretrained_model's loader; ``encoder_pad=auto`` keeps
    TF-SAME for these TF-ported weights (torchvision's want "torch")."""
    cfg = Config(encoder=NAME, bts_size=128, pretrained_model=str(tmp_path / "b5.pth"))
    with torch.device("meta"):
        model = create_model(cfg, "meta")
    model = model.to_empty(device="cpu")
    g = torch.Generator().manual_seed(0)
    sd = {n: torch.randn(t.shape, generator=g) for n, t in model.encoder.state_dict().items()}
    timm = dict(sd)
    for n in sd:
        if n.endswith(".running_var"):
            timm[n[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(1000)
    timm.update({"classifier.weight": torch.zeros(1000, 2048), "classifier.bias": torch.zeros(1000)})
    torch.save(timm, cfg.pretrained_model)
    load_pretrained_encoder(model, cfg.pretrained_model)
    assert all(torch.equal(t, sd[n]) for n, t in model.encoder.state_dict().items())
    assert resolved_pad(cfg) == "same"
    assert resolved_pad(cfg.replace(encoder="resnet50_bts")) == "torch"
    assert resolved_pad(cfg.replace(encoder_pad="torch")) == "torch"


def test_spatial_sharding_is_refused():
    """The squeeze-excite's mean is over each whole frame: --spatial_shards
    with this encoder raises, naming it, in create_model and in bts_main's
    check before any process group is asked."""
    for kw in ({"spatial_shards": 2}, {"spatial_shards_w": 2}):
        cfg = Config(encoder=NAME, bts_size=128, input_height=64, input_width=96, **kw)
        for refuse in (lambda: create_model(cfg, "meta"), lambda: check_spatial(cfg)):
            with pytest.raises(ValueError, match="global mean"):
                refuse()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_is_taken_of_the_f32_normalisation_and_rounded_once(dtype):
    """K7's plain version with SiLU (``bn_cuda.normalize``), the op's CPU
    implementation and BatchNorm(act="silu") in eval mode all equal F.silu
    of the f32 normalisation (eps 1e-3) rounded once to the dtype, bit for
    bit; in bf16 that differs from F.silu of the rounded normalisation."""
    g = torch.Generator().manual_seed(0)
    c = 24
    bn = layers.BatchNorm(c, eps=1e-3).eval()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    x = (3 * torch.randn(2, c, 9, 13, generator=g)).to(dtype)
    params = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    shape = (1, -1, 1, 1)
    z = (x.float() - bn.running_mean.view(shape)) * (torch.rsqrt(bn.running_var + 1e-3) * bn.weight).view(shape) \
        + bn.bias.view(shape)
    want = F.silu(z).to(dtype)
    with torch.no_grad():
        outs = [bn_cuda.normalize(x.float(), *params, 1e-3, dtype, "silu"),
                bn_cuda.bn_act_plain(x, *params, 1e-3, "silu"), bn_cuda.bn_act(x, *params, 1e-3, "silu"),
                bn(x, act="silu")]
    for out in outs:
        assert out.dtype == dtype and torch.equal(out, want)
    if dtype == torch.bfloat16:
        assert not torch.equal(want, F.silu(z.to(dtype).float()).to(dtype))
