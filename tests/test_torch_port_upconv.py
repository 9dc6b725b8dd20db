"""The fused UpConv, ``downsample_nearest`` and the orbax conversion of
bts_tpu_torch against bts_tpu on the CPU.

Tolerances:
- f32 forward: rtol 2e-5, atol 2e-6, the JAX package's own fused-against-
  literal rule (tests/test_model.py::test_fused_upconv_matches_literal);
- bf16 forward against the JAX fused form: rtol 2^-6 (two bf16 steps) and
  atol 2^-8 * max|ref| (one bf16 step below max|ref|): the JAX form rounds
  the conv and then the bias add to bf16, the port's transposed conv adds
  the bias before its one rounding;
- f32 gradients: rtol 1e-4, atol 1e-5, the JAX package's own rule for its
  two UpConv backwards (tests/test_model.py::
  test_upconv_dilated_bwd_grads_match_literal);
- the port's fused form against its literal form: f32 as above; bf16
  forward within 2^-6 * max|literal| and each gradient's norm gap within
  2^-6, the rule chip_smoke.py's upconv phase holds the card to (the two
  forms round their kernels to bf16 differently: 9 taps each, or the 4x4
  tap sums once).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bts_tpu.models import layers as jlayers
from bts_tpu.ops import resize as jresize
from bts_tpu_torch.models import layers
from bts_tpu_torch.ops import resize
from test_torch_port_model import MAX_DEPTH, NF, TINY, _assert_close_nhwc, _JTiny, _nchw, _random_variables

CIN, COUT = 16, 8
BF16_RTOL, BF16_ATOL_SCALE = 2.0**-6, 2.0**-8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread beside the suite's other workers (see
    test_torch_port_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, b=2, h=9, w=12):
    """x (B, H, W, CIN), an O(1)-scaled 3x3 kernel (HWIO), a bias, and a
    cotangent of the output (B, 2H, 2W, COUT)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, CIN)).astype(np.float32)
    k = (rng.normal(size=(3, 3, CIN, COUT)) / np.sqrt(9 * CIN)).astype(np.float32)
    bias = rng.normal(0, 0.05, COUT).astype(np.float32)
    cot = rng.normal(size=(b, 2 * h, 2 * w, COUT)).astype(np.float32)
    return x, k, bias, cot


def _port(k, bias, dtype=torch.float32, fused=True):
    m = layers.UpConv(CIN, COUT, dtype, fused=fused)
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        m.conv.bias.copy_(torch.from_numpy(bias))
    return m


def _jax_vars(k, bias):
    return {"params": {"ConvBlock_0": {"Conv_0": {"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)}}}}


def _port_grads(m, x, cot, dtype=torch.float32):
    """The port's output (NHWC, f32) and d(x), d(kernel) (HWIO), d(bias)
    for the cotangent ``cot``."""
    xt = _nchw(x).requires_grad_()
    y = m(xt.to(dtype))
    y.backward(_nchw(cot).to(y.dtype))
    return (y.detach().float().permute(0, 2, 3, 1).numpy(), xt.grad.permute(0, 2, 3, 1).numpy(),
            m.conv.weight.grad.permute(2, 3, 1, 0).numpy(), m.conv.bias.grad.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_upconv_matches_jax_default(dtype):
    """The port's default UpConv (fused) against bts_tpu's default
    UpConv(fused=True) on the same weights."""
    x, k, bias, _ = _inputs(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jlayers.UpConv(COUT, dtype=jdt).apply(_jax_vars(k, bias), jnp.asarray(x)).astype(jnp.float32))
    m = layers.UpConv(CIN, COUT, tdt)
    assert m.fused
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        m.conv.bias.copy_(torch.from_numpy(bias))
        out = m(_nchw(x))
    assert out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=2e-5, atol=2e-6)
    else:
        _assert_close_nhwc(out.float(), ref, rtol=BF16_RTOL, scale_tol=BF16_ATOL_SCALE)


def test_fused_upconv_grads_match_jax_dilated():
    """d(x), d(kernel), d(bias) of the port's fused UpConv (autograd of the
    fold and the transposed conv) against jax.vjp of bts_tpu's
    UpConv(bwd="dilated"), the JAX default outside spatial sharding."""
    x, k, bias, cot = _inputs(1)
    _, vjp = jax.vjp(lambda v, xx: jlayers.UpConv(COUT, bwd="dilated").apply(v, xx), _jax_vars(k, bias),
                     jnp.asarray(x))
    gv, gx = vjp(jnp.asarray(cot))
    gconv = gv["params"]["ConvBlock_0"]["Conv_0"]
    _, px, pk, pb = _port_grads(_port(k, bias), x, cot)
    for port, ref in ((px, gx), (pk, gconv["kernel"]), (pb, gconv["bias"])):
        np.testing.assert_allclose(port, np.asarray(ref), rtol=1e-4, atol=1e-5)


def _norm_gap(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matches_literal(dtype):
    """The port's two forms on the same weights: forward and gradients."""
    x, k, bias, cot = _inputs(2)
    tdt = getattr(torch, dtype)
    fused = _port_grads(_port(k, bias, tdt, fused=True), x, cot, tdt)
    literal = _port_grads(_port(k, bias, tdt, fused=False), x, cot, tdt)
    if dtype == "float32":
        np.testing.assert_allclose(fused[0], literal[0], rtol=2e-5, atol=2e-6)
        for f, lit in zip(fused[1:], literal[1:]):
            np.testing.assert_allclose(f, lit, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(fused[0] - literal[0]).max() <= BF16_RTOL * np.abs(literal[0]).max()
        for f, lit in zip(fused[1:], literal[1:]):
            assert _norm_gap(f, lit) <= BF16_RTOL


def test_f32_fused_upconv_forward_is_the_phase_conv():
    """In f32 the fused UpConv's transposed conv runs as one stride-1 2x2
    conv with a block of channels per output phase (cuDNN's forward
    algorithms repeat bit for bit, its f32 transposed-conv algorithm does
    not), in eager and in a ``torch.export`` graph: the forward equals
    ``F.conv_transpose2d``'s within f32 rounding (float64: to 1e-12), as do
    the gradients (the transposed conv's own backward, behind ELU's), and
    the exported program equals eager bit for bit.  bf16 keeps the transposed
    conv."""
    x, k, bias, cot = _inputs(4)
    assert _port(k, bias).deterministic and not _port(k, bias, torch.bfloat16).deterministic
    phase = _port_grads(_port(k, bias), x, cot)
    default = _port(k, bias)
    default.deterministic = False
    transposed = _port_grads(default, x, cot)
    np.testing.assert_allclose(phase[0], transposed[0], rtol=1e-6, atol=1e-6)
    for a, b in zip(phase[1:], transposed[1:]):  # ELU's backward reads that output
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    x64, w64, b64 = (torch.from_numpy(a).double() for a in (x, np.ones((CIN, COUT, 4, 4)), bias))
    w64 = w64 * torch.randn(w64.shape, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    x64 = x64.permute(0, 3, 1, 2)
    gap = layers._phase_conv_transpose_2x(x64, w64, b64) - F.conv_transpose2d(x64, w64, b64, stride=2, padding=1)
    assert gap.abs().max().item() < 1e-12
    m = _port(k, bias)
    with torch.no_grad():
        ep = torch.export.export(m, (_nchw(x),), strict=False)
        assert torch.equal(ep.module()(_nchw(x)), m(_nchw(x)))
    convs = [n for n in ep.graph.nodes if n.op == "call_function" and "conv" in str(n.target)]
    assert [str(n.target) for n in convs] == ["aten.conv2d.default"], convs


@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_nearest_matches_jax(factor):
    x = np.random.default_rng(3).normal(size=(2, 12, 20, 3)).astype(np.float32)
    ref = np.asarray(jresize.downsample_nearest(jnp.asarray(x), factor))
    out = resize.downsample_nearest(_nchw(x), factor)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), ref)


# -- serving a bts_tpu orbax checkpoint ------------------------------------------

TINY_NAME = "tiny_densenet_bts"


@functools.lru_cache(maxsize=None)
def _jax_state_and_ref():
    """A tiny bts_tpu model's random variables, its JAX forward on a seeded
    64x96 b2 batch, and that batch."""
    rng = np.random.default_rng(8)
    image = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    focal = np.array([721.5377, 700.0], np.float32)
    jm = _JTiny("same")
    variables = _random_variables(jm, 9, jnp.zeros((1, 64, 96, 3)), None)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(image), jnp.asarray(focal))
    return variables, [np.asarray(r) for r in ref], image, focal


@pytest.fixture
def tiny_registered(monkeypatch):
    """The tiny DenseNet under an encoder name in the port's registry and
    weight mapping, as the conversion tool looks them up."""
    from bts_tpu_torch.models import encoders
    from bts_tpu_torch.models.encoders.densenet import DenseNet
    from bts_tpu_torch.utils import torch_converter as TC

    spec = dict(cls=DenseNet, kwargs=dict(TINY), channels=DenseNet(**TINY).channels)
    monkeypatch.setitem(encoders.ENCODERS, TINY_NAME, spec)
    monkeypatch.setitem(TC.ENCODER_MAPPINGS, TINY_NAME, lambda: TC.densenet_mapping(TINY["block_config"]))


def _save_orbax(directory, variables, layout):
    """``variables`` saved by bts_tpu's CheckpointManager at step 5: the full
    TrainState (with AdamW state) or the weights-only best layout."""
    from bts_tpu.config import Config as JConfig
    from bts_tpu.training.optimizer import make_optimizer
    from bts_tpu.training.trainer import TrainState
    from bts_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager

    step = jnp.asarray(5, jnp.int32)
    if layout == "full":  # TrainState.create's tree, its AdamW init jitted (eager costs seconds)
        opt_state = jax.jit(make_optimizer(JConfig(), 10).init)(variables["params"])
        state = TrainState(step=step, params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=opt_state)
    else:  # evaluation/best.py's weights-only tree
        state = {"step": step, "params": variables["params"], "batch_stats": variables["batch_stats"]}
    mgr = JCheckpointManager(str(directory))
    mgr.save(5, state)
    mgr.wait()
    mgr.close()


@pytest.mark.parametrize("layout", ["full", "best"])
def test_from_orbax_serves_like_jax(layout, tmp_path, tiny_registered):
    """A bts_tpu orbax checkpoint, converted by tools/from_orbax.py, restored
    the way bts_test restores --checkpoint_path, predicts what the JAX model
    of the same state predicts (the tiny-slice rule: rtol 2e-4, atol
    2e-4*max|ref|); the run's config.json sidecar is carried over."""
    import json

    from bts_tpu_torch.cli.bts_test import predict
    from bts_tpu_torch.config import Config, adopt_sidecar_geometry
    from bts_tpu_torch.tools import from_orbax
    from bts_tpu_torch.utils.weights import read_weights, restore_model

    variables, ref, image, focal = _jax_state_and_ref()
    ckpt = tmp_path / "run" / "ckpt"
    _save_orbax(ckpt, variables, layout)
    (tmp_path / "run" / "config.json").write_text(json.dumps({"encoder_pad_resolved": "same"}))
    out = tmp_path / "converted"
    assert from_orbax.main(["--checkpoint_path", str(ckpt), "--encoder", TINY_NAME, "--bts_size", str(NF),
                            "--out", str(out)]) == 0
    assert (out / "config.json").is_file()
    _, step = read_weights(str(out))
    assert step == 5

    cfg = Config(mode="test", encoder=TINY_NAME, bts_size=NF, max_depth=MAX_DEPTH, compute_dtype="float32",
                 input_height=64, input_width=96, device="cpu", checkpoint_path=str(out))
    cfg = adopt_sidecar_geometry(cfg)
    assert cfg.encoder_pad == "same"
    model = restore_model(cfg, "cpu")
    with torch.inference_mode():
        outs = model(_nchw(image), torch.from_numpy(focal))
    for port, r in zip(outs, ref):
        _assert_close_nhwc(port, r, rtol=2e-4, scale_tol=2e-4)
    # bts_test's own batch path on uint8 frames: finite depth of the right shape
    frames = {"image": np.random.default_rng(1).integers(0, 256, (1, 64, 96, 3), dtype=np.uint8),
              "focal": focal[:1]}
    depth = next(predict(cfg, model, [frames], "cpu"))[4]
    assert depth.shape == (1, 1, 64, 96) and bool(torch.isfinite(depth).all())


def test_read_weights_names_the_tool_on_an_orbax_directory(tmp_path):
    """An orbax directory (or one of its steps) given to read_weights raises
    an error that names tools/from_orbax.py, not a torch.load failure."""
    from bts_tpu_torch.utils.weights import read_weights

    step = tmp_path / "ckpt" / "3"
    step.mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    for path in (tmp_path / "ckpt", step):
        with pytest.raises(ValueError, match="bts_tpu_torch.tools.from_orbax"):
            read_weights(str(path))
