"""bts_tpu_torch's ResNet / ResNeXt and MobileNetV2 encoders against
bts_tpu on the CPU, with the same weights.

Weights go from the flax tree to the port through the port's copy of the
mapping (``utils/torch_converter.py``), with random BN statistics and affine
parameters so every leaf matters.  The reduced-depth encoders (ResNet with
one bottleneck per stage, plain and grouped; the whole MobileNetV2) hold all
five taps to rtol 2e-4, atol 2e-4*max|ref| (the slice rule of
tests/test_torch_port_model.py) under both stride-2 geometries.  The JAX
references are jitted: at these sizes a compile takes about a second, less
than running them op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bts_tpu.models.encoders import ENCODERS as J_ENCODERS
from bts_tpu.models.encoders import build_encoder as j_build_encoder
from bts_tpu.models.encoders import freeze_prefixes as j_freeze_prefixes
from bts_tpu.models.encoders.mobilenetv2 import MobileNetV2 as JMobileNetV2
from bts_tpu.models.encoders.resnet import ResNet as JResNet
from bts_tpu_torch.config import Config
from bts_tpu_torch.models.bts import create_model
from bts_tpu_torch.models.encoders import ENCODERS, build_encoder, encoder_channels, freeze_prefixes
from bts_tpu_torch.models.encoders.mobilenetv2 import MobileNetV2
from bts_tpu_torch.models.encoders.resnet import ResNet
from bts_tpu_torch.utils import torch_converter as TC
from bts_tpu_torch.utils import weights
from test_torch_port_model import (  # noqa: F401
    _assert_close_nhwc, _load_port, _nchw, _one_torch_thread, _random_variables,
)

REDUCED = (1, 1, 1, 1)
# the registry names both packages have (efficientnet_b5_bts is the port's
# alone; tests/test_torch_port_efficientnet.py holds its keys and prefixes)
SHARED = sorted(set(ENCODERS) & set(J_ENCODERS))
FAMILIES = {
    # name -> (JAX module, port module, mapping), each built for a pad style
    "resnet": (lambda ps: JResNet(stage_sizes=REDUCED, pad_style=ps),
               lambda ps: ResNet(REDUCED, pad_style=ps), lambda: TC.resnet_mapping(REDUCED)),
    "resnext": (lambda ps: JResNet(stage_sizes=REDUCED, groups=4, width_per_group=4, pad_style=ps),
                lambda ps: ResNet(REDUCED, groups=4, width_per_group=4, pad_style=ps),
                lambda: TC.resnet_mapping(REDUCED)),
    "mobilenetv2": (lambda ps: JMobileNetV2(pad_style=ps), lambda ps: MobileNetV2(pad_style=ps),
                    TC.mobilenetv2_mapping),
}


@pytest.mark.parametrize("pad_style", ["same", "torch"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_encoder_taps_match_flax(family, pad_style):
    """All five taps (strides 2..32) of a 64x96 batch of 2, inference BN."""
    jmake, pmake, mapping = FAMILIES[family]
    x = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(np.float32)
    jm = jmake(pad_style)
    variables = _random_variables(jm, 2, jnp.asarray(x))
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    port = _load_port(pmake(pad_style), variables, mapping())
    with torch.no_grad():
        taps = port(_nchw(x))
    assert len(taps) == len(ref) == 5
    assert tuple(t.shape[1] for t in taps) == port.channels
    for t, r in zip(taps, ref):
        _assert_close_nhwc(t, r, rtol=2e-4, scale_tol=2e-4)


@pytest.mark.parametrize("name", SHARED)
def test_full_width_keys_and_shapes(name):
    """Each registry encoder at full width has exactly the torch keys of its
    mapping, each with the shape of its flax leaf (transposed), and the
    registry's channels; nothing is computed (meta tensors, jax.eval_shape)."""
    shapes = jax.eval_shape(j_build_encoder(name).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    with torch.device("meta"):
        enc = build_encoder(name)
    sd = enc.state_dict()
    mapping = TC.ENCODER_MAPPINGS[name]()
    assert set(sd) == {key for _, key, _ in mapping}
    for path, key, kind in mapping:
        leaf = shapes["batch_stats" if path[-1] in ("mean", "var") else "params"]
        for p in path:
            leaf = leaf[p]
        expected = TC.flax_to_torch_tensor(np.empty(leaf.shape, np.float32), kind).shape
        assert tuple(sd[key].shape) == tuple(expected), key
    assert enc.channels == encoder_channels(name)


@pytest.mark.parametrize("num", [1, 2])
@pytest.mark.parametrize("name", SHARED)
def test_freeze_prefixes_match_jax(name, num):
    """--fix_first_conv_block(s): the port's prefixes (torchvision names)
    freeze exactly the parameters that the JAX package's prefixes (flax
    names) name, through the mapping."""
    jfrozen = set(j_freeze_prefixes(name, num))
    expected = {key for path, key, _ in TC.ENCODER_MAPPINGS[name]()
                if path[0] in jfrozen and path[-1] not in ("mean", "var")}
    with torch.device("meta"):
        enc = build_encoder(name)
    prefixes = tuple(p + "." for p in freeze_prefixes(name, num))
    assert {n for n, _ in enc.named_parameters() if n.startswith(prefixes)} == expected


@pytest.mark.parametrize("family", ["resnext", "mobilenetv2"])
def test_remat_matches_no_remat(family):
    """--remat (a checkpoint per bottleneck / inverted residual) gives the
    no-remat loss, gradients and BN running statistics exactly."""
    make = {"resnext": lambda remat: ResNet(REDUCED, groups=4, width_per_group=4, remat=remat),
            "mobilenetv2": lambda remat: MobileNetV2(remat=remat)}[family]
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 64, 96)).astype(np.float32))
    results = []
    for remat in (False, True):
        torch.manual_seed(0)
        net = make(remat).train()
        loss = sum(f.square().mean() for f in net(x))
        loss.backward()
        results.append((loss, [p.grad for p in net.parameters()], list(net.buffers())))
    (l0, g0, b0), (l1, g1, b1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))


def test_mobilenetv2_model_matches_jax():
    """A whole BtsModel with mobilenetv2_bts (bts_size 128) at 64x96 against
    the JAX BtsModel on weights carried over by state_dict_from_jax: the five
    outputs, one sample with focal 0."""
    from bts_tpu.models.bts import BtsModel as JBtsModel

    rng = np.random.default_rng(4)
    image = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    focal = np.array([721.5377, 0.0], np.float32)
    jm = JBtsModel(encoder_name="mobilenetv2_bts", max_depth=80.0, num_features=128)
    variables = _random_variables(jm, 5, jnp.zeros((1, 64, 96, 3)))
    ref = jax.jit(lambda v, x, f: jm.apply(v, x, focal=f))(variables, jnp.asarray(image), jnp.asarray(focal))
    model = create_model(Config(encoder="mobilenetv2_bts", bts_size=128, max_depth=80.0,
                                compute_dtype="float32"))
    weights.load_state_dict(model, weights.state_dict_from_jax(variables, "mobilenetv2_bts", 128))
    with torch.inference_mode():
        outs = model(_nchw(image), torch.from_numpy(focal))
    for port, r in zip(outs, ref):
        _assert_close_nhwc(port, r, rtol=2e-4, scale_tol=2e-4)
