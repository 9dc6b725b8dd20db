"""K7, the eval-mode BatchNorm (+ReLU or SiLU) kernel (``bts_tpu_torch/ops/bn_cuda.py``,
``csrc/batchnorm.cu``), on the CPU: its plain version is ``BatchNorm``'s
arithmetic, its op's CPU and fake implementations agree with the plain
version, the launch refuses what the kernel does not take, and
``BatchNorm`` takes the op exactly in eval mode under no grad on an
NCHW-contiguous f32 or bf16 CUDA tensor.  The rule is checked on fake CUDA
tensors (``FakeTensorMode``), whose ops are recorded as they dispatch.  The
kernel itself, and the count of its launches in a serving forward, run in
tests/test_torch_port_cuda.py, on a card."""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from bts_tpu_torch.models import layers
from bts_tpu_torch.ops import bn_cuda

C = 6
OP = "bts_tpu_torch.bn_act.default"


def _bn(c=C, seed=0):
    """An eval BatchNorm with statistics and affine parameters away from
    their initial values."""
    g = torch.Generator().manual_seed(seed)
    bn = layers.BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn.eval()


def _x(dtype, shape=(2, C, 5, 7), seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


def _params(bn):
    return bn.running_mean, bn.running_var, bn.weight, bn.bias


class _Record(TorchDispatchMode):
    """The names of the ops dispatched inside it, queries left out."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not str(func).startswith("prim."):  # a tensor's device and layout queries
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_modules_arithmetic(dtype, relu):
    """The module (eval, CPU), the plain version and the op's CPU
    implementation equal, bit for bit, BatchNorm's f32 chain rounded once to
    the dtype; act="relu" equals F.relu of the unfused result."""
    bn, x = _bn(), _x(dtype)
    act = "relu" if relu else "none"
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(bn.running_var + layers.BN_EPS) * bn.weight
    chain = ((x.float() - bn.running_mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)).to(dtype)
    ref = F.relu(chain) if relu else chain
    with torch.no_grad():
        outs = [bn(x, act=act), bn_cuda.bn_act_plain(x, *_params(bn), layers.BN_EPS, act),
                bn_cuda.bn_act(x, *_params(bn), layers.BN_EPS, act)]
        assert torch.equal(bn(x, act="relu"), F.relu(bn(x)))
    for out in outs:
        assert out.dtype == dtype and torch.equal(out, ref)
    assert torch.equal(bn(x, act=act), ref)  # under autograd too


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_matches_plain(dtype, layout):
    """The op's fake implementation (what torch.export traces) gives the
    plain version's shape, dtype and strides."""
    bn, x = _bn(), _x(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    ref = bn_cuda.bn_act_plain(x, *_params(bn), layers.BN_EPS, "relu")
    mode = FakeTensorMode()
    fx, fparams = mode.from_tensor(x), [mode.from_tensor(p.detach()) for p in _params(bn)]
    with mode:
        out = bn_cuda.bn_act(fx, *fparams, layers.BN_EPS, "relu")
    assert (out.shape, out.dtype, out.stride()) == (ref.shape, ref.dtype, ref.stride())


@pytest.mark.parametrize("case,expect", [
    ("eval_no_grad", True), ("train", False), ("eval_grad", False), ("channels_last", False),
    ("band", False), ("float16", False), ("cpu", False), ("too_large", False)])
def test_batchnorm_takes_the_op_by_its_rule(case, expect):
    """BatchNorm dispatches the one op bts_tpu_torch::bn_act exactly in eval
    mode, under no grad, on an NCHW-contiguous f32 or bf16 CUDA tensor of
    under 2**31 elements; in every other case it dispatches today's chain (a
    spatial band is a narrowed, non-contiguous view)."""
    device = "cpu" if case == "cpu" else "cuda"
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    with torch.device("meta"):
        bn = layers.BatchNorm(C).train(case == "train")
    # without a card, fake CUDA tensors take no in-place copy (the running
    # statistics) and no autograd graph: the rule reads the grad mode only
    bn.track_stats = False
    bn.requires_grad_(False)
    layout = torch.channels_last if case == "channels_last" else torch.contiguous_format
    with FakeTensorMode(allow_non_fake_inputs=True):  # the meta parameters, replaced by to_empty
        bn.to_empty(device=device)
        shape = (1, C, 2**15, 2**14) if case == "too_large" else (2, C, 6, 8)  # fake: nothing is allocated
        x = torch.empty(shape, dtype=dtype, device=device, memory_format=layout)
        if case == "band":
            x = x.narrow(2, 2, 3)
        with torch.set_grad_enabled(case in ("train", "eval_grad")), _Record() as rec:
            y = bn(x, act="relu")
    assert y.shape == x.shape and y.dtype == dtype
    if expect:
        assert rec.ops == [OP]
    else:
        assert OP not in rec.ops and "aten.rsqrt.default" in rec.ops and "aten.relu_.default" in rec.ops


@pytest.mark.parametrize("case", ["float16", "not_contiguous", "parameter_shape", "too_large", "activation"])
def test_launch_refuses_what_the_kernel_does_not_take(case):
    bn, x = _bn(), _x(torch.bfloat16)
    params = list(_params(bn))
    if case == "too_large":  # 3 * 2**30 elements, on the meta device: nothing is allocated
        x = torch.empty(1, C, 2**15, 2**14, dtype=torch.bfloat16, device="meta")
        params = [q.detach().to("meta") for q in params]
    elif case == "float16":
        x = x.half()
    elif case == "not_contiguous":
        x = x.narrow(2, 1, 3)
    else:
        params[1] = params[1][:-1]
    with pytest.raises(TypeError if case == "float16" else ValueError):
        bn_cuda._k7_cuda(x, *params, layers.BN_EPS, "gelu" if case == "activation" else "none")
