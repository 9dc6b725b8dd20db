"""Eval-mode BatchNorm, with the activation after it where asked (ReLU or
SiLU), in one pass on Hopper (K7, ``csrc/batchnorm.cu``): its plain PyTorch
version, its launch, its registered op and the call
``models/layers.py::BatchNorm`` makes.

K7 replaces no TPU kernel (the JAX package leaves BatchNorm to XLA, which
fuses it); it replaces the eight ATen launches of the f32 chain, and the
F.relu or F.silu after it, with one bf16 (or f32) pass: its bound is bytes,
see the source's header.

- :func:`normalize` is the arithmetic of ``BatchNorm`` in every mode:
  ``mul = rsqrt(var + eps) * weight``, ``y = (x - mean) * mul + bias`` in
  f32, then the activation ``act``: "none", "relu" (on the rounded y; it
  commutes with the rounding) or "silu" (``y * sigmoid(y)`` on the f32 y),
  rounded once to the compute dtype.
  :func:`bn_act_plain` applies it to x; it is K7's oracle and its CPU path.
- :data:`bn_act` is the ``torch.library`` op ``bts_tpu_torch::bn_act``, so
  ``torch.export`` captures it and a profiler finds K7 under it: a CUDA
  implementation (the launch, :func:`_k7_cuda`), a CPU one (the plain
  version) and a fake one.  ``BatchNorm`` calls the op itself: on the H100's
  host its dispatch adds 8-10 us to the launch's 21-33 us, where the chain
  it replaces cost 120-170 us (PERF.md).
- On a CUDA tensor K7 launches or raises; it never falls back.  Each launch
  adds one to ``bn_act.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from bts_tpu_torch.ops import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes (the compute dtypes)
ACTS = {"none": 0, "relu": 1, "silu": 2}  # the kernel's activation codes
MAX_NUMEL, MAX_PLANE = 2**31, 2**27  # the kernel indexes in 32 bits: numel < MAX_NUMEL, H * W <= MAX_PLANE


def fits(x: torch.Tensor) -> bool:
    """Whether K7 takes x's size: under 2**31 elements, planes of at most
    2**27 pixels (every tensor of the port's forwards; the largest holds
    ~82 M elements)."""
    return x.numel() < MAX_NUMEL and x.shape[-2] * x.shape[-1] <= MAX_PLANE


def normalize(xf: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor, eps: float, dtype: torch.dtype, act: str) -> torch.Tensor:
    """BatchNorm of an f32 NCHW ``xf`` by per-channel statistics and affine
    parameters, in f32, then ``act`` (a key of :data:`ACTS`), rounded once
    to ``dtype``.  SiLU is taken of the f32 value before the rounding.  The
    ReLU is in place after it: y is this function's own tensor, which no
    backward saves, and the caller still holds x, so a second output would
    add an activation to the peak that a ReLU after the module did not."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    if act == "silu":
        return F.silu(y).to(dtype)
    y = y.to(dtype)
    if act == "relu":
        return torch.relu_(y)
    if act != "none":
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    return y


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, eps: float, act: str) -> torch.Tensor:
    """Plain PyTorch K7: :func:`normalize` of x, in x's dtype."""
    return normalize(x.float(), mean, var, weight, bias, eps, x.dtype, act)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("batchnorm")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bn_act_forward.argtypes = [vp, vp, i32, vp, vp, vp, vp, ctypes.c_float, i64, i32, i32, i32, i32, vp]
    lib.bn_act_forward.restype = i32
    lib.bn_act_error_string.argtypes = [i32]
    lib.bn_act_error_string.restype = ctypes.c_char_p
    return lib


def _k7_cuda(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor, eps: float, act: str) -> torch.Tensor:
    """K7 on a CUDA tensor, on the current stream; adds one to
    ``bn_act.launches``.  The CUDA implementation of :data:`bn_act`: x is
    an NCHW-contiguous f32 or bf16 tensor, the four parameters contiguous f32
    (C,) tensors on its device."""
    if x.dtype not in DTYPES:
        raise TypeError(f"bn_act: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"bn_act: x must be an NCHW-contiguous 4-D tensor, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    n, c, h, w = x.shape
    dev = x.get_device()
    # one chained test, as cheap as it can be on the host (the call's cost
    # is the host's at b1), then the message
    if not (mean.dtype is var.dtype is weight.dtype is bias.dtype is torch.float32
            and mean.dim() == var.dim() == weight.dim() == bias.dim() == 1
            and mean.numel() == var.numel() == weight.numel() == bias.numel() == c
            and mean.get_device() == var.get_device() == weight.get_device() == bias.get_device() == dev
            and mean.is_contiguous() and var.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        got = [(p.dtype, tuple(p.shape), str(p.device), p.is_contiguous()) for p in (mean, var, weight, bias)]
        raise ValueError(f"bn_act: each parameter must be a contiguous float32 ({c},) tensor on {x.device}, "
                         f"got (dtype, shape, device, contiguous) {got}")
    if not fits(x):
        raise ValueError(f"bn_act: {tuple(x.shape)} is beyond the kernel's 2**31 elements or 2**27-pixel planes")
    if act not in ACTS:
        raise ValueError(f"bn_act: act must be one of {sorted(ACTS)}, got {act!r}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    err = _lib().bn_act_forward(x.data_ptr(), y.data_ptr(), DTYPES[x.dtype], mean.data_ptr(), var.data_ptr(),
                                weight.data_ptr(), bias.data_ptr(), eps, y.numel(), c, h * w, ACTS[act], dev,
                                torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: {_lib().bn_act_error_string(err).decode()}")
    bn_act.launches += 1
    return y


# Eval-mode BatchNorm (+ ReLU or SiLU): x (N, C, H, W) and f32 (C,) mean, var,
# weight, bias -> y in x's dtype and layout.  A CPU tensor takes
# bn_act_plain; a CUDA tensor launches K7 on the current stream (_k7_cuda).
bn_act = torch.library.custom_op("bts_tpu_torch::bn_act", _k7_cuda, mutates_args=(), device_types="cuda")
bn_act.register_kernel("cpu")(bn_act_plain)


@bn_act.register_fake
def _(x, mean, var, weight, bias, eps, act):
    return torch.empty_like(x)


bn_act.launches = 0  # K7 launches since the last reset, read by chip_smoke.py and the tests
