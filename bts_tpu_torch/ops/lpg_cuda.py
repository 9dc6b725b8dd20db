"""The LPG kernels on Hopper: the fused reduction_1x1 -> LPG head (forward
K1, backward K2) and the LPG of an already-transformed plane (forward K3,
backward K4), their wrappers, registered ops, autograd and plain PyTorch
versions.

Counterpart of ``bts_tpu/ops/lpg_pallas.py``: ``lpg_fused`` and its VJP (K1,
K2), ``lpg`` and its VJP (K3, K4).  The public functions keep the JAX layout:
raw (B, h, w, 3) or plane (B, h, w, 4) in any float dtype and any strides ->
(B, h*k, w*k) float32.

- K1 and K2 are ``torch.library`` ops, ``bts_tpu_torch::lpg_fused_fwd`` and
  ``bts_tpu_torch::lpg_fused_bwd``, so ``torch.export`` captures them:
  each has a CUDA implementation (the kernel launch), a CPU one (the plain
  version) and a fake one (the output's shape, dtype and strides).
  :data:`lpg_fused` (K1) is the op itself and differentiable, with
  :data:`lpg_fused_bwd` (K2) as its registered backward.
- :func:`lpg_plane` is differentiable (:class:`Lpg`): its forward is
  :func:`lpg_plane_fwd`, its backward :func:`lpg_plane_bwd`.
- Each wrapper launches its kernel (``csrc/lpg_fused.cu``) on CUDA tensors
  and computes its plain version (``*_plain``) on CPU tensors.  A gradient
  comes back in the dtype of the input, as the JAX VJPs cast it.
- On a CUDA tensor a wrapper launches its kernel or raises; it never falls
  back.  Each launch adds one to ``lpg_fused.launches`` (K1),
  ``lpg_fused_bwd.launches`` (K2), ``lpg_plane.launches`` (K3) or
  ``lpg_plane_bwd.launches`` (K4).
- The plain versions are the CPU path, the ``use_pallas="never"`` path (the
  forward, differentiated by autograd) and the kernels' oracles.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bts_tpu_torch.ops import _build

SUPPORTED_K = (2, 4, 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes (the compute dtypes)


def _spherical(x0, x1, x2):
    """Low-res spherical transform; returns (n1, n2, n3, n4_scaled)."""
    t = torch.sigmoid(x0) * (math.pi / 3)
    p = torch.sigmoid(x1) * (2 * math.pi)
    st, ct = torch.sin(t), torch.cos(t)
    sp, cp = torch.sin(p), torch.cos(p)
    return st * cp, st * sp, ct, torch.sigmoid(x2)


def _patch_coords(k: int, device) -> torch.Tensor:
    """Patch-centred offsets (i - (k-1)/2)/k for i in [0, k)."""
    return (torch.arange(k, dtype=torch.float32, device=device) - (k - 1) * 0.5) / k


def _expanded_plane(raw3: torch.Tensor, k: int):
    """(numerator, denominator) of the fused head, each (B, h, k, w, k) f32."""
    r = raw3.float()
    n1, n2, n3, n4s = (c[:, :, None, :, None] for c in _spherical(r[..., 0], r[..., 1], r[..., 2]))
    off = _patch_coords(k, raw3.device)
    u = off.view(1, 1, 1, 1, k)  # column offset
    v = off.view(1, 1, k, 1, 1)  # row offset
    return n4s, n1 * u + n2 * v + n3


def lpg_fused_plain(raw3: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch fused head: raw (B, h, w, 3) -> (B, h*k, w*k) f32."""
    b, h, w, _ = raw3.shape
    num, den = _expanded_plane(raw3, k)
    return (num / den).reshape(b, h * k, w * k)


def lpg_fused_bwd_plain(raw3: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch backward of the fused head: raw (B, h, w, 3) and the
    cotangent g (B, h*k, w*k) -> d(raw) (B, h, w, 3) in raw's dtype.

    The formula of ``lpg_pallas.py::_fused_bwd_kernel``: patch sums of
    ``-g*n4s/den^2 * (u, v, 1)`` and ``g/den`` over each cell's k x k pixels,
    chained through the spherical transform at low resolution."""
    b, h, w, _ = raw3.shape
    r = raw3.float()
    s0, s1, s2 = torch.sigmoid(r[..., 0]), torch.sigmoid(r[..., 1]), torch.sigmoid(r[..., 2])
    t, p = s0 * (math.pi / 3), s1 * (2 * math.pi)
    st, ct, sp, cp = torch.sin(t), torch.cos(t), torch.sin(p), torch.cos(p)
    n1, n2, n3, n4s = (c[:, :, None, :, None] for c in (st * cp, st * sp, ct, s2))
    off = _patch_coords(k, raw3.device)
    u = off.view(1, 1, 1, 1, k)
    v = off.view(1, 1, k, 1, 1)
    inv = 1.0 / (n1 * u + n2 * v + n3)
    ginv = g.float().reshape(b, h, k, w, k) * inv
    common = -ginv * n4s * inv
    dn1 = (common * u).sum((2, 4))
    dn2 = (common * v).sum((2, 4))
    dn3 = common.sum((2, 4))
    dn4 = ginv.sum((2, 4))
    dt = dn1 * (ct * cp) + dn2 * (ct * sp) - dn3 * st
    dp = dn1 * (-st * sp) + dn2 * (st * cp)
    d0 = dt * (s0 * (1.0 - s0)) * (math.pi / 3)
    d1 = dp * (s1 * (1.0 - s1)) * (2 * math.pi)
    d2 = dn4 * (s2 * (1.0 - s2))
    # (B, 3, h, w) memory, as the kernel writes it
    return torch.stack([d0, d1, d2], dim=1).to(raw3.dtype).permute(0, 2, 3, 1)


def fused_denominator(raw3: torch.Tensor, k: int) -> torch.Tensor:
    """The denominators n1*u + n2*v + n3 of :func:`lpg_fused_plain`, at full
    resolution.  Where one is near zero, one-ULP differences in sin/cos grow
    without bound, so comparisons exclude those pixels."""
    b, h, w, _ = raw3.shape
    return _expanded_plane(raw3, k)[1].reshape(b, h * k, w * k)


def _plane_cells(plane_eq: torch.Tensor):
    """(n1, n2, n3, n4) of a (B, h, w, 4) plane, each (B, h, 1, w, 1) f32."""
    if plane_eq.shape[-1] != 4:
        raise ValueError(f"plane_eq last dim must be 4, got {plane_eq.shape[-1]}")
    pe = plane_eq.float()
    return tuple(pe[..., i][:, :, None, :, None] for i in range(4))


def lpg_plane_plain(plane_eq: torch.Tensor, k: int) -> torch.Tensor:
    """Plain LPG: plane_eq (B, h, w, 4) -> depth (B, h*k, w*k) f32."""
    b, h, w, _ = plane_eq.shape
    n1, n2, n3, n4 = _plane_cells(plane_eq)
    off = _patch_coords(k, plane_eq.device)
    u = off.view(1, 1, 1, 1, k)
    v = off.view(1, 1, k, 1, 1)
    return (n4 / (n1 * u + n2 * v + n3)).reshape(b, h * k, w * k)


def lpg_plane_bwd_plain(plane_eq: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Plain backward of the LPG: plane (B, h, w, 4) and the cotangent g
    (B, h*k, w*k) -> d(plane) (B, h, w, 4) in the plane's dtype.  The formula
    of ``lpg_pallas.py::_bwd_kernel``: patch sums of ``-g*n4/den^2 * (u, v, 1)``
    and ``g/den``, stacked and cast as ``_lpg_bwd`` does."""
    b, h, w, _ = plane_eq.shape
    n1, n2, n3, n4 = _plane_cells(plane_eq)
    off = _patch_coords(k, plane_eq.device)
    u = off.view(1, 1, 1, 1, k)
    v = off.view(1, 1, k, 1, 1)
    inv = 1.0 / (n1 * u + n2 * v + n3)
    ginv = g.float().reshape(b, h, k, w, k) * inv
    common = -ginv * n4 * inv
    sums = [(common * u).sum((2, 4)), (common * v).sum((2, 4)), common.sum((2, 4)), ginv.sum((2, 4))]
    return torch.stack(sums, dim=-1).to(plane_eq.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lpg_fused")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fwd = [vp, i32, i64, i64, i64, i64, vp, i32, i32, i32, i32, vp]
    bwd = [vp, i32, i64, i64, i64, i64, vp, i64, i64, i64, vp, i32, i32, i32, i32, vp]
    phase = [vp, i64, i64, i64, i64, vp, i32, i32, i32, i32, vp]  # K5: f32 raw, no dtype code
    for name, argtypes in (("lpg_fused_forward", fwd), ("lpg_forward", fwd), ("lpg_phase_forward", phase),
                           ("lpg_fused_backward", bwd), ("lpg_backward", bwd)):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i32
    lib.lpg_error_string.argtypes = [i32]
    lib.lpg_error_string.restype = ctypes.c_char_p
    return lib


def _check_raw(raw3: torch.Tensor, k: int, name: str, channels: int = 3) -> None:
    """What the kernels take: a CUDA float (B, h, w, channels) tensor, k in
    SUPPORTED_K, and B*h*w*k below 2**31 (the kernels count work items,
    rows and columns in int32)."""
    if raw3.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {raw3.device}")
    if raw3.dim() != 4 or raw3.shape[-1] != channels:
        raise ValueError(f"{name}: input must be (B, h, w, {channels}), got {tuple(raw3.shape)}")
    if not raw3.is_floating_point():
        raise TypeError(f"{name}: raw must be floating point, got {raw3.dtype}")
    if k not in SUPPORTED_K:
        raise ValueError(f"{name}: k must be one of {SUPPORTED_K}, got {k}")
    b, h, w, _ = raw3.shape
    if b * h * w * k >= 2**31:
        raise ValueError(f"{name}: too large for the kernels' int32 indices: (B={b}, h={h}, w={w}, k={k})")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {_lib().lpg_error_string(err).decode()}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(entry: str, x: torch.Tensor, k: int, name: str, out_shape):
    """Launch forward ``entry`` of the library on a checked CUDA input into a
    new f32 ``out_shape`` buffer; returns it and whether a kernel launched.
    The kernel reads x through its strides (a permuted view is not copied)
    in its own dtype where that is f32 or bf16, else an f32 copy."""
    b, h, w, _ = x.shape
    xk = x if x.dtype in _DTYPES else x.float()
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out, False
    with torch.cuda.device(x.device):
        err = getattr(_lib(), entry)(xk.data_ptr(), _DTYPES[xk.dtype], *xk.stride(), out.data_ptr(),
                                     b, h, w, k, _stream(x.device))
    _raise_on(err, name)
    return out, True


def _backward(entry: str, x: torch.Tensor, g: torch.Tensor, k: int, name: str, out_shape):
    """Launch backward ``entry`` on a checked CUDA input and cotangent g
    (B, h*k, w*k); the gradient buffer has ``out_shape`` and x's dtype.  The
    kernel reads x in its dtype and g (f32) through their strides; it loads g
    by vectors where g's strides and base allow it, else by scalars."""
    b, h, w, _ = x.shape
    if g.device != x.device or tuple(g.shape) != (b, h * k, w * k):
        raise ValueError(
            f"{name}: g must be {(b, h * k, w * k)} on {x.device}, got {tuple(g.shape)} on {g.device}"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: input dtype {x.dtype} not supported")
    gf = g.float()
    dx = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx, False
    with torch.cuda.device(x.device):
        err = getattr(_lib(), entry)(
            x.data_ptr(), _DTYPES[x.dtype], *x.stride(), gf.data_ptr(), *gf.stride(), dx.data_ptr(),
            b, h, w, k, _stream(x.device),
        )
    _raise_on(err, name)
    return dx, True


def _k1_cuda(raw3: torch.Tensor, k: int) -> torch.Tensor:
    """K1 on a CUDA tensor, on the current stream; adds one to
    ``lpg_fused.launches``.  The CUDA implementation of :data:`lpg_fused`."""
    _check_raw(raw3, k, "lpg_fused")
    b, h, w, _ = raw3.shape
    out, launched = _forward("lpg_fused_forward", raw3, k, "lpg_fused", (b, h * k, w * k))
    lpg_fused.launches += launched
    return out


# The fused head: raw (B, h, w, 3) -> depth/max_depth (B, h*k, w*k) f32,
# differentiable, with lpg_fused_bwd (K2) as its registered backward.  A CPU
# tensor takes lpg_fused_plain; a CUDA tensor launches K1 on the current
# stream (_k1_cuda).
lpg_fused = torch.library.custom_op("bts_tpu_torch::lpg_fused_fwd", _k1_cuda, mutates_args=(),
                                    device_types="cuda")
lpg_fused.register_kernel("cpu")(lpg_fused_plain)


@lpg_fused.register_fake
def _(raw3, k):
    b, h, w, _ = raw3.shape
    return raw3.new_empty((b, h * k, w * k), dtype=torch.float32)


def _k2_cuda(raw3: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """K2 on CUDA tensors, on the current stream; adds one to
    ``lpg_fused_bwd.launches``.  The CUDA implementation of
    :data:`lpg_fused_bwd`."""
    _check_raw(raw3, k, "lpg_fused_bwd")
    b, h, w, _ = raw3.shape
    draw, launched = _backward("lpg_fused_backward", raw3, g, k, "lpg_fused_bwd", (b, 3, h, w))
    lpg_fused_bwd.launches += launched
    return draw.permute(0, 2, 3, 1)


# Backward of the fused head: raw (B, h, w, 3) and the cotangent g
# (B, h*k, w*k) -> d(raw) (B, h, w, 3) in raw's dtype, the (B, h, w, 3) view
# of a (B, 3, h, w)-contiguous buffer (the fake implementation says so too,
# for torch.export).  CPU tensors take lpg_fused_bwd_plain; CUDA tensors
# launch K2 on the current stream (_k2_cuda).
lpg_fused_bwd = torch.library.custom_op("bts_tpu_torch::lpg_fused_bwd", _k2_cuda, mutates_args=(),
                                        device_types="cuda")
lpg_fused_bwd.register_kernel("cpu")(lpg_fused_bwd_plain)


@lpg_fused_bwd.register_fake
def _(raw3, g, k):
    b, h, w, _ = raw3.shape
    return raw3.new_empty((b, 3, h, w)).permute(0, 2, 3, 1)


def _k1_setup_context(ctx, inputs, output):
    raw3, ctx.k = inputs
    ctx.save_for_backward(raw3)


def _k1_backward(ctx, g):
    (raw3,) = ctx.saved_tensors
    return lpg_fused_bwd(raw3, g, ctx.k), None


lpg_fused.register_autograd(_k1_backward, setup_context=_k1_setup_context)


def lpg_plane_fwd(plane_eq: torch.Tensor, k: int) -> torch.Tensor:
    """LPG forward, not differentiable: plane (B, h, w, 4) -> depth
    (B, h*k, w*k) f32.  A CPU tensor takes :func:`lpg_plane_plain`; a CUDA
    tensor launches K3 and adds one to ``lpg_plane.launches``."""
    if plane_eq.device.type == "cpu":
        return lpg_plane_plain(plane_eq, k)
    _check_raw(plane_eq, k, "lpg_plane", channels=4)
    b, h, w, _ = plane_eq.shape
    out, launched = _forward("lpg_forward", plane_eq, k, "lpg_plane", (b, h * k, w * k))
    lpg_plane.launches += launched
    return out


def lpg_plane_bwd(plane_eq: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """LPG backward: plane (B, h, w, 4) and the cotangent g (B, h*k, w*k) ->
    d(plane) (B, h, w, 4) in the plane's dtype.  CPU tensors take
    :func:`lpg_plane_bwd_plain`; CUDA tensors launch K4 and add one to
    ``lpg_plane_bwd.launches``."""
    if plane_eq.device.type == "cpu" and g.device.type == "cpu":
        return lpg_plane_bwd_plain(plane_eq, g, k)
    _check_raw(plane_eq, k, "lpg_plane_bwd", channels=4)
    dplane, launched = _backward("lpg_backward", plane_eq, g, k, "lpg_plane_bwd", plane_eq.shape)
    lpg_plane_bwd.launches += launched
    return dplane


class Lpg(torch.autograd.Function):
    """The LPG of a plane with K3 as its forward and K4 as its backward."""

    @staticmethod
    def forward(ctx, plane_eq, k):
        ctx.k = k
        ctx.save_for_backward(plane_eq)
        return lpg_plane_fwd(plane_eq, k)

    @staticmethod
    def backward(ctx, g):
        (plane_eq,) = ctx.saved_tensors
        return lpg_plane_bwd(plane_eq, g, ctx.k), None


def lpg_plane(plane_eq: torch.Tensor, k: int) -> torch.Tensor:
    """Differentiable LPG: plane (B, h, w, 4) -> depth (B, h*k, w*k) f32; K3
    forward and K4 backward on CUDA tensors."""
    return Lpg.apply(plane_eq, k)


# launches since the last reset, read by chip_smoke.py
lpg_fused.launches = 0  # K1
lpg_fused_bwd.launches = 0  # K2
lpg_plane.launches = 0  # K3
lpg_plane_bwd.launches = 0  # K4
