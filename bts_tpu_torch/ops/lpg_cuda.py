"""Fused reduction_1x1 -> LPG head: the Hopper kernels (forward K1, backward
K2), their wrappers, the autograd Function, and their plain PyTorch versions.

Counterpart of ``bts_tpu/ops/lpg_pallas.py::lpg_fused`` and its VJP.  The
public functions keep the JAX layout: raw (B, h, w, 3) in any float dtype and
any strides -> depth / max_depth (B, h*k, w*k) float32.

- :func:`lpg_fused` is differentiable (:class:`LpgFused`): its forward is
  :func:`lpg_fused_fwd`, its backward :func:`lpg_fused_bwd`.
- :func:`lpg_fused_fwd` launches K1 (``csrc/lpg_fused.cu``) on a CUDA tensor
  and computes :func:`lpg_fused_plain` on a CPU tensor.
- :func:`lpg_fused_bwd` launches K2 on CUDA tensors and computes
  :func:`lpg_fused_bwd_plain` on CPU tensors.  d(raw) comes back in raw's
  dtype, as the JAX VJP casts it.
- On a CUDA tensor a wrapper launches its kernel or raises; it never falls
  back.  Each launch adds one to ``lpg_fused.launches`` (K1) or
  ``lpg_fused_bwd.launches`` (K2).
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
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # K2's output codes (the compute dtypes)


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lpg_fused")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.lpg_fused_forward.argtypes = [vp, i64, i64, i64, i64, vp, i32, i32, i32, i32, vp]
    lib.lpg_fused_forward.restype = i32
    lib.lpg_fused_backward.argtypes = [
        vp, i64, i64, i64, i64, vp, i64, i64, i64, vp, i32, i32, i32, i32, i32, vp
    ]
    lib.lpg_fused_backward.restype = i32
    lib.lpg_error_string.argtypes = [i32]
    lib.lpg_error_string.restype = ctypes.c_char_p
    return lib


def _check_raw(raw3: torch.Tensor, k: int, name: str) -> None:
    if raw3.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {raw3.device}")
    if raw3.dim() != 4 or raw3.shape[-1] != 3:
        raise ValueError(f"{name}: raw must be (B, h, w, 3), got {tuple(raw3.shape)}")
    if not raw3.is_floating_point():
        raise TypeError(f"{name}: raw must be floating point, got {raw3.dtype}")
    if k not in SUPPORTED_K:
        raise ValueError(f"{name}: k must be one of {SUPPORTED_K}, got {k}")
    b, h, _, _ = raw3.shape
    if h * k > 65535 or b > 65535:
        raise ValueError(f"{name}: grid too large for (B={b}, H={h * k})")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {_lib().lpg_error_string(err).decode()}")


def lpg_fused_fwd(raw3: torch.Tensor, k: int) -> torch.Tensor:
    """Forward of the fused head, not differentiable: raw (B, h, w, 3) ->
    depth/max_depth (B, h*k, w*k) f32.  A CPU tensor takes
    :func:`lpg_fused_plain`; a CUDA tensor launches K1 on the current stream
    and adds one to ``lpg_fused.launches``."""
    if raw3.device.type == "cpu":
        return lpg_fused_plain(raw3, k)
    _check_raw(raw3, k, "lpg_fused")
    b, h, w, _ = raw3.shape
    x = raw3.float()  # f32 in, as _raw_components; keeps the strides of a permuted view
    out = torch.empty((b, h * k, w * k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().lpg_fused_forward(x.data_ptr(), *x.stride(), out.data_ptr(), b, h, w, k, stream)
    _raise_on(err, "lpg_fused")
    lpg_fused.launches += 1
    return out


def lpg_fused_bwd(raw3: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Backward of the fused head: raw (B, h, w, 3) and the cotangent g
    (B, h*k, w*k) -> d(raw) (B, h, w, 3) in raw's dtype.  CPU tensors take
    :func:`lpg_fused_bwd_plain`; CUDA tensors launch K2 on the current stream
    and add one to ``lpg_fused_bwd.launches``.  On CUDA the result is the
    (B, h, w, 3) view of a (B, 3, h, w)-contiguous buffer."""
    if raw3.device.type == "cpu" and g.device.type == "cpu":
        return lpg_fused_bwd_plain(raw3, g, k)
    _check_raw(raw3, k, "lpg_fused_bwd")
    b, h, w, _ = raw3.shape
    if g.device != raw3.device or tuple(g.shape) != (b, h * k, w * k):
        raise ValueError(
            f"lpg_fused_bwd: g must be {(b, h * k, w * k)} on {raw3.device}, "
            f"got {tuple(g.shape)} on {g.device}"
        )
    if raw3.dtype not in _OUT_DTYPES:
        raise TypeError(f"lpg_fused_bwd: raw dtype {raw3.dtype} not supported")
    x, gf = raw3.float(), g.float()
    draw = torch.empty((b, 3, h, w), dtype=raw3.dtype, device=x.device)
    if draw.numel() > 0:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().lpg_fused_backward(
                x.data_ptr(), *x.stride(), gf.data_ptr(), *gf.stride(), draw.data_ptr(),
                _OUT_DTYPES[raw3.dtype], b, h, w, k, stream,
            )
        _raise_on(err, "lpg_fused_bwd")
        lpg_fused_bwd.launches += 1
    return draw.permute(0, 2, 3, 1)


class LpgFused(torch.autograd.Function):
    """The fused head with K2 as its backward.  The f32 cast happens inside;
    the Function saves raw3 itself, not its f32 copy."""

    @staticmethod
    def forward(ctx, raw3, k):
        ctx.k = k
        ctx.save_for_backward(raw3)
        return lpg_fused_fwd(raw3, k)

    @staticmethod
    def backward(ctx, g):
        (raw3,) = ctx.saved_tensors
        return lpg_fused_bwd(raw3, g, ctx.k), None


def lpg_fused(raw3: torch.Tensor, k: int) -> torch.Tensor:
    """Differentiable fused head: raw (B, h, w, 3) -> depth/max_depth
    (B, h*k, w*k) f32; K1 forward and K2 backward on CUDA tensors."""
    return LpgFused.apply(raw3, k)


lpg_fused.launches = 0  # K1 launches since the last reset; read by chip_smoke.py
lpg_fused_bwd.launches = 0  # K2 launches since the last reset; read by chip_smoke.py
