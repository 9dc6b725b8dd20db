"""Fused reduction_1x1 -> LPG head: the Hopper kernel, its wrapper, and its
plain PyTorch version.

Counterpart of ``bts_tpu/ops/lpg_pallas.py::lpg_fused`` (forward only).  The
public functions keep the JAX layout: raw (B, h, w, 3) in any float dtype and
any strides -> depth / max_depth (B, h*k, w*k) float32.

- :func:`lpg_fused` launches ``csrc/lpg_fused.cu`` on a CUDA tensor, and on a
  CPU tensor computes :func:`lpg_fused_plain`.  On a CUDA tensor it launches
  the kernel or raises; it never falls back.
- :func:`lpg_fused_plain` is the same function in plain PyTorch: the CPU
  path, the ``use_pallas="never"`` path, and the kernel's oracle.

The backward (the TPU kernel ``_fused_bwd_kernel``, K2 in ROADMAP.md) is not
ported yet, so a CUDA input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bts_tpu_torch.ops import _build

SUPPORTED_K = (2, 4, 8)


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
    lib.lpg_error_string.argtypes = [i32]
    lib.lpg_error_string.restype = ctypes.c_char_p
    return lib


def lpg_fused(raw3: torch.Tensor, k: int) -> torch.Tensor:
    """Fused head: raw (B, h, w, 3) -> depth/max_depth (B, h*k, w*k) f32.

    A CPU tensor takes :func:`lpg_fused_plain`; a CUDA tensor launches the
    kernel on the current stream and adds one to ``lpg_fused.launches``.
    """
    if raw3.device.type == "cpu":
        return lpg_fused_plain(raw3, k)
    if raw3.device.type != "cuda":
        raise ValueError(f"lpg_fused: unsupported device {raw3.device}")
    if raw3.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "lpg_fused has no CUDA backward yet (K2, lpg_pallas.py::_fused_bwd_kernel, "
            "ROADMAP.md); run the forward under torch.inference_mode()"
        )
    if raw3.dim() != 4 or raw3.shape[-1] != 3:
        raise ValueError(f"lpg_fused: raw must be (B, h, w, 3), got {tuple(raw3.shape)}")
    if not raw3.is_floating_point():
        raise TypeError(f"lpg_fused: raw must be floating point, got {raw3.dtype}")
    if k not in SUPPORTED_K:
        raise ValueError(f"lpg_fused: k must be one of {SUPPORTED_K}, got {k}")
    b, h, w, _ = raw3.shape
    if h * k > 65535 or b > 65535:
        raise ValueError(f"lpg_fused: grid too large for (B={b}, H={h * k})")
    x = raw3.float()  # f32 in, as _raw_components; keeps the strides of a permuted view
    out = torch.empty((b, h * k, w * k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lpg_fused_forward(x.data_ptr(), *x.stride(), out.data_ptr(), b, h, w, k, stream)
    if err != 0:
        raise RuntimeError(f"lpg_fused kernel launch failed: {lib.lpg_error_string(err).decode()}")
    lpg_fused.launches += 1
    return out


lpg_fused.launches = 0  # kernel launches since the last reset; read by chip_smoke.py
