"""The fused LPG head's CUDA kernels (csrc/lpg_fused.cu) on the card: the
forward K1 and the backward K2.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode.  On a machine with a card (and ``nvcc``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

``--noconftest`` because tests/conftest.py sets up JAX, which this file
does not use.  K1's rule: rtol 2e-5, atol 2e-6*max|ref| on pixels whose
denominator is at least 1e-3 in magnitude (near zero, one-ULP differences in
sin/cos grow without bound).  K2's rule is the gradient rule of
tests/test_ops.py: rtol 2e-4, atol 2e-5*max|ref|, on cells whose k x k
denominators are all at least 1e-3 in magnitude (K2 sums the patch in
another order than the plain version, and the gradient grows as 1/den^2).
"""

import numpy as np
import pytest
import torch

from bts_tpu_torch.ops import lpg_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _raw(card, b, h, w, seed=0, dtype=torch.float32):
    nchw = np.random.default_rng(seed).standard_normal((b, 3, h, w), dtype=np.float32)
    return torch.from_numpy(nchw).to(card, dtype).permute(0, 2, 3, 1)  # the decoder's view


def _assert_rule(out, ref, raw, k):
    keep = lpg_cuda.fused_denominator(raw, k).abs() >= 1e-3
    scale = ref[keep].abs().max().item()
    torch.testing.assert_close(out[keep], ref[keep], rtol=2e-5, atol=2e-6 * scale)


@pytest.mark.parametrize("k,h,w,b", [(8, 44, 152, 1), (4, 88, 304, 1), (2, 176, 608, 1), (8, 13, 37, 2)])
def test_kernel_matches_plain(card, k, h, w, b):
    raw = _raw(card, b, h, w, seed=k)
    out = lpg_cuda.lpg_fused(raw, k)
    torch.cuda.synchronize()
    assert out.shape == (b, h * k, w * k) and out.dtype == torch.float32
    _assert_rule(out, lpg_cuda.lpg_fused_plain(raw, k), raw, k)


def test_kernel_takes_bf16_as_the_model_passes_it(card):
    raw = _raw(card, 1, 22, 76, dtype=torch.bfloat16)
    _assert_rule(lpg_cuda.lpg_fused(raw, 4), lpg_cuda.lpg_fused_plain(raw, 4), raw, 4)


def test_each_launch_counts_once(card, monkeypatch):
    monkeypatch.setattr(lpg_cuda.lpg_fused, "launches", 0)
    raw = _raw(card, 1, 8, 8)
    for k in (2, 4, 8):
        lpg_cuda.lpg_fused(raw, k)
    lpg_cuda.lpg_fused_plain(raw, 8)
    assert lpg_cuda.lpg_fused.launches == 3


def _assert_grad_rule(out, ref, raw, k):
    """K2's rule on the cells whose k x k denominators all have |den| >= 1e-3."""
    b, h, w, _ = raw.shape
    den = lpg_cuda.fused_denominator(raw, k).reshape(b, h, k, w, k)
    keep = (den.abs() >= 1e-3).all(dim=4).all(dim=2)
    out, ref = out.float()[keep], ref.float()[keep]
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5 * ref.abs().max().item())


@pytest.mark.parametrize("k,h,w,b", [(8, 44, 88, 16), (4, 88, 176, 16), (2, 176, 352, 16), (8, 13, 37, 2)])
def test_backward_kernel_matches_plain(card, k, h, w, b):
    """K2 at the config-4 training shapes (b16, 352x704) and a ragged B=2."""
    raw = _raw(card, b, h, w, seed=k)
    g = torch.from_numpy(np.random.default_rng(k + 1).standard_normal((b, h * k, w * k), dtype=np.float32)).to(card)
    out = lpg_cuda.lpg_fused_bwd(raw, g, k)
    torch.cuda.synchronize()
    assert out.shape == raw.shape and out.dtype == raw.dtype
    assert out.permute(0, 3, 1, 2).is_contiguous()  # NCHW memory for the reduction conv
    _assert_grad_rule(out, lpg_cuda.lpg_fused_bwd_plain(raw, g, k), raw, k)


def test_backward_kernel_takes_bf16_raw_and_returns_bf16(card):
    raw = _raw(card, 2, 22, 44, dtype=torch.bfloat16)
    g = torch.randn(2, 88, 176, device=card)
    out = lpg_cuda.lpg_fused_bwd(raw, g, 4)
    assert out.dtype == torch.bfloat16
    ref = lpg_cuda.lpg_fused_bwd_plain(raw, g, 4)
    # both round the same f32 value to bf16, so they differ by at most one bf16 step
    b, h, w, _ = raw.shape
    keep = (lpg_cuda.fused_denominator(raw, 4).reshape(b, h, 4, w, 4).abs() >= 1e-3).all(4).all(2)
    torch.testing.assert_close(out.float()[keep], ref.float()[keep], rtol=2 ** -7,
                               atol=2e-5 * ref.float()[keep].abs().max().item())


def test_one_backward_launch_per_head(card, monkeypatch):
    """Autograd through lpg_fused launches K1 once and K2 once."""
    monkeypatch.setattr(lpg_cuda.lpg_fused, "launches", 0)
    monkeypatch.setattr(lpg_cuda.lpg_fused_bwd, "launches", 0)
    raw = _raw(card, 2, 8, 8).detach().requires_grad_()
    out = lpg_cuda.lpg_fused(raw, 4)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert lpg_cuda.lpg_fused.launches == 1 and lpg_cuda.lpg_fused_bwd.launches == 1
    ref = torch.autograd.grad(lpg_cuda.lpg_fused_plain(raw, 4).square().sum(), raw)[0]
    _assert_grad_rule(raw.grad, ref, raw.detach(), 4)


def test_kernels_refuse_bad_k(card):
    raw = _raw(card, 1, 4, 4)
    with pytest.raises(ValueError, match="k must be"):
        lpg_cuda.lpg_fused(raw, 3)
    with pytest.raises(ValueError, match="k must be"):
        lpg_cuda.lpg_fused_bwd(raw, torch.zeros(1, 12, 12, device=card), 3)
