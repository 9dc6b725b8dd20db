"""The fused LPG head's CUDA kernel (csrc/lpg_fused.cu) on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode.  On a machine with a card (and ``nvcc``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

``--noconftest`` because tests/conftest.py sets up JAX, which this file
does not use.  Rule: rtol 2e-5, atol 2e-6*max|ref| on pixels whose
denominator is at least 1e-3 in magnitude (near zero, one-ULP differences in
sin/cos grow without bound).
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


def test_kernel_refuses_grad_and_bad_k(card):
    raw = _raw(card, 1, 4, 4).detach().requires_grad_()
    with pytest.raises(NotImplementedError, match="K2"):
        lpg_cuda.lpg_fused(raw, 4)
    with pytest.raises(ValueError, match="k must be"):
        lpg_cuda.lpg_fused(raw.detach(), 3)
