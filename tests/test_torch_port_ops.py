"""bts_tpu_torch ops against bts_tpu on the CPU: LPG, the fused head K1's
plain version (against the Pallas kernel in interpret mode and against the
composed jnp path), resize and eval preprocessing.  The same numpy inputs go
to both sides.

Tolerance: rtol 2e-5, atol 2e-6 (tests/test_ops.py's fused-head rule); the
random inputs keep every LPG denominator well away from zero.

The CUDA kernel itself runs only on a card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bts_tpu.ops import lpg as jlpg
from bts_tpu.ops import lpg_pallas
from bts_tpu.ops.resize import upsample_nearest_2x as j_upsample
from bts_tpu_torch.ops import _build, lpg, lpg_cuda
from bts_tpu_torch.ops.resize import upsample_nearest_2x

RTOL, ATOL = 2e-5, 2e-6


def _planes(rng, b, h, w):
    theta = rng.uniform(0, np.pi / 3, (b, h, w))
    phi = rng.uniform(0, 2 * np.pi, (b, h, w))
    dist = rng.uniform(0.5, 80.0, (b, h, w))
    return np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta), dist], -1
    ).astype(np.float32)


def _raw(seed, shape=(2, 6, 10, 3)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_lpg_reference_matches_jax(k):
    pe = _planes(np.random.default_rng(k), 2, 3, 5)
    _close(lpg.lpg_reference(torch.from_numpy(pe), k), jlpg.lpg_reference(jnp.asarray(pe), k))


@pytest.mark.parametrize("k,stride", [(8, 4), (4, 2), (8, 2), (2, 1)])
def test_lpg_strided_matches_jax(k, stride):
    pe = _planes(np.random.default_rng(10 + k), 2, 6, 10)
    port = lpg.lpg_strided(torch.from_numpy(pe), k, stride)
    _close(port, jlpg.lpg_strided(jnp.asarray(pe), k, stride))
    # and it is the full map at every stride-th pixel, exactly
    full = lpg.lpg_reference(torch.from_numpy(pe), k)
    assert torch.equal(port, full[:, ::stride, ::stride])


def test_plane_from_spherical_matches_jax():
    raw = _raw(3)
    _close(
        lpg.plane_from_spherical(torch.from_numpy(raw), 80.0),
        jlpg.plane_from_spherical(jnp.asarray(raw), 80.0),
    )


@pytest.mark.parametrize("k", [2, 4, 8])
def test_fused_plain_matches_pallas_interpret(k, monkeypatch):
    """K1's plain version against the TPU kernel itself, run in interpret mode."""
    monkeypatch.setattr(lpg_pallas, "_INTERPRET", True)
    raw = _raw(20 + k)
    ref = lpg_pallas.lpg_fused(jnp.asarray(raw), k)
    _close(lpg_cuda.lpg_fused_plain(torch.from_numpy(raw), k), ref)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_fused_plain_matches_composed_jnp_path(k):
    raw = _raw(30 + k)
    ref = jlpg.lpg_scaled_from_raw(jnp.asarray(raw), k, 80.0, use_pallas="never")
    _close(lpg_cuda.lpg_fused_plain(torch.from_numpy(raw), k), ref)


def test_fused_plain_reads_permuted_views():
    """The decoder hands the head a permuted NCHW tensor; strides must not
    matter (beyond the CPU's vectorised and scalar sin/exp differing in the
    last bit, hence a tolerance and not equality)."""
    nchw = torch.from_numpy(_raw(4, (2, 3, 6, 10)))
    view = nchw.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    _close(lpg_cuda.lpg_fused_plain(view, 4), lpg_cuda.lpg_fused_plain(view.contiguous(), 4))


def test_fused_denominator_is_the_plain_denominator():
    raw = torch.from_numpy(_raw(5))
    den = lpg_cuda.fused_denominator(raw, 8)
    n4s = torch.sigmoid(raw[..., 2]).repeat_interleave(8, 1).repeat_interleave(8, 2)
    assert torch.equal(n4s / den, lpg_cuda.lpg_fused_plain(raw, 8))


@pytest.mark.parametrize("use_pallas", ["auto", "always", "never"])
def test_cpu_dispatch_takes_plain_version(use_pallas, monkeypatch):
    """On a CPU tensor every setting computes the plain version and launches nothing."""
    monkeypatch.setattr(lpg_cuda.lpg_fused, "launches", 0)
    raw = torch.from_numpy(_raw(6, (1, 8, 6, 3)))
    out = lpg.lpg_scaled_from_raw(raw, 8, 10.0, use_pallas=use_pallas)
    assert torch.equal(out, lpg_cuda.lpg_fused_plain(raw, 8))
    assert lpg_cuda.lpg_fused.launches == 0


def test_dispatch_rejects_unknown_setting():
    with pytest.raises(ValueError, match="use_pallas"):
        lpg.lpg_scaled_from_raw(torch.zeros(1, 2, 2, 3), 2, 10.0, use_pallas="sometimes")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a missing toolkit is an error that names nvcc."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("lpg_fused")


def test_upsample_nearest_2x_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 4, 5, 3)).astype(np.float32)
    port = upsample_nearest_2x(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_array_equal(port.numpy().transpose(0, 2, 3, 1), np.asarray(j_upsample(jnp.asarray(x))))


def test_eval_preprocess_matches_jax():
    from bts_tpu.data.augment import eval_preprocess as j_eval_preprocess
    from bts_tpu_torch.data.augment import eval_preprocess

    img = np.random.default_rng(8).integers(0, 256, (2, 6, 10, 3), dtype=np.uint8)
    _close(eval_preprocess(torch.from_numpy(img)), j_eval_preprocess(jnp.asarray(img)), atol=1e-6)
