"""bts_tpu_torch ops against bts_tpu on the CPU: LPG, the fused head K1's
plain version (against the Pallas kernel in interpret mode and against the
composed jnp path), K2's plain version (against jax.grad of the interpret-mode
Pallas head), the public LPG op's K3 and K4 plain versions (against the
interpret-mode Pallas op and its jax.grad), the silog loss, resize and eval
preprocessing.  The same numpy
inputs go to both sides.

Tolerance: rtol 2e-5, atol 2e-6 (tests/test_ops.py's fused-head rule); the
gradients rtol 2e-4, atol 2e-5*max|ref| (its gradient rule).  The random
inputs keep every LPG denominator well away from zero.

The CUDA kernel itself runs only on a card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bts_tpu.ops import lpg as jlpg
from bts_tpu.ops import lpg_pallas
from bts_tpu.ops.resize import upsample_nearest_2x as j_upsample
from bts_tpu.ops import silog as jsilog
from bts_tpu_torch.ops import _build, lpg, lpg_cuda, silog
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


def _grad_close(port, ref):
    ref = np.asarray(ref, np.float32)
    _close(port.float(), ref, rtol=2e-4, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("k", [2, 4, 8])
def test_fused_bwd_plain_matches_pallas_grad(k, monkeypatch):
    """K2's plain version against jax.grad of the TPU head (K1 + K2) run in
    interpret mode, on a permuted view as the decoder passes it."""
    monkeypatch.setattr(lpg_pallas, "_INTERPRET", True)
    raw = _raw(40 + k, (2, 3, 5, 7)).transpose(0, 2, 3, 1)
    g = np.random.default_rng(50 + k).normal(size=(2, 5 * k, 7 * k)).astype(np.float32)
    import jax

    ref = jax.grad(lambda r: (lpg_pallas.lpg_fused(r, k) * g).sum())(jnp.asarray(raw))
    port = lpg_cuda.lpg_fused_bwd_plain(torch.from_numpy(raw), torch.from_numpy(g), k)
    assert port.shape == raw.shape
    _grad_close(port, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_head_autograd_is_the_plain_backward(dtype):
    """On a CPU tensor, autograd through lpg_fused (the Function, whose
    backward is lpg_fused_bwd) equals autograd of lpg_fused_plain; the
    gradient of bf16 raw comes back bf16, as the JAX VJP casts it."""
    raw = torch.from_numpy(_raw(7, (2, 3, 6, 10))).to(dtype).permute(0, 2, 3, 1)
    g = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 24, 40)).astype(np.float32))
    a = raw.detach().requires_grad_()
    (lpg_cuda.lpg_fused(a, 4) * g).sum().backward()
    b = raw.detach().float().requires_grad_()
    (lpg_cuda.lpg_fused_plain(b, 4) * g).sum().backward()
    assert a.grad.dtype == dtype
    if dtype == torch.float32:
        _grad_close(a.grad, b.grad.numpy())
    else:  # one bf16 rounding of the same f32 gradient
        _close(a.grad.float(), b.grad.to(dtype).float().numpy(), rtol=2**-7,
               atol=2e-5 * b.grad.abs().max().item())


def test_cpu_backward_launches_nothing(monkeypatch):
    monkeypatch.setattr(lpg_cuda.lpg_fused_bwd, "launches", 0)
    raw = torch.from_numpy(_raw(9, (1, 4, 4, 3))).requires_grad_()
    lpg.lpg_scaled_from_raw(raw, 2, 10.0).sum().backward()
    assert lpg_cuda.lpg_fused_bwd.launches == 0 and raw.grad is not None


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_lpg_plane_plain_matches_pallas_and_its_grad(k, dtype, monkeypatch):
    """K3's plain version against the TPU op ``lpg`` and K4's against its
    jax.grad, both in interpret mode, for f32 and bf16 planes; the gradient
    comes back in the plane's dtype.  bf16: both sides round the same f32
    sums once, so they may differ by one bf16 step."""
    import jax

    monkeypatch.setattr(lpg_pallas, "_INTERPRET", True)
    pe = np.asarray(jnp.asarray(_planes(np.random.default_rng(60 + k), 2, 3, 5)).astype(dtype))
    g = np.random.default_rng(70 + k).normal(size=(2, 3 * k, 5 * k)).astype(np.float32)
    port_pe = torch.from_numpy(pe.astype(np.float32)).to(torch.float32 if dtype == np.float32 else torch.bfloat16)
    _close(lpg_cuda.lpg_plane_plain(port_pe, k), lpg_pallas.lpg(jnp.asarray(pe), k))
    ref = jax.grad(lambda p: (lpg_pallas.lpg(p, k) * g).sum())(jnp.asarray(pe))
    port = lpg_cuda.lpg_plane_bwd_plain(port_pe, torch.from_numpy(g), k)
    assert port.dtype == port_pe.dtype and port.shape == port_pe.shape
    if dtype == np.float32:
        _grad_close(port, ref)
    else:
        ref = np.asarray(ref, np.float32)
        _close(port.float(), ref, rtol=2**-7, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("use_pallas", ["auto", "always", "never"])
def test_public_lpg_op_on_the_cpu(use_pallas, monkeypatch):
    """local_planar_guidance on a CPU tensor: every setting computes the
    plain version, matches the JAX op's jnp path, launches nothing, and its
    gradient is K4's plain version."""
    for fn in (lpg_cuda.lpg_plane, lpg_cuda.lpg_plane_bwd):
        monkeypatch.setattr(fn, "launches", 0)
    pe = torch.from_numpy(_planes(np.random.default_rng(80), 1, 4, 6)).requires_grad_()
    out = lpg.local_planar_guidance(pe, 4, use_pallas)
    _close(out.detach(), jlpg.local_planar_guidance(jnp.asarray(pe.detach().numpy()), 4, "never"))
    g = torch.from_numpy(np.random.default_rng(81).normal(size=out.shape).astype(np.float32))
    (out * g).sum().backward()
    _grad_close(pe.grad, lpg_cuda.lpg_plane_bwd_plain(pe.detach(), g, 4).numpy())
    assert lpg_cuda.lpg_plane.launches == 0 and lpg_cuda.lpg_plane_bwd.launches == 0


def test_public_lpg_op_rejects_unknown_setting():
    with pytest.raises(ValueError, match="use_pallas"):
        lpg.local_planar_guidance(torch.zeros(1, 2, 2, 4), 2, use_pallas="sometimes")


@pytest.mark.parametrize("dataset", ["kitti", "nyu"])
def test_silog_and_mask_match_jax(dataset):
    rng = np.random.default_rng(11)
    est = rng.uniform(0.5, 80.0, (2, 6, 10)).astype(np.float32)
    gt = np.where(rng.random((2, 6, 10)) < 0.5, rng.uniform(0.0, 80.0, (2, 6, 10)), 0.0).astype(np.float32)
    mask = silog.default_mask(torch.from_numpy(gt), dataset)
    jmask = jsilog.default_mask(jnp.asarray(gt), dataset)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    for m, jm in ((mask, jmask), (torch.zeros_like(mask), jnp.zeros_like(jmask))):  # and all masked
        port = silog.silog_loss(torch.from_numpy(est), torch.from_numpy(gt), m, 0.85)
        ref = jsilog.silog_loss(jnp.asarray(est), jnp.asarray(gt), jm, 0.85)
        assert torch.isfinite(port)
        _close(port, ref, rtol=1e-6, atol=1e-6)


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
