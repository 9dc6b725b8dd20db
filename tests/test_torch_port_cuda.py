"""The port's CUDA kernels on the card: the fused LPG head's forward K1 and
backward K2, the public LPG op's forward K3 and backward K4, the phase-plane
head K5 (csrc/lpg_fused.cu) and the fused decoder tail K6
(csrc/fused_tail.cu), each against its plain version; K1, K2, K5 and K6
through their torch.library ops against their CUDA implementations called
directly, and through an exported serving program.

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
K3 and K4 take the rules of K1 and K2.  K5 equals K1 interleaved, bit for
bit.  K6 holds tests/test_torch_port_tail.py's rule against its plain
version: mean abs error <= 2e-5, max <= 5e-2, at most 1% of pixels off by
more than 1e-4.
"""

import numpy as np
import pytest
import torch

from bts_tpu_torch.ops import lpg_cuda, tail_cuda

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


@pytest.mark.parametrize("k,h,w,b", [(8, 44, 152, 1), (4, 88, 304, 1), (2, 176, 608, 1), (8, 13, 37, 2),
                                     (2, 13, 37, 2), (2, 176, 352, 16), (8, 52, 68, 4), (4, 104, 136, 4),
                                     (2, 208, 272, 4), (2, 187, 621, 1)])
def test_kernel_matches_plain(card, k, h, w, b):
    """K1 at the serving heads, a ragged B=2 at k = 8 and at k = 2 (odd w: a
    row pitch of 2 mod 4 floats), the largest config-4 head (16,896 work
    items, more than the card holds warps at once), the three config-3 heads
    (NYU 416x544, b4), and the k = 2 head of a raw 374x1242 KITTI frame at
    b1 (odd w)."""
    raw = _raw(card, b, h, w, seed=k)
    out = lpg_cuda.lpg_fused(raw, k)
    torch.cuda.synchronize()
    assert out.shape == (b, h * k, w * k) and out.dtype == torch.float32
    _assert_rule(out, lpg_cuda.lpg_fused_plain(raw, k), raw, k)


def test_kernel_takes_bf16_as_the_model_passes_it(card):
    raw = _raw(card, 1, 22, 76, dtype=torch.bfloat16)
    _assert_rule(lpg_cuda.lpg_fused(raw, 4), lpg_cuda.lpg_fused_plain(raw, 4), raw, 4)


@pytest.mark.parametrize("k,h,w", [(8, 13, 37), (4, 22, 76), (2, 13, 37)])
def test_kernel_reads_bf16_raw_as_its_f32_copy(card, k, h, w):
    """K1 reads bf16 raw in its dtype; bf16 -> f32 is exact, so the map is
    bit for bit the one of its f32 copy."""
    raw = _raw(card, 2, h, w, seed=k, dtype=torch.bfloat16)
    assert torch.equal(lpg_cuda.lpg_fused(raw, k), lpg_cuda.lpg_fused(raw.float(), k))


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


@pytest.mark.parametrize("k,h,w,b", [(8, 44, 88, 16), (4, 88, 176, 16), (2, 176, 352, 16), (8, 13, 37, 2),
                                     (2, 13, 37, 2), (8, 52, 68, 4), (4, 104, 136, 4), (2, 208, 272, 4),
                                     (2, 187, 621, 1)])
def test_backward_kernel_matches_plain(card, k, h, w, b):
    """K2 at the config-4 training shapes (b16, 352x704), a ragged B=2, k = 2
    with odd w (g's row pitch 2 mod 4 floats), the config-3 heads (NYU
    416x544, b4) and the k = 2 head of a raw 374x1242 KITTI frame (odd w)."""
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


@pytest.mark.parametrize("k", [8, 2])
def test_backward_kernel_reads_a_misaligned_g(card, k):
    """A g one float off its allocation (a sliced view) does not allow K2's
    vector loads: the scalar-load instance reads it, in the same order, so
    the gradient is bit for bit the one of an aligned copy."""
    b, h, w = 2, 13, 37
    raw = _raw(card, b, h, w, seed=k)
    flat = torch.randn(b * h * k * w * k + 1, device=card)
    g = flat[1:].view(b, h * k, w * k)
    out = lpg_cuda.lpg_fused_bwd(raw, g, k)
    assert torch.equal(out, lpg_cuda.lpg_fused_bwd(raw, g.clone(), k))
    _assert_grad_rule(out, lpg_cuda.lpg_fused_bwd_plain(raw, g, k), raw, k)


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


def _plane(card, b, h, w, seed=0, dtype=torch.float32):
    from bts_tpu_torch.ops.lpg import plane_from_spherical

    return plane_from_spherical(_raw(card, b, h, w, seed), 80.0).to(dtype)


def _plane_den(plane, k):
    """The denominators n1*u + n2*v + n3 of the LPG of ``plane``, (B, h, k, w, k)."""
    p = plane.float()
    off = lpg_cuda._patch_coords(k, plane.device)
    return (p[..., 0][:, :, None, :, None] * off.view(1, 1, 1, 1, k)
            + p[..., 1][:, :, None, :, None] * off.view(1, 1, k, 1, 1) + p[..., 2][:, :, None, :, None])


@pytest.mark.parametrize("k,h,w,b", [(8, 44, 152, 1), (2, 176, 608, 1), (8, 13, 37, 2)])
def test_lpg_plane_kernels_match_plain(card, k, h, w, b, monkeypatch):
    """K3 and K4 through the public op's autograd Function, f32 plane."""
    for fn in (lpg_cuda.lpg_plane, lpg_cuda.lpg_plane_bwd):
        monkeypatch.setattr(fn, "launches", 0)
    plane = _plane(card, b, h, w, seed=k).requires_grad_()
    out = lpg_cuda.lpg_plane(plane, k)
    g = torch.randn_like(out)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert lpg_cuda.lpg_plane.launches == 1 and lpg_cuda.lpg_plane_bwd.launches == 1
    p = plane.detach()
    den = _plane_den(p, k)
    keep = den.reshape(b, h * k, w * k).abs() >= 1e-3
    ref = lpg_cuda.lpg_plane_plain(p, k)
    torch.testing.assert_close(out[keep], ref[keep], rtol=2e-5, atol=2e-6 * ref[keep].abs().max().item())
    cells = (den.abs() >= 1e-3).all(4).all(2)
    gref = lpg_cuda.lpg_plane_bwd_plain(p, g, k)
    assert plane.grad.shape == p.shape and plane.grad.is_contiguous()
    torch.testing.assert_close(plane.grad[cells], gref[cells], rtol=2e-4,
                               atol=2e-5 * gref[cells].abs().max().item())


def test_lpg_plane_backward_returns_bf16_for_bf16(card):
    plane = _plane(card, 2, 11, 20, dtype=torch.bfloat16)
    g = torch.randn(2, 44, 80, device=card)
    out = lpg_cuda.lpg_plane_bwd(plane, g, 4)
    ref = lpg_cuda.lpg_plane_bwd_plain(plane, g, 4)
    assert out.dtype == torch.bfloat16
    cells = (_plane_den(plane, 4).abs() >= 1e-3).all(4).all(2)
    torch.testing.assert_close(out.float()[cells], ref.float()[cells], rtol=2 ** -7,
                               atol=2e-5 * ref.float()[cells].abs().max().item())


@pytest.mark.parametrize("k,h,w,b", [(8, 44, 152, 1), (4, 88, 304, 1), (2, 176, 608, 1), (8, 13, 37, 2)])
def test_phase_kernel_is_k1_interleaved(card, k, h, w, b):
    raw = _raw(card, b, h, w, seed=k)
    ph = tail_cuda.lpg_phase_planes(raw, k)
    torch.cuda.synchronize()
    assert ph.shape == (b, 4, h * k // 2, w * k // 2)
    assert torch.equal(tail_cuda.interleave2x2(ph), lpg_cuda.lpg_fused(raw, k))
    assert torch.equal(ph, tail_cuda.lpg_phase_planes_plain(raw, k))


def _tail_inputs(card, b, hh, w2, seed, dtype=torch.float32, x_scale=0.3):
    g = torch.Generator().manual_seed(seed)

    def t(*shape, scale=0.3):
        return (torch.randn(*shape, generator=g) * scale).to(card)

    shapes = {"up": (3, 3, 64, 32), "r1": (1, 1, 32, 16), "r2": (1, 1, 16, 8),
              "r3": (1, 1, 8, 1), "i1": (3, 3, 36, 32), "f": (3, 3, 32, 1)}
    params = {n: {"kernel": t(*s), "bias": t(s[-1])} for n, s in shapes.items()}
    iconv2 = t(b, 64, hh, w2, scale=x_scale).to(dtype).permute(0, 2, 3, 1)  # the decoder's NCHW view
    maps = [tail_cuda.lpg_phase_planes(_raw(card, b, 2 * hh // k, 2 * w2 // k, seed + k), k) for k in (2, 4, 8)]
    return iconv2, maps, params


def _assert_tail_rule(out, ref):
    e = (out - ref).abs()
    assert torch.isfinite(out).all()
    assert e.mean() <= 2e-5 and e.max() <= 5e-2 and (e > 1e-4).float().mean() <= 0.01, (
        e.mean().item(), e.max().item(), (e > 1e-4).float().mean().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hh,w2,x_scale", [(2, 16, 128, 0.3), (1, 16, 152, 0.3), (1, 24, 40, 0.3),
                                             (3, 40, 72, 0.3), (1, 16, 152, 3.0)])
def test_tail_kernel_matches_plain(card, b, hh, w2, x_scale, dtype, monkeypatch):
    """K6 against its plain version at a tile multiple and at ragged shapes
    (Hh and W2 not multiples of the 8 x 16 tile: (3, 40, 72)), and with
    iconv2 at scale 3.0, where the ELUs and sigmoids saturate; on the
    decoder's NCHW view of iconv2 in f32 and in bf16 (a bf16 view must
    still be copied to channels-last)."""
    from bts_tpu_torch.models.bts import set_float32_precision

    set_float32_precision()  # the plain version's f32 convs without TF32
    monkeypatch.setattr(tail_cuda.fused_tail, "launches", 0)
    iconv2, maps, params = _tail_inputs(card, b, hh, w2, seed=hh + w2, dtype=dtype, x_scale=x_scale)
    fin, d1 = tail_cuda.fused_tail(iconv2, *maps, params)
    torch.cuda.synchronize()
    assert tail_cuda.fused_tail.launches == 1
    rfin, rd1 = tail_cuda.fused_tail_plain(iconv2, *maps, params)
    for out, ref in ((fin, rfin), (d1, rd1)):
        assert out.shape == (b, 4, hh, w2)
        _assert_tail_rule(out, ref)


@pytest.mark.parametrize("layout", ["channels_last", "strided"])
def test_tail_kernel_reads_iconv2_through_its_strides(card, layout):
    """K6 reads iconv2 through its strides: a contiguous (B, Hh, W2, 64)
    tensor and a view with a column stride of 2 give the plain version's
    result as the decoder's NCHW view does."""
    from bts_tpu_torch.models.bts import set_float32_precision

    set_float32_precision()
    iconv2, maps, params = _tail_inputs(card, 1, 16, 72, seed=7)
    if layout == "channels_last":
        x = iconv2.contiguous()
    else:
        wide = torch.zeros(1, 16, 144, 64, device=card)
        wide[:, :, ::2] = iconv2
        x = wide[:, :, ::2]
    assert x.stride() != iconv2.stride()
    fin, d1 = tail_cuda.fused_tail(x, *maps, params)
    rfin, rd1 = tail_cuda.fused_tail_plain(iconv2, *maps, params)
    _assert_tail_rule(fin, rfin)
    _assert_tail_rule(d1, rd1)


def test_tail_kernel_sees_a_weight_update(card):
    """An in-place update of a weight between two calls (same address, new
    version) reaches the kernel through the packed-weight cache."""
    from bts_tpu_torch.models.bts import set_float32_precision

    set_float32_precision()
    iconv2, maps, params = _tail_inputs(card, 1, 16, 128, seed=5)
    fin0, d10 = tail_cuda.fused_tail(iconv2, *maps, params)
    assert tail_cuda.fused_tail(iconv2, *maps, params)[0].equal(fin0)
    with torch.no_grad():
        params["i1"]["kernel"].mul_(-1.0)
    fin1, d11 = tail_cuda.fused_tail(iconv2, *maps, params)
    torch.cuda.synchronize()
    assert torch.equal(d11, d10)  # iconv1 does not reach the d1x1 head
    assert (fin1 - fin0).abs().max() > 0.1
    _assert_tail_rule(fin1, tail_cuda.fused_tail_plain(iconv2, *maps, params)[0])


def test_tail_kernel_refuses_bad_shapes(card):
    iconv2, maps, params = _tail_inputs(card, 1, 16, 128, seed=0)
    with pytest.raises(ValueError, match="iconv2"):
        tail_cuda.fused_tail(iconv2[..., :32], *maps, params)
    with pytest.raises(ValueError, match="maps"):
        tail_cuda.fused_tail(iconv2, maps[0][..., :64], maps[1], maps[2], params)


def _op_cases(card):
    """(op, its CUDA implementation, the object that counts its launches,
    args) of K1, K2, K5 and K6 on the inputs the decoder gives them."""
    raw = _raw(card, 2, 13, 37, seed=3)
    g = torch.randn(2, 13 * 4, 37 * 4, device=card)
    iconv2, maps, params = _tail_inputs(card, 1, 16, 128, seed=6)
    return {
        "K1": (lpg_cuda.lpg_fused, lpg_cuda._k1_cuda, lpg_cuda.lpg_fused, (raw, 8)),
        "K2": (lpg_cuda.lpg_fused_bwd, lpg_cuda._k2_cuda, lpg_cuda.lpg_fused_bwd, (raw, g, 4)),
        "K5": (tail_cuda.lpg_phase_planes, tail_cuda._k5_cuda, tail_cuda.lpg_phase_planes, (raw, 4)),
        "K6": (tail_cuda._k6, tail_cuda._k6_cuda, tail_cuda.fused_tail,
               (iconv2, *maps, tail_cuda._flat_params(params))),
    }


@pytest.mark.parametrize("key", ["K1", "K2", "K5", "K6"])
def test_registered_op_is_its_cuda_implementation(card, key, monkeypatch):
    """Through the dispatcher, each op runs its CUDA implementation (the
    launch code, called directly here): the same output bit for bit, in the
    same strides, and one launch counted per call."""
    op, impl, counted, args = _op_cases(card)[key]
    monkeypatch.setattr(counted, "launches", 0)
    via_op, direct = op(*args), impl(*args)
    torch.cuda.synchronize()
    assert counted.launches == 2
    for a, b in zip(*((x,) if torch.is_tensor(x) else x for x in (via_op, direct))):
        assert a.stride() == b.stride() and torch.equal(a, b)


@pytest.mark.parametrize("fused_tail", ["auto", "always"])
def test_exported_program_launches_the_kernels(card, tmp_path, fused_tail, monkeypatch):
    """A tiny KITTI model exported on the card, saved and loaded: one call
    launches K1 three times (or, with the fused tail, K5 three times and K6
    once) and equals the eager serving forward bit for bit."""
    from bts_tpu_torch.cli.bts_export import build_serve_fn, export_serving_fn
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model, set_float32_precision
    from bts_tpu_torch.utils.serving import load_exported

    set_float32_precision()
    cfg = Config(mode="test", encoder="mobilenetv2_bts", dataset="kitti", input_height=32, input_width=64,
                 batch_size=2, compute_dtype="float32", fused_tail=fused_tail,
                 bts_size=512 if fused_tail == "always" else 128)
    model = create_model(cfg, card)
    path = str(tmp_path / "m.pt2")
    torch.export.save(export_serving_fn(cfg, model), path)
    serve = load_exported(path)
    assert serve.device.type == "cuda"
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32, 64, 3), dtype=np.uint8))
    focal = torch.tensor([721.5377, 707.0493])
    counters = (lpg_cuda.lpg_fused, tail_cuda.lpg_phase_planes, tail_cuda.fused_tail)
    for c in counters:
        monkeypatch.setattr(c, "launches", 0)
    got = serve(images, focal)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == ([3, 0, 0] if fused_tail == "auto" else [0, 3, 1])
    fwd, _ = build_serve_fn(cfg, model)
    with torch.inference_mode():
        want = fwd(images.to(card), focal.to(card))
    assert got.shape == (2, 32, 64, 1) and torch.equal(got, want)
