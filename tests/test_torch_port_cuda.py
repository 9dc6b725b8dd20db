"""The port's CUDA kernels on the card: the fused LPG head's forward K1 and
backward K2, the public LPG op's forward K3 and backward K4, the phase-plane
head K5 (csrc/lpg_fused.cu), the fused decoder tail K6
(csrc/fused_tail.cu) and the eval-mode BatchNorm K7 (csrc/batchnorm.cu),
each against its plain version; K1, K2, K5 and K6
through their torch.library ops against their CUDA implementations called
directly, and through an exported serving program; bts_main on the card
fed by the native C++ loader against PIL, and --debug_nans.

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
more than 1e-4.  K7 equals its plain version bit for bit: the ATen chain it
replaces, and with SiLU, F.silu of the f32 normalisation, rounded once.
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
                                     (2, 13, 37, 2), (8, 44, 88, 16), (4, 88, 176, 16), (2, 176, 352, 16),
                                     (8, 52, 68, 4), (4, 104, 136, 4), (2, 208, 272, 4), (2, 187, 621, 1)])
def test_kernel_matches_plain(card, k, h, w, b):
    """K1 at the serving heads (b1: their rows split among warps), a ragged
    B=2 at k = 8 and at k = 2 (odd w: a row pitch of 2 mod 4 floats), the
    three config-4 heads (the largest: 16,896 work items, more than the
    card holds warps at once), the three config-3 heads (NYU 416x544, b4),
    and the k = 2 head of a raw 374x1242 KITTI frame at b1 (odd w)."""
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


@pytest.mark.parametrize("k,h,w,b", [(8, 44, 152, 1), (4, 88, 304, 1), (2, 176, 608, 1), (8, 13, 37, 2),
                                     (2, 13, 37, 2), (8, 44, 88, 16), (4, 88, 176, 16), (2, 176, 352, 16)])
def test_lpg_plane_kernels_match_plain(card, k, h, w, b, monkeypatch):
    """K3 and K4 through the public op's autograd Function, f32 plane, at
    the b1 serving heads (split launches), the ragged shapes (k = 2 with
    odd w) and the config-4 heads."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,h,w,b", [(8, 44, 152, 1), (4, 88, 304, 1), (2, 176, 608, 1), (8, 44, 152, 4),
                                     (2, 176, 608, 4), (8, 13, 37, 2), (4, 13, 37, 2), (2, 13, 37, 2)])
def test_phase_kernel_is_k1_interleaved(card, k, h, w, b, dtype):
    """K5 at the serving heads, two b4 export heads and the ragged shapes
    (k = 4 and k = 2 with odd w: phase rows of 2 mod 4 floats and of an odd
    count), on f32 and on bf16 raw read as it is: bit for bit K1
    interleaved, its plain version and, for bf16, K5 on the f32 copy."""
    raw = _raw(card, b, h, w, seed=k, dtype=dtype)
    ph = tail_cuda.lpg_phase_planes(raw, k)
    torch.cuda.synchronize()
    assert ph.shape == (b, 4, h * k // 2, w * k // 2) and ph.dtype == torch.float32
    assert torch.equal(tail_cuda.interleave2x2(ph), lpg_cuda.lpg_fused(raw, k))
    assert torch.equal(ph, tail_cuda.lpg_phase_planes_plain(raw, k))
    assert torch.equal(ph, tail_cuda.lpg_phase_planes(raw.float(), k))


@pytest.mark.parametrize("k,h,w", [(8, 44, 152), (4, 88, 304), (2, 176, 608), (8, 13, 37), (2, 13, 37)])
def test_split_launch_gives_the_unsplit_map(card, k, h, w):
    """K1 and K3 split a cell row's k rows among warps where the grid is
    small (a b1 serving head) and not where it is large: the b1 map equals,
    bit for bit, each image of a b16 batch of the same frame (a stride-0
    view, an unsplit launch on this card when the b1 launch splits)."""
    from bts_tpu_torch.ops.lpg import plane_from_spherical

    raw = _raw(card, 1, h, w, seed=k)
    plane = plane_from_spherical(raw, 80.0)
    for kernel, fn, x in (("K1", lpg_cuda.lpg_fused, raw), ("K3", lpg_cuda.lpg_plane_fwd, plane)):
        one, batch = fn(x, k), fn(x.expand(16, *x.shape[1:]), k)
        torch.cuda.synchronize()
        assert torch.equal(batch[0], one[0]) and torch.equal(batch[15], one[0]), kernel
    small, large = lpg_cuda.launch_shape("K1", 1, h, w, k), lpg_cuda.launch_shape("K1", 16, h, w, k)
    assert small["items"] == small["warps_per_cell_row"] * h * -(-w * k // 128)
    assert large["warps_per_cell_row"] <= small["warps_per_cell_row"]


def test_launch_rule_on_the_h100(card):
    """On a 132-SM card: the b1 serving head at k = 8 splits its rows (4
    warps per cell row, in blocks of 4 warps), the k = 4 and k = 2 heads do
    not; the config-4 (b16) and config-3 (b4) heads keep one warp per cell
    row and 8 per block, as before the split; K5 gives each warp one phase
    row."""
    if torch.cuda.get_device_properties(card).multi_processor_count != 132:
        pytest.skip("the rule's outcome is stated for 132 SMs")
    serving = [(1, 44, 152, 8), (1, 88, 304, 4), (1, 176, 608, 2)]
    for (b, h, w, k), split in zip(serving, (4, 1, 1)):
        got = lpg_cuda.launch_shape("K1", b, h, w, k)
        assert (got["warps_per_cell_row"], got["warps_per_block"]) == (split, 4 if split > 1 else 8)
        assert lpg_cuda.launch_shape("K5", b, h, w, k)["warps_per_cell_row"] == k // 2
    for b, h, w, k in [(16, 44, 88, 8), (16, 88, 176, 4), (16, 176, 352, 2),
                       (4, 52, 68, 8), (4, 104, 136, 4), (4, 208, 272, 2)]:
        items = b * h * -(-w * k // 128)
        assert lpg_cuda.launch_shape("K1", b, h, w, k) == {
            "warps_per_cell_row": 1, "warps_per_block": 8, "blocks": -(-items // 8), "items": items}
    stream = torch.cuda.current_stream().cuda_stream
    assert lpg_cuda._lib().lpg_empty_launch(0, 1, 44, 152, 8, stream) == 0
    assert lpg_cuda._lib().lpg_empty_launch(1, 1, 44, 152, 8, stream) == 0
    torch.cuda.synchronize()


def test_bf16_fused_tail_forward_launches_no_cast(card):
    """A bf16 decoder forward on the fused tail launches 3 K5 and 1 K6, and
    under each K5 op (its CPU subtree, torch.profiler) its kernel alone: K5
    reads the bf16 raw as it is, no cast kernel before it."""
    from bts_tpu_torch.cli.bts_test import predict
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.utils.profiling import launched_kernels

    cfg = Config(mode="test", encoder="mobilenetv2_bts", dataset="kitti", input_height=32, input_width=64,
                 batch_size=1, compute_dtype="bfloat16", fused_tail="always", bts_size=512)
    model = create_model(cfg, card)
    batch = {"image": np.random.default_rng(0).integers(0, 256, (1, 32, 64, 3), dtype=np.uint8),
             "focal": np.array([721.5377], np.float32)}

    got = launched_kernels(lambda: next(predict(cfg, model, [batch], card)),
                           ("bts_tpu_torch::lpg_phase_planes", "bts_tpu_torch::fused_tail"))
    k5, k6 = got["by_op"].values()
    assert len(k5) == 3 and all(len(ks) == 1 and "lpg_phase_kernel" in ks[0] for ks in k5), k5
    assert len(k6) == 1 and len(k6[0]) == 1 and "fused_tail_kernel" in k6[0][0], k6
    device = got["kernels"]
    assert sum("lpg_phase_kernel" in n for n in device) == 3 and sum("fused_tail_kernel" in n for n in device) == 1


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


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiny_trainer(card):
    """A tiny DenseNet under the BTS decoder (bts_size 64), seeded, and its
    Trainer at the config-4 training size: b2 KITTI frames of 352x1216
    augmented to 352x704, so K1 and K2 run at config-4 head shapes."""
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import BtsDecoder, BtsModel, init_weights
    from bts_tpu_torch.models.encoders.densenet import DenseNet
    from bts_tpu_torch.training.trainer import Trainer

    cfg = Config(mode="train", encoder="densenet121_bts", bts_size=64, dataset="kitti", input_height=352,
                 input_width=704, batch_size=2, compute_dtype="float32", do_random_rotate=True, device="cuda")
    encoder = DenseNet(growth_rate=8, block_config=(1, 1, 2, 1), num_init_features=16)
    model = BtsModel(encoder, BtsDecoder(encoder.channels, cfg.max_depth, cfg.bts_size))
    init_weights(model, torch.Generator().manual_seed(3))
    return Trainer(model.to(card), cfg, total_steps=10, device=card)


def test_ddp_over_nccl_at_world1_equals_the_unwrapped_step(card, monkeypatch):
    """A NCCL group of one: the step runs inside DistributedDataParallel with
    3 K1 + 3 K2 launches and equals the unwrapped step (loss rtol 1e-5, each
    gradient tensor within 1e-3 of its norm, as the train phase of
    chip_smoke.py holds two f32 steps)."""
    import torch.distributed as dist

    from bts_tpu_torch.models.bts import set_float32_precision

    set_float32_precision()
    rng = np.random.default_rng(1)
    depth = rng.uniform(1.0, 80.0, (2, 352, 1216)).astype(np.float32)
    depth[rng.random(depth.shape) >= 0.05] = 0.0
    batch = {"image": rng.integers(0, 256, (2, 352, 1216, 3), dtype=np.uint8), "depth": depth,
             "focal": np.full((2,), 721.5377, np.float32)}
    ref = _tiny_trainer(card)
    ref_loss = float(ref.train_step(batch)["loss"])
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        trainer = _tiny_trainer(card)
        assert trainer.ddp is not None
        monkeypatch.setattr(lpg_cuda.lpg_fused, "launches", 0)
        monkeypatch.setattr(lpg_cuda.lpg_fused_bwd, "launches", 0)
        loss = float(trainer.train_step(batch)["loss"])
        torch.cuda.synchronize()
        assert (lpg_cuda.lpg_fused.launches, lpg_cuda.lpg_fused_bwd.launches) == (3, 3)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    grads = {n: p.grad for n, p in ref.model.named_parameters()}
    total = torch.sqrt(sum(g.square().sum() for g in grads.values())).item()
    for n, p in trainer.model.named_parameters():
        gap = (p.grad - grads[n]).norm().item()
        assert gap <= max(1e-3 * grads[n].norm().item(), 1e-6 * total), (n, gap)


def _bn_rank(rank, world, port, x, gy, out):
    """One gloo rank on cuda:0: a train-mode BatchNorm over the process
    group on its two samples of ``x``, forward and backward of sum(y * gy)."""
    import os

    import torch.distributed as dist

    from bts_tpu_torch.models.layers import BatchNorm

    torch.cuda.set_device(0)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        bn = BatchNorm(x.shape[1]).cuda().train()
        bn.process_group = dist.group.WORLD
        rows = slice(2 * rank, 2 * rank + 2)
        xr = x[rows].cuda().requires_grad_()
        y = bn(xr)
        (y * gy[rows].cuda()).sum().backward()
        torch.save({"y": y.detach().cpu(), "dx": xr.grad.cpu(), "dw": bn.weight.grad.cpu(),
                    "db": bn.bias.grad.cpu(), "mean": bn.running_mean.cpu(), "var": bn.running_var.cpu()},
                   f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def test_batchnorm_global_moments_on_cuda_under_gloo(card, tmp_path):
    """Two gloo ranks on the one card, each with half of a b4 batch: the
    all-reduced moments give the output, input gradient, running statistics
    and (summed over the ranks) the affine gradients of one BatchNorm over
    the whole batch; rtol 1e-5, atol 1e-6 of each reference's largest value."""
    import torch.multiprocessing as mp

    from bts_tpu_torch.models.layers import BatchNorm

    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.normal(size=(4, 8, 12, 20)) * 2 + 0.5).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    mp.spawn(_bn_rank, args=(2, _free_port(), x, gy, str(tmp_path / "bn")), nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"bn.{r}") for r in range(2)]
    bn = BatchNorm(8).to(card).train()
    xc = x.to(card).requires_grad_()
    y = bn(xc)
    (y * gy.to(card)).sum().backward()
    want = {"y": y.detach(), "dx": xc.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": bn.running_mean, "var": bn.running_var}
    got = {"y": torch.cat([r["y"] for r in ranks]), "dx": torch.cat([r["dx"] for r in ranks]),
           "dw": ranks[0]["dw"] + ranks[1]["dw"], "db": ranks[0]["db"] + ranks[1]["db"],
           "mean": ranks[0]["mean"], "var": ranks[0]["var"]}
    assert torch.equal(ranks[1]["mean"], got["mean"]) and torch.equal(ranks[1]["var"], got["var"])
    for k, w in want.items():
        w = w.cpu()
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-6 * w.abs().max().item(), msg=k)


def _kitti_tree(root, n: int, hw, seed: int):
    """``n`` seeded KITTI frames and sparse depth PNGs (meters x 256) and
    their split file."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(root / f"rgb{i}.png")
        depth = rng.uniform(1.0, 80.0, hw) * (rng.random(hw) < 0.05)
        Image.fromarray((depth * 256).astype(np.uint16)).save(root / f"gt{i}.png")
        lines.append(f"rgb{i}.png gt{i}.png 721.5377")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return ["--data_path", str(root), "--gt_path", str(root), "--filenames_file", str(root / "split.txt")]


def _tiny_main_argv(tmp_path, name, *extra):
    return ["--device", "cuda", "--encoder", "mobilenetv2_bts", "--bts_size", "64", "--dataset", "kitti",
            "--compute_dtype", "float32", "--batch_size", "2", "--num_epochs", "1", "--log_freq", "1",
            "--save_freq", "100", "--log_directory", str(tmp_path / "runs"), "--model_name", name, *extra]


def test_bts_main_native_loader_equals_pil_on_the_card(card, tmp_path, capsys):
    """bts_main for 2 steps on the card (KB crop, 352x704, the config-4
    heads): --use_native_loader always gives the first loss of never (the
    same batches, weights and draws)."""
    from bts_tpu_torch.cli import bts_main
    from bts_tpu_torch.data import native_loader as nl

    if not nl.available():
        pytest.skip(f"the native loader does not build on this machine: {nl.unavailable_reason()[:300]}")
    data = _kitti_tree(tmp_path / "kitti", 4, (375, 1242), seed=4)
    first = {}
    for choice in ("always", "never"):
        argv = _tiny_main_argv(tmp_path, choice, "--do_kb_crop", "--input_height", "352", "--input_width", "704",
                               "--use_native_loader", choice, *data)
        assert bts_main.main(argv) == 0
        out = capsys.readouterr().out
        assert ("input: native C++ loader" in out) == (choice == "always")
        first[choice] = next(ln for ln in out.splitlines() if ln.startswith("step 1/2 loss")).split()[3]
    assert first["always"] == first["never"]


def test_debug_nans_names_the_module_on_the_card(card, tmp_path, capsys):
    """--debug_nans with remat on the card: a clean step trains; a NaN in
    one conv weight raises FloatingPointError naming that conv."""
    from bts_tpu_torch.cli import bts_main
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model

    data = _kitti_tree(tmp_path / "kitti", 2, (80, 112), seed=5)
    argv = _tiny_main_argv(tmp_path, "clean", "--input_height", "64", "--input_width", "96", "--remat",
                           "--debug_nans", "--use_native_loader", "never", *data)
    assert bts_main.main(argv) == 0
    assert "done at step 1" in capsys.readouterr().out
    sd = create_model(Config(encoder="mobilenetv2_bts", bts_size=64), "cpu").encoder.state_dict()
    sd["features.3.conv.1.0.weight"][0, 0, 0, 0] = float("nan")
    torch.save(sd, tmp_path / "encoder.pt")
    argv[argv.index("clean")] = "nan"
    with pytest.raises(FloatingPointError, match=r"NaN in the output of encoder\.features\.3\.conv\.1\.0 "):
        bts_main.main(argv + ["--pretrained_model", str(tmp_path / "encoder.pt")])


# K7: the eval-mode BatchNorm (+ReLU), csrc/batchnorm.cu.  Shapes of
# DenseNet-161 BTS at 352x1216: norm0 at H/2 (96 channels), dense layers at
# H/4 and H/8 (norm2's 192; denseblock1's last norm1, 352), transition3 at
# H/16 (2,112), norm5 and denseblock4 at H/32 (2,208 and 192 channels of 418
# pixels: a vector straddles planes), at b1 and b8; an odd plane (13 x 37)
# with a last partial vector; planes smaller than a vector (1 x 3).
BN_SHAPES = [(1, 96, 176, 608), (8, 192, 88, 304), (1, 352, 88, 304), (8, 512, 44, 152), (1, 2112, 22, 76),
             (1, 2208, 11, 38), (8, 2208, 11, 38), (8, 192, 11, 38), (3, 7, 13, 37), (2, 5, 1, 3)]


def _bn_case(card, shape, dtype, seed=0):
    """x in ``dtype`` and f32 (mean, var, weight, bias) as a trained
    network holds them."""
    g = torch.Generator(device=card).manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, device=card) * 2 + 0.5).to(dtype)
    mean = torch.randn(c, generator=g, device=card) * 0.5
    var = torch.rand(c, generator=g, device=card) * 2 + 1e-3
    weight = 1 + 0.2 * torch.randn(c, generator=g, device=card)
    bias = 0.2 * torch.randn(c, generator=g, device=card)
    return x, (mean, var, weight, bias)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_act_kernel_equals_the_chain(card, shape, dtype, relu):
    """K7 equals the ATen chain it replaces (today's eval BatchNorm, then
    F.relu), bit for bit, and counts one launch."""
    from bts_tpu_torch.models.layers import BN_EPS
    from bts_tpu_torch.ops import bn_cuda

    act = "relu" if relu else "none"
    x, params = _bn_case(card, shape, dtype)
    before = bn_cuda.bn_act.launches
    out = bn_cuda._k7_cuda(x, *params, BN_EPS, act)
    torch.cuda.synchronize()
    assert bn_cuda.bn_act.launches == before + 1
    ref = bn_cuda.bn_act_plain(x, *params, BN_EPS, act)
    assert out.dtype == dtype and out.shape == x.shape and out.is_contiguous()
    assert torch.equal(out, ref), f"{(out != ref).sum().item()} of {out.numel()} elements differ"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_kernel_reads_a_misaligned_x(card, dtype):
    """A contiguous view one element into its storage (not 16-byte
    aligned) takes the kernel's 1-element vectors, with the same result."""
    from bts_tpu_torch.models.layers import BN_EPS
    from bts_tpu_torch.ops import bn_cuda

    x, params = _bn_case(card, (2, 64, 22, 76), dtype, seed=1)
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=card)[1:].view(x.shape).copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert torch.equal(bn_cuda._k7_cuda(shifted, *params, BN_EPS, "relu"),
                       bn_cuda._k7_cuda(x, *params, BN_EPS, "relu"))


BN_TRACE_CHECK = """
import torch
from bts_tpu_torch.models.layers import BN_EPS, BatchNorm
from bts_tpu_torch.ops import bn_cuda
from bts_tpu_torch.utils.profiling import launched_kernels

g = torch.Generator(device="cuda").manual_seed(2)
x = torch.randn(1, 352, 88, 304, generator=g, device="cuda").to(torch.bfloat16)
bn = BatchNorm(352).to("cuda").eval()
with torch.inference_mode():
    got = launched_kernels(lambda: bn(x, act="relu"), ("bts_tpu_torch::bn_act",))
(calls,) = got["by_op"].values()
assert len(calls) == 1 and len(calls[0]) == 1 and "bn_act_kernel" in calls[0][0], got
assert got["kernels"] == calls[0], got
print("ok")
"""


def test_bn_act_module_launches_k7_under_its_op(card):
    """The op runs K7 as its CUDA implementation called directly does, and
    an eval BatchNorm under no grad goes through the op: under a profiler,
    one kernel, K7's, under its one call (what the benchmark's trace
    readers find).  The profiler window runs in a fresh process, as the
    benchmark's traced run does: late in a run of this whole file, after
    many windows, the test process's profiler delivered no kernel record of
    the window in three tries, in two runs of two (the lost records of
    utils/profiling.py); run with fewer tests before it, it passed."""
    import subprocess
    import sys
    from pathlib import Path

    from bts_tpu_torch.models.layers import BN_EPS
    from bts_tpu_torch.ops import bn_cuda

    x, params = _bn_case(card, (1, 352, 88, 304), torch.bfloat16, seed=2)
    assert torch.equal(bn_cuda.bn_act(x, *params, BN_EPS, "relu"), bn_cuda._k7_cuda(x, *params, BN_EPS, "relu"))
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", BN_TRACE_CHECK], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout + proc.stderr


def test_bn_act_engages_at_every_batchnorm_of_a_serving_forward(card):
    """One DenseNet-161 BTS serving forward under inference_mode launches K7
    once per BatchNorm (161 in the encoder, 5 in the decoder, 9 in the dense
    ASPP); a train-mode step and an eval forward under autograd launch
    none, and the serving forward equals today's, bit for bit."""
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.layers import BN_EPS, BatchNorm
    from bts_tpu_torch.ops import bn_cuda

    cfg = Config(mode="test", encoder="densenet161_bts", dataset="kitti", input_height=64, input_width=96,
                 compute_dtype="bfloat16", bts_size=512)
    model = create_model(cfg, card)
    assert sum(isinstance(m, BatchNorm) for m in model.modules()) == 175
    image = torch.rand(1, 3, 64, 96, device=card)
    focal = torch.tensor([721.5377], device=card)
    before = bn_cuda.bn_act.launches
    with torch.inference_mode():
        fused = model(image, focal)
    assert bn_cuda.bn_act.launches - before == 175
    with torch.no_grad():  # the same forward with every BatchNorm on today's chain
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.forward = lambda x, act="none", m=m: bn_cuda.bn_act_plain(
                    x, m.running_mean, m.running_var, m.weight, m.bias, BN_EPS, act)
        today = model(image, focal)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                del m.forward
    for a, b in zip(fused, today):
        assert torch.equal(a, b)
    before = bn_cuda.bn_act.launches
    model(image, focal)  # eval, grad on
    model.train()
    sum(o.float().mean() for o in model(image, focal)).backward()
    torch.cuda.synchronize()
    assert bn_cuda.bn_act.launches == before


def _bn_calls(encoder, h=352, w=1216):
    """(per-image shape, activation, eps) of each BatchNorm call of a BTS
    serving forward of ``encoder`` at h x w, in order, recorded by forward
    pre-hooks on the meta device (nothing is computed)."""
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.layers import BatchNorm

    with torch.device("meta"):
        model = create_model(Config(encoder=encoder, bts_size=512, compute_dtype="bfloat16"), "meta")
    calls = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(lambda m, args, kw: calls.append(
                (tuple(args[0].shape[1:]), kw.get("act", "none"), m.eps)), with_kwargs=True)
    with torch.no_grad():
        model(torch.empty(1, 3, h, w, device="meta"), torch.empty(1, device="meta"))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 16])
def test_bn_act_silu_equals_plain_on_efficientnet_b5_calls(card, b, dtype):
    """K7 at each of the 130 BatchNorm calls of an EfficientNet-B5 BTS
    serving forward at b x 352 x 1216 (76 with SiLU, 9 with ReLU, 45
    without; eps 1e-3 in the encoder) equals its plain version bit for bit:
    SiLU of the f32 normalisation, rounded once."""
    from bts_tpu_torch.ops import bn_cuda

    calls = _bn_calls("efficientnet_b5_bts")
    acts = [act for _, act, _ in calls]
    assert (len(calls), acts.count("silu"), acts.count("relu")) == (130, 76, 9)
    for i, (shape, act, eps) in enumerate(calls):
        x, params = _bn_case(card, (b,) + shape, dtype, seed=i)
        out, ref = bn_cuda._k7_cuda(x, *params, eps, act), bn_cuda.bn_act_plain(x, *params, eps, act)
        assert torch.equal(out, ref), f"call {i} {shape} {act}: {(out != ref).sum().item()} elements differ"
        del x, out, ref


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_silu_reads_a_misaligned_x(card, dtype):
    """SiLU on the 1-element vectors of a view that is not 16-byte aligned,
    with the same result as on an aligned copy and as the plain version."""
    from bts_tpu_torch.ops import bn_cuda

    x, params = _bn_case(card, (2, 240, 22, 76), dtype, seed=3)
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=card)[1:].view(x.shape).copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    out = bn_cuda._k7_cuda(shifted, *params, 1e-3, "silu")
    assert torch.equal(out, bn_cuda._k7_cuda(x, *params, 1e-3, "silu"))
    assert torch.equal(out, bn_cuda.bn_act_plain(x, *params, 1e-3, "silu"))


def test_bn_act_relu_equals_plain_on_densenet161_calls(card):
    """K7's ReLU path is unchanged by the SiLU epilogue: at each of the 175
    BatchNorm calls of a DenseNet-161 BTS serving forward at 352 x 1216
    (b1, bf16) it equals the chain bit for bit."""
    from bts_tpu_torch.ops import bn_cuda

    calls = _bn_calls("densenet161_bts")
    assert len(calls) == 175 and {act for _, act, _ in calls} == {"relu", "none"}
    for i, (shape, act, eps) in enumerate(calls):
        x, params = _bn_case(card, (1,) + shape, torch.bfloat16, seed=i)
        out, ref = bn_cuda._k7_cuda(x, *params, eps, act), bn_cuda.bn_act_plain(x, *params, eps, act)
        assert torch.equal(out, ref), f"call {i} {shape} {act}: {(out != ref).sum().item()} elements differ"


def test_efficientnet_b5_serving_forward_with_k7_equals_without(card):
    """A b2 352 x 1216 bf16 serving forward of EfficientNet-B5 BTS through
    ``predict`` launches K7 once per BatchNorm (130) and equals, bit for
    bit, the same forward with every BatchNorm on its plain version."""
    from bts_tpu_torch.cli.bts_test import predict
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.layers import BatchNorm
    from bts_tpu_torch.ops import bn_cuda

    cfg = Config(mode="test", encoder="efficientnet_b5_bts", dataset="kitti", bts_size=512,
                 compute_dtype="bfloat16", seed=1)
    model = create_model(cfg, card)
    g = torch.Generator().manual_seed(5)
    batch = {"image": torch.randint(0, 256, (2, 352, 1216, 3), dtype=torch.uint8, generator=g),
             "focal": torch.tensor([721.5377, 707.0493])}
    before = bn_cuda.bn_act.launches
    fused = next(predict(cfg, model, [batch], card))
    torch.cuda.synchronize()
    assert bn_cuda.bn_act.launches - before == 130
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.forward = lambda x, act="none", m=m: bn_cuda.bn_act_plain(
                x, m.running_mean, m.running_var, m.weight, m.bias, m.eps, act)
    before = bn_cuda.bn_act.launches
    plain = next(predict(cfg, model, [batch], card))
    assert bn_cuda.bn_act.launches == before
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)
