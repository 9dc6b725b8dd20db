"""bts_tpu_torch's fused decoder tail against bts_tpu on the CPU: the phase
planes (K5's plain version against ``tail_pallas.lpg_phase_planes``), the
tail (K6's plain version against ``tail_pallas.fused_tail``), both run in
interpret mode, and the decoder with ``fused_tail="always"`` against the JAX
decoder with the same weights.  The same numpy inputs go to both sides; each
JAX reference is computed once per module.

K6's rule, set from the measured gap: on each output the mean abs error
<= 2e-5, the max abs error <= 5e-2 and at most 1% of pixels off by more than
1e-4.  Both sides round the same intermediates to bf16 and sum in f32 in
other orders, so a sum near a bf16 rounding boundary can round one step
apart and carry that step on.  Measured against the TPU kernel at
(2, 16, 128): mean 1.7e-6, max 7.5e-3, 18 of 16,384 pixels above 1e-4; the
card's kernel against this plain version at 352x1216 (1.7 M pixels): mean
2.9e-6, max 1.8e-2 (the largest of these rare flips grows with the pixel
count, so the max bound leaves room and the mean and the share carry the
rule).  The literal path follows another rounding schedule and misses the
rule by far (tests/test_tail.py holds it to mean < 3e-3, max < 0.15); the
negative control below shows that.

The CUDA kernels themselves run only on a card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bts_tpu.ops.lpg_pallas as lpg_mod
from bts_tpu.models.bts import BtsDecoder as JBtsDecoder
from bts_tpu.ops.tail_pallas import fused_tail as j_fused_tail
from bts_tpu.ops.tail_pallas import lpg_phase_planes as j_phase_planes
from bts_tpu_torch.models import layers
from bts_tpu_torch.models.bts import BtsDecoder, _tail_ok
from bts_tpu_torch.ops import lpg as port_lpg
from bts_tpu_torch.ops import lpg_cuda, tail_cuda
from bts_tpu_torch.utils import torch_converter as TC

from test_torch_port_model import _load_port, _random_variables

MEAN_MAX, ABS_MAX, OFF_SHARE = 2e-5, 5e-2, 0.01
TAIL_SHAPES = [(2, 16, 128), (1, 16, 152)]  # (B, Hh, W2); W2 = 152 is not a tile multiple


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _interpret():
    """The Pallas kernels run in interpret mode on the CPU."""
    old = lpg_mod._INTERPRET
    lpg_mod._INTERPRET = True
    yield
    lpg_mod._INTERPRET = old


def _t(rng, *shape, scale=0.3):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _tail_params(rng):
    shapes = {"up": (3, 3, 64, 32), "r1": (1, 1, 32, 16), "r2": (1, 1, 16, 8),
              "r3": (1, 1, 8, 1), "i1": (3, 3, 36, 32), "f": (3, 3, 32, 1)}
    return {n: {"kernel": _t(rng, *s), "bias": _t(rng, s[-1])} for n, s in shapes.items()}


@pytest.fixture(scope="module")
def tail_case():
    """Per shape: params, iconv2, raw heads, the JAX phase planes and the
    JAX tail's outputs, all numpy."""
    cases = {}
    for i, (b, hh, w2) in enumerate(TAIL_SHAPES):
        rng = np.random.default_rng(i)
        p = _tail_params(rng)
        x = _t(rng, b, hh, w2, 64)
        raws = {k: _t(rng, b, 2 * hh // k, 2 * w2 // k, 3) for k in (2, 4, 8)}
        phs = {k: np.array(j_phase_planes(jnp.asarray(r), k)) for k, r in raws.items()}
        jp = jax.tree.map(jnp.asarray, p)
        fin, d1 = jax.jit(lambda *a: j_fused_tail(*a, params=jp))(
            jnp.asarray(x).astype(jnp.bfloat16), *(jnp.asarray(phs[k]) for k in (2, 4, 8)))
        cases[(b, hh, w2)] = dict(params=p, x=x, raws=raws, phs=phs, fin=np.asarray(fin), d1=np.asarray(d1))
    return cases


def _torch_params(p):
    return {n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in p.items()}


def _gap(port, ref):
    e = np.abs(np.asarray(port, np.float32) - ref)
    return {"mean": float(e.mean()), "max": float(e.max()), "off_share": float((e > 1e-4).mean())}


def _within_rule(gap):
    return gap["mean"] <= MEAN_MAX and gap["max"] <= ABS_MAX and gap["off_share"] <= OFF_SHARE


@pytest.mark.parametrize("k", [2, 4, 8])
def test_phase_planes_plain_matches_jax(k, tail_case):
    """K5's plain version against the TPU kernel (interpret mode), and its
    interleaving is the fused head's plain map exactly."""
    case = tail_case[TAIL_SHAPES[0]]
    raw = torch.from_numpy(case["raws"][k])
    port = tail_cuda.lpg_phase_planes_plain(raw, k)
    np.testing.assert_allclose(port.numpy(), case["phs"][k], rtol=0, atol=1e-6)
    assert torch.equal(tail_cuda.interleave2x2(port), lpg_cuda.lpg_fused_plain(raw, k))


def test_interleave_matches_jax(tail_case):
    from bts_tpu.ops.tail_pallas import interleave2x2 as j_interleave

    ph = tail_case[TAIL_SHAPES[0]]["phs"][4]
    np.testing.assert_array_equal(tail_cuda.interleave2x2(torch.from_numpy(ph)).numpy(),
                                  np.asarray(j_interleave(jnp.asarray(ph))))


@pytest.mark.parametrize("shape", TAIL_SHAPES)
def test_fused_tail_plain_matches_jax(shape, tail_case):
    """K6's plain version against the TPU kernel (interpret mode), at a tile
    multiple and at a ragged width, under the module's rule."""
    case = tail_case[shape]
    fin, d1 = tail_cuda.fused_tail_plain(
        torch.from_numpy(case["x"]), *(torch.from_numpy(case["phs"][k]) for k in (2, 4, 8)),
        _torch_params(case["params"]))
    assert fin.shape == d1.shape == (shape[0], 4, shape[1], shape[2])
    for name, port, ref in (("final", fin, case["fin"]), ("d1x1", d1, case["d1"])):
        gap = _gap(port, ref)
        assert _within_rule(gap), (name, gap)


def _unpack_k16(frag, ksteps):
    """B (16*ksteps, 32) from fused_tail.cu's m16n8k16 B fragments, read as
    the PTX ISA defines them: lane = 4g + t holds b0 = B[2t, 2t+1][n] and
    b1 = B[2t+8, 2t+9][n] of n8 tile j at n = 8j + g; a lane's 16 bytes per
    k-step and tile pair h are b0, b1 of tile 2h, then of tile 2h+1."""
    frag = frag.reshape(ksteps, 2, 32, 8)
    out = np.zeros((16 * ksteps, 32), np.float32)
    for s in range(ksteps):
        for h in range(2):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for reg in range(4):
                    k = 16 * s + 2 * t + 8 * (reg % 2)
                    out[k:k + 2, 8 * (2 * h + reg // 2) + g] = frag[s, h, lane, 2 * reg:2 * reg + 2]
    return out


def _unpack_k8(frag):
    """B (8, 32) from m16n8k8 b0 fragments: lane 4g + t, tile j -> B[2t, 2t+1][8j + g]."""
    frag = frag.reshape(32, 4, 2)
    out = np.zeros((8, 32), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(4):
            out[2 * t:2 * t + 2, 8 * j + g] = frag[lane, j]
    return out


def test_packed_tail_params_unpack_to_the_kernels():
    """K6's packed buffer, read back by the mma.sync fragment layout, gives
    the folded upconv's phase taps, iconv1's HWIO kernel (maps and zero rows
    in the k8 step) and the small parameters, so a slip in the fragment
    order shows without a card."""
    p = _torch_params(_tail_params(np.random.default_rng(3)))
    buf = tail_cuda.pack_tail_params(p)
    assert buf.dtype == torch.uint8 and buf.numel() == tail_cuda.PARAM_BYTES
    k4_bytes, ki1_bytes = 4 * 16 * 2 * 32 * 16, 9 * 2560
    frags = buf[:k4_bytes + ki1_bytes].view(torch.bfloat16).float().numpy()
    k4 = tail_cuda._folded_upconv(p["up"]["kernel"])
    for q, (py, pz) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        got = _unpack_k16(frags[q * 8192:(q + 1) * 8192], 16).reshape(2, 2, 64, 32)
        np.testing.assert_array_equal(got, k4[py::2, pz::2].numpy())
    i1 = tail_cuda._bf(p["i1"]["kernel"]).reshape(9, 36, 32).numpy()
    for tap in range(9):
        f = frags[32768 + tap * 1280:32768 + (tap + 1) * 1280]
        np.testing.assert_array_equal(_unpack_k16(f[:1024], 2), i1[tap, :32])
        maps = _unpack_k8(f[1024:])
        np.testing.assert_array_equal(maps[:4], i1[tap, 32:])
        assert not maps[4:].any()
    small = buf[k4_bytes + ki1_bytes:].view(torch.float32).numpy()
    bf = lambda name, part: tail_cuda._bf(p[name][part]).reshape(-1).numpy()  # noqa: E731
    want = np.concatenate([bf("r1", "kernel"), bf("r1", "bias"), bf("r2", "kernel"), bf("r2", "bias"),
                           bf("r3", "kernel"), p["r3"]["bias"].numpy(), bf("f", "kernel"), p["f"]["bias"].numpy(),
                           bf("up", "bias"), bf("i1", "bias"), np.zeros(2, np.float32)])
    np.testing.assert_array_equal(small, want)
    np.testing.assert_array_equal(tail_cuda.host_floats(buf).numpy(), want)
    assert k4_bytes + ki1_bytes == tail_cuda.FRAG_BYTES


class _TailModules(torch.nn.Module):
    """The decoder's tail modules, as tail_params reads them."""

    def __init__(self):
        super().__init__()
        self.upconv1 = layers.UpConv(64, 32)
        self.reduc1x1 = layers.Reduction1x1(32, 16, is_final=True)
        self.conv1 = layers.ConvBlock(36, 32)
        self.get_depth = layers.ConvBlock(32, 1, act=None)


@pytest.mark.parametrize("update", ["load_state_dict", "add_"])
def test_packed_tail_params_cache(update):
    """The cache gives the same buffer while the weights are unchanged and a
    new one, of the new weights, after load_state_dict or an in-place add_."""
    torch.manual_seed(0)
    mods = _TailModules()

    def packed():
        return tail_cuda.packed_tail_params(tail_cuda.tail_params(mods), "cpu")

    first = packed()
    assert all(a is b for a, b in zip(packed(), first))
    with torch.inference_mode():  # as predict runs the model
        assert all(a is b for a, b in zip(packed(), first))
    if update == "add_":
        with torch.no_grad():
            mods.conv1.weight.add_(0.5)
    else:
        mods.load_state_dict(_TailModules().state_dict())
    again = packed()
    assert again[0] is not first[0] and not torch.equal(again[0], first[0])
    assert torch.equal(again[0], tail_cuda.pack_tail_params(tail_cuda.tail_params(mods)))
    assert torch.equal(again[1], tail_cuda.host_floats(again[0]))
    assert all(a is b for a, b in zip(packed(), again))


def _literal_tail(p, x, maps):
    """The port's literal modules in bf16 on the same weights and inputs:
    upconv1 -> reduc1x1 -> concat -> conv1 -> get_depth, as phase planes."""
    bf = torch.bfloat16
    up = layers.UpConv(64, 32, bf)
    red = layers.Reduction1x1(32, 16, is_final=True, dtype=bf)
    conv1 = layers.ConvBlock(36, 32, dtype=bf)
    get_depth = layers.ConvBlock(32, 1, act=None, dtype=bf)
    for mod, name in ((up.conv, "up"), (red.conv0, "r1"), (red.conv1, "r2"), (red.conv2, "r3"),
                      (conv1, "i1"), (get_depth, "f")):
        mod.weight.data = p[name]["kernel"].permute(3, 2, 0, 1).contiguous()
        mod.bias.data = p[name]["bias"]
    with torch.no_grad():
        up1 = up(x.permute(0, 3, 1, 2).to(bf))
        d1x1 = torch.sigmoid(red(up1).float())
        full = [tail_cuda.interleave2x2(m)[:, None].to(bf) for m in maps]
        iconv1 = conv1(torch.cat([up1, d1x1.to(bf)] + full, dim=1))
        final = torch.sigmoid(get_depth(iconv1).float())
    return tail_cuda._split2x2(final[:, 0]), tail_cuda._split2x2(d1x1[:, 0])


def test_literal_tail_misses_the_rule(tail_case):
    """Negative control: the literal bf16 path on the same inputs misses the
    rule, so the rule sees the rounding schedule."""
    case = tail_case[TAIL_SHAPES[0]]
    fin, _ = _literal_tail(_torch_params(case["params"]), torch.from_numpy(case["x"]),
                           [torch.from_numpy(case["phs"][k]) for k in (2, 4, 8)])
    gap = _gap(fin, case["fin"])
    assert not _within_rule(gap), gap
    assert gap["mean"] < 3e-3 and gap["max"] < 0.15, gap  # tests/test_tail.py's rule for it


def test_tail_supported_guards():
    assert tail_cuda.tail_supported((1, 176, 608, 64))
    assert tail_cuda.tail_supported((1, 176, 1024, 64))
    assert not tail_cuda.tail_supported((1, 176, 608, 32))  # bts_size != 512
    assert not tail_cuda.tail_supported((1, 175, 608, 64))  # Hh not a multiple of 8


def test_dispatch_follows_the_jax_package():
    """auto and never keep the literal tail, as does train mode; always on
    an unsupported shape raises."""
    from bts_tpu.models.bts import _tail_ok as j_tail_ok

    for args in (("auto", False), ("never", False), ("always", False), ("always", True)):
        assert _tail_ok(*args, (1, 176, 608, 64)) == j_tail_ok(*args, (1, 176, 608, 64))
    assert not _tail_ok("auto", False, (1, 176, 608, 64))
    assert not _tail_ok("always", True, (1, 176, 608, 64))
    with pytest.raises(ValueError):
        _tail_ok("always", False, (1, 176, 608, 32))


CHANNELS = (8, 8, 16, 16, 32)  # skip2, skip4, skip8, skip16, bottleneck
H, W, NF, MAX_DEPTH = 32, 256, 512, 10.0


def _features(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, H // s, W // s, c)).astype(np.float32)
            for s, c in zip((2, 4, 8, 16, 32), CHANNELS)]


def _port_decoder(variables, dtype, fused_tail, use_pallas="auto"):
    dec = BtsDecoder(CHANNELS, MAX_DEPTH, NF, dtype=dtype, use_pallas=use_pallas, fused_tail=fused_tail)
    return _load_port(dec, variables, TC.decoder_mapping(NF))


def _nchw(f):
    return torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def decoder_case():
    feats = _features(7)
    focal = np.array([600.0], np.float32)
    jdec = JBtsDecoder(max_depth=MAX_DEPTH, num_features=NF, fused_tail="always")

    class _Eval:  # init with train=False static
        init = staticmethod(lambda key, fs: jdec.init(key, fs, False))

    variables = _random_variables(_Eval, 8, [jnp.asarray(f) for f in feats])
    return feats, focal, variables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_fused_tail_matches_jax(dtype, decoder_case):
    """The port's decoder with fused_tail="always" against the JAX decoder
    with fused_tail="always" (interpret mode), same weights, with focal.

    float32: the three LPG maps to the fused head's rule (rtol 2e-5, atol
    2e-6); d1x1 and the final depth (over max_depth * focal scale) to the
    module's mean and max bounds.  The share of pixels off by 1e-4 is not
    held here: iconv2 differs by ~1e-6 relative before the tail rounds it to
    bf16 (measured: 1.3% of pixels, max 7.3e-4 on d1x1).
    bfloat16: the decoder's convs before the tail round to bf16 in XLA's and
    torch's own ways, which moves the maps by up to 0.6% of their scale and
    the outputs by a mean of 3.6e-4 (measured); held to atol 1e-2*max|ref|
    on the maps, and mean <= 1e-3, max <= 1e-2 on the outputs, inside
    tests/test_tail.py's rule for the literal path."""
    feats, focal, variables = decoder_case
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jdec = JBtsDecoder(max_depth=MAX_DEPTH, num_features=NF, dtype=jdt, fused_tail="always")
    # eager: a jit of the whole decoder with the interpret-mode tail costs ~45 s
    # of XLA compile per dtype on a cold cache, twice the eager run
    ref = jdec.apply(variables, [jnp.asarray(f) for f in feats], False, jnp.asarray(focal))
    dec = _port_decoder(variables, getattr(torch, dtype), "always")
    with torch.inference_mode():
        outs = dec([_nchw(f) for f in feats], torch.from_numpy(focal))
    scale = MAX_DEPTH * focal[0] / 715.0873
    for i, (name, port, r) in enumerate(zip(("d8", "d4", "d2", "d1x1", "final"), outs, ref)):
        port = port[:, 0].numpy()
        r = np.asarray(r, np.float32)[..., 0]
        assert port.shape == r.shape == (1, H, W), name
        if i < 3:
            if dtype == "float32":
                np.testing.assert_allclose(port, r, rtol=2e-5, atol=2e-6, err_msg=name)
            else:
                np.testing.assert_allclose(port, r, rtol=0, atol=1e-2 * np.abs(r).max(), err_msg=name)
        else:
            gap = _gap(port / (scale if name == "final" else 1.0), r / (scale if name == "final" else 1.0))
            mean_max, abs_max = (MEAN_MAX, ABS_MAX) if dtype == "float32" else (1e-3, 1e-2)
            assert gap["mean"] <= mean_max and gap["max"] <= abs_max, (dtype, name, gap)


def test_decoder_plain_tail_is_the_cpu_tail(decoder_case, monkeypatch):
    """On the CPU, use_pallas="never" and "auto" compute the same plain
    versions, and the fused path runs neither K1's plain version nor the
    literal tail modules."""
    feats, focal, variables = decoder_case
    calls = []
    monkeypatch.setattr(port_lpg, "lpg_fused", lambda *a: calls.append("K1") or None)
    outs = {}
    for setting in ("auto", "never"):
        dec = _port_decoder(variables, torch.float32, "always", setting)
        for mod in (dec.upconv1, dec.reduc1x1, dec.conv1, dec.get_depth):
            mod.register_forward_hook(lambda *a: calls.append("literal"))
        with torch.inference_mode():
            outs[setting] = dec([_nchw(f) for f in feats], torch.from_numpy(focal))
    assert calls == []
    for a, b in zip(outs["auto"], outs["never"]):
        assert torch.equal(a, b)


def test_decoder_train_mode_keeps_the_literal_tail(decoder_case):
    """fused_tail="always" in train mode runs the literal (differentiable)
    tail; an unsupported shape raises instead of falling back."""
    feats, _, variables = decoder_case
    dec = _port_decoder(variables, torch.float32, "always").train()
    fs = [_nchw(f) for f in feats]
    dec(fs)[-1].mean().backward()
    assert dec.conv1.weight.grad is not None and torch.isfinite(dec.conv1.weight.grad).all()
    narrow = BtsDecoder(CHANNELS, MAX_DEPTH, 128, fused_tail="always").eval()  # bts_size 128: cin 16
    with pytest.raises(ValueError, match="unsupported"), torch.inference_mode():
        narrow(fs)
