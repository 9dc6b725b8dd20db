"""The fused decoder tail on Hopper: the phase-plane LPG maps (K5) and the
whole full-resolution tail in one kernel (K6), their wrappers and plain
PyTorch versions.  Counterpart of ``bts_tpu/ops/tail_pallas.py``, with its
layouts: iconv2 (B, Hh, W2, 64), phase planes (B, 4, Hh, W2) f32, plane
q = 2*py + pz holding full-resolution pixel (2u+py, 2v+pz).

- :data:`lpg_phase_planes` (K5, ``csrc/lpg_fused.cu``) and
  :func:`lpg_phase_planes_plain`: the fused LPG head's map as phase planes;
  ``interleave2x2`` of them is the head's map bit for bit.
- :func:`fused_tail` (K6, ``csrc/fused_tail.cu``) and
  :func:`fused_tail_plain`: upconv1 + ELU, the reduction_1x1 chain + sigmoid,
  the 36-channel concat, iconv1 + ELU and the final conv + sigmoid, in the
  bf16 rounding schedule of the TPU kernel (see ``fused_tail.cu``).
- :func:`tail_params` reads K6's weights from a port decoder's modules, in
  the JAX package's parameter layout (HWIO kernels);
  :func:`pack_tail_params` lays them out as K6 reads them (bf16 mma.sync B
  fragments and f32 small parameters) and :func:`packed_tail_params` caches
  that buffer per weight version.
- K5 and K6 are ``torch.library`` ops, ``bts_tpu_torch::lpg_phase_planes``
  and ``bts_tpu_torch::fused_tail``, so ``torch.export`` captures them: a
  CUDA implementation (the kernel launch), a CPU one (the plain version)
  and a fake one (the outputs' shapes).  A CUDA tensor launches the kernel
  or raises.  Each launch adds one to ``lpg_phase_planes.launches`` or
  ``fused_tail.launches``.

Inference only, as in the JAX package: no backward.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict

import torch
import torch.nn.functional as F

from bts_tpu_torch.ops import _build, lpg_cuda
from bts_tpu_torch.ops.lpg_cuda import _check_raw, _stream, lpg_fused_plain

CIN = 64  # iconv2 channels: bts_size 512
PARAM_BYTES = 92688  # bytes of pack_tail_params' buffer (fused_tail.cu's PARAM_BYTES)
FRAG_BYTES = 65536 + 23040  # its bf16 mma.sync B fragments: the upconv's, then iconv1's


def tail_supported(iconv2_shape) -> bool:
    """The shapes the fused tail takes (a copy of the JAX package's check):
    (B, Hh, W2, 64) with Hh a multiple of 8, W2 >= 32 and a multiple of 8."""
    b, hh, w2, cin = iconv2_shape
    return cin == CIN and hh % 8 == 0 and w2 >= 32 and w2 % 8 == 0


def interleave2x2(ph: torch.Tensor) -> torch.Tensor:
    """(B, 4, Hh, Wh) phase planes -> (B, 2Hh, 2Wh) full resolution."""
    b, q, hh, wh = ph.shape
    assert q == 4
    return ph.reshape(b, 2, 2, hh, wh).permute(0, 3, 1, 4, 2).reshape(b, 2 * hh, 2 * wh)


def _split2x2(full: torch.Tensor) -> torch.Tensor:
    """(B, 2Hh, 2Wh) -> (B, 4, Hh, Wh) phase planes; undoes interleave2x2."""
    b, h, w = full.shape
    return full.reshape(b, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3).reshape(b, 4, h // 2, w // 2)


def lpg_phase_planes_plain(raw3: torch.Tensor, k: int) -> torch.Tensor:
    """Plain K5: raw (B, h, w, 3) -> (B, 4, h*k/2, w*k/2) f32, the phase
    planes of :func:`~bts_tpu_torch.ops.lpg_cuda.lpg_fused_plain`."""
    return _split2x2(lpg_fused_plain(raw3, k))


def _k5_cuda(raw3: torch.Tensor, k: int) -> torch.Tensor:
    """K5 on a CUDA tensor, on the current stream; adds one to
    ``lpg_phase_planes.launches``.  The CUDA implementation of
    :data:`lpg_phase_planes`.  K5 reads raw in its own dtype (f32 or bf16:
    a bf16 decoder launches no cast) through its strides; each lane
    transforms one cell and stores its k/2 phase columns in all four planes,
    each warp on one phase row."""
    _check_raw(raw3, k, "lpg_phase_planes")
    b, h, w, _ = raw3.shape
    kk = k // 2
    out, launched = lpg_cuda._forward("lpg_phase_forward", raw3, k, "lpg_phase_planes", (b, 4, h * kk, w * kk))
    lpg_phase_planes.launches += launched
    return out


# raw (B, h, w, 3), any float dtype and strides -> (B, 4, h*k/2, w*k/2) f32
# phase planes of the fused LPG head's map.  A CPU tensor takes
# lpg_phase_planes_plain; a CUDA tensor launches K5 on the current stream
# (_k5_cuda).
lpg_phase_planes = torch.library.custom_op("bts_tpu_torch::lpg_phase_planes", _k5_cuda, mutates_args=(),
                                           device_types="cuda")
lpg_phase_planes.register_kernel("cpu")(lpg_phase_planes_plain)


@lpg_phase_planes.register_fake
def _(raw3, k):
    b, h, w, _ = raw3.shape
    return raw3.new_empty((b, 4, h * (k // 2), w * (k // 2)), dtype=torch.float32)


def tail_params(decoder) -> dict:
    """K6's weights from a port ``BtsDecoder``, as the JAX branch reads them
    from the literal modules (upconv1, reduc1x1's three convs, conv1,
    get_depth): ``{"up"|"r1"|"r2"|"r3"|"i1"|"f": {"kernel": HWIO f32, "bias"}}``,
    views of the f32 parameters (no copy), which :func:`packed_tail_params`
    keys its cache on."""

    def conv(m):
        return {"kernel": m.weight.detach().float().permute(2, 3, 1, 0), "bias": m.bias.detach().float()}

    r = decoder.reduc1x1
    return {"up": conv(decoder.upconv1.conv), "r1": conv(r.conv0), "r2": conv(r.conv1),
            "r3": conv(r.conv2), "i1": conv(decoder.conv1), "f": conv(decoder.get_depth)}


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32 (exact)."""
    return t.to(torch.bfloat16).float()


def _elu(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's ELU: where(x > 0, x, exp(x) - 1) in f32 (not expm1)."""
    return torch.where(x > 0, x, torch.exp(x) - 1.0)


def _folded_upconv(kernel: torch.Tensor) -> torch.Tensor:
    """The 3x3 upconv kernel (3, 3, 64, 32) folded over the nearest-2x
    upsample: K4 = K (*) ones(2, 2), (4, 4, 64, 32), summed in f32 in the JAX
    package's order and rounded to bf16 once."""
    k = kernel.float()
    k4 = torch.zeros((4, 4) + tuple(k.shape[2:]), dtype=torch.float32, device=k.device)
    for u in (0, 1):
        for v in (0, 1):
            k4[u:u + 3, v:v + 3] += k
    return _bf(k4)


def _phase_taps(k4: torch.Tensor, py: int, pz: int) -> torch.Tensor:
    """The 2x2 taps of phase (py, pz): [dy][dx] = K4[py + 2dy, pz + 2dx]."""
    return k4[py::2, pz::2]


def fused_tail_plain(iconv2, d2ph, d4ph, d8ph, params):
    """Plain K6: iconv2 (B, Hh, W2, 64), d{2,4,8}ph (B, 4, Hh, W2) f32 ->
    (final_sig_ph, d1x1_ph), each (B, 4, Hh, W2) f32.

    The TPU kernel's rounding schedule, computed at full resolution: every
    conv takes bf16 values and sums in f32 (f32 convs on bf16-rounded
    tensors), the upconv per phase with the folded kernel.  On a card the f32
    convs must not use TF32 (``models/bts.py::set_float32_precision``)."""
    b, hh, w2, _ = iconv2.shape
    x = F.pad(_bf(iconv2).permute(0, 3, 1, 2), (1, 1, 1, 1))  # (B, 64, Hh+2, W2+2)
    k4 = _folded_upconv(params["up"]["kernel"])
    bup = _bf(params["up"]["bias"])
    phases = []
    for py in (0, 1):
        for pz in (0, 1):
            w = _phase_taps(k4, py, pz).permute(3, 2, 0, 1)  # OIHW
            y = F.conv2d(x[:, :, py:py + hh + 1, pz:pz + w2 + 1], w) + bup[:, None, None]
            phases.append(_elu(y))
    c = phases[0].shape[1]
    up = torch.stack(phases, 1).reshape(b, 2, 2, c, hh, w2).permute(0, 3, 4, 1, 5, 2)
    up = _bf(up.reshape(b, c, 2 * hh, 2 * w2))  # read only as bf16

    def dense(t, name):  # 1x1 conv of bf16 values, f32 sums, bf16 bias
        k = _bf(params[name]["kernel"]).reshape(t.shape[1], -1)
        return torch.einsum("bchw,co->bohw", t, k) + _bf(params[name]["bias"])[:, None, None]

    r = _bf(_elu(dense(up, "r1")))
    r = _bf(_elu(dense(r, "r2")))
    k3 = _bf(params["r3"]["kernel"]).reshape(-1)
    d1x1 = torch.sigmoid((r * k3[:, None, None]).sum(1) + params["r3"]["bias"].float().reshape(()))

    maps = [d1x1] + [interleave2x2(m.float()) for m in (d2ph, d4ph, d8ph)]
    cat = torch.cat([up] + [_bf(m)[:, None] for m in maps], dim=1)  # (B, 36, H, W)
    i1 = F.conv2d(cat, _bf(params["i1"]["kernel"]).permute(3, 2, 0, 1), padding=1)
    i1 = _bf(_elu(i1 + _bf(params["i1"]["bias"])[:, None, None]))
    logits = F.conv2d(i1, _bf(params["f"]["kernel"]).permute(3, 2, 0, 1), padding=1)[:, 0]
    final = torch.sigmoid(logits + params["f"]["bias"].float().reshape(()))
    return _split2x2(final), _split2x2(d1x1)


def _frag_k16(bmat: torch.Tensor) -> torch.Tensor:
    """B (K, 32), K a multiple of 16, as the mma.sync m16n8k16 B fragments
    are read: [k-step][tile pair h][lane][8], the 8 values being b0, b1 of
    n8 tile 2h then of tile 2h+1 (b0: k = 2t, 2t+1; b1: k = 2t+8, 2t+9;
    n = 8*tile + g; lane = 4g + t)."""
    b = bmat.reshape(-1, 2, 4, 2, 2, 2, 8)  # (k-step, b0|b1, t, e, h, tile in pair, g)
    return b.permute(0, 4, 6, 2, 5, 1, 3).reshape(-1, 2, 32, 8)


def _frag_k8(bmat: torch.Tensor) -> torch.Tensor:
    """B (8, 32) as the m16n8k8 b0 fragments of n8 tiles 0..3: [lane][tile][2]."""
    return bmat.reshape(4, 2, 4, 8).permute(3, 0, 2, 1).reshape(32, 8)


def pack_tail_params(params) -> torch.Tensor:
    """K6's parameter buffer (uint8, PARAM_BYTES) in fused_tail.cu's order:
    bf16 B fragments of the folded upconv per phase (B[tap*64 + c][n] over
    taps [dy][dx]) and of iconv1 per tap (channels 0..31 in two k16 steps,
    then channels 32..35 and four zero rows in one k8 step), then f32: r1
    [32][16], bias, r2 [16][8], bias, r3 [8], bias, final [3][3][32], bias
    (the kernel takes these 962 floats by value too), the upconv bias,
    the iconv1 bias, two zeros.  Kernels and the upconv / r1 / r2 / iconv1
    biases are bf16 values; the r3 and final biases stay f32, as in the TPU
    kernel."""
    k4 = _folded_upconv(params["up"]["kernel"])
    up = [_frag_k16(_phase_taps(k4, py, pz).reshape(4 * CIN, 32)) for py in (0, 1) for pz in (0, 1)]
    i1 = _bf(params["i1"]["kernel"]).reshape(9, 36, 32)
    maps = F.pad(i1[:, 32:], (0, 0, 0, 4))  # (9, 8, 32): d1, d2, d4, d8, four zero rows
    taps = [torch.cat([_frag_k16(i1[t, :32]).reshape(-1), _frag_k8(maps[t]).reshape(-1)]) for t in range(9)]
    frags = torch.cat([f.reshape(-1) for f in up] + taps).to(torch.bfloat16)
    p = params
    small = [_bf(p["r1"]["kernel"]), _bf(p["r1"]["bias"]), _bf(p["r2"]["kernel"]), _bf(p["r2"]["bias"]),
             _bf(p["r3"]["kernel"]), p["r3"]["bias"].float(), _bf(p["f"]["kernel"]), p["f"]["bias"].float(),
             _bf(p["up"]["bias"]), _bf(p["i1"]["bias"]), k4.new_zeros(2)]
    small = torch.cat([t.reshape(-1) for t in small])
    buf = torch.cat([frags.view(torch.uint8), small.view(torch.uint8)])
    assert buf.numel() == PARAM_BYTES, buf.numel()
    return buf


def host_floats(buf: torch.Tensor) -> torch.Tensor:
    """The f32 part of a :func:`pack_tail_params` buffer, on the host (the
    kernel launch passes its first 962 floats by value)."""
    return buf[FRAG_BYTES:].view(torch.float32).cpu()


_TAIL_LAYERS = ("up", "r1", "r2", "r3", "i1", "f")
_PACKED: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> ((buffer, host floats), the sources)
_PACKED_MAX = 4


def packed_tail_params(params, device) -> tuple:
    """(:func:`pack_tail_params` on ``device``, its :func:`host_floats`),
    cached: the same pair while each source tensor keeps its ``(data_ptr,
    _version, device)`` (and dtype, shape, strides), so the weights are
    packed once per model and again after ``load_state_dict`` or an in-place
    update.  An entry keeps its source tensors alive, so no other tensor can
    take their addresses; the last four entries are kept.  Inference tensors
    have no version counter and are packed on every call."""
    device = torch.device(device)
    tensors = [params[n][k] for n in _TAIL_LAYERS for k in ("kernel", "bias")]
    if any(t.is_inference() for t in tensors):
        buf = pack_tail_params(params).to(device)
        return buf, host_floats(buf)
    key = (device,) + tuple((t.data_ptr(), t._version, t.device, t.dtype, tuple(t.shape), t.stride())
                            for t in tensors)
    hit = _PACKED.get(key)
    if hit is not None:
        _PACKED.move_to_end(key)
        return hit[0]
    buf = pack_tail_params(params).to(device)
    packed = (buf, host_floats(buf))
    _PACKED[key] = (packed, tensors)
    while len(_PACKED) > _PACKED_MAX:
        _PACKED.popitem(last=False)
    return packed


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built ``fused_tail.cu``'s C interface."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fused_tail_forward.argtypes = [vp, i32, i64, i64, i64, i64, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, vp]
    lib.fused_tail_forward.restype = i32
    lib.fused_tail_param_bytes.restype = i32
    lib.fused_tail_error_string.argtypes = [i32]
    lib.fused_tail_error_string.restype = ctypes.c_char_p
    if lib.fused_tail_param_bytes() != PARAM_BYTES:
        raise RuntimeError(f"fused_tail.cu takes {lib.fused_tail_param_bytes()} parameter bytes, not {PARAM_BYTES}")
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("fused_tail"))


def _flat_params(params) -> list:
    """:func:`tail_params`' dict as the op takes it: kernel, bias of each layer
    in ``_TAIL_LAYERS`` order."""
    return [params[n][key] for n in _TAIL_LAYERS for key in ("kernel", "bias")]


def _params_dict(weights) -> dict:
    """The inverse of :func:`_flat_params`."""
    return {n: {"kernel": weights[2 * i], "bias": weights[2 * i + 1]} for i, n in enumerate(_TAIL_LAYERS)}


def _k6_cuda(iconv2: torch.Tensor, d2ph: torch.Tensor, d4ph: torch.Tensor, d8ph: torch.Tensor,
             weights: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 on CUDA tensors, on the current stream; adds one to
    ``fused_tail.launches``.  ``weights``: the twelve tensors of
    :func:`_flat_params`, packed here at run time (cached per weight
    version by :func:`packed_tail_params`).  The CUDA implementation of the
    op ``_k6``."""
    b, hh, w2, cin = iconv2.shape
    if iconv2.device.type != "cuda" or cin != CIN:
        raise ValueError(f"fused_tail: iconv2 must be (B, Hh, W2, {CIN}) on a card, got "
                         f"{tuple(iconv2.shape)} on {iconv2.device}")
    for m in (d2ph, d4ph, d8ph):
        if m.device != iconv2.device or tuple(m.shape) != (b, 4, hh, w2):
            raise ValueError(f"fused_tail: maps must be {(b, 4, hh, w2)} on {iconv2.device}, "
                             f"got {tuple(m.shape)} on {m.device}")
    if (hh + 7) // 8 > 65535 or b > 65535:
        raise ValueError(f"fused_tail: grid too large for (B={b}, Hh={hh})")
    x = iconv2 if iconv2.dtype in (torch.bfloat16, torch.float32) else iconv2.float()
    maps = [m.float().contiguous() for m in (d2ph, d4ph, d8ph)]
    prm, small = packed_tail_params(_params_dict(weights), iconv2.device)
    fin = torch.empty((b, 4, hh, w2), dtype=torch.float32, device=x.device)
    d1 = torch.empty_like(fin)
    if fin.numel() == 0:
        return fin, d1
    with torch.cuda.device(x.device):
        err = _lib().fused_tail_forward(
            x.data_ptr(), int(x.dtype == torch.float32), *x.stride(), *(m.data_ptr() for m in maps),
            prm.data_ptr(), small.data_ptr(), fin.data_ptr(), d1.data_ptr(), b, hh, w2, _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"fused_tail kernel launch failed: {_lib().fused_tail_error_string(err).decode()}")
    fused_tail.launches += 1
    return fin, d1


_k6 = torch.library.custom_op("bts_tpu_torch::fused_tail", _k6_cuda, mutates_args=(),
                              device_types="cuda")


@_k6.register_kernel("cpu")
def _(iconv2, d2ph, d4ph, d8ph, weights):
    return fused_tail_plain(iconv2, d2ph, d4ph, d8ph, _params_dict(weights))


@_k6.register_fake
def _(iconv2, d2ph, d4ph, d8ph, weights):
    b, hh, w2, _ = iconv2.shape
    fin = iconv2.new_empty((b, 4, hh, w2), dtype=torch.float32)
    return fin, torch.empty_like(fin)


def fused_tail(iconv2, d2ph, d4ph, d8ph, params):
    """The fused tail: iconv2 (B, Hh, W2, 64) in any float dtype and layout,
    d{2,4,8}ph (B, 4, Hh, W2) f32 phase planes (from
    :func:`lpg_phase_planes`), ``params`` as :func:`tail_params` gives them
    -> (final_sig_ph, d1x1_ph), each (B, 4, Hh, W2) f32: phase planes of
    sigmoid(final logits) and of the depth_1x1 head.

    The registered op ``bts_tpu_torch::fused_tail``, which takes the twelve
    weight tensors as inputs.  A CPU tensor takes :func:`fused_tail_plain`.
    A CUDA tensor launches K6 on the current stream and adds one to
    ``fused_tail.launches``.  K6 reads iconv2 through its strides (the
    decoder's NCHW activation arrives as a permuted view), bf16 or f32
    (another float dtype is cast to f32 first), and rounds it to bf16 as it
    stages it, so nothing is copied; the packed weights come from
    :func:`packed_tail_params`' cache."""
    return _k6(iconv2, d2ph, d4ph, d8ph, _flat_params(params))


# launches since the last reset, read by chip_smoke.py
lpg_phase_planes.launches = 0  # K5
fused_tail.launches = 0  # K6
