"""Device ms of the fused UpConv's stride-2 transposed conv by lowering and
cuDNN algorithm choice, within one run on one CUDA card, at the five
UpConvs of DenseNet-161 BTS (bts_size 512): the b1 352x1216 serving shapes
and the b16 352x704 config-4 shapes, f32 and bf16.

    python -m bts_tpu_torch.tools.upconv_algos   # from the repo root

Forms, each on the same input, folded kernel and cotangent (the fold itself
is not timed):

- ``transposed``: ``F.conv_transpose2d``, cuDNN's default algorithms;
- ``transposed_det``: the same with ``torch.backends.cudnn.deterministic``
  set, forward and backward;
- ``transposed_det_bench``: deterministic, ``cudnn.benchmark`` set too;
- ``phase``: the port's f32 path (``models/layers.py::
  _DeterministicUpConvT``): one 2x2 conv with a block of channels per
  output phase, then an interleave; the transposed conv's backward;
- ``literal``: the nearest-2x upsample, then the 3x3 conv.

For each: the median device ms of the forward and of the backward alone
(CUDA events, 5 batches of 5 calls after one warm-up), how far a second
forward and a second backward on the same input land from the first, and
max|y - literal| / max|literal|.  Output: one JSON line per shape and dtype,
then the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from bts_tpu_torch.models.layers import _DeterministicUpConvT
from bts_tpu_torch.ops.resize import fold_up2x_kernel, upsample_nearest_2x

CHANNELS = [(2208, 512), (512, 256), (128, 128), (128, 64), (64, 32)]  # upconv5 .. upconv1, (cin, cout)
SHAPES = {"serving b1": (1, 352, 1216), "config 4 b16": (16, 352, 704)}
FORMS = ("transposed", "transposed_det", "transposed_det_bench", "phase", "literal")
BATCHES, CALLS = 5, 5


def _forward(form: str, x, k, w4, bias):
    if form == "literal":
        return F.conv2d(upsample_nearest_2x(x), k, bias, padding=1)
    if form == "phase":
        return _DeterministicUpConvT.apply(x, w4, bias)
    return F.conv_transpose2d(x, w4, bias, stride=2, padding=1)


def _device_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(BATCHES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def measure(b: int, h: int, w: int, cin: int, cout: int, dtype, gen) -> dict:
    """Every form at one UpConv shape (input (b, cin, h, w))."""
    cudnn = torch.backends.cudnn
    x = torch.randn(b, cin, h, w, device="cuda", generator=gen).to(dtype).requires_grad_()
    k32 = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) / (3 * cin ** 0.5)
    k = k32.to(dtype).requires_grad_()
    w4 = fold_up2x_kernel(k32).to(dtype).transpose(0, 1).flip(-2, -1).detach().requires_grad_()
    bias = (0.05 * torch.randn(cout, device="cuda", generator=gen)).to(dtype).requires_grad_()
    with torch.no_grad():
        ref = _forward("literal", x, k, w4, bias).float()
    cot = torch.randn(ref.shape, device="cuda", generator=gen).to(dtype)
    row = {}
    for form in FORMS:
        prev = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = form.startswith("transposed_det"), form.endswith("bench")
        try:
            inputs = (x, k if form == "literal" else w4, bias)
            with torch.no_grad():
                y1 = _forward(form, x, k, w4, bias)
                y2 = _forward(form, x, k, w4, bias)
                fwd_ms = _device_ms(lambda: _forward(form, x, k, w4, bias))
            y = _forward(form, x, k, w4, bias)
            grads = [torch.autograd.grad(y, inputs, cot, retain_graph=True) for _ in range(2)]
            bwd_ms = _device_ms(lambda: torch.autograd.grad(y, inputs, cot, retain_graph=True))
        finally:
            cudnn.deterministic, cudnn.benchmark = prev
        row[form] = {
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "fwd_repeat_max_abs_diff": (y1 - y2).abs().max().item(),
            "grad_repeat_max_abs_diff": max((a - c).abs().max().item() for a, c in zip(*grads)),
            "gap_to_literal": ((y1.float() - ref).abs().max() / ref.abs().max()).item(),
        }
        del y, y1, y2, grads
    return row


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("upconv_algos needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False  # f32 as the port runs it (models/bts.py::set_float32_precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, h, w) in SHAPES.items():
        for dt in ("float32", "bfloat16"):
            for i, (cin, cout) in enumerate(CHANNELS):
                shape = (b, cin, h >> (5 - i), w >> (5 - i))
                row = measure(*shape[:1], *shape[2:], cin, cout, getattr(torch, dt), gen)
                print(json.dumps({"shapes": name, "upconv": 5 - i, "compute_dtype": dt, "input": list(shape),
                                  "output_channels": cout, **row}), flush=True)
                torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
