"""The readers of K7 (the eval-mode BatchNorm kernel) on a synthetic traced
window, and on one without the kernel, as at a parent without it."""

import pytest

from portbench.harness import manifest
from portbench.harness.trace import Trace


def _rec(with_k7: bool):
    ops = [("aten::conv", 0.0, 1.0, 11), ("bts_tpu_torch::bn_act", 1.0, 2.0, 12),
           ("bts_tpu_torch::bn_act", 2.0, 3.0, 13)]
    device = [("cudnn_fprop", 0.5, 1.5, 11),
              ("void (anonymous namespace)::bn_act_kernel<__nv_bfloat16, 8, true>(args)", 1.5, 1.502, 12),
              ("void (anonymous namespace)::bn_act_kernel<__nv_bfloat16, 8, false>(args)", 2.5, 2.503, 13),
              ("void (anonymous namespace)::bn_act_kernel<__nv_bfloat16, 8, true>(args)", 0.1, 0.2, 99)]
    if not with_k7:
        device = device[:1]
    return {"kind": "serve", "trace": Trace((0.0, 4.0), device, ops), "trace_images": 2}


def test_k7_readers_count_its_linked_launches():
    rec = _rec(True)
    assert manifest.reader("kernels.bn_act_launches_per_image.serve")(rec) == 1.0  # 2 linked launches, 2 images
    assert manifest.reader("kernels.bn_act_device_ms.serve")(rec) == pytest.approx(2.5)  # 5 ms over 2 images


def test_k7_readers_read_nothing_without_the_kernel():
    for rec in (_rec(False), {"kind": "serve", "trace": None, "trace_images": 2}):
        assert manifest.reader("kernels.bn_act_launches_per_image.serve")(rec) is None
        assert manifest.reader("kernels.bn_act_device_ms.serve")(rec) is None
