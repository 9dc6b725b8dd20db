"""The byte counts behind ``kernels.bn_act_roofline.serve`` (one K7 call
per BatchNorm of the reference's forward) against hand-worked values, and
the reader on synthetic traced windows: with the counted launches, with
another number of them, and without K7."""

import pytest

from portbench.counts import bn
from portbench.harness import manifest
from portbench.harness.trace import Trace

READ = "kernels.bn_act_roofline.serve"
K7 = "void (anonymous namespace)::bn_act_kernel<__nv_bfloat16, 8, true, 1>(args)"


def test_densenet161_serving_forward_is_175_calls_of_294_6_m_elements():
    calls = bn.calls("densenet161_bts", 512, 80.0, 1, 352, 1216)
    assert len(calls) == 175 and sum(e for e, _ in calls) == 294_579_648


def test_efficientnet_b5_serving_forward_is_130_calls():
    # 116 in the encoder (stem, 2 a depthwise-separable block, 3 an MBConv
    # block, head) and the decoder's 14
    calls = bn.calls("efficientnet_b5_bts", 512, 80.0, 2, 64, 96)
    assert len(calls) == 1 + 3 * 2 + 36 * 3 + 1 + 14 == 130
    assert calls[0] == (2 * 48 * 32 * 48, 48)  # the stem's, at H/2


def test_bytes_are_x_and_y_in_the_dtype_and_four_f32_vectors():
    assert bn.nbytes(1000, 10, "bfloat16") == 2 * 1000 * 2 + 16 * 10
    assert bn.nbytes(1000, 10, "float32") == 2 * 1000 * 4 + 16 * 10


def _rec(launches: int, seconds: float = 1e-3):
    ops = [(f"bts_tpu_torch::bn_act#{i}", float(i), i + 0.5, 10 + i) for i in range(launches)]
    device = [(K7, i + 0.1, i + 0.1 + seconds, 10 + i) for i in range(launches)]
    return {"trace": Trace((0.0, float(launches + 1)), device, ops), "trace_images": 4, "batch": 2,
            "height": 64, "width": 96, "device_name": "NVIDIA H100 80GB HBM3",
            "model": {"encoder": "efficientnet_b5_bts", "bts_size": 512, "max_depth": 80.0,
                      "compute_dtype": "bfloat16"}}


def test_reader_is_the_bound_over_k7s_time():
    calls = bn.calls("efficientnet_b5_bts", 512, 80.0, 2, 64, 96)
    rec = _rec(2 * len(calls))  # two forwards of batch 2
    bound = 2 * sum(bn.nbytes(e, c, "bfloat16") for e, c in calls) / 3.35e12
    assert manifest.reader(READ)(rec) == pytest.approx(100 * bound / (2 * len(calls) * 1e-3))


def test_reader_reads_nothing_where_the_launches_are_not_the_calls():
    assert manifest.reader(READ)(_rec(259)) is None
    assert manifest.reader(READ)(_rec(0)) is None
    assert manifest.reader(READ)({**_rec(260), "trace": None}) is None
