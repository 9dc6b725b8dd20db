"""The program's spans read from a synthetic traced window: self time per
``bts.*`` span (``harness/spans.py``) and the metric files over it."""

from __future__ import annotations

import pytest

from portbench.harness import manifest, spans
from portbench.harness.trace import Trace

SERVE = ["driver.input_device_ms.serve", "model.encoder_device_ms.serve", "model.decoder_device_ms.serve",
         "kernels.lpg_heads_device_ms.serve", "model.encoder_launches_per_image.serve"]
TRAIN = [n.replace(".serve", ".train") for n in SERVE] + [
    "driver.loss_device_ms.train", "model.backward_device_ms.train", "driver.optimizer_device_ms.train"]


def _step() -> Trace:
    """One training step's records, in seconds: each span, and each op with
    the kernels it launched (durations mostly powers of two)."""
    ops = [
        ("bts.train_step", 0.0, 10.0, 1),
        ("bts.input", 0.1, 1.0, 2), ("aten::copy_", 0.2, 0.3, 3),
        ("bts.encoder", 1.0, 3.0, 4), ("aten::cudnn_convolution", 1.5, 1.6, 5),
        ("bts.decoder", 3.0, 5.0, 6), ("aten::add", 3.1, 3.2, 7),
        ("bts.lpg", 4.0, 4.5, 8), ("bts_tpu_torch::lpg_fused_fwd", 4.1, 4.2, 9),
        ("bts.loss", 5.0, 5.5, 10), ("aten::mean", 5.1, 5.2, 11),
        ("bts.backward", 6.0, 8.0, 12),
        # autograd's thread: no span of its own, inside bts.backward's interval
        ("aten::convolution_backward", 6.5, 7.0, 13),
        ("bts.optimizer", 8.0, 9.0, 14), ("aten::_foreach_add_", 8.1, 8.2, 15),
        ("aten::item", 9.5, 9.6, 16),  # in the step, in none of its children
        ("aten::copy_", 11.0, 11.5, 17),  # after the step: in no span
    ]
    device = [
        ("elementwise_kernel", 0.25, 0.5, 3),
        ("Memcpy HtoD (Pinned -> Device)", 0.2, 0.7, 3),  # a copy: not a kernel
        ("sm90_xmma_fprop", 1.6, 2.6, 5), ("sm90_xmma_fprop", 2.6, 3.1, 5),
        ("vectorized_elementwise_kernel", 3.2, 3.7, 7),
        ("void lpg_fwd_kernel<true, 8, 4, 4, __nv_bfloat16>(args)", 4.2, 4.45, 9),
        ("reduce_kernel", 5.2, 5.25, 11),
        ("sm90_xmma_dgrad", 7.0, 7.75, 13),
        ("multi_tensor_apply_kernel", 8.2, 8.325, 15),
        ("reduce_kernel", 9.6, 9.6625, 16),
        ("elementwise_kernel", 11.5, 11.75, 17),
        ("left_over_kernel", 0.0, 0.5, 99),  # an op of an earlier window
    ]
    return Trace((0.0, 12.0), device, ops)


def test_self_time_excludes_children_and_counts_each_kernel_once():
    got = spans.self_times(_step())
    want = {
        "bts.input": (0.25, 1),
        "bts.encoder": (1.5, 2),
        "bts.decoder": (0.5, 1),  # bts.lpg's kernel is the child's
        "bts.lpg": (0.25, 1),
        "bts.loss": (0.05, 1),
        "bts.backward": (0.75, 1),
        "bts.optimizer": (0.125, 1),
        "bts.train_step": (0.0625, 1),  # aten::item, in the step and in no child
    }
    assert {n: c for n, (_, c) in got.items()} == {n: c for n, (_, c) in want.items()}
    assert {n: t for n, (t, _) in got.items()} == pytest.approx({n: t for n, (t, _) in want.items()})


def test_an_op_of_another_thread_counts_in_the_span_whose_interval_holds_it():
    tr = _step()
    # the backward's op started on autograd's thread after the calling
    # thread opened bts.backward: only the interval says where it belongs
    tr.ops = [o for o in tr.ops if o[0] != "aten::convolution_backward"] + [
        ("aten::convolution_backward", 7.9, 8.0, 13)]
    assert spans.self_times(tr)["bts.backward"] == (0.75, 1)


def test_a_kernel_whose_op_lies_in_no_span_counts_nowhere():
    tr = _step()
    kernels = sum(e - s for _, s, e in tr.kernels())
    counted = sum(t for t, _ in spans.self_times(tr).values())
    assert kernels - counted == pytest.approx(0.25)  # the copy_ after the step


def read(name, rec):
    return manifest.reader(name)(rec)


def test_metric_files_read_self_time_per_image():
    rec = {"trace": _step(), "trace_images": 2}
    want = {"driver.input_device_ms": 125.0, "model.encoder_device_ms": 750.0,
            "model.decoder_device_ms": 250.0, "kernels.lpg_heads_device_ms": 125.0,
            "model.encoder_launches_per_image": 1.0}
    for name, value in want.items():
        assert read(f"{name}.serve", rec) == pytest.approx(value)
        assert read(f"{name}.train", rec) == pytest.approx(value)
    assert read("driver.loss_device_ms.train", rec) == pytest.approx(25.0)
    assert read("model.backward_device_ms.train", rec) == pytest.approx(375.0)
    assert read("driver.optimizer_device_ms.train", rec) == pytest.approx(62.5)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_trace_without_spans_reads_none(name):
    """A program that opens no span (as before spans existed): its traced
    run prints nothing for these metrics rather than 0."""
    tr = _step()
    tr.ops = [o for o in tr.ops if not o[0].startswith(spans.PREFIX)]
    assert spans.self_times(tr) == {}
    assert read(name, {"trace": tr, "trace_images": 2}) is None
    assert read(name, {"trace": None, "trace_images": 2}) is None


def test_every_span_metric_is_declared_for_its_cells():
    bench = manifest.Manifest()
    declared = {m["name"]: m for m in bench.data["per_layer"]}
    for name in SERVE + TRAIN:
        m = declared[name]
        kind = name.rsplit(".", 1)[1]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        assert m["moves"] == f"{kind}_images_per_s"
        assert m["workloads"] and all(m["moves"] in {e["name"] for e in bench.end_to_end(w)}
                                      for w in m["workloads"])
