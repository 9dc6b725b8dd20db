"""The port's spans (``bts_tpu_torch/utils/profiling.py::span``) on the CPU:
where each ``bts.*`` range lies in the profiler's records of one serving
batch and one training step, that the named children of a top span hold
every ATen op called inside it, that no range is opened while no profiler
records, and that ``Trainer.run(profile_dir=...)`` writes them into its
trace.  A tiny mobilenetv2_bts model (bts_size 64) at 32x64, batch 2."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bts_tpu_torch.cli.bts_test import predict
from bts_tpu_torch.config import Config
from bts_tpu_torch.models.bts import create_model
from bts_tpu_torch.training.trainer import Trainer
from bts_tpu_torch.utils import profiling

H, W, B = 32, 64, 2
TOP = {"predict": "bts.predict", "train_step": "bts.train_step"}
CHILDREN = {
    "predict": {"bts.input", "bts.encoder", "bts.decoder"},
    "train_step": {"bts.input", "bts.encoder", "bts.decoder", "bts.loss", "bts.backward", "bts.optimizer"},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers torch's OpenMP
    pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mode):
    return Config(mode=mode, encoder="mobilenetv2_bts", bts_size=64, dataset="kitti", input_height=H,
                  input_width=W, batch_size=B, compute_dtype="float32", device="cpu", seed=0)


def _batch(h=H + 8, w=W + 16):
    """KITTI-like frames, larger than the training crop by default."""
    rng = np.random.default_rng(0)
    return {"image": rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8),
            "depth": rng.uniform(1.0, 80.0, (B, h, w)).astype(np.float32),
            "focal": np.array([721.5377, 707.0493], np.float32)}


def _trainer():
    cfg = _cfg("train")
    return Trainer(create_model(cfg, "cpu"), cfg, total_steps=20, device="cpu")


def _call(kind):
    """One batch of ``predict`` or one ``Trainer.train_step``, to be run."""
    if kind == "predict":
        cfg = _cfg("test")
        model = create_model(cfg, "cpu")
        return lambda: next(predict(cfg, model, [_batch(H, W)], "cpu"))
    trainer = _trainer()
    return lambda: trainer.train_step(_batch())


def _records(kind):
    """(name, start, end) of every CPU record of one call, in ns."""
    call = _call(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    cpu = torch.autograd.DeviceType.CPU
    return [(r.name(), r.start_ns(), r.start_ns() + r.duration_ns())
            for r in prof.profiler.kineto_results.events() if r.device_type() == cpu]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(records, name):
    return [r for r in records if r[0] == name]


@pytest.mark.parametrize("kind", ["predict", "train_step"])
def test_one_call_is_one_top_span_over_its_layers(kind):
    records = _records(kind)
    top = _named(records, TOP[kind])
    assert len(top) == 1
    spans = [r for r in records if r[0].startswith("bts.")]
    assert {r[0] for r in spans} == {TOP[kind], "bts.lpg"} | CHILDREN[kind]
    assert all(_inside(r, top[0]) for r in spans)
    decoder = _named(records, "bts.decoder")
    assert len(decoder) == 1
    # three LPG heads and the two strided guidances, each inside the decoder
    lpg = _named(records, "bts.lpg")
    assert len(lpg) == 5 and all(_inside(r, decoder[0]) for r in lpg)
    assert len(_named(records, "bts.encoder")) == 1
    if kind == "train_step":
        backward, optimizer = _named(records, "bts.backward"), _named(records, "bts.optimizer")
        assert len(backward) == 1 and len(optimizer) == 2  # zero_grad; norm, AdamW and schedule
        assert decoder[0][2] <= backward[0][1] <= optimizer[1][1]


@pytest.mark.parametrize("kind", ["predict", "train_step"])
def test_every_aten_op_of_a_top_span_lies_in_a_named_child(kind):
    """The coverage the benchmark's span metrics rely on, by op: what a top
    span holds outside its children would be counted nowhere."""
    records = _records(kind)
    (top,) = _named(records, TOP[kind])
    children = [r for r in records if r[0] in CHILDREN[kind]]
    ops = [r for r in records if r[0].startswith("aten::") and _inside(r, top)]
    assert len(ops) > 100
    stray = [r[0] for r in ops if not any(_inside(r, c) for c in children)]
    assert not stray, stray


def test_no_profiler_opens_no_range(monkeypatch):
    """Without a profiler ``span`` returns its shared no-op and never
    constructs a ``record_function``; under one it does, and not while a
    graph is being compiled or exported."""
    opened = []
    real = torch.profiler.record_function

    def counting(*args):
        opened.append(args[0])
        return real(*args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    predict_once, step_once = _call("predict"), _call("train_step")
    predict_once(), step_once()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        predict_once()
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        with profiling.span("bts.compiled"):
            pass
    assert opened[0] == "bts.predict" and "bts.lpg" in opened and "bts.compiled" not in opened


def test_trainer_profile_writes_the_spans_into_its_trace(tmp_path, capsys):
    """``Trainer.run(profile_dir=...)`` profiles steps 10..15 through
    ``profiling.window``; a run of 11 steps closes the window early and
    writes ``trace.json`` with step 10 and its layers."""
    trainer = _trainer()
    batch = _batch()
    assert trainer.run(iter([batch] * 11), num_steps=11, profile_dir=str(tmp_path)) == 11
    path = tmp_path / "trace.json"
    assert f"profile written to {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"bts.train_step", "bts.lpg"} | CHILDREN["train_step"] <= names
    assert [e["name"] for e in events if e.get("name") == "bts.train_step"] == ["bts.train_step"]
