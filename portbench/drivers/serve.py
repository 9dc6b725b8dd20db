"""The serving driver: clients in a closed loop through the port's
``predict`` (``bts_tpu_torch.cli.bts_test``), each batch sent when the
previous batch's depth maps have reached the host.

A frame's latency runs from the moment its batch is handed to ``predict``
until its final depth map is a host array; at batch B a frame's latency is
its batch's.  ``enqueue`` is the part until ``predict`` returns the
outputs, before the copy waits for the card: the host's dispatch.

The check: a sample of the frames served in the window, drawn from the
seed (reservoir sampling over the served sequence), is run again through
the plain reference in float32 (TF32 off) after the program has been
freed, and each served depth map is compared with the reference's.

Faults (``portbench/faults.py``) swap :func:`serve`: ``stale_answer``,
each batch comes back with the previous batch's depth maps, the window's
first with the warm-up's last (an answer altered where it is produced); ``half_batch`` (batches of 2 or more), the
second half of each batch gets the first half's depth maps.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from bts_tpu_torch.cli.bts_test import predict
from portbench.harness import inputs, program, trace, weights
from portbench.reference import augment as ref_augment
from portbench.reference import model as ref_model
from portbench.reference.quant import fp8

LOGIT_EPS = 1e-6  # depth maps are clamped into (top * eps, top * (1 - eps)) before the logit


def rel_rms(served: torch.Tensor, ref: torch.Tensor) -> float:
    """rms(served - ref) / rms(ref) over a depth map."""
    ref = ref.double()
    return float((served.double() - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def logits(depth: torch.Tensor, top: float) -> torch.Tensor:
    """The final conv's output behind a depth map ``top * sigmoid(x)``."""
    d = depth.double().clamp(top * LOGIT_EPS, top * (1 - LOGIT_EPS))
    return torch.log(d) - torch.log(top - d)


def serve(cfg, model, batches, device):
    """The system under test: the port's serving forward over ``batches``."""
    return predict(cfg, model, batches, device)


class Driver:
    kind = "serve"

    def __init__(self, model_cfg: dict, traffic: dict, seeds: dict, device):
        self.m, self.t, self.seeds, self.device = model_cfg, traffic, seeds, torch.device(device)
        self.cfg = program.config(model_cfg["model"], {}, seeds["program"], device, "test")
        self.sample: list = []  # (batch index, row, served depth (H, W) on the host)
        self.rng = random.Random(seeds["sample"])
        self.served = 0

    def setup(self) -> None:
        self.model = program.build_model(self.cfg, self.state(), self.device)
        self.pool = inputs.serve_pool(self.t, self.m["model"]["focal"], self.seeds["inputs"], self.device)
        self.next = 0
        self._loop(batches=self.t["warmup_batches"], keep=False)

    def state(self) -> dict:
        return weights.model_state(self.m["model"], self.seeds["weights"], self.device)

    def _loop(self, seconds: float = None, batches: int = None, keep: bool = True) -> dict:
        handed = [0.0]

        def feed():
            while True:
                self.current = self.next % len(self.pool)
                self.next += 1
                handed[0] = time.perf_counter()
                yield self.pool[self.current]

        lat, enq, images = [], [], 0
        gen = serve(self.cfg, self.model, feed(), self.device)
        t0 = time.perf_counter()
        try:
            while True:
                outs = next(gen)
                t_ret = time.perf_counter()
                depth = outs[4][:, 0].cpu()
                t_done = time.perf_counter()
                b = depth.shape[0]
                lat += [t_done - handed[0]] * b
                enq.append(t_ret - handed[0])
                images += b
                if keep:
                    self._offer(self.current, depth)
                if (seconds is not None and t_done - t0 >= seconds) or (batches is not None and len(enq) >= batches):
                    break
        finally:
            gen.close()
        return {"images": images, "window_s": time.perf_counter() - t0, "latencies_s": lat, "enqueue_s": enq}

    def _offer(self, index: int, depth: torch.Tensor) -> None:
        """Reservoir sampling of ``check_frames`` served frames."""
        for row in range(depth.shape[0]):
            self.served += 1
            if len(self.sample) < self.t["check_frames"]:
                self.sample.append((index, row, depth[row].clone()))
            else:
                j = self.rng.randrange(self.served)
                if j < self.t["check_frames"]:
                    self.sample[j] = (index, row, depth[row].clone())

    def window(self, seconds: float) -> dict:
        return self._loop(seconds=seconds)

    def traced(self) -> dict:
        return trace.traced(self.device, lambda: self._loop(batches=self.t["trace_batches"], keep=False))

    def heads(self):
        """(batch, height, width) of one forward, for the counts."""
        return self.t["batch"], self.t["frame_height"], self.t["frame_width"]

    def free(self) -> None:
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None) -> list:
        """The reference's final depth (H, W) for each sampled frame."""
        m = self.m["model"]
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        state = self.state()
        out = []
        with torch.no_grad():
            for index, row, _ in self.sample:
                batch = self.pool[index]
                image = ref_augment.eval_preprocess(batch["image"][row:row + 1].to(self.device))
                focal = batch["focal"][row:row + 1].to(self.device) if m["dataset"] == "kitti" else None
                outs = ref_model.forward(state, image.permute(0, 3, 1, 2), focal, encoder=m["encoder"],
                                         bts_size=m["bts_size"], max_depth=m["max_depth"], quant=quant)
                out.append(outs[4][0, 0].cpu())
        return out

    def top(self, index: int, row: int) -> float:
        """The largest depth the frame can get: max_depth, scaled by its
        focal length for KITTI."""
        m = self.m["model"]
        focal = float(self.pool[index]["focal"][row])
        scale = focal / ref_model.KITTI_FOCAL if m["dataset"] == "kitti" and focal > 0 else 1.0
        return m["max_depth"] * scale

    def check(self) -> dict:
        """The compared number, ``logit_rel_rms``: the worst served frame's
        rms(l - l_ref) / rms(l_ref) of the logits behind the two depth maps
        (the model's last conv, before its sigmoid).  The depth maps' own gap
        (``depth_rel_rms``, printed) shrinks wherever the sigmoid saturates,
        by a factor that changes with the seed's weights, for the program
        and the control alike; the logits' does not."""
        refs = self.reference()
        depth, logit = [], []
        for (index, row, served), ref in zip(self.sample, refs):
            top = self.top(index, row)
            depth.append(rel_rms(served, ref))
            logit.append(rel_rms(logits(served, top), logits(ref, top)))
        return {"logit_rel_rms": max(logit), "depth_rel_rms": max(depth), "frames_compared": len(depth)}


def _broken(kind: str):
    def make(real):
        last = [None]  # across calls: the window's first batch gets the warm-up's last answer

        def broken(cfg, model, batches, device):
            for outs in real(cfg, model, batches, device):
                final = outs[4]
                if kind == "stale_answer":
                    final, last[0] = (final if last[0] is None else last[0]), final
                else:
                    half = final.shape[0] // 2
                    final = final.clone()
                    final[half:2 * half] = final[:half]
                yield (*outs[:4], final)

        return broken

    return make


def faults(traffic: dict) -> dict:
    out = {"stale_answer": ("serve", _broken("stale_answer"))}
    if traffic["batch"] > 1:  # no half of one frame
        out["half_batch"] = ("serve", _broken("half_batch"))
    return out


READ_FAULTS = ()


def shrink(traffic: dict) -> dict:
    """The traffic at a size the CPU runs in seconds (the tests'), batch kept."""
    return {**traffic, "frame_height": 64, "frame_width": 192, "pool_frames": 2 * traffic["batch"],
            "warmup_batches": 1, "trace_batches": 1, "check_frames": 2 * traffic["batch"]}


def control(drv: Driver) -> dict:
    """The first ``check_frames`` frames of the pool through the reference
    in fp8 and in float32, compared as :meth:`Driver.check` compares."""
    drv.pool = inputs.serve_pool(drv.t, drv.m["model"]["focal"], drv.seeds["inputs"], drv.device)
    rows = [(i, r) for i in range(len(drv.pool)) for r in range(drv.t["batch"])]
    drv.sample = [(i, r, None) for i, r in rows[:drv.t["check_frames"]]]
    ref, ctl = drv.reference(), drv.reference(fp8)
    tops = [drv.top(i, r) for i, r, _ in drv.sample]
    return {"logit_rel_rms": max(rel_rms(logits(c, t), logits(r, t)) for c, r, t in zip(ctl, ref, tops)),
            "depth_rel_rms": max(rel_rms(c, r) for c, r in zip(ctl, ref))}
