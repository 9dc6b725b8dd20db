"""The training driver: the port's ``Trainer.train_step``
(``bts_tpu_torch.training.trainer``) on a pool of distinct host batches in
pinned memory, cycled; augmentation on the card.

Set-up builds one trainer (model, AdamW state, schedule) and drives it
through ``checked_steps`` steps on distinct pool batches, reading what the
check needs as it goes: each step's loss, the first gradient as AdamW got
it (its first moment after one step, divided by 1 - beta1), and after the
last checked step how far every parameter and BatchNorm statistic has
moved from its initial value.  Then ``warmup_steps`` more, and the same
trainer goes on into the window.

The check runs the plain reference (float32, TF32 off) through the same
steps on the same batches from the same initial state, after the program
has been freed, and compares the numbers (:func:`compare`).

Faults (``portbench/faults.py``) swap :func:`trainer`:
``state_unchanged``, the optimizer's step leaves the parameters as they
were; ``half_batch``, each step sees only the first half of its batch,
the mean taken over the rest.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

import torch

from bts_tpu_torch.models.bts import set_float32_precision
from portbench.drivers.serve import rel_rms
from portbench.harness import inputs, program, trace, weights
from portbench.reference import train as ref_train
from portbench.reference.quant import fp8

GRAD_FLOOR = 1e-3  # leaves whose reference gradient norm is under this share of the median leaf's


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of two readings, each {'losses': [...],
    'grads': {leaf: norm}, 'changes': {leaf or buffer: norm}}.  A leaf's gap
    is the gap between its two norms, |n - n_ref|, over the larger of the
    reference's norm of that leaf and of the median leaf.

    - ``depth_rel_rms``: the first step's predicted depth (the forward in
      train mode on the augmented batch), the worst image's
      rms(depth - ref) / rms(ref), as the serving cells compare;
    - ``grad_gap_median``: the median leaf's gap of the first gradient (the
      worst leaf's, ``grad_gap_worst``, is a BatchNorm scale or shift whose
      gradient, a sum over every pixel of the batch that cancels, bfloat16
      rounds by a tenth or more on every seed; the program in float32 reads
      1e-6 there);
    - ``change_gap_worst``: the worst leaf's gap of the change over the
      steps, parameters and BatchNorm statistics;
    - printed beside them, not compared: ``loss_rel_gap``, the largest
      |loss - ref| / ref over the steps (no control or fault reads 3x its
      sound runs), and the worst and median leaves named above.

    Leaves whose reference gradient norm is under ``GRAD_FLOOR`` of the
    median leaf's (a conv bias before a train-mode BatchNorm: zero but for
    rounding) are left out of both, by that rule and not by name; the
    BatchNorm statistics always count in the change."""
    rg = ref["grads"]
    med = statistics.median(rg.values())
    keep = {n for n, g in rg.items() if g >= GRAD_FLOOR * med}

    def gaps(a: dict, b: dict, names) -> dict:
        m = statistics.median(b[n] for n in names)
        return {n: abs(a.get(n, 0.0) - b[n]) / max(b[n], m) for n in names}

    def at(g: dict, a: dict, b: dict) -> str:
        n = max(g, key=g.get)
        return f"{n}: {a.get(n, 0.0):.6g} against {b[n]:.6g}"

    grad = gaps(prog["grads"], rg, keep)
    change = gaps(prog["changes"], ref["changes"], keep | (set(ref["changes"]) - set(rg)))
    return {
        "depth_rel_rms": max(rel_rms(p, r) for p, r in zip(prog["depth"], ref["depth"])),
        "loss_rel_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
        "grad_gap_median": statistics.median(grad.values()),
        "change_gap_worst": max(change.values()),
        "grad_gap_worst": max(grad.values()),
        "change_gap_median": statistics.median(change.values()),
        "grad_worst_leaf": at(grad, prog["grads"], rg),
        "change_worst_leaf": at(change, prog["changes"], ref["changes"]),
        "leaves_left_out": len(rg) - len(keep),
    }


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def trainer(cfg, model, total_steps: int, device):
    """The system under test: the port's Trainer, whose ``train_step`` is
    the training step."""
    # imported here: torch.distributed.optim, which it brings, takes seconds
    # of a serving cell's set-up for nothing
    from bts_tpu_torch.training.trainer import Trainer

    return Trainer(model, cfg, total_steps=total_steps, device=device, augment=True)


class Driver:
    kind = "train"

    def __init__(self, model_cfg: dict, traffic: dict, seeds: dict, device):
        self.m, self.t, self.seeds, self.device = model_cfg, traffic, seeds, torch.device(device)
        train = {**model_cfg["train"], "batch_size": traffic["batch"]}  # the batch one card takes
        self.cfg = program.config(model_cfg["model"], train, seeds["program"], device, "train")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self):
        batch = self.pool[self.next % len(self.pool)]
        self.next += 1
        return self.trainer.train_step(batch)

    def setup(self) -> None:
        set_float32_precision()  # as bts_main sets it before it builds its Trainer
        state = weights.model_state(self.m["model"], self.seeds["weights"], self.device)
        model = program.build_model(self.cfg, state, self.device)
        self.trainer = trainer(self.cfg, model, self.m["train"]["total_steps"], self.device)
        self.pool = inputs.train_pool(self.t, self.m["model"]["focal"], self.seeds["inputs"], self.device)
        self.next = 0
        names = {id(p): n for n, p in model.named_parameters()}
        first: list = []
        hook = model.register_forward_hook(lambda mod, args, outs: first.append(outs[4].detach().float().cpu()))
        losses = []
        for i in range(self.t["checked_steps"]):
            losses.append(float(self._step()["loss"]))
            if i == 0:
                hook.remove()
                opt = self.trainer.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                moment = {names[id(p)]: opt.state[p]["exp_avg"] / (1 - beta1) for p in opt.state}
                grads = {**dict.fromkeys(names.values(), 0.0), **norms(moment)}
        after = model.state_dict()
        self.reading = {"losses": losses, "grads": grads, "depth": first[0],
                        "changes": norms({n: after[n].float() - state[n] for n in state})}
        del state, after
        for _ in range(self.t["warmup_steps"]):
            self._step()
        self._sync()

    def _loop(self, seconds: float = None, steps: int = None) -> dict:
        enq, images = [], 0
        self._sync()
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            self._step()
            now = time.perf_counter()
            enq.append(now - ts)
            images += self.t["batch"]
            if (seconds is not None and now - t0 >= seconds) or (steps is not None and len(enq) >= steps):
                break
        self._sync()
        return {"images": images, "window_s": time.perf_counter() - t0, "enqueue_s": enq}

    def window(self, seconds: float) -> dict:
        return self._loop(seconds=seconds)

    def traced(self) -> dict:
        return trace.traced(self.device, lambda: self._loop(steps=self.t["trace_steps"]))

    def heads(self):
        train = self.m["train"]
        return self.t["batch"], train["input_height"], train["input_width"]

    def free(self) -> None:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None) -> dict:
        """The reference's reading over the checked steps."""
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        state = weights.model_state(self.m["model"], self.seeds["weights"], self.device)
        initial = {n: t.clone() for n, t in state.items()}
        stat = (".running_mean", ".running_var")
        params = {n: t for n, t in state.items() if not n.endswith(stat)}
        buffers = {n: t for n, t in state.items() if n.endswith(stat)}
        opt = ref_train.AdamW(params, self.m["train"])
        losses = []
        for i in range(self.t["checked_steps"]):
            batch = {k: v.to(self.device) for k, v in self.pool[i].items()}
            loss, grads, depth = ref_train.step(params, buffers, opt, batch, self.seeds["program"],
                                                self.m["model"], self.m["train"], quant)
            losses.append(float(loss))
            if i == 0:
                first, first_depth = norms(grads), depth.cpu()
            del grads, depth
        return {"losses": losses, "grads": first, "depth": first_depth,
                "changes": norms({n: state[n] - initial[n] for n in state})}

    def check(self) -> dict:
        return compare(self.reading, self.reference())


def _broken(kind: str):
    def make(real):
        def broken(cfg, model, total_steps, device):
            t = real(cfg, model, total_steps, device)
            if kind == "state_unchanged":
                t.optimizer.step = lambda *a, **k: None
            else:
                step = t.train_step
                t.train_step = lambda batch: step({k: v[:v.shape[0] // 2] for k, v in batch.items()})
            return t

        return broken

    return make


def faults(traffic: dict) -> dict:
    return {name: ("trainer", _broken(name)) for name in ("state_unchanged", "half_batch")}


READ_FAULTS = ("half_batch",)  # a state left unchanged reads 1 by its measure, no run needed


def shrink(traffic: dict) -> dict:
    """The traffic at a size the CPU runs in seconds (the tests'); frames
    larger than the configuration's crop, which the tests shrink to 64x96."""
    return {**traffic, "frame_height": 80, "frame_width": 112, "batch": 2, "pool_batches": 3,
            "warmup_steps": 0, "trace_steps": 1}


def control(drv: Driver) -> dict:
    """The checked steps through the reference in fp8 and in float32, from
    the same state on the same batches, compared as :meth:`Driver.check`."""
    drv.pool = inputs.train_pool(drv.t, drv.m["model"]["focal"], drv.seeds["inputs"], drv.device)
    ref = drv.reference()
    return compare(drv.reference(fp8), ref)
