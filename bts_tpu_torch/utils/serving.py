"""Serving: the loader of exported BTS serving programs and the
micro-batcher; counterpart of ``bts_tpu/utils/serving.py``.

The artifact is a ``torch.export`` program saved by ``torch.export.save``
(``cli/bts_export.py``): the serving forward's graph, with the restored
weights inside.  Loading it needs torch and the registrations of the port's
kernels as ``torch.library`` ops (``import bts_tpu_torch.ops``, which this
module does), because the graph calls ``bts_tpu_torch::lpg_fused_fwd`` (K1)
or, with ``--fused_tail always``, ``bts_tpu_torch::lpg_phase_planes`` (K5)
and ``bts_tpu_torch::fused_tail`` (K6).  It needs neither the model code nor
the checkpoint.  That is the difference from the JAX artifact, which jax
alone loads: its kernels are compiled into it.

    from bts_tpu_torch.utils.serving import load_exported
    serve = load_exported("model.pt2")
    depth = serve(images_u8)            # (B, H, W, 3) u8 -> (B, H, W, 1) f32

The shapes and dtypes are fixed in the artifact; a call that does not match
them fails with the expected signature.  A float32 program computes its
convolutions in full float32 on a card only with TF32 off
(``models/bts.py::set_float32_precision``), as ``bts_serve`` sets it.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from collections import deque
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np
import torch

import bts_tpu_torch.ops  # noqa: F401  (registers the kernels' ops the program calls)


class InputSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def load_exported(path: str, device=None):
    """Load an exported serving program; returns ``serve(*args)``: uint8
    images (B, H, W, 3) [and focal (B,) for KITTI], numpy or tensors on any
    device, -> (B, H, W, 1) f32 depth in metres, a tensor on the program's
    device.  ``device``: where to run it (default: where it was exported);
    the weights and the device arguments in its graph move there.

    ``serve.in_specs`` holds the expected :class:`InputSpec` of each argument
    and ``serve.exported`` the ``torch.export.ExportedProgram``."""
    exported = torch.export.load(path)
    user_inputs = set(exported.graph_signature.user_inputs)
    specs, home = [], None
    for node in exported.graph.nodes:
        if node.op == "placeholder" and node.name in user_inputs:
            val = node.meta["val"]
            specs.append(InputSpec(tuple(val.shape), val.dtype))
            home = val.device
    device = home if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device != home:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    module = exported.module()
    signature = ", ".join(f"{tuple(s.shape)} {s.dtype}" for s in specs)

    def serve(*args):
        got = [(tuple(np.shape(a)), torch.as_tensor(a).dtype) for a in args]
        if got != [(s.shape, s.dtype) for s in specs]:
            raise ValueError(f"exported serve takes ({signature}); got "
                             f"({', '.join(f'{s} {d}' for s, d in got)})")
        with torch.inference_mode():
            return module(*(torch.as_tensor(a).to(device, non_blocking=True) for a in args))

    serve.in_specs = tuple(specs)
    serve.exported = exported
    serve.device = device
    return serve


def _on(device: torch.device):
    """The device's context for the dispatcher thread: its CUDA device set
    before any launch, so a replica's kernels go to its own card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class MicroBatcher:
    """Collect concurrent single-image requests into static-batch device calls.

    The exported program has ONE static batch shape, and requests arrive one
    image at a time.  A dispatcher thread drains a queue, waits up to
    ``linger_ms`` for up to ``batch`` requests, zero-pads the rest (focal
    1.0 for the padded rows), runs ONE device call, and scatters the result
    rows back to per-request futures; an exception reaches every caller of
    its group.  Any number of HTTP threads block in :meth:`submit`.

    ``replicas`` is a sequence of ``(device, fn)``: ``fn(images[, focal])``
    takes tensors on ``device``.  The dispatcher copies each batch into
    pinned host memory and on to the device with ``non_blocking=True``, and
    launches ``fn``; the device->host copy of the result waits until the
    batch's slot is needed (``_scatter``), so the host collects batch i+1
    while the device works on batch i.  With one replica one batch is in
    flight; with several (a replica pool, one per card) batches go to them
    round-robin, one in flight on each.  ``calls`` counts the device calls.
    """

    def __init__(self, replicas, batch: int, *, needs_focal: bool, linger_ms: float = 5.0):
        self._replicas = [(torch.device(d), fn) for d, fn in replicas]
        if not self._replicas:
            raise ValueError("MicroBatcher needs at least one (device, fn) replica")
        self.batch = int(batch)
        self.needs_focal = bool(needs_focal)
        self.linger_s = float(linger_ms) / 1e3
        self.calls = 0
        self._rr = 0  # next replica (round-robin)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="bts-microbatch")
        self._thread.start()

    def submit(self, image_u8: np.ndarray, focal: float | None = None) -> np.ndarray:
        """Blocking: returns this image's (H, W, 1) depth row."""
        fut: Future = Future()
        self._q.put((np.asarray(image_u8, dtype=np.uint8), focal, fut))
        return fut.result()

    def close(self) -> None:
        """Stop taking requests; the batches in flight are still answered."""
        self._stop.set()
        self._q.put(None)  # unblock the dispatcher
        self._thread.join(timeout=5.0)

    # -- dispatcher -------------------------------------------------------

    def _take(self, timeout: float | None):
        try:
            return self._q.get(block=True, timeout=timeout)  # None: close()'s sentinel
        except queue.Empty:
            return None

    def _loop(self) -> None:
        # After launching a batch, go straight back to collecting the next
        # one, and copy the OLDEST batch's result to the host only once its
        # launch slot is needed: at most one batch in flight per replica.
        # With no follow-up traffic the idle poll drains the pipeline within
        # linger_ms per batch.
        pending: deque = deque()  # (group, result on the device)
        while not self._stop.is_set():
            first = self._take(self.linger_s if pending else None)
            if first is None:
                if pending:
                    self._scatter(*pending.popleft())
                continue
            group = [first]
            while len(group) < self.batch:
                nxt = self._take(self.linger_s)
                if nxt is None:
                    break
                group.append(nxt)
            if len(pending) >= len(self._replicas):  # free the oldest slot
                self._scatter(*pending.popleft())
            out = self._dispatch(group)
            if out is not None:
                pending.append((group, out))
        while pending:  # close() mid-flight: answer the remaining batches
            self._scatter(*pending.popleft())

    def _dispatch(self, group):
        """Launch one device call; returns its result (still on the device)
        or None after scattering the error to the group."""
        device, fn = self._replicas[self._rr]
        self._rr = (self._rr + 1) % len(self._replicas)
        n, pin = len(group), device.type == "cuda"
        try:
            images = torch.empty((self.batch,) + group[0][0].shape, dtype=torch.uint8, pin_memory=pin)
            rows = images.numpy()
            for i, (image, _, _) in enumerate(group):
                rows[i] = image
            rows[n:] = 0
            args = [images]
            if self.needs_focal:
                focal = torch.tensor([g[1] if g[1] is not None else 0.0 for g in group] + [1.0] * (self.batch - n),
                                     dtype=torch.float32)
                args.append(focal.pin_memory() if pin else focal)
            with _on(device):
                out = fn(*(a.to(device, non_blocking=True) for a in args))
            self.calls += 1
            return out
        except Exception as e:  # scatter the failure to every caller
            for _, _, fut in group:
                fut.set_exception(e)
            return None

    def _scatter(self, group, out) -> None:
        """Copy a dispatched result to the host and resolve its futures."""
        try:
            out = out.cpu().numpy()  # waits for the device; its errors surface here
        except Exception as e:
            for _, _, fut in group:
                fut.set_exception(e)
            return
        for i, (_, _, fut) in enumerate(group):
            fut.set_result(out[i])
