"""HTTP depth-inference server over an exported (or in-process) serving
forward; counterpart of ``bts_tpu/cli/bts_serve.py``.

Serves single-image HTTP requests against the static-batch program by
micro-batching them (``utils/serving.py::MicroBatcher``): concurrent
requests within a ``--serve_linger_ms`` window share one device call.

    python -m bts_tpu_torch.cli.bts_serve --export_path model.pt2 \\
        --dataset kitti --serve_port 8502
    # or straight from a checkpoint (same flags as bts_test):
    python -m bts_tpu_torch.cli.bts_serve @arguments/arguments_test_eigen.txt

Endpoints (stdlib http.server):

- ``GET /healthz`` -> JSON ``{status, batch, height, width, needs_focal, dataset}``.
- ``POST /v1/depth`` -> depth for ONE image.  Body: PNG/JPEG bytes at
  exactly (height, width); KITTI additionally requires ``?focal=<px>``.
  Response: uint16 depth PNG in the dataset scaling (kitti x256 / nyu
  x1000), or raw float32 ``.npy`` metres when the request sends
  ``Accept: application/octet-stream``.

Shape mismatches and a missing focal fail with 400 and the expected
contract; a failed device call with 500.  The server runs on ``--device``
(default ``cuda``; it raises without a card, ``--device cpu`` runs on the
CPU); ``--num_devices N > 1`` serves from a replica pool on cuda:0..N-1.
"""

from __future__ import annotations

import copy
import io
import json
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
from PIL import Image

from bts_tpu_torch.cli.bts_export import build_serve_fn
from bts_tpu_torch.config import adopt_sidecar_geometry, parse_args, require_device
from bts_tpu_torch.data.depth_io import depth_to_png
from bts_tpu_torch.models.bts import set_float32_precision
from bts_tpu_torch.utils.serving import MicroBatcher, load_exported
from bts_tpu_torch.utils.weights import restore_model


def serving_devices(cfg) -> list:
    """``--device``, or cuda:0..N-1 for ``--num_devices N > 1``."""
    device = require_device(cfg)
    if cfg.num_devices <= 1:
        return [device]
    if device.type != "cuda" or cfg.num_devices > torch.cuda.device_count():
        raise ValueError(f"--num_devices {cfg.num_devices} needs as many cards; --device {cfg.device} "
                         f"has {torch.cuda.device_count() if device.type == 'cuda' else 0}")
    return [torch.device("cuda", i) for i in range(cfg.num_devices)]


def _inference(fn):
    def run(*args):
        with torch.inference_mode():
            return fn(*args)

    return run


def build_backend(cfg, devices):
    """-> (replicas, batch, height, width, needs_focal), ``replicas`` one
    ``(device, fn)`` per device; from the exported file or the checkpoint."""
    if cfg.export_path:
        replicas = [(d, load_exported(cfg.export_path, d)) for d in devices]
        specs = replicas[0][1].in_specs
        b, h, w = specs[0].shape[:3]
        return replicas, b, h, w, len(specs) == 2
    # in-process: restore the checkpoint and serve the closure bts_export
    # exports (no artifact file needed); one model copy per device
    serve, use_focal = build_serve_fn(cfg, restore_model(cfg, devices[0]))
    replicas = [(d, _inference(serve if i == 0 else copy.deepcopy(serve).to(d))) for i, d in enumerate(devices)]
    return replicas, cfg.batch_size, cfg.input_height, cfg.input_width, use_focal


def make_server(cfg) -> ThreadingHTTPServer:
    """Build the HTTP server (not yet serving; caller runs serve_forever)."""
    set_float32_precision()  # served f32 depth is bts_test's
    devices = serving_devices(cfg)
    replicas, batch, height, width, needs_focal = build_backend(cfg, devices)
    if len(devices) > 1:
        print(f"[bts_tpu_torch] replica pool over {len(devices)} devices")
    batcher = MicroBatcher(replicas, batch, needs_focal=needs_focal, linger_ms=cfg.serve_linger_ms)
    dataset = cfg.dataset

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; stdout is the server log
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {
                    "status": "ok", "batch": batch, "height": height,
                    "width": width, "needs_focal": needs_focal, "dataset": dataset,
                })
            else:
                self._json(404, {"error": "unknown path; endpoints: GET /healthz, POST /v1/depth"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/v1/depth":
                self._json(404, {"error": "unknown path; endpoints: GET /healthz, POST /v1/depth"})
                return
            try:
                body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"), np.uint8)
            except Exception as e:
                self._json(400, {"error": f"body must be a decodable PNG/JPEG image: {e}"})
                return
            if img.shape != (height, width, 3):
                self._json(400, {"error": f"image shape {img.shape} != exported ({height}, {width}, 3); "
                                          "resize client-side"})
                return
            q = parse_qs(url.query)
            focal = None
            if needs_focal:
                if "focal" not in q:
                    self._json(400, {"error": "KITTI artifact: ?focal=<px> is required"})
                    return
                try:
                    focal = float(q["focal"][0])
                except ValueError:
                    self._json(400, {"error": f"bad focal {q['focal'][0]!r}"})
                    return
            try:
                depth_m = batcher.submit(img, focal)  # (H, W, 1) f32 metres
            except Exception as e:
                self._json(500, {"error": f"inference failed: {e}"})
                return
            depth_m = depth_m[..., 0]
            buf = io.BytesIO()
            if self.headers.get("Accept", "") == "application/octet-stream":
                np.save(buf, depth_m.astype(np.float32))
                self._send(200, buf.getvalue(), "application/octet-stream")
            else:
                Image.fromarray(depth_to_png(depth_m, dataset)).save(buf, format="PNG")
                self._send(200, buf.getvalue(), "image/png")

    server = ThreadingHTTPServer(("0.0.0.0", cfg.serve_port), Handler)
    server.batcher = batcher  # for tests / clean shutdown
    _orig_shutdown = server.shutdown

    def shutdown():
        _orig_shutdown()
        batcher.close()

    server.shutdown = shutdown
    return server


def main(argv=None):
    cfg = parse_args(argv, mode="test")
    cfg = adopt_sidecar_geometry(cfg)  # trained-run stride-2 geometry, if recorded
    server = make_server(cfg)
    host, port = server.server_address[:2]
    print(f"[bts_tpu_torch] serving depth on http://{host}:{port} "
          f"(batch={server.batcher.batch}, linger={cfg.serve_linger_ms} ms); Ctrl-C to stop", flush=True)

    # SIGTERM = the scheduler's stop (pod drain / rollout): stop accepting,
    # let in-flight micro-batches finish, exit 0.  shutdown() blocks until
    # serve_forever returns, and serve_forever runs on THIS thread, so the
    # handler fires it from a helper thread or the process deadlocks.
    def _drain(signum, frame):
        print(f"[bts_tpu_torch] received signal {signum}: draining and stopping", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    prev_term = signal.signal(signal.SIGTERM, _drain)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        server.shutdown()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
