"""bts_tpu_torch's serving entry points against bts_tpu on the CPU: the
exported program (``cli/bts_export.py`` + ``utils/serving.py::load_exported``),
the HTTP server (``cli/bts_serve.py``) and its micro-batcher
(``utils/serving.py::MicroBatcher``), ``cli/bts_convert.py`` and
``cli/bts_sequence.py``; and ``torch.library.opcheck`` of the kernels' ops
(K1, K2, K5, K6), whose CPU implementations are the plain versions.

The tiny model is the JAX serving tests' (tests/test_serving.py:
mobilenetv2_bts, 32x64, b2, f32) at bts_size 128, the smallest width the
weight mapping takes (``torch_converter.decoder_mapping``, in both
packages), with ``encoder_pad="torch"``; NYU and KITTI.  The JAX variables
are drawn from a seed and carried over by ``utils/weights.py::
state_dict_from_jax``.  Tolerance against JAX: the decoder oracle's rtol
2e-4, atol 2e-4*max|ref| (tests/test_torch_oracle.py); uint16 PNGs within
1 unit.  The exported program against the eager port forward: equal.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bts_tpu.cli.bts_export import build_serve_fn as j_build_serve_fn
from bts_tpu.config import Config as JConfig
from bts_tpu.data.depth_io import depth_to_png
from bts_tpu.models import create_model as j_create_model
from bts_tpu_torch.cli import bts_convert, bts_export, bts_sequence, bts_serve, bts_test
from bts_tpu_torch.config import Config, adopt_sidecar_geometry
from bts_tpu_torch.models.bts import create_model
from bts_tpu_torch.ops import lpg_cuda, tail_cuda
from bts_tpu_torch.utils import weights
from bts_tpu_torch.utils.serving import MicroBatcher, load_exported
from test_torch_port_model import REPO, _one_torch_thread, _random_variables  # noqa: F401

RTOL, ATOL_SCALE = 2e-4, 2e-4
B, H, W, NF = 2, 32, 64, 128
MAX_DEPTH = {"nyu": 10.0, "kitti": 80.0}
FOCAL = np.array([600.0, 715.0873], np.float32)


class _State(NamedTuple):  # what the JAX build_serve_fn reads, as a pytree
    params: dict
    batch_stats: dict


def _kw(dataset, **kw):
    base = dict(mode="test", encoder="mobilenetv2_bts", dataset=dataset, max_depth=MAX_DEPTH[dataset],
                bts_size=NF, input_height=H, input_width=W, batch_size=B, compute_dtype="float32",
                encoder_pad="torch", serve_port=0, serve_linger_ms=100.0)
    base.update(kw)
    return base


def _cli_args(dataset, **kw):
    return [a for k, v in _kw(dataset, **kw).items() if k != "mode" for a in (f"--{k}", str(v))] + [
        "--device", "cpu"]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL_SCALE * np.abs(want).max())


def _frames(seed, n=B):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 3), dtype=np.uint8)


class _Tiny(NamedTuple):
    cfg: Config  # the port's
    jax_serve: object  # jitted JAX build_serve_fn: (state, images[, focal]) -> (B, H, W, 1)
    state: _State
    model: torch.nn.Module
    sd_path: str  # the port's state_dict, as a file


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Per dataset: JAX variables from a seed, the jitted JAX serving fn, and
    the port model with the same weights (and its state_dict file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out, tmp = {}, tmp_path_factory.mktemp("tiny")
    for seed, dataset in enumerate(("nyu", "kitti")):
        jcfg = JConfig(**_kw(dataset))
        variables = _random_variables(j_create_model(jcfg), seed, jnp.zeros((B, H, W, 3)))
        jax_serve = jax.jit(lambda state, *a, jcfg=jcfg: j_build_serve_fn(jcfg, state)[0](*a))
        cfg = Config(**_kw(dataset), device="cpu")
        model = create_model(cfg)
        sd = weights.state_dict_from_jax(variables, cfg.encoder, NF)
        weights.load_state_dict(model, sd)
        torch.save(sd, tmp / f"{dataset}.pt")
        out[dataset] = _Tiny(cfg, jax_serve, _State(variables["params"], variables["batch_stats"]), model,
                             str(tmp / f"{dataset}.pt"))
    torch.set_num_threads(threads)
    return out


def _truth(t: _Tiny, images, focal=None):
    """JAX's serving depth (B, H, W, 1) for a full batch."""
    args = (images,) if t.cfg.dataset == "nyu" else (images, FOCAL if focal is None else focal)
    return np.asarray(t.jax_serve(t.state, *args))


def _eager(t: _Tiny, images, focal=None):
    fwd, use_focal = bts_export.build_serve_fn(t.cfg, t.model)
    args = (images, FOCAL if focal is None else focal) if use_focal else (images,)
    with torch.inference_mode():
        return fwd(*(torch.as_tensor(a) for a in args)).numpy()


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    """The exported program of each dataset's tiny model, saved: NYU by the
    bts_export CLI from the checkpoint (with its summary line), KITTI by
    export_serving_fn."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp, paths = tmp_path_factory.mktemp("export"), {}
    paths["nyu"] = str(tmp / "nyu.pt2")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        code = bts_export.main(_cli_args("nyu", export_path=paths["nyu"], checkpoint_path=tiny["nyu"].sd_path))
    paths["nyu_summary"] = out.getvalue() if code == 0 else f"exit {code}"
    paths["kitti"] = str(tmp / "kitti.pt2")
    torch.export.save(bts_export.export_serving_fn(tiny["kitti"].cfg, tiny["kitti"].model), paths["kitti"])
    torch.set_num_threads(threads)
    return paths


@pytest.fixture(scope="module")
def loaded(artifacts):
    return {dataset: load_exported(artifacts[dataset]) for dataset in ("nyu", "kitti")}


@pytest.fixture(scope="module")
def served(tiny, artifacts):
    """Two servers on free ports: NYU from the exported program, KITTI in
    process from the checkpoint."""
    servers = {
        "nyu": bts_serve.make_server(tiny["nyu"].cfg.replace(export_path=artifacts["nyu"])),
        "kitti": bts_serve.make_server(tiny["kitti"].cfg.replace(checkpoint_path=tiny["kitti"].sd_path)),
    }
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers.values()]
    for th in threads:
        th.start()
    yield {d: s for d, s in servers.items()}
    for s, th in zip(servers.values(), threads):
        s.shutdown()
        s.server_close()
        th.join(timeout=5)
        assert not th.is_alive()


def _req(server, path, data=None, accept=None, method=None):
    port = server if isinstance(server, int) else server.server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def _png_bytes(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


# -- the slice: HTTP responses against the JAX serving fn ---------------------


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_served_npy_matches_jax(tiny, served, dataset):
    """One request to each server (NYU: the exported program; KITTI: in
    process, ?focal=) against the JAX package's build_serve_fn on the same
    weights, the request in row 0 of a zero-padded batch."""
    img = _frames(1, 1)[0]
    query = "?focal=600.0" if dataset == "kitti" else ""
    code, body, ctype = _req(served[dataset], f"/v1/depth{query}", _png_bytes(img), "application/octet-stream")
    assert code == 200 and ctype == "application/octet-stream", body
    got = np.load(io.BytesIO(body))
    batch = np.concatenate([img[None], np.zeros((B - 1, H, W, 3), np.uint8)])
    want = _truth(tiny[dataset], batch, np.array([600.0, 1.0], np.float32))[0, ..., 0]
    assert got.shape == (H, W) and got.dtype == np.float32
    _close(got, want)


def test_healthz(served):
    for dataset, server in served.items():
        code, body, ctype = _req(server, "/healthz")
        assert code == 200 and ctype == "application/json"
        assert json.loads(body) == {"status": "ok", "batch": B, "height": H, "width": W,
                                    "needs_focal": dataset == "kitti", "dataset": dataset}


def test_depth_png_scaling(tiny, served):
    """Without ``Accept: application/octet-stream`` the answer is the uint16
    PNG (NYU: metres x 1000), within 1 unit of the JAX depth's."""
    img = _frames(2, 1)[0]
    code, body, ctype = _req(served["nyu"], "/v1/depth", _png_bytes(img))
    assert code == 200 and ctype == "image/png", body
    png = np.array(Image.open(io.BytesIO(body)))
    assert png.dtype == np.uint16 and png.shape == (H, W)
    want = _truth(tiny["nyu"], np.concatenate([img[None], np.zeros((1, H, W, 3), np.uint8)]))[0, ..., 0]
    assert np.abs(png.astype(np.int64) - depth_to_png(want, "nyu").astype(np.int64)).max() <= 1


def test_concurrent_requests_microbatch(tiny, served):
    """Six concurrent requests at batch 2 share device calls, and each answer
    is its own image's depth (each pair against JAX)."""
    server = served["nyu"]
    imgs = _frames(3, 6)
    results = [None] * len(imgs)
    before = server.batcher.calls

    def hit(i):
        code, body, _ = _req(server, "/v1/depth", _png_bytes(imgs[i]), "application/octet-stream")
        assert code == 200, body
        results[i] = np.load(io.BytesIO(body))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(imgs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    calls = server.batcher.calls - before
    assert 3 <= calls < len(imgs), calls
    for i in range(0, len(imgs), B):
        want = _truth(tiny["nyu"], imgs[i:i + B])[..., 0]
        for j in range(B):
            _close(results[i + j], want[j])


def test_bad_requests(served):
    server = served["nyu"]
    code, body, _ = _req(server, "/v1/depth", _png_bytes(np.zeros((16, W, 3), np.uint8)))
    assert code == 400 and b"resize client-side" in body
    code, body, _ = _req(server, "/v1/depth", b"not a png")
    assert code == 400 and b"decodable" in body
    code, *_ = _req(server, "/v1/nope", b"", method="POST")
    assert code == 404
    code, *_ = _req(server, "/nope")
    assert code == 404


def test_kitti_requires_focal(served):
    img = _png_bytes(np.zeros((H, W, 3), np.uint8))
    code, body, _ = _req(served["kitti"], "/v1/depth", img)
    assert code == 400 and b"focal" in body
    code, body, _ = _req(served["kitti"], "/v1/depth?focal=far", img)
    assert code == 400 and b"bad focal" in body


def test_sigterm_drains_and_exits_cleanly(tmp_path):
    """SIGTERM, delivered to the public CLI in a subprocess (--device cpu,
    the in-process backend), stops the server after it answered, and the
    process exits 0."""
    log_path = tmp_path / "serve.log"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "bts_tpu_torch.cli.bts_serve", *_cli_args("nyu")],
                                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
        try:
            deadline, port = time.time() + 120, None
            while time.time() < deadline and port is None:
                m = re.search(r"serving depth on http://[^:]+:(\d+)", log_path.read_text())
                if m:
                    port = int(m.group(1))
                elif proc.poll() is not None:
                    pytest.fail(f"server exited early:\n{log_path.read_text()}")
                time.sleep(0.2)
            assert port, f"server never came up:\n{log_path.read_text()}"
            code, body, _ = _req(port, "/v1/depth", _png_bytes(_frames(4, 1)[0]), "application/octet-stream")
            assert code == 200 and np.isfinite(np.load(io.BytesIO(body))).all()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
    log = log_path.read_text()
    assert rc == 0, log
    assert "draining and stopping" in log, log


# -- MicroBatcher -------------------------------------------------------------


def test_microbatcher_padding_and_errors():
    """One request is zero-padded to the batch (focal 1.0 on the padded
    rows, 0.0 for a request without one); an exception reaches every caller
    of its group."""
    calls = []

    def fn(images, focal):
        calls.append((images.clone(), focal.clone()))
        return images[..., :1].float() + focal.view(-1, 1, 1, 1)

    mb = MicroBatcher([("cpu", fn)], batch=4, needs_focal=True, linger_ms=1.0)
    try:
        out = mb.submit(np.full((2, 3, 3), 7, np.uint8), 5.0)
        np.testing.assert_array_equal(out, np.full((2, 3, 1), 12.0, np.float32))
        mb.submit(np.full((2, 3, 3), 7, np.uint8))
        (images, focal), (_, focal2) = calls
        assert images.shape == (4, 2, 3, 3) and not images[1:].any()
        assert focal.tolist() == [5.0, 1.0, 1.0, 1.0] and focal2.tolist() == [0.0, 1.0, 1.0, 1.0]
        assert mb.calls == 2
    finally:
        mb.close()

    def boom(images):
        raise RuntimeError("device on fire")

    mb = MicroBatcher([("cpu", boom)], batch=2, needs_focal=False, linger_ms=50.0)
    try:
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(mb.submit, np.zeros((2, 3, 3), np.uint8)) for _ in range(2)]
            for f in futs:
                with pytest.raises(RuntimeError, match="device on fire"):
                    f.result(timeout=30)
        assert mb.calls == 0
    finally:
        mb.close()


class _Lazy:
    """Stands in for a result still on the device: the copy to the host
    blocks, the launch does not."""

    def __init__(self, out, delay_s):
        self._out, self._delay = out, delay_s

    def cpu(self):
        time.sleep(self._delay)
        return self._out


def test_microbatcher_pipelined_groups_map_rows_correctly():
    """With a batch in flight while the next is collected, results land on
    the right request, and a failure in the copy to the host reaches the
    callers of its batch."""
    dispatched = []

    def fn(images):
        dispatched.append(images.clone())
        return _Lazy(images[..., :1].float() + 1.0, delay_s=0.03)

    mb = MicroBatcher([("cpu", fn)], batch=2, needs_focal=False, linger_ms=2.0)
    try:
        imgs = [np.full((2, 2, 3), i, np.uint8) for i in range(6)]
        with ThreadPoolExecutor(6) as ex:
            outs = list(ex.map(mb.submit, imgs))
        for i, out in enumerate(outs):
            np.testing.assert_array_equal(out, np.full((2, 2, 1), i + 1.0, np.float32))
        assert len(dispatched) >= 3 and mb.calls == len(dispatched)
    finally:
        mb.close()

    class _Boom:
        def cpu(self):
            raise RuntimeError("async device failure")

    mb = MicroBatcher([("cpu", lambda images: _Boom())], batch=2, needs_focal=False, linger_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="async device failure"):
            mb.submit(np.zeros((2, 3, 3), np.uint8))
    finally:
        mb.close()


def test_microbatcher_replica_pool_round_robins_devices():
    """With several replicas (four stand-in devices, each its own fn), the
    micro-batches go to them in turn and the results land on the right
    requests."""
    seen = []

    def replica(r):
        def fn(images):
            seen.append(r)
            return _Lazy(images[..., :1].float() + 1.0, delay_s=0.01)
        return fn

    mb = MicroBatcher([("cpu", replica(r)) for r in range(4)], batch=1, needs_focal=False, linger_ms=1.0)
    try:
        imgs = [np.full((2, 2, 3), i, np.uint8) for i in range(8)]
        with ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(mb.submit, imgs))
        for i, out in enumerate(outs):
            np.testing.assert_array_equal(out, np.full((2, 2, 1), i + 1.0, np.float32))
        assert seen == [0, 1, 2, 3, 0, 1, 2, 3]
    finally:
        mb.close()


def test_microbatcher_close_flushes_in_flight_batch():
    """close() right after submit still answers the pending request."""
    mb = MicroBatcher([("cpu", lambda images: _Lazy(images[..., :1].float(), delay_s=0.1))],
                      batch=2, needs_focal=False, linger_ms=50.0)
    got = []
    th = threading.Thread(target=lambda: got.append(mb.submit(np.full((2, 2, 3), 5, np.uint8))))
    th.start()
    time.sleep(0.08)  # the dispatcher has the request
    mb.close()
    th.join(timeout=5.0)
    assert not th.is_alive()
    np.testing.assert_array_equal(got[0], np.full((2, 2, 1), 5.0, np.float32))


# -- export -------------------------------------------------------------------


def _kernel_calls(exported) -> list:
    return [str(n.target) for n in exported.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("bts_tpu_torch.")]


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_export_roundtrip_matches_forward(tiny, loaded, dataset):
    """The saved program, loaded without the model: its graph calls K1 three
    times; its depth equals the eager port forward and holds the rule
    against JAX; its input specs survive the round trip."""
    serve = loaded[dataset]
    assert _kernel_calls(serve.exported) == ["bts_tpu_torch.lpg_fused_fwd.default"] * 3
    images = _frames(5)
    args = (images, FOCAL) if dataset == "kitti" else (images,)
    got = serve(*args).numpy()
    assert got.shape == (B, H, W, 1)
    np.testing.assert_array_equal(got, _eager(tiny[dataset], images))
    _close(got, _truth(tiny[dataset], images))
    specs = [(s.shape, s.dtype) for s in serve.in_specs]
    assert specs[0] == ((B, H, W, 3), torch.uint8)
    assert specs[1:] == ([((B,), torch.float32)] if dataset == "kitti" else [])


def test_export_rejects_wrong_shape(loaded):
    serve = loaded["nyu"]
    with pytest.raises(ValueError, match=r"takes \(\(2, 32, 64, 3\) torch.uint8\)"):
        serve(np.zeros((1, H, W, 3), np.uint8))  # batch 1 != exported 2
    with pytest.raises(ValueError, match="takes"):
        serve(np.zeros((B, H, W, 3), np.float32))


def test_export_cli_end_to_end(artifacts, loaded):
    """bts_export from a checkpoint prints the JAX entry point's summary line, and
    its artifact serves finite depth in (0, max_depth)."""
    assert (f"exported serve(images_u8) b{B} {H}x{W} platforms=['cpu'] -> {artifacts['nyu']}"
            in artifacts["nyu_summary"]), artifacts["nyu_summary"]
    d = loaded["nyu"](np.zeros((B, H, W, 3), np.uint8)).numpy()
    assert d.shape == (B, H, W, 1) and np.isfinite(d).all()
    assert 0 < d.min() and d.max() < MAX_DEPTH["nyu"]


@pytest.mark.parametrize("platforms,match", [("tpu", "cuda or cpu"), ("cuda,cpu", "one device")])
def test_export_refuses_other_platforms(tmp_path, platforms, match):
    with pytest.raises(ValueError, match=match):
        bts_export.main(_cli_args("nyu", export_path=str(tmp_path / "m.pt2"), export_platforms=platforms))


def test_export_fused_tail_calls_k5_and_k6(tmp_path):
    """--fused_tail always (bts_size 512, b1): the saved graph calls K5
    three times, K6 once and K1 never, and the program equals the eager
    fused-tail forward."""
    cfg = Config(**_kw("kitti", bts_size=512, batch_size=1, fused_tail="always"), device="cpu")
    model = create_model(cfg)
    path = str(tmp_path / "tail.pt2")
    torch.export.save(bts_export.export_serving_fn(cfg, model), path)
    serve = load_exported(path)
    assert sorted(_kernel_calls(serve.exported)) == ["bts_tpu_torch.fused_tail.default"] + [
        "bts_tpu_torch.lpg_phase_planes.default"] * 3
    images = _frames(7, 1)
    focal = np.array([721.5377], np.float32)
    fwd, _ = bts_export.build_serve_fn(cfg, model)
    with torch.inference_mode():
        want = fwd(torch.from_numpy(images), torch.from_numpy(focal)).numpy()
    np.testing.assert_array_equal(serve(images, focal).numpy(), want)


@pytest.mark.parametrize("cli", ["bts_export", "bts_serve", "bts_sequence", "bts_convert"])
def test_entry_points_raise_on_cuda_without_a_card(cli, monkeypatch, tmp_path):
    """--device cuda (the default) without a card raises; nothing moves to
    the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Image.fromarray(_frames(0, 1)[0]).save(tmp_path / "0.png")
    argv = [*_cli_args("nyu", export_path=str(tmp_path / "m.pt2"), image_path=str(tmp_path))[:-2],
            "--device", "cuda"]
    if cli == "bts_convert":  # raises before it reads the file
        argv += ["--torch_checkpoint", str(tmp_path / "m.pth"), "--checkpoint_path", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        {"bts_export": bts_export, "bts_serve": bts_serve, "bts_sequence": bts_sequence,
         "bts_convert": bts_convert}[cli].main(argv)


# -- the kernels' ops ---------------------------------------------------------


def _opcheck_cases():
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    raw = t(2, 3, 4, 6).permute(0, 2, 3, 1)  # the decoder's (B, h, w, 3) view of NCHW
    iconv2 = t(1, 64, 16, 32).permute(0, 2, 3, 1)
    shapes = {"up": (3, 3, 64, 32), "r1": (1, 1, 32, 16), "r2": (1, 1, 16, 8), "r3": (1, 1, 8, 1),
              "i1": (3, 3, 36, 32), "f": (3, 3, 32, 1)}
    params = {n: {"kernel": t(*s) * 0.3, "bias": t(s[-1]) * 0.3} for n, s in shapes.items()}
    maps = [tail_cuda.lpg_phase_planes_plain(t(1, 32 // k, 64 // k, 3), k) for k in (2, 4, 8)]
    return {
        "K1": (lpg_cuda.lpg_fused, (raw, 4)),
        "K1_grad": (lpg_cuda.lpg_fused, (raw.detach().requires_grad_(), 2)),
        "K1_bf16": (lpg_cuda.lpg_fused, (raw.bfloat16(), 8)),
        "K2": (lpg_cuda.lpg_fused_bwd, (raw, t(2, 16, 24), 4)),
        "K5": (tail_cuda.lpg_phase_planes, (raw, 4)),
        "K6": (tail_cuda._k6, (iconv2, *maps, tail_cuda._flat_params(params))),
    }


@pytest.mark.parametrize("case", ["K1", "K1_grad", "K1_bf16", "K2", "K5", "K6"])
def test_registered_op_passes_opcheck(case):
    """torch.library.opcheck: schema, fake implementation (shapes, dtypes
    and strides against the CPU implementation, the plain version), the
    autograd registration (K1's backward is K2) and AOT dispatch."""
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


def test_k2_returns_the_nhwc_view_of_nchw_memory():
    """K2's gradient is the (B, h, w, 3) view of a (B, 3, h, w) buffer, from
    the CPU implementation and from the fake one that torch.export traces."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    raw, g = torch.randn(2, 3, 4, 6).permute(0, 2, 3, 1), torch.randn(2, 8, 12)
    with FakeTensorMode() as mode:
        fake = lpg_cuda.lpg_fused_bwd(mode.from_tensor(raw), mode.from_tensor(g), 2)
    for draw in (lpg_cuda.lpg_fused_bwd(raw, g, 2), fake):
        assert draw.shape == (2, 4, 6, 3) and draw.permute(0, 3, 1, 2).is_contiguous()


# -- bts_convert --------------------------------------------------------------


def _upstream_sd(variables, layout):
    """A full upstream-style state_dict from JAX variables, through the JAX
    package's own mapping, in one of the layouts released files use."""
    from bts_tpu.utils import torch_converter as jtc

    params, stats = variables["params"], variables["batch_stats"]
    enc = next(k for k in params if k.startswith("MobileNetV2"))
    sd = {}
    for prefix, subtree, mapping in (("encoder.base_model.", enc, jtc.ENCODER_MAPPINGS["mobilenetv2_bts"]()),
                                     ("decoder.", "BtsDecoder_0", jtc.decoder_mapping(NF))):
        for flax_path, key, kind in mapping:
            tree = (stats if flax_path[-1] in ("mean", "var") else params)[subtree]
            for p in flax_path:
                tree = tree[p]
            sd[prefix + key] = torch.from_numpy(jtc.flax_to_torch_tensor(np.asarray(tree, np.float32), kind).copy())
    sd["encoder.base_model.classifier.1.weight"] = torch.zeros(1000, 1280)  # not BTS's: ignored
    if layout == "module_model":
        return {"model": {f"module.{k}": v for k, v in sd.items()}, "global_step": 50000}
    if layout == "state_dict":
        return {"state_dict": sd, "epoch": 3}
    return sd


def _convert(tmp_path, pth, **kw):
    out = tmp_path / "converted"
    argv = ["--torch_checkpoint", str(pth), "--checkpoint_path", str(out), "--encoder", "mobilenetv2_bts",
            "--bts_size", str(NF), "--max_depth", "10", "--dataset", "nyu", "--compute_dtype", "float32",
            "--device", "cpu"]
    assert bts_convert.main(argv) == 0
    return out


def test_convert_serves_what_jax_load_torch_full_model_serves(tiny, tmp_path):
    """An upstream .pth ({'model'} wrapper, 'module.' prefix) built with the
    JAX package's mapping: JAX's load_torch_full_model + its serving fn, and
    the port's bts_convert -> bts_serve's in-process backend (the sidecar's
    encoder_pad=torch adopted), give the same depth."""
    from bts_tpu.utils.torch_converter import load_torch_full_model

    t = tiny["nyu"]
    pth = tmp_path / "bts_model.pth"
    torch.save(_upstream_sd(t.state._asdict(), "module_model"), pth)
    out = _convert(tmp_path, pth)
    jvars = load_torch_full_model(t.state._asdict(), "mobilenetv2_bts", NF, str(pth))
    images = _frames(9)
    want = np.asarray(t.jax_serve(_State(jvars["params"], jvars["batch_stats"]), images))

    cfg = adopt_sidecar_geometry(t.cfg.replace(encoder_pad="auto", checkpoint_path=str(out)))
    assert cfg.encoder_pad == "torch"
    (device, serve), *_ = bts_serve.build_backend(cfg, [torch.device("cpu")])[0]
    _close(serve(torch.from_numpy(images)).numpy(), want)


@pytest.mark.parametrize("layout", ["module_model", "state_dict", "bare"])
def test_convert_reads_wrapped_and_prefixed_layouts(tiny, tmp_path, layout):
    """Each layout converts to a weights-only checkpoint (step 0) that
    utils.weights.read_weights restores equal to the source tensors, with the
    encoder_pad=torch sidecar beside it."""
    t = tiny["nyu"]
    pth = tmp_path / "bts_model.pth"
    torch.save(_upstream_sd(t.state._asdict(), layout), pth)
    out = _convert(tmp_path, pth)
    sd, step = weights.read_weights(str(out))
    assert step == 0
    src = t.model.state_dict()
    assert sd.keys() == src.keys()
    for k in src:
        assert torch.equal(sd[k], src[k]), k
    assert json.loads((out / "config.json").read_text())["encoder_pad"] == "torch"


def test_convert_missing_key_fails_loudly(tiny, tmp_path):
    sd = _upstream_sd(tiny["nyu"].state._asdict(), "bare")
    del sd["decoder.conv3.weight"]
    pth = tmp_path / "partial.pth"
    torch.save(sd, pth)
    with pytest.raises(KeyError, match="decoder.conv3.weight"):
        _convert(tmp_path, pth)
    assert not (tmp_path / "converted").exists()


# -- bts_sequence -------------------------------------------------------------


def test_sequence_matches_bts_test_and_jax(tiny, tmp_path):
    """Five frames at batch 2 (a padded tail): bts_sequence's PNGs equal
    bts_test's for the same frames and weights, and are within 1 unit of
    the JAX serving depth's."""
    t = tiny["nyu"]
    frames = _frames(10, 5)
    (tmp_path / "rgb").mkdir()
    for i, img in enumerate(frames):
        Image.fromarray(img).save(tmp_path / "rgb" / f"{i}.png")
    (tmp_path / "split.txt").write_text("".join(f"rgb/{i}.png None 518.8579\n" for i in range(5)))
    common = _cli_args("nyu", checkpoint_path=t.sd_path)
    assert bts_sequence.main(common + ["--image_path", str(tmp_path / "rgb"), "--out_path",
                                       str(tmp_path / "seq")]) == 0
    assert bts_test.main(common + ["--data_path", str(tmp_path), "--filenames_file", str(tmp_path / "split.txt"),
                                   "--out_path", str(tmp_path / "test"), "--use_native_loader", "never"]) == 0
    padded = np.concatenate([frames, frames[-1:]])
    want = np.concatenate([_truth(t, padded[i:i + B]) for i in range(0, 6, B)])[..., 0]
    for i in range(5):
        seq = np.array(Image.open(tmp_path / "seq" / f"{i}.png"))
        assert seq.dtype == np.uint16
        np.testing.assert_array_equal(seq, np.array(Image.open(tmp_path / "test" / "raw" / f"rgb_{i}.png")))
        assert np.abs(seq.astype(np.int64) - depth_to_png(want[i], "nyu").astype(np.int64)).max() <= 1
