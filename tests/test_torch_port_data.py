"""The port's input plane against the JAX package's, on the CPU: the native
C++ loader (``bts_tpu_torch/data/native_loader.py`` over its copy
``csrc/btsdata.cc``), ArrayRecord shards (``data/records.py``,
``tools/make_records.py``), ``BtsDataLoader``'s choice between them and
PIL, and ``--debug_nans``.

Every file is made here from a numpy seed.  Images and KITTI depths are
held bit for bit: the native decoder, PIL and the JAX package's loader
give the same arrays.  NYU depths follow one rule: the native loader
scales uint16 counts by ``float32(1/1000)`` in float32 (a multiply), the
PIL path divides by 1000; the two differ by at most one ulp (on about 59%
of all uint16 values, by one), and the port's native depths equal the JAX
package's native depths bit for bit.
"""

from __future__ import annotations

import io
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from bts_tpu.config import Config as JConfig
from bts_tpu.data import native_loader as jnl
from bts_tpu.data import records as jrecords
from bts_tpu.data.dataloader import BtsDataLoader as JLoader
from bts_tpu_torch.config import Config
from bts_tpu_torch.data import native_loader as nl
from bts_tpu_torch.data import records
from bts_tpu_torch.data.crops import kb_crop, nyu_border_crop
from bts_tpu_torch.data.dataloader import BtsDataLoader
from bts_tpu_torch.data.depth_io import depth_from_png
from bts_tpu_torch.ops import _build
from bts_tpu_torch.parallel import distributed as parallel

REPO = Path(__file__).resolve().parents[1]
KITTI_HW, NYU_HW = (375, 1242), (480, 640)
NYU_SCALE = np.float32(1 / 1000)  # what the native loader multiplies NYU counts by


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while these tests run: beside the suite's other
    workers, torch's OpenMP pool oversubscribes the cores and runs tens of
    times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root: Path, dataset: str, n: int, seed: int) -> dict:
    """``n`` seeded frames and depth PNGs in the KITTI layout (a left and a
    right camera, ``image_02``/``image_03``) or a flat NYU one, with their
    split file; returns the loader's config fields."""
    rng = np.random.default_rng(seed)
    hw = KITTI_HW if dataset == "kitti" else NYU_HW
    scale = 256.0 if dataset == "kitti" else 1000.0
    cams = ("image_02", "image_03") if dataset == "kitti" else ("cam",)
    lines = []
    for i in range(n):
        for cam in cams:
            (root / cam).mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(root / cam / f"rgb{i}.png")
            depth = rng.uniform(0.3, 60.0 if dataset == "kitti" else 9.5, hw)
            if dataset == "kitti":
                depth *= rng.random(hw) < 0.3
            Image.fromarray((depth * scale).astype(np.uint16)).save(root / cam / f"gt{i}.png")
        lines.append(f"{cams[0]}/rgb{i}.png {cams[0]}/gt{i}.png {700.0 + i}")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return dict(dataset=dataset, data_path=str(root), gt_path=str(root), filenames_file=str(root / "split.txt"),
                batch_size=2, seed=3, dataloader_workers=2, do_kb_crop=dataset == "kitti")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return {"kitti": _tree(root / "kitti", "kitti", 5, seed=1), "nyu": _tree(root / "nyu", "nyu", 5, seed=2)}


def _equal_batches(a: list, b: list, nyu_depth: bool = False) -> None:
    """Batch by batch: equal keys, images and focals bit for bit; depths bit
    for bit, or (``nyu_depth``, native against PIL) within one ulp."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if k == "depth" and nyu_depth:
                ulps = np.abs(x[k].view(np.int32).astype(np.int64) - y[k].view(np.int32))
                assert ulps.max() <= 1, ulps.max()
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# -- the native library -------------------------------------------------------


def test_btsdata_source_is_a_copy_of_the_jax_packages():
    assert (REPO / "bts_tpu_torch/csrc/btsdata.cc").read_bytes() == (REPO / "native/btsdata.cc").read_bytes()


def test_port_loads_its_own_build_of_the_library():
    """The port builds under build/ (content digest), never the JAX
    package's in-place native/libbtsdata.so, and neither loads the other's."""
    assert nl.available(), nl.unavailable_reason()
    lib = Path(nl._lib()._name)
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libbtsdata-")
    assert jnl._load() is not None
    assert Path(jnl._SO) != lib and Path(jnl._SO).parent == REPO / "native"


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """One 480x1242 frame (large enough for the KB and the NYU crop) as
    PNG and JPEG, and a uint16 depth PNG, on disk."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (480, 1242, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(root / "f.png")
    Image.fromarray(rgb).save(root / "f.jpg", quality=92)
    Image.fromarray(rng.integers(0, 65536, (480, 1242), dtype=np.uint16)).save(root / "d.png")
    return root


CROPS = {"none": (nl.CROP_NONE, lambda a: a), "kb": (nl.CROP_KB, kb_crop), "nyu": (nl.CROP_NYU, nyu_border_crop)}


@pytest.mark.parametrize("source,kind,crop", [
    *[("file", kind, crop) for kind in ("png", "jpeg", "depth") for crop in CROPS],
    *[("memory", kind, "none") for kind in ("png", "jpeg", "depth")]])
def test_native_decode_matches_jax_and_pil(frames, source, kind, crop):
    """Native decode (file: with each crop; memory: the records path, no
    crop) equals the JAX package's native decode and PIL bit for bit; depth
    from a file at KITTI's 1/256 (exact), from memory as raw counts."""
    path = frames / {"png": "f.png", "jpeg": "f.jpg", "depth": "d.png"}[kind]
    mode, crop_fn = CROPS[crop]
    pil = np.asarray(Image.open(path).convert("RGB")) if kind != "depth" else np.array(Image.open(path))
    if source == "memory":
        data = path.read_bytes()
        assert nl.peek_dims(data) == jnl.peek_dims(data) == pil.shape[:2]
        port = nl.decode_rgb_mem(data) if kind != "depth" else nl.decode_depth_mem(data)
        ref = jnl.decode_rgb_mem(data) if kind != "depth" else jnl.decode_depth_mem(data)
        want = pil if kind != "depth" else pil.astype(np.float32)
    else:
        h, w = nl.crop_shape(mode, *pil.shape[:2])
        if kind != "depth":
            port, ref = nl.decode_rgb(str(path), mode, h, w), jnl.decode_rgb(str(path), mode, h, w)
            want = crop_fn(pil)
        else:
            port = nl.decode_depth(str(path), mode, 1 / 256, h, w)
            ref = jnl.decode_depth(str(path), mode, 1 / 256, h, w)
            want = depth_from_png(crop_fn(pil), "kitti")
    assert port.dtype == want.dtype
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, want)


def test_nyu_depth_scaling_rule(frames):
    """NYU: the native decoder multiplies by float32(1/1000), PIL's path
    divides by 1000: at most one ulp apart; the port equals the JAX
    package's native decode bit for bit."""
    path = str(frames / "d.png")
    counts = np.array(Image.open(path))
    port = nl.decode_depth(path, nl.CROP_NONE, 1 / 1000, *counts.shape)
    np.testing.assert_array_equal(port, jnl.decode_depth(path, nl.CROP_NONE, 1 / 1000, *counts.shape))
    np.testing.assert_array_equal(port, counts.astype(np.float32) * NYU_SCALE)
    pil = depth_from_png(counts, "nyu")
    ulps = np.abs(port.view(np.int32).astype(np.int64) - pil.view(np.int32))
    assert ulps.max() == 1 and 0.5 < (ulps == 1).mean() < 0.7


def test_peek_dims_refuses_garbage():
    with pytest.raises(ValueError, match="unrecognized/truncated image header"):
        nl.peek_dims(b"\x00" * 16)


# -- BtsDataLoader: native against PIL against the JAX package ------------------


def _streams(kw: dict, mode: str, **prefetch) -> dict:
    """The port's batches with --use_native_loader always and never, and the
    JAX package's with always, from ``prefetched``."""
    out = {}
    for name, make, cfg_cls, choice in (("always", BtsDataLoader, Config, "always"),
                                        ("never", BtsDataLoader, Config, "never"),
                                        ("jax", JLoader, JConfig, "always")):
        out[name] = list(make(cfg_cls(**kw, use_native_loader=choice), mode).prefetched(**prefetch))
    return out


@pytest.mark.parametrize("case", ["kitti_kb_train", "nyu_train", "kitti_kb_test", "nyu_test", "resume",
                                  "kitti_use_right"])
def test_loader_native_matches_pil_and_jax(trees, case, capsys):
    """Batches of the native path equal the PIL path's and the JAX
    package's native loader's: KITTI KB-crop train over two epochs, NYU
    train (border crop), test mode with a padded tail (KB crop; NYU at the
    probed 480x640), a resume at step 3, and --use_right (a camera drawn per
    sample).  The printed line names the path."""
    dataset = "nyu" if case.startswith("nyu") else "kitti"
    kw = dict(trees[dataset])
    mode = "test" if case.endswith("_test") else "train"
    prefetch = {"num_epochs": 1 if mode == "test" else 2, "start_step": 3 if case == "resume" else 0}
    if case == "kitti_use_right":
        kw["use_right"] = True
    s = _streams(kw, mode, **prefetch)
    out = capsys.readouterr().out
    crop = {"kitti": "KB crop", "nyu": "NYU border crop" if mode == "train" else "480x640"}[dataset]
    assert f"input: native C++ loader ({crop}, 2 threads)" in out and "input: PIL (--use_native_loader never)" in out
    # two epochs from the start epoch: step 3 is the second batch of epoch 1
    assert len(s["never"]) == {"train": 4, "test": 3}[mode] - (1 if case == "resume" else 0)
    _equal_batches(s["always"], s["jax"])
    _equal_batches(s["always"], s["never"], nyu_depth=dataset == "nyu")
    _equal_batches(s["never"], list(JLoader(JConfig(**kw, use_native_loader="never"), mode).prefetched(**prefetch)))
    if mode == "test":
        assert "depth" not in s["always"][0]
        np.testing.assert_array_equal(s["always"][-1]["image"][0], s["always"][-1]["image"][1])  # the pad
    if case == "kitti_use_right":
        right = kb_crop(np.asarray(Image.open(Path(kw["data_path"]) / "image_03" / "rgb0.png")))
        assert any((b["image"] == right).all((1, 2, 3)).any() for b in s["always"])


def test_kitti_test_mode_without_kb_crop_stays_on_pil(trees, capsys):
    kw = dict(trees["kitti"], do_kb_crop=False)
    got = list(BtsDataLoader(Config(**kw, use_native_loader="always"), "test").prefetched(num_epochs=1))
    assert "input: PIL (KITTI frames without --do_kb_crop differ in size)" in capsys.readouterr().out
    assert got[0]["image"].shape == (2, *KITTI_HW, 3)


@pytest.mark.parametrize("accum", [1, 2])
def test_world_2_rows_native_match_pil(trees, monkeypatch, accum):
    """Data parallel without processes: rank r of 2 gets the rows
    ``rank_rows`` gives it (not a contiguous slice when --grad_accum_steps
    is 2) from each global batch of 4, on the native path as on PIL; the two
    ranks together are the world-1 batch."""
    kw = dict(trees["kitti"], batch_size=4, grad_accum_steps=accum)
    whole = list(BtsDataLoader(Config(**kw, use_native_loader="never"), "train").prefetched(num_epochs=2))
    monkeypatch.setattr(parallel, "world", lambda: 2)
    parts = []
    for r in (0, 1):
        monkeypatch.setattr(parallel, "rank", lambda r=r: r)
        native = list(BtsDataLoader(Config(**kw, use_native_loader="always"), "train").prefetched(num_epochs=2))
        pil = list(BtsDataLoader(Config(**kw, use_native_loader="never"), "train").prefetched(num_epochs=2))
        _equal_batches(native, pil)
        parts.append((parallel.rank_rows(4, accum, r, 2), native))
    assert parts[0][0] == ([0, 1] if accum == 1 else [0, 2])
    for i, batch in enumerate(whole):
        for rows, native in parts:
            for k in batch:
                np.testing.assert_array_equal(native[i][k], batch[k][rows])


@pytest.fixture
def broken_build(monkeypatch):
    """The native library's link made to fail (a library that does not
    exist); the cached result is dropped before and after."""
    monkeypatch.setattr(nl, "LINK", ("-lbts_no_such_library",))
    nl._load.cache_clear()
    yield
    monkeypatch.undo()
    nl._load.cache_clear()


def test_always_raises_and_auto_falls_back_when_the_build_fails(trees, broken_build, capsys):
    assert not nl.available() and "bts_no_such_library" in nl.unavailable_reason()
    kw = trees["kitti"]
    with pytest.raises(RuntimeError, match="--use_native_loader always, but g.. failed to build"):
        BtsDataLoader(Config(**kw, use_native_loader="always"), "train").prefetched()
    auto = list(BtsDataLoader(Config(**kw, use_native_loader="auto"), "train").prefetched(num_epochs=1))
    out = capsys.readouterr().out
    assert re.search(r"input: PIL \(the native loader did not build: g.. failed to build .*btsdata\.cc", out), out
    _equal_batches(auto, list(BtsDataLoader(Config(**kw, use_native_loader="never"), "train").batches(1)))


# -- ArrayRecord shards ---------------------------------------------------------


@pytest.fixture(scope="module")
def shards(trees, tmp_path_factory):
    """The KITTI tree as shards written by the port (make_records, in
    process) and by the JAX package (write_records)."""
    from bts_tpu.data.dataloader import parse_filenames_file as jparse
    from bts_tpu_torch.tools import make_records

    root = tmp_path_factory.mktemp("records")
    kw = trees["kitti"]
    assert make_records.main(["--filenames_file", kw["filenames_file"], "--data_path", kw["data_path"],
                              "--gt_path", kw["gt_path"], "--out", str(root / "port" / "train"),
                              "--shard_size", "2"]) == 0
    (root / "jax").mkdir()
    jrecords.write_records(jparse(kw["filenames_file"], kw["data_path"], kw["gt_path"]),
                           str(root / "jax" / "train"), shard_size=3)
    return {"port": str(root / "port" / "train-*.array_record"), "jax": str(root / "jax" / "train-*.array_record")}


def test_make_records_writes_the_jax_packages_bytes(shards):
    """Three shards of 2, 2 and 1 records, each record the JAX package's
    encoding of the same files; the JAX reader reads the port's shards."""
    import glob

    files = sorted(glob.glob(shards["port"]))
    assert [Path(f).name for f in files] == [f"train-{i:05d}-of-00003.array_record" for i in range(3)]
    port, jax_src = records.RecordSource(shards["port"]), jrecords.RecordSource(shards["jax"])
    assert len(port) == len(jax_src) == 5
    for i in range(5):
        assert port._source[i] == jax_src._source[i]
        for a, b in zip(port.read(i), jrecords.RecordSource(shards["port"]).read(i)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("written_by", ["port", "jax"])
@pytest.mark.parametrize("choice", ["always", "never"])
def test_records_loader_equals_png_tree(trees, shards, written_by, choice, capsys):
    """Either package's shards through the port's loader (native in-memory
    decode or PIL) equal the port's PNG-tree batches bit for bit, over two
    epochs and from a resume at step 3; the JAX loader on the same shards
    gives the same batches."""
    kw = trees["kitti"]
    tree = list(BtsDataLoader(Config(**kw, use_native_loader="never"), "train").prefetched(num_epochs=2))
    rec_kw = dict(kw, filenames_file=shards[written_by], use_native_loader=choice)
    loader = BtsDataLoader(Config(**rec_kw), "train")
    assert loader.n_base == 5 and loader.steps_per_epoch() == 2
    _equal_batches(list(loader.prefetched(num_epochs=2)), tree)
    decode = "native in-memory decode" if choice == "always" else "PIL decode (--use_native_loader never)"
    assert f"input: ArrayRecord shards, {decode}" in capsys.readouterr().out
    _equal_batches(list(loader.prefetched(num_epochs=1, start_step=3)), tree[3:])
    _equal_batches(list(JLoader(JConfig(**rec_kw), "train").batches(num_epochs=2)), tree)


def _png_bytes(shape, dtype, fmt: str = "PNG", seed: int = 9) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, shape).astype(dtype)).save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("buf", [b"\x01\x00", b"\xff\x00\x00\x00abcd",
                                 jrecords.encode_record(_png_bytes((4, 6, 3), np.uint8), b"dep", 1.0) + b"x"],
                         ids=["short_header", "img_overrun", "framing"])
def test_record_framing_errors_match_the_reference(buf):
    with pytest.raises(ValueError) as port:
        records.decode_record(buf)
    with pytest.raises(ValueError) as ref:
        jrecords.decode_record(buf)
    assert str(port.value) == str(ref.value) and str(port.value).startswith(("record truncated", "record framing"))


def test_record_decode_falls_back_to_pil_and_names_a_bad_shard(tmp_path):
    """Payloads the native decoder cannot parse (a BMP image, a TIFF depth)
    decode through PIL, as in the reference; an undecodable image names its
    shard and local index."""
    from array_record.python.array_record_module import ArrayRecordWriter

    img = _png_bytes((16, 24, 3), np.uint8, "BMP")
    good = records.encode_record(img, _png_bytes((16, 24), np.uint16, "TIFF"), 5.0)
    image, depth, focal = records.decode_record(good)
    for a, b in zip((image, depth, focal), jrecords.decode_record(good)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(image, np.asarray(Image.open(io.BytesIO(img))))
    assert depth.dtype == np.uint16 and focal == 5.0
    path = str(tmp_path / "bad-00000-of-00001.array_record")
    writer = ArrayRecordWriter(path, "group_size:1")
    writer.write(good)
    writer.write(records.encode_record(b"not an image", None, 1.0))
    writer.close()
    with pytest.raises(RuntimeError, match=re.escape(f"failed to decode {path}[1]")):
        records.RecordSource(path).read(1)


@pytest.mark.parametrize("refused", ["test_mode", "use_right"])
def test_records_refuse_test_mode_and_use_right(shards, trees, refused):
    kw = dict(trees["kitti"], filenames_file=shards["port"], use_right=refused == "use_right")
    mode = "test" if refused == "test_mode" else "train"
    with pytest.raises(ValueError) as port:
        BtsDataLoader(Config(**kw), mode)
    with pytest.raises(ValueError) as ref:
        JLoader(JConfig(**kw), mode)
    assert str(port.value) == str(ref.value)


# -- bts_main: the native stream, closed; --debug_nans --------------------------


def _bts_main_argv(kw: dict, tmp_path: Path, name: str, *extra) -> list:
    return ["--device", "cpu", "--encoder", "mobilenetv2_bts", "--bts_size", "64", "--input_height", "64",
            "--input_width", "96", "--compute_dtype", "float32", "--dataset", kw["dataset"],
            "--data_path", kw["data_path"], "--gt_path", kw["gt_path"], "--filenames_file", kw["filenames_file"],
            "--batch_size", "2", "--num_epochs", "1", "--do_kb_crop", "--log_directory", str(tmp_path),
            "--model_name", name, "--log_freq", "1", "--save_freq", "100", *extra]


def test_bts_main_native_equals_pil_and_closes_the_loader(trees, tmp_path, monkeypatch, capsys):
    """bts_main with --use_native_loader always logs the losses of never
    (the same batches), and its C++ workers are stopped when it returns."""
    from bts_tpu_torch.cli import bts_main

    closed = []
    close = nl.NativeBatchLoader.close
    monkeypatch.setattr(nl.NativeBatchLoader, "close", lambda self: (closed.append(self.handle), close(self)))
    losses = {}
    for choice in ("always", "never"):
        argv = _bts_main_argv(trees["kitti"], tmp_path, choice, "--use_native_loader", choice)
        assert bts_main.main(argv) == 0
        losses[choice] = re.findall(r"^step \d+/2 loss (\S+)", capsys.readouterr().out, re.M)
    assert len(losses["always"]) == 2 and losses["always"] == losses["never"]
    assert closed and closed[0] is not None  # the stream's close reached the live loader


def test_debug_nans_names_the_module_that_made_the_nan(trees, tmp_path, capsys):
    """--debug_nans with remat on a tiny MobileNetV2: a clean run trains; a
    NaN planted in one conv weight (through --pretrained_model) raises
    FloatingPointError naming that conv at its first forward.  Without the
    flag no hook is installed."""
    from bts_tpu_torch.cli import bts_main
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.training.trainer import Trainer

    kw = trees["kitti"]
    argv = _bts_main_argv(kw, tmp_path, "clean", "--remat", "--debug_nans", "--use_native_loader", "never")
    assert bts_main.main(argv) == 0
    assert "done at step 2" in capsys.readouterr().out
    cfg = Config(encoder="mobilenetv2_bts", bts_size=64, dataset="kitti")
    model = create_model(cfg, "cpu")
    Trainer(model, cfg, total_steps=1, device="cpu")
    assert not any(m._forward_hooks for m in model.modules())
    sd = model.encoder.state_dict()
    sd["features.3.conv.1.0.weight"][0, 0, 0, 0] = float("nan")
    torch.save(sd, tmp_path / "encoder.pt")
    argv[argv.index("clean")] = "nan"
    with pytest.raises(FloatingPointError, match=r"NaN in the output of encoder\.features\.3\.conv\.1\.0 \(Conv2d\)"):
        bts_main.main(argv + ["--pretrained_model", str(tmp_path / "encoder.pt")])
    assert re.findall(r"^step \d+", capsys.readouterr().out, re.M) == []
