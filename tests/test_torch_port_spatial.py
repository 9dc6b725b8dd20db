"""bts_tpu_torch's spatial sharding (``--spatial_shards``,
``--spatial_shards_w``) on the CPU: the band arithmetic and the halo
exchange in-process, then the banded model in gloo ranks (one intra-op
thread each) against the one-process port and against bts_tpu on the same
weights.

The rules are the JAX package's (tests/test_spatial_sharding.py): the
banded forward equals the one-process forward within rtol 2e-5, atol 2e-5;
a train step through the Trainer gives the one-process loss (rtol 1e-5)
and, with BatchNorm frozen (eval mode), each tensor of the gradient the
Trainer applied within rtol 1e-4, atol 1e-4 of the tensor's largest entry.
With train-mode BatchNorm single tensors are not compared: a bias in front
of a BatchNorm has a true gradient of ~1e-10 and whatever rounding gives,
and the batch statistics amplify the order of the sums (the JAX test's
docstring; here such a bias, decoder.daspp_3.conv1.bias, is off by 1.9e-3
of its largest entry), so the whole gradient is held to 1e-4 relative
(3.3e-6 measured).  Either way the rules of
tests/test_torch_port_parallel.py hold the rest: BatchNorm's running
statistics and every parameter after the update 1e-6 absolute (1.2e-7
measured), and every rank holds the same parameters bit for bit.  The
readings: tests/torch_port_spatial_gaps.py.

The model is a tiny DenseNet (growth 8, blocks 1-1-2-1: the transitions'
average pools, the -inf max-pool, the stride-2 stem) under the BTS decoder
at bts_size 128 and 64x96, with weights from bts_tpu's variables through
the port's copy of the converter (``utils/weights.py::state_dict_from_jax``,
which needs bts_size >= 128); the slow bts_main/bts_test case runs
mobilenetv2_bts (depthwise stride-2 convs).
The ranks import this module, so JAX is imported only inside the tests
that use it.  The slow cases: the 2x2 train step, spatial with gradient
accumulation over two data groups of four bands (empty bands at H/32),
and bts_main then bts_test under torchrun.
"""

import multiprocessing
import os
import socket
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from hypothesis import given, settings
from hypothesis import strategies as st

from bts_tpu_torch.config import Config
from bts_tpu_torch.models.bts import create_model
from bts_tpu_torch.ops.lpg import check_divisible
from bts_tpu_torch.parallel import distributed as parallel
from bts_tpu_torch.parallel import spatial
from torch_port_spatial_ranks import BTS_SIZE, MAX_DEPTH, B, H, W

import torch_port_spatial_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the spawned ranks (see test_torch_port_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the band arithmetic -----------------------------------------------------


def _fake_grid(n, m, i, j):
    return SimpleNamespace(layout=spatial.Layout(n, m, n * m), i=i, j=j, col_group=None, row_group=None)


@settings(max_examples=60, deadline=None)
@given(a=st.integers(1, 6), b=st.integers(1, 6), n=st.integers(1, 4), m=st.integers(1, 4))
def test_bands_partition_every_level(a, b, n, m):
    """Over N x M bands of a 32a x 32b frame: each level's bands tile it,
    H..H/8 bands are whole LPG cells and equal at full resolution, and a
    band's (rows, columns) names its level on every rank; a split that
    cuts a cell is refused with the flags named."""
    height, width = 32 * a, 32 * b
    if height % (8 * n) or width % (8 * m):
        with pytest.raises(ValueError, match="--spatial_shards/--spatial_shards_w"):
            spatial.Bands(_fake_grid(n, m, 0, 0), height, width)
        return
    def shapes(i, j):
        r = [spatial.bounds(height // s, n) for s in spatial.LEVELS]
        c = [spatial.bounds(width // s, m) for s in spatial.LEVELS]
        return [(r[k][i + 1] - r[k][i], c[k][j + 1] - c[k][j]) for k in range(len(spatial.LEVELS))]

    if any(len(set(shapes(i, j))) < len(spatial.LEVELS) for i in range(n) for j in range(m)):
        # a band of one pixel or none at H/16 and at H/32: its level is not in its shape
        with pytest.raises(ValueError, match="the same"):
            for i in range(n):
                for j in range(m):
                    spatial.Bands(_fake_grid(n, m, i, j), height, width)
        return
    grids = [[spatial.Bands(_fake_grid(n, m, i, j), height, width) for j in range(m)] for i in range(n)]
    for s in spatial.LEVELS:
        rows = [grids[i][0].band(s)[:2] for i in range(n)]
        cols = [grids[0][j].band(s)[2:] for j in range(m)]
        assert rows[0][0] == 0 and rows[-1][1] == height // s and cols[-1][1] == width // s
        assert all(rows[i][1] == rows[i + 1][0] for i in range(n - 1))
        if s <= 8:
            assert all(r0 * s % 8 == 0 for r0, _ in rows) and all(c0 * s % 8 == 0 for c0, _ in cols)
        for i in range(n):
            for j in range(m):
                x = torch.empty(1, 1, *grids[i][j].band_shape(s))
                assert grids[i][j].level(x) == s
    assert {grids[i][j].band_shape(1) for i in range(n) for j in range(m)} == {(height // n, width // m)}


@pytest.mark.parametrize("world,n,m", [(2, 2, 1), (4, 2, 2), (8, 2, 2), (6, 1, 3)])
def test_layout_coords_round_trip(world, n, m):
    lay = spatial.Layout(n, m, world)
    coords = [lay.coords(r) for r in range(world)]
    assert [lay.rank(*c) for c in coords] == list(range(world))
    assert sorted(coords) == coords and lay.data == world // (n * m)


class _Board:
    """The shared state of in-process "ranks" (threads) of one group."""

    def __init__(self, size):
        self.size, self.sent, self.barrier = size, {}, threading.Barrier(size, timeout=30)


def _threaded_all_to_all(flat, out_splits, in_splits, group):
    board = group.board
    board.sent[group.rank] = list(flat.split(in_splits))
    board.barrier.wait()
    got = torch.cat([board.sent[q][group.rank] for q in range(board.size)])
    board.barrier.wait()
    return got


def _run_ranks(size, fn):
    out, errors = [None] * size, []

    def run(p):
        try:
            out[p] = fn(p)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(p,)) for p in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return out


needs_strategy = st.integers(1, 4).flatmap(lambda size: st.tuples(
    st.just(size), st.integers(0, 12),
    st.lists(st.tuples(st.integers(-6, 18), st.integers(0, 12)), min_size=size, max_size=size),
    st.sampled_from([0.0, float("-inf")]), st.integers(2, 3)))


@settings(max_examples=60, deadline=None)
@given(case=needs_strategy)
def test_halo_fetch_and_its_backward_equal_slicing(case):
    """``_Halo`` on threads standing in for a group: each rank gets rows
    [lo, hi) of the whole tensor with the pad value outside it (halos wider
    than a band, empty bands and empty needs included), and its backward
    gives each rank's rows the gradient that slicing the whole tensor
    gives them."""
    size, n, raw, value, dim = case
    needs = [(lo, lo + length) for lo, length in raw]
    b = spatial.bounds(n, size)
    rng = np.random.default_rng(n * 31 + size)
    shape = [2, 3, 5, 4]
    shape[dim] = n
    whole = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).requires_grad_()
    cots = []
    for lo, hi in needs:
        s = list(shape)
        s[dim] = hi - lo
        cots.append(torch.from_numpy(rng.normal(size=s).astype(np.float32)))
    board = _Board(size)

    def rank(p):
        x = whole.detach().narrow(dim, b[p], b[p + 1] - b[p]).clone().requires_grad_()
        plan = spatial._Plan(dim, b, p, needs, SimpleNamespace(board=board, rank=p))
        win = spatial._Halo.apply(x, plan, value)
        (win * cots[p]).sum().backward()
        return win.detach(), x.grad

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(spatial, "_all_to_all", _threaded_all_to_all)
        got = _run_ranks(size, rank)
    pad = [(0, 0)] * 4
    pad[dim] = (6, 31)
    padded = torch.nn.functional.pad(whole, [w for p in reversed(pad) for w in p], value=value)
    total = 0
    for p, (lo, hi) in enumerate(needs):
        ref = padded.narrow(dim, lo + 6, hi - lo)
        assert torch.equal(got[p][0], ref.detach()), p
        total = total + (torch.where(torch.isinf(ref), 0, ref) * cots[p]).sum()
    total.backward()
    for p in range(size):  # the same sums, perhaps in another order
        ref = whole.grad.narrow(dim, b[p], b[p + 1] - b[p])
        np.testing.assert_allclose(got[p][1].numpy(), ref.numpy(), rtol=1e-6, atol=1e-6, err_msg=str(p))


# --- refusals ------------------------------------------------------------------


def test_one_process_with_spatial_flags_raises_naming_them():
    with pytest.raises(ValueError, match="--spatial_shards 2 --spatial_shards_w 1 .* world holds 1"):
        create_model(Config(bts_size=128, spatial_shards=2))
    with pytest.raises(SystemExit, match="--spatial_shards 1 --spatial_shards_w 2"):
        parallel.maybe_init_distributed(Config(spatial_shards_w=2, device="cpu"))


def test_lpg_check_names_the_flags():
    check_divisible(352, 1216, 2, 2)
    with pytest.raises(ValueError, match=r"plane grid \(44.0, 152.0\) is sharded 8-way but 44 % 8 != 0"):
        check_divisible(352, 1216, 8, 1)
    with pytest.raises(ValueError, match=r"input_width/\(8\*shards_w\)"):
        check_divisible(64, 96, 1, 8)


# --- the banded model in gloo ranks ----------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_weights(path):
    """bts_tpu's BtsModel variables (numpy leaves from a seed: lecun-scaled
    kernels, non-default biases, BN affine and statistics) and the port's
    state_dict of them, written to ``path``; returns the JAX model and
    variables."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from bts_tpu.models.bts import BtsDecoder as JBtsDecoder
    from bts_tpu.models.encoders.densenet import DenseNet as JDenseNet
    from bts_tpu_torch.utils import torch_converter
    from bts_tpu_torch.utils.weights import state_dict_from_jax

    class JTiny(fnn.Module):
        """The tiny DenseNet + BtsDecoder, with BtsModel's subtree names."""

        @fnn.compact
        def __call__(self, image, focal=None):
            feats = JDenseNet(**ranks.TINY)(image, False)
            return JBtsDecoder(max_depth=MAX_DEPTH, num_features=BTS_SIZE)(feats, False, focal)

    rng = np.random.default_rng(5)

    def draw(name, shape, collection):
        if collection == "batch_stats":
            return rng.uniform(0.5, 2.0, shape) if name == "var" else rng.normal(0, 0.1, shape)
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        return rng.uniform(0.8, 1.2, shape) if name == "scale" else rng.normal(0, 0.05, shape)

    def walk(tree, collection):
        return {k: walk(v, collection) if hasattr(v, "items") else draw(k, v.shape, collection).astype(np.float32)
                for k, v in tree.items()}

    jm = JTiny()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    variables = {c: walk(t, c) for c, t in shapes.items()}
    mapping = torch_converter.densenet_mapping(ranks.TINY["block_config"])
    torch.save(state_dict_from_jax(variables, "densenet121_bts", BTS_SIZE, encoder_mapping=mapping), path)
    return jm, variables


def _spawn(tmp, world, cfg_kw, weights, parts):
    """Start ``world`` ranks (not waiting for them); returns the context
    and the paths of their records.  The ranks are forked from a fork
    server that imported the ranks' module once (a fresh process, so no
    thread of this one is forked), not started each from a new interpreter."""
    out = tmp / f"out{world}_{'_'.join(parts)}"
    multiprocessing.get_context("forkserver").set_forkserver_preload(["torch_port_spatial_ranks"])
    ctx = mp.start_processes(ranks.rank, args=(world, _free_port(), cfg_kw, str(weights), str(out), parts),
                             nprocs=world, join=False, start_method="forkserver")
    return ctx, [f"{out}.{r}" for r in range(world)]


def _records(started):
    ctx, paths = started
    while not ctx.join():
        pass
    return [torch.load(p, weights_only=False) for p in paths]


def _one_process(weights, b=B, **kw):
    """The one-process port's train step on the global batch, with
    BatchNorm in train mode ("step") and frozen ("frozen")."""
    cfg = ranks.config(batch_size=b, **kw)
    _, _, batch = ranks.inputs(b)
    return {part: ranks.train_step(cfg, ranks.load(cfg, weights), batch, list(range(b)), frozen_bn=part == "frozen")
            for part in ("step", "frozen")}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("spatial") / "weights.pt"
    return path, *_jax_weights(path)


@pytest.fixture(scope="module")
def runs(weights):
    """World 2 (H over 2: forward, a train step, the step with BatchNorm frozen) and
    world 4 (2 x 2: forward) on bts_tpu's weights, both started at once;
    meanwhile the one-process port's forward and steps and
    bts_tpu's forward on the same inputs, on one thread as the ranks (this
    module-scoped fixture runs before _one_torch_thread)."""
    import jax

    path, jm, variables = weights
    tmp = path.parent
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        h2 = _spawn(tmp, 2, {"spatial_shards": 2}, path, ("forward", "step", "frozen"))
        hw4 = _spawn(tmp, 4, {"spatial_shards": 2, "spatial_shards_w": 2}, path, ("forward",))
        image, focal, _ = ranks.inputs()
        with torch.inference_mode():
            port = ranks.load(ranks.config(), path)(image, focal)
        nhwc = np.ascontiguousarray(image.permute(0, 2, 3, 1).numpy())
        jax_outs = jax.jit(lambda v, x, f: jm.apply(v, x, focal=f))(variables, nhwc, focal.numpy())
        return {"port": port, "jax": [torch.from_numpy(np.asarray(o)).permute(0, 3, 1, 2) for o in jax_outs],
                **_one_process(path), "h2": _records(h2), "hw4": _records(hw4)}
    finally:
        torch.set_num_threads(threads)


def _close(out, ref, rtol=2e-5, atol=2e-5):
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("world", ["h2", "hw4"])
def test_banded_forward_equals_one_process(runs, world):
    """The five outputs of the banded forward (H over 2, or 2 x 2),
    gathered from every rank's bands, against the one-process forward."""
    for r in runs[world]:
        assert r["halo_bytes"] > 0
        for out, ref in zip(r["forward"], runs["port"]):
            _close(out, ref)


@pytest.mark.parametrize("world", ["h2", "hw4"])
def test_banded_forward_equals_bts_tpu(runs, world):
    """The same banded forward against bts_tpu's BtsModel on the variables
    the weights came from."""
    for out, ref in zip(runs[world][0]["forward"], runs["jax"]):
        _close(out, ref)


def _assert_update(ranks_, ref, frozen=False):
    """Every rank's step against the one-process step: loss, depth_mean,
    BatchNorm buffers, the gradient the Trainer applied and the parameters
    after the update, which every rank holds bit for bit alike."""
    for r in ranks_:
        step = r["frozen" if frozen else "step"]
        np.testing.assert_allclose(step["loss"], ref["loss"], rtol=1e-6 if frozen else 1e-5)
        np.testing.assert_allclose(step["depth_mean"], ref["depth_mean"], rtol=1e-5)
        for k, v in ref["buffers"].items():
            np.testing.assert_allclose(step["buffers"][k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
        assert step["grads"].keys() == ref["grads"].keys()
        if frozen:
            for k, v in ref["grads"].items():
                scale = max(v.abs().max().item(), 1e-6)
                np.testing.assert_allclose(step["grads"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4 * scale,
                                           err_msg=k)
        else:
            diff = sum((step["grads"][k] - v).square().sum() for k, v in ref["grads"].items())
            assert (diff / sum(v.square().sum() for v in ref["grads"].values())).sqrt() <= 1e-4
        first = ranks_[0]["frozen" if frozen else "step"]["params"]
        for k, v in ref["params"].items():
            assert torch.equal(step["params"][k], first[k]), k
            np.testing.assert_allclose(step["params"][k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_banded_step_equals_one_process(runs):
    """One f32 train step at world 2 (both ranks take the global b2 and
    split each augmented frame) against the one-process step: the loss,
    depth_mean, BatchNorm running statistics and the parameters after the
    update, and the gradient the Trainer reduced over the bands as a whole."""
    _assert_update(runs["h2"], runs["step"])


def test_banded_gradients_with_frozen_batchnorm(runs):
    """The same step with BatchNorm frozen: the gradient of the global loss
    (summed over the bands' backward passes, the halos' gradients returned
    to their owners, reduced by the Trainer) equals the one-process
    gradient tensor by tensor."""
    _assert_update(runs["h2"], runs["frozen"], frozen=True)


@pytest.mark.slow
def test_2x2_step_and_gradients_equal_one_process(weights, tmp_path):
    """The step and the frozen-BatchNorm gradients of the 2 x 2 split."""
    path = weights[0]
    started = _spawn(tmp_path, 4, {"spatial_shards": 2, "spatial_shards_w": 2}, path, ("step", "frozen"))
    ref = _one_process(path)
    got = _records(started)
    _assert_update(got, ref["step"])
    _assert_update(got, ref["frozen"], frozen=True)


@pytest.mark.slow
def test_grad_accum_spatial_matches_one_process(weights, tmp_path):
    """--grad_accum_steps 2 with --spatial_shards 4 over two data groups
    (world 8; bands of none or one row at H/32), AdamW's state sharded
    over the world (--shard_opt_state): the one-process accumulated step on
    the global b4 (the port of
    tests/test_spatial_sharding.py::test_grad_accum_spatial_matches_single)."""
    path = weights[0]
    kw = {"spatial_shards": 4, "grad_accum_steps": 2, "shard_opt_state": True}
    started = _spawn(tmp_path, 8, kw, path, ("step", "frozen"))
    ref = _one_process(path, b=4, grad_accum_steps=2)
    got = _records(started)
    _assert_update(got, ref["step"])
    _assert_update(got, ref["frozen"], frozen=True)


def _nyu_tree(root, n=3):
    from PIL import Image

    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)).save(root / "rgb" / f"{i}.png")
        Image.fromarray((rng.uniform(0.5, 9.5, (480, 640)) * 1000).astype(np.uint16)).save(root / "depth" / f"{i}.png")
        lines.append(f"rgb/{i}.png depth/{i}.png 518.8579")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.slow
@pytest.mark.parametrize("n,m", [(2, 1), (2, 2)])
def test_bts_main_and_bts_test_under_torchrun(tmp_path, n, m):
    """bts_main and bts_test with --spatial_shards N --spatial_shards_w M
    under torchrun on NYU geometry (480x640 frames, the 427x565 border
    crop augmented to 64x96): training, a resume, a resume in one process
    without the flags, and bts_test's PNGs against the one-process bts_test
    on the same checkpoint (one unit, 1 mm, for the rounding of depths
    within the forward rule); the port of
    tests/test_cli_spatial.py::test_train_and_infer_2d_spatial."""
    from bts_tpu_torch.cli import bts_main
    from bts_tpu_torch.utils.checkpoint import CheckpointManager
    from PIL import Image

    from bts_tpu_torch.cli import bts_test

    root = _nyu_tree(tmp_path / "nyu")
    common = ["--dataset", "nyu", "--encoder", "mobilenetv2_bts", "--bts_size", "64", "--max_depth", "10",
              "--data_path", str(root), "--gt_path", str(root), "--filenames_file", str(root / "split.txt"),
              "--compute_dtype", "float32", "--device", "cpu", "--use_native_loader", "never"]
    flags = ["--spatial_shards", str(n), "--spatial_shards_w", str(m)]
    train = common + ["--model_name", "sp", "--input_height", "64", "--input_width", "96", "--batch_size", "2",
                      "--log_freq", "1", "--save_freq", "100", "--dataloader_workers", "1",
                      "--log_directory", str(tmp_path / "runs"), *flags]

    def torchrun(module, argv):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n * m),
             "-m", module, *argv], cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc.stdout

    out = torchrun("bts_tpu_torch.cli.bts_main", train + ["--num_epochs", "1"])
    assert f"H over {n} x W over {m}" in out and "done at step 1" in out
    out = torchrun("bts_tpu_torch.cli.bts_main", train + ["--num_epochs", "2"])
    assert "resumed @ step 1" in out and "done at step 2" in out
    assert bts_main.main(train[:-len(flags)] + ["--num_epochs", "3"]) == 0
    ckpt = str(tmp_path / "runs" / "sp" / "ckpt")
    assert CheckpointManager(ckpt).steps()[-1] == 3
    test = common + ["--checkpoint_path", ckpt, "--batch_size", "2"]
    out = torchrun("bts_tpu_torch.cli.bts_test", test + ["--out_path", str(tmp_path / "banded"), *flags])
    assert "wrote 3 predictions" in out
    assert bts_test.main(test + ["--out_path", str(tmp_path / "whole")]) == 0
    for i in range(3):
        a, b = (np.array(Image.open(tmp_path / d / "raw" / f"rgb_{i}.png")).astype(np.int64)
                for d in ("banded", "whole"))
        assert 0 < b.max() <= 10_000
        assert np.abs(a - b).max() <= 1, i
